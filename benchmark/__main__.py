import time

_T0 = time.perf_counter()

import sys  # noqa: E402

from benchmark.run import main  # noqa: E402

sys.exit(main(t_start=_T0))
