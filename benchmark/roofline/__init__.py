"""Each kernel entry's work and the card's peaks.

A file <entry>.py here names a kernel entry of the program (MODULE and
the entry's name, which is the file's) and counts what one call needs
from the call's own arguments: capture(args, kwargs) at call time, with
no device sync, and optionally work(captured) once the trace has
stopped. Both give 'ops' (fp32 operations) and 'bytes' (every input
byte read once, every output byte written once); work() may add counts
of its own. Because the work is counted at the entry's arguments, it is
the same whatever implements the entry.
"""

from __future__ import annotations

import importlib
from pathlib import Path

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# fp32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two
    bounds."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def entries() -> dict:
    """entry name -> its module, for every file here."""
    return {p.stem: importlib.import_module(f"{__name__}.{p.stem}")
            for p in sorted(Path(__file__).parent.glob("*.py"))
            if p.stem != "__init__"}


def share(ctx, entry: str):
    """The entry's share of its roofline over the traced steps, in %:
    the sum of each call's bound over the device time of its span; None
    where the entry ran no kernel there."""
    if ctx.trace is None:
        return None
    w = ctx.work.get(entry)
    t = ctx.trace.span_seconds(entry)
    if not w or not w["calls"] or t <= 0:
        return None
    return 100.0 * w["bound_s"] / t
