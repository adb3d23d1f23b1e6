"""K4, the streamed sweep of scenes above the resident limit: K2's work
count, with one list a 512-ray block (the block is read from the call)."""

from benchmark.roofline.intersect_culled_rows import (  # noqa: F401
    MODULE,
    capture,
    work,
)
