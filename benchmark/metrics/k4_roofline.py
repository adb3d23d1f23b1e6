"""K4's share of its roofline in the traced steps, in %: the sum of each
call's bound (its work counted at intersect_stream_rows's arguments,
benchmark/roofline/intersect_stream_rows.py) over its span's device time."""

from benchmark.roofline import share


def read(ctx):
    return share(ctx, "intersect_stream_rows")
