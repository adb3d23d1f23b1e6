"""K2's share of its roofline in the traced steps, in %: the sum of each
call's bound (its work counted at intersect_culled_rows's arguments,
benchmark/roofline/intersect_culled_rows.py) over its span's device time."""

from benchmark.roofline import share


def read(ctx):
    return share(ctx, "intersect_culled_rows")
