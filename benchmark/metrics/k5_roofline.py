"""K5's share of its roofline in the traced steps, in %: the sum of each
call's bound (its work counted at light_sums_rows's arguments,
benchmark/roofline/light_sums_rows.py) over its span's device time."""

from benchmark.roofline import share


def read(ctx):
    return share(ctx, "light_sums_rows")
