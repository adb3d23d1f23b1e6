"""K1's share of its roofline in the traced steps, in %: the sum of each
call's bound (its work counted at cluster_masks_rows's arguments,
benchmark/roofline/cluster_masks_rows.py) over its span's device time."""

from benchmark.roofline import share


def read(ctx):
    return share(ctx, "cluster_masks_rows")
