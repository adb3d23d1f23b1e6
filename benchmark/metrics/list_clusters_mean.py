"""Mean clusters a list handed to the sweep entries (K2, K4) in the traced
steps; a count of -1 counts every cluster."""

ENTRIES = ("intersect_culled_rows", "intersect_stream_rows")


def read(ctx):
    clusters = sum(ctx.work.get(e, {}).get("clusters", 0) for e in ENTRIES)
    lists = sum(ctx.work.get(e, {}).get("lists", 0) for e in ENTRIES)
    return clusters / lists if lists else None
