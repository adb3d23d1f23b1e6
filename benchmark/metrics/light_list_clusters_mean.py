"""Mean light clusters a list handed to K5 (light_sums_rows) in the traced
steps; a count of -1 counts every cluster."""


def read(ctx):
    w = ctx.work.get("light_sums_rows", {})
    return w["clusters"] / w["lists"] if w.get("lists") else None
