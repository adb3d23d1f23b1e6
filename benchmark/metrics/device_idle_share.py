"""One minus the union of the device's busy intervals over the traced
window, as a mean over the cell's cards."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    busy = list(t.busy_s.values())
    return 1.0 - sum(busy) / len(busy) / t.window_s
