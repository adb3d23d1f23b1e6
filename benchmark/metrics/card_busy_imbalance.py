"""The busiest card's device time over the least busy card's, in the
traced steps."""


def read(ctx):
    t = ctx.trace
    if t is None or len(t.busy_s) < 2 or min(t.busy_s.values()) <= 0:
        return None
    return max(t.busy_s.values()) / min(t.busy_s.values())
