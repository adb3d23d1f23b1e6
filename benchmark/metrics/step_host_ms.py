"""Mean host time a step, from the end of one frame's hook to the start
of the next (the enqueue of a step), over the window's untraced steps."""


def read(ctx):
    t = ctx.step_host_s
    return 1e3 * sum(t) / len(t) if t else None
