"""Device time a step of every kernel outside the benchmark's kernel
spans (PyTorch's own kernels: shading, textures, the dense light pdf,
sorts, gathers, copies), summed over the cards."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.steps:
        return None
    ns = sum(e - s for _, s, e, _, span in ctx.trace.kernels()
             if span is None)
    return ns * 1e-6 / ctx.trace.steps
