"""torch.cuda.max_memory_allocated of the whole run, on the fullest
card, in GiB."""


def read(ctx):
    return ctx.peak_mem_bytes / 2**30 if ctx.peak_mem_bytes else None
