"""``torch.cuda.max_memory_allocated`` over the window (the statistics
reset when it opens), in GiB: the weights and all else kept alive count."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
