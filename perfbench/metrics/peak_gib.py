"""peak_gib (GiB): the highest ``torch.cuda.max_memory_allocated()`` of the
window's fits, the peak reset before each."""


def read(ctx):
    peak = max((f["peak_bytes"] for f in ctx["fits"]), default=0)
    return peak / 2**30 if peak else None
