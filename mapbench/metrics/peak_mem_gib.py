"""``torch.cuda.max_memory_allocated()`` over the run, read when the
window closes, in GiB; its stats are reset at the start of set-up."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2 ** 30
