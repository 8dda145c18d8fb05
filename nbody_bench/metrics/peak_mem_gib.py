"""torch.cuda.max_memory_allocated() from the engine's build to the
window's end, in GiB; the benchmark's own check runs after it is read."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
