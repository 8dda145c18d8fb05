"""Device kernel launches in the traced window over the steps traced
(the engine loop: core/engine.py run, _fast_chunk,
_sync_state_from_fast, and everything they launch)."""


def read(ctx):
    n = sum(1 for e in ctx["trace"].device if e[1] == "kernel")
    return n / ctx["steps"] if n and ctx["steps"] else None
