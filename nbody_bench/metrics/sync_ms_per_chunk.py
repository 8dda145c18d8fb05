"""Device time of the public state's sync a chunk: the span
`engine.sync_state` (core/engine.py _sync_state_from_fast: the live
rows' boolean masks and the scatter into particle order) over the
chunks (`engine.chunk`), idle time inside the span included."""

from . import _program


def read(ctx):
    tot = _program.totals()
    if tot is None:
        return None
    return (_program.device_seconds(tot, "engine.sync_state") * 1e3
            / tot["spans"]["engine.chunk"]["count"])
