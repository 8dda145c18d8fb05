"""Device time of the rebucket passes a step: the span `fast.rebucket`
(ops/fast_treepm.py fast_run: _rebucket in its gather or compact form
and the overflow readback), idle time inside the span included."""

from . import _program


def read(ctx):
    tot = _program.totals()
    if tot is None:
        return None
    return _program.per_step(
        ctx, _program.device_seconds(tot, "fast.rebucket") * 1e3)
