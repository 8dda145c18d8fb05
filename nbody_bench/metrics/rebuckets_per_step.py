"""Rebucket passes a step: the program's counter `rebuckets`
(ops/fast_treepm.py fast_run), set by the cadence the drift guard
leaves (core/engine.py _fast_cadence)."""

from . import _program


def read(ctx):
    tot = _program.totals()
    if tot is None:
        return None
    return _program.per_step(ctx, tot["counters"].get("rebuckets", 0))
