"""Points a step where the host waits on the card: the program's counter
`readbacks` (each synchronize, each read of a device value and each
boolean mask on the fast path and its resets; utils/profiling.py)."""

from . import _program


def read(ctx):
    tot = _program.totals()
    if tot is None:
        return None
    return _program.per_step(ctx, tot["counters"].get("readbacks", 0))
