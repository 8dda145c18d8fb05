"""Device time of the half kicks and the drift a step: the spans
`fast.kick` (two a step) and `fast.drift` (with the scale factor's update
on the host) in ops/fast_treepm.py _fast_segment, idle time inside the
spans included."""

from . import _program


def read(ctx):
    tot = _program.totals()
    if tot is None:
        return None
    return _program.per_step(ctx, _program.device_seconds(
        tot, "fast.kick", "fast.drift") * 1e3)
