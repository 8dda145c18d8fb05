"""Device time a step that neither the PM long range nor K3 claims: the
kicks and drifts (physics/integrators.py via ops/fast_treepm.py), the
rebucket (fast_treepm._rebucket*), the resets' bucketing and the state
syncs."""

from . import k3_ms_per_step, pm_ms_per_step


def read(ctx):
    tr = ctx["trace"]
    if not tr.device or not ctx["steps"]:
        return None
    claimed = (tr.seconds(tr.kernels(pm_ms_per_step.PATTERN))
               + tr.seconds(tr.kernels(k3_ms_per_step.PATTERN)))
    return (tr.device_seconds() - claimed) * 1e3 / ctx["steps"]
