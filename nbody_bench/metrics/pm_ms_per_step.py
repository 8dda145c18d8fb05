"""Device time of the PM long range a step: K1 (cic_deposit_kernel), K2
(fd4_gather_kernel) and the cuFFT kernels (ops/pm_rods.py,
ops/bucketed_pm.py)."""

PATTERN = r"cic_deposit_kernel|fd4_gather_kernel|(?i:fft)"


def read(ctx):
    tr = ctx["trace"]
    ev = tr.kernels(PATTERN)
    return tr.seconds(ev) * 1e3 / ctx["steps"] if ev and ctx["steps"] \
        else None
