"""Device time of the stateless PM's particle passes a step: the CIC
scatter and the three-field gather kernels (csrc/pm_cic.cu, launched by
ops/pm_cic.py inside the spans pm.deposit and pm.gather), read from the
device trace by kernel name; the grid's zeroing is left out."""

PATTERN = r"pm_cic_scatter_kernel|pm_cic_gather3_kernel"


def read(ctx):
    tr = ctx["trace"]
    ev = tr.kernels(PATTERN)
    return tr.seconds(ev) * 1e3 / ctx["steps"] if ev and ctx["steps"] \
        else None
