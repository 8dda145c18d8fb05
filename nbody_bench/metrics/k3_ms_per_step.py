"""Device time of the short range a step: K3 (short_range_kernel) and its
plan kernels (ops/short_range.py -> csrc/short_range.cu)."""

PATTERN = r"short_range_kernel|plan_classes|plan_order"
KERNEL = r"short_range_kernel"


def read(ctx):
    tr = ctx["trace"]
    ev = tr.kernels(PATTERN)
    return tr.seconds(ev) * 1e3 / ctx["steps"] if ev and ctx["steps"] \
        else None
