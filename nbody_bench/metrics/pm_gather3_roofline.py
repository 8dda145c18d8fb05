"""The stateless PM's three-field gather kernel (pm_cic_gather3_kernel,
csrc/pm_cic.cu) against its byte roofline, in %: the bytes its inputs
need over 3.35 TB/s, divided by its device time a call. A call reads the
three ng^3 float32 gradient fields and each particle's position (12 B)
and writes its acceleration (12 B)."""

from .. import peaks

KERNEL = r"pm_cic_gather3_kernel"


def bytes_needed(n: int, ng: int) -> float:
    return 12.0 * ng ** 3 + 24.0 * n


def read(ctx):
    tr = ctx["trace"]
    ev = tr.kernels(KERNEL)
    if not ev:
        return None
    bound = bytes_needed(ctx["n"], ctx["geometry"]["ng"]) \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / (tr.seconds(ev) / len(ev))
