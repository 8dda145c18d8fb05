"""The stateless PM's CIC scatter kernel (pm_cic_scatter_kernel,
csrc/pm_cic.cu) against its byte roofline, in %: the bytes its inputs
need over 3.35 TB/s, divided by its device time a call. A call reads
each particle's position and mass (16 B) and writes the ng^3 float32
grid once."""

from .. import peaks

KERNEL = r"pm_cic_scatter_kernel"


def bytes_needed(n: int, ng: int) -> float:
    return 16.0 * n + 4.0 * ng ** 3


def read(ctx):
    tr = ctx["trace"]
    ev = tr.kernels(KERNEL)
    if not ev:
        return None
    bound = bytes_needed(ctx["n"], ctx["geometry"]["ng"]) \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / (tr.seconds(ev) / len(ev))
