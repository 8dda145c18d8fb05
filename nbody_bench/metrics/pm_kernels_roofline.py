"""K1 + K2's share of their byte roofline, in %: the bytes the inputs
need over 3.35 TB/s, divided by K1 + K2's device time a call.

A call of K1 reads each particle's position and mass (16 B) and writes
the ng^3 float32 grid; K2 reads the potential grid and the positions
(12 B a particle) and writes the accelerations (12 B a particle)."""

from .. import peaks

K1 = r"cic_deposit_kernel"
K2 = r"fd4_gather_kernel"


def bytes_needed(n: int, ng: int) -> float:
    grid = 4.0 * ng ** 3
    return (16.0 * n + grid) + (grid + 12.0 * n + 12.0 * n)


def read(ctx):
    tr = ctx["trace"]
    k1, k2 = tr.kernels(K1), tr.kernels(K2)
    if not k1 or not k2:
        return None
    per_call = (tr.seconds(k1) + tr.seconds(k2)) / len(k1)
    bound = bytes_needed(ctx["n"], ctx["geometry"]["ng"]) \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / per_call
