"""K3's share of its operation roofline, in %: the float operations the
inputs need over 67 TFLOP/s (float32), divided by K3's device time a
call (short_range_kernel and its plan kernels).

What the inputs need: every ordered pair closer than r_cut
(forces.cut_factor times rs) at the start state, counted by the
benchmark's own cell search on sampled targets and scaled to N, times
FLOPS_PER_PAIR. The count reads the same whatever plan, capacity or
kernel the program uses."""

import torch

from .. import peaks, reference
from . import k3_ms_per_step

# a pair of the even split: dx (3), r^2 + eps^2 (6), rsqrt (1), r^-3
# (2), v (2), degree-10 Horner (20), + r^-3 and the clamp (2), times m_j
# (1), three multiply-adds into the sum (6); a multiply-add counts 2
FLOPS_PER_PAIR = 44
SAMPLES = 8192


def needed_pairs(pos, box: float, r_cut: float, targets) -> float:
    """Ordered pairs within r_cut at `pos`, from the targets' neighbour
    counts scaled to every particle."""
    ncell = max(3, int(box // r_cut))
    cid = reference.cell_ids(pos, box, ncell)
    p = pos.to(torch.float64)
    r2max = r_cut * r_cut
    count = 0
    for _, _, ti, j, d in reference.pair_chunks(p, cid, targets, ncell=ncell,
                                                box=box):
        r2 = (d * d).sum(-1)
        count += int(((r2 < r2max) & (j != targets[ti])).sum())
    return count * pos.shape[0] / targets.numel()


def read(ctx):
    tr = ctx["trace"]
    calls = len(tr.kernels(k3_ms_per_step.KERNEL))
    if not calls:
        return None
    per_call = tr.seconds(tr.kernels(k3_ms_per_step.PATTERN)) / calls
    g = ctx["geometry"]
    start = ctx["start_positions"]
    n = start.shape[0]
    targets = torch.as_tensor(ctx["rng"].choice(n, min(SAMPLES, n),
                                                replace=False),
                              device=start.device)
    pairs = needed_pairs(start, g["box"], g["r_cut"], targets)
    bound = pairs * FLOPS_PER_PAIR / peaks.FP32_FLOPS
    return 100.0 * bound / per_call
