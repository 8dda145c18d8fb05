"""Cell bucketing and the short-range split fit (counterpart of the parts
of lambda_cdm_tpu/forces/treepm.py that the treepm_fast path uses).

Buckets are [ncell^3, capacity] with z-major cell ids
((cx*nc)+cy)*nc+cz and LIVE-FIRST slots: the live particles of a cell
sit at ranks 0..count-1 in a stable (input) order, padding after them
with zero mass. The kernels rely on that packing.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _fit_short_poly(degree: int = 10, x_max: float = 3.0):
    """Least-squares polynomial fit of S(x) = erfc(x) + (2x/sqrt(pi))e^-x^2
    on [0, x_max], in numpy exactly as the JAX package does it, so the
    float32 coefficients are identical. Returns (coeffs f32, x_max)."""
    x = np.linspace(0.0, x_max, 4001)
    s = np.array([math.erfc(v) + (2.0 * v / math.sqrt(math.pi))
                  * math.exp(-v * v) for v in x])
    coeffs = np.polyfit(x, s, degree)
    err = float(np.max(np.abs(np.polyval(coeffs, x) - s)))
    assert err < 5e-4, f"short-range poly fit error {err}"
    return coeffs.astype(np.float32), x_max


def bucket_src_map(positions, masses, box_size, *, ncell: int,
                   capacity: int):
    """Inverse slot map for cell bucketing: src[dest_slot] = source row, or
    n (the sentinel) for empty slots. positions are [N, 3] or SoA [3, N].

    Returns (src [C*capacity] int64, slot [n] in sorted order, order [n],
    ok [n] bool, overflow 0-d int64). The sort is stable, as jnp.argsort
    is, so slot ranks match the JAX package exactly."""
    soa = positions.ndim == 2 and positions.shape[0] == 3
    n = positions.shape[1] if soa else positions.shape[0]
    ncells = ncell ** 3
    comps = ((positions[0], positions[1], positions[2]) if soa else
             (positions[:, 0], positions[:, 1], positions[:, 2]))
    # a 0-d tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can move a particle on a cell
    # boundary; a tensor divides exactly on every device, as XLA does
    box = torch.tensor(box_size, dtype=comps[0].dtype,
                       device=comps[0].device)
    cx, cy, cz = (torch.clamp(torch.floor(c / box * ncell)
                              .to(torch.int64), 0, ncell - 1)
                  for c in comps)
    cid = (cx * ncell + cy) * ncell + cz
    live = masses > 0
    cid = torch.where(live, cid, ncells)

    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    live_s = live[order]

    idx = torch.arange(n, device=cid.device)
    is_start = torch.ones(n, dtype=torch.bool, device=cid.device)
    is_start[1:] = cid_s[1:] != cid_s[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - run_start
    ok = (rank < capacity) & live_s
    nslots = ncells * capacity
    slot = torch.where(ok, cid_s * capacity + rank, nslots)
    overflow = torch.sum(~ok & live_s)

    # slot nslots is the drop sentinel (sliced off): the scatter below
    # writes each real slot at most once
    src = torch.full((nslots + 1,), n, dtype=torch.int64, device=cid.device)
    src[slot] = order
    return src[:nslots], slot, order, ok, overflow


def bucket_gather(x, src, fill=0.0):
    """Re-bucket one per-particle array by the bucket_src_map: a single
    row gather with a sentinel pad row."""
    pad = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=0)[src]


def bucket_particles(positions, masses, box_size, *, ncell: int,
                     capacity: int):
    """[N, 3] particles -> (bucket_pos [C, K, 3], bucket_mass [C, K],
    particle_slot [N] (-1 on overflow or dead), overflow)."""
    n = positions.shape[0]
    ncells = ncell ** 3
    src, slot, order, ok, overflow = bucket_src_map(
        positions, masses, box_size, ncell=ncell, capacity=capacity)
    bpos = bucket_gather(positions, src, 0.0)
    bmass = bucket_gather(torch.where(masses > 0, masses, 0.0), src, 0.0)
    pslot = torch.full((n,), -1, dtype=torch.int64, device=positions.device)
    pslot[order] = torch.where(ok, slot, -1)
    return (bpos.reshape(ncells, capacity, 3),
            bmass.reshape(ncells, capacity), pslot, overflow)
