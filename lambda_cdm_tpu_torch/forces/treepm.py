"""TreePM gravity in plain PyTorch (counterpart of
lambda_cdm_tpu/forces/treepm.py): cell bucketing and the short-range split
fit that the treepm_fast path uses, and the stateless `treepm` solver
(PM long range + bucketed short range,
S(r) = erfc(r/2rs) + (r/(rs sqrt(pi))) exp(-r^2/4rs^2)).

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


# ---------------------------------------------------------------------------
# The stateless TreePM solver (plain PyTorch, as the JAX package computes
# it in jnp): PM long range + cell-bucketed short range
# ---------------------------------------------------------------------------

_S_POLY_COEFFS, _S_POLY_XMAX = _fit_short_poly()


def short_range_factor(r, rs):
    """S(r) = erfc(r / 2rs) + (r / (rs sqrt(pi))) exp(-r^2 / 4rs^2): the
    short-range truncation of the Gaussian split."""
    x = r / (2.0 * rs)
    return torch.special.erfc(x) + (r / (rs * math.sqrt(math.pi))) \
        * torch.exp(-x * x)


def short_range_factor_poly(r, rs):
    """Polynomial S(r): the least-squares fit on x in [0, 3], zero
    beyond (S(3) = 2e-5)."""
    x = r / (2.0 * rs)
    xc = torch.clamp(x, max=_S_POLY_XMAX)
    s = torch.zeros_like(xc)
    for c in _S_POLY_COEFFS:
        s = s * xc + float(c)
    return torch.where(x < _S_POLY_XMAX, torch.clamp(s, min=0.0), 0.0)


def treepm_plan(num_particles: int, box_size: float, pm_grid: int, *,
                split_factor: float = 1.25, cut_factor: float = 4.5,
                capacity: int = 0) -> dict:
    """Static geometry of the short-range pass: rs = split_factor *
    box / pm_grid, r_cut = cut_factor * rs, cells of size >= r_cut (one
    cell when fewer than 3 fit), capacity 4x the mean occupancy (at least
    32, a multiple of 8) unless given."""
    rs = split_factor * box_size / pm_grid
    r_cut = cut_factor * rs
    ncell = max(int(math.floor(box_size / r_cut)), 1)
    if ncell < 3:
        ncell = 1
    if capacity <= 0:
        mean_occ = num_particles / max(ncell ** 3, 1)
        capacity = int(max(32, math.ceil(4.0 * mean_occ)))
        capacity = ((capacity + 7) // 8) * 8
    return {"rs": rs, "r_cut": r_cut, "ncell": ncell, "capacity": capacity}


# pair slots a batch of x-slabs of short_range_bucketed may hold: its
# temporaries are about 12 float32 [slots] tensors (3.2 GB at 2^26)
PAIR_SLOT_BUDGET = 1 << 26


def short_range_bucketed(bucket_pos, bucket_mass, box_size, rs, softening,
                         *, ncell: int, capacity: int,
                         use_poly: bool = False):
    """Short-range accelerations (unit G) for every bucket slot
    -> [C, K, 3]: for each of the 27 neighbour offsets (the lattice rolled
    as the JAX package rolls it), the min-image pair sum over the
    neighbour cell's K slots, in batches of x-slabs of at most
    PAIR_SLOT_BUDGET pair slots (the JAX package scans one slab at a
    time)."""
    from .direct import min_image
    nc, k = ncell, capacity
    bp = bucket_pos.reshape(nc, nc, nc, k, 3)
    bm = bucket_mass.reshape(nc, nc, nc, k)
    soft2 = softening * softening
    s_fn = short_range_factor_poly if use_poly else short_range_factor
    slabs = max(1, min(nc, PAIR_SLOT_BUDGET // max(nc * nc * k * k, 1)))
    acc = torch.zeros_like(bp)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                nb_pos = torch.roll(bp, shifts=(-ox, -oy, -oz),
                                    dims=(0, 1, 2))
                nb_mass = torch.roll(bm, shifts=(-ox, -oy, -oz),
                                     dims=(0, 1, 2))
                for x0 in range(0, nc, slabs):
                    cp = bp[x0:x0 + slabs]
                    dx = min_image(nb_pos[x0:x0 + slabs, :, :, None, :, :]
                                   - cp[:, :, :, :, None, :], box_size)
                    r2 = torch.sum(dx * dx, dim=-1) + soft2
                    inv_r = torch.rsqrt(r2)
                    s = s_fn(r2 * inv_r, rs)
                    w = (nb_mass[x0:x0 + slabs, :, :, None, :] * s
                         * (inv_r * inv_r * inv_r))
                    acc[x0:x0 + slabs] += torch.sum(w[..., None] * dx,
                                                    dim=4)
    return acc.reshape(nc ** 3, k, 3)


def short_range_targets(bpos_soa, bmass, rows, box_size, rs, softening,
                        *, ncell: int, capacity: int, use_poly: bool = True):
    """Short-range accelerations of selected flat bucket rows -> [T, 3]:
    the pair set and arithmetic of short_range_bucketed (27 neighbour
    cells, min image), O(T * 27 * capacity). bpos_soa is [3, C, K]."""
    from .direct import min_image
    nc, k = ncell, capacity
    c_cnt = nc ** 3
    soft2 = softening * softening
    s_fn = short_range_factor_poly if use_poly else short_range_factor
    rows = torch.as_tensor(rows, device=bpos_soa.device).to(torch.int64)
    cell = rows // k
    cx, cy, cz = cell // (nc * nc), (cell // nc) % nc, cell % nc
    pt = bpos_soa.reshape(3, c_cnt * k)[:, rows]                  # [3, T]
    offs = torch.tensor([(ox, oy, oz) for ox in (-1, 0, 1)
                         for oy in (-1, 0, 1) for oz in (-1, 0, 1)],
                        device=rows.device)
    nx = torch.remainder(cx[:, None] + offs[None, :, 0], nc)
    ny = torch.remainder(cy[:, None] + offs[None, :, 1], nc)
    nz = torch.remainder(cz[:, None] + offs[None, :, 2], nc)
    ncid = (nx * nc + ny) * nc + nz                               # [T, 27]
    nb_pos = bpos_soa.reshape(3, c_cnt, k)[:, ncid]               # [3,T,27,K]
    nb_mass = bmass.reshape(c_cnt, k)[ncid]                       # [T, 27, K]
    dx = min_image(nb_pos - pt[:, :, None, None], box_size)
    r2 = torch.sum(dx * dx, dim=0) + soft2
    inv_r = torch.rsqrt(r2)
    w = nb_mass * s_fn(r2 * inv_r, rs) * (inv_r * inv_r * inv_r)
    return torch.sum(w[None] * dx, dim=(2, 3)).T                  # [T, 3]


def treepm_accelerations(positions, masses, box_size, *, pm_grid: int,
                         softening=0.01, g_const=1.0,
                         split_factor: float = 1.25,
                         cut_factor: float = 4.5, capacity: int = 0,
                         return_diagnostics: bool = False):
    """TreePM accelerations [N, 3] = PM long range + bucketed short range.
    A box too small for a 3^3 cell lattice degrades to PM with the
    unsplit Green's function. Particles that overflow their bucket get the
    PM force only (the overflow count is in the diagnostics)."""
    from .pm import pm_accelerations
    n = positions.shape[0]
    plan = treepm_plan(n, float(box_size), pm_grid,
                       split_factor=split_factor, cut_factor=cut_factor,
                       capacity=capacity)
    ncell, cap, rs = plan["ncell"], plan["capacity"], plan["rs"]
    if ncell == 1:
        acc = pm_accelerations(positions, masses, pm_grid, box_size,
                               g_const, split_scale=0.0)
        zero = torch.zeros((), dtype=torch.int64, device=positions.device)
        return (acc, {"overflow": zero, **plan}) if return_diagnostics \
            else acc
    acc_long = pm_accelerations(positions, masses, pm_grid, box_size,
                                g_const, split_scale=rs)
    bpos, bmass, pslot, overflow = bucket_particles(
        positions, masses, box_size, ncell=ncell, capacity=cap)
    acc_short_b = short_range_bucketed(bpos, bmass, box_size, rs, softening,
                                       ncell=ncell, capacity=cap)
    flat = acc_short_b.reshape(-1, 3)
    acc_short = torch.where((pslot >= 0)[:, None],
                            flat[torch.clamp(pslot, min=0)], 0.0)
    acc = acc_long + g_const * acc_short
    if return_diagnostics:
        return acc, {"overflow": overflow, **plan}
    return acc
