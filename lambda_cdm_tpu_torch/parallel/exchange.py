"""Capacity-bounded particle migration over the rank mesh (counterpart of
lambda_cdm_tpu/parallel/exchange.py, less `exchange_ghosts`, which comes
with the sharded TreePM).

Ownership is a 1D x-slab decomposition: rank d owns x in [d, d + 1) *
box / D, or the slab [bounds[d], bounds[d + 1]) of load-adaptive bounds.
As in the JAX package, the exchange has static shapes: each rank fills a
[D, capacity] send buffer (zero-mass padding), one all_to_all moves the
buckets, and overflow is counted and reported, never dropped silently;
the caller grows the capacity and retries.

The per-rank functions (`migrate_particles`, `migrate_particles_emigrant`,
`load_imbalance`) take the rank's rows and return its rows, row for row
what the JAX shard_map body computes on that shard; the partition helpers
take whole arrays, or a rank's rows and the mesh, whose histograms they
then sum over the ranks (the JAX package's histograms of the global
sharded array, bit for bit: the sums are of integer-valued floats).
"""

from __future__ import annotations

import math

import torch

from .mesh import Mesh


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d as a true division on every device (PyTorch's CUDA division
    by a Python number multiplies by its reciprocal)."""
    return x / torch.as_tensor(d, dtype=x.dtype, device=x.device)


def pad_particles(positions, velocities, masses, *, n_dev: int,
                  factor: float = 1.5):
    """Arrays of N_alloc = ceil(factor * N / n_dev) * n_dev rows, zero-mass
    padding after the N particles (compute.mesh.migrate_capacity_factor
    headroom for slab occupancy to fluctuate)."""
    n = positions.shape[0]
    n_alloc = int(math.ceil(factor * n / n_dev)) * n_dev
    pad = n_alloc - n
    if pad == 0:
        return positions, velocities, masses
    return (torch.nn.functional.pad(positions, (0, 0, 0, pad)),
            torch.nn.functional.pad(velocities, (0, 0, 0, pad)),
            torch.nn.functional.pad(masses, (0, pad)))


def find_owner(positions, box_size, n_dev: int, bounds=None):
    """Owning rank of each row: uniform x-slabs, or the slabs of adaptive
    `bounds` [n_dev + 1]; int32."""
    if bounds is None:
        d = torch.floor(_div(positions[:, 0], box_size) * n_dev)
        return torch.clamp(d.to(torch.int32), 0, n_dev - 1)
    d = torch.searchsorted(bounds[1:-1].contiguous(),
                           positions[:, 0].contiguous(), right=True)
    return torch.clamp(d.to(torch.int32), 0, n_dev - 1)


def find_owner_3d(positions, box_size, dims: tuple, bounds=None):
    """Owning flat rank for a (dx, dy, dz) block decomposition (row-major
    ranks): uniform blocks, or the bricks of adaptive_bounds_nd's
    (bx, by, bz)."""
    if bounds is None:
        ids = []
        for a in range(3):
            d = torch.floor(_div(positions[:, a], box_size) * dims[a])
            ids.append(torch.clamp(d.to(torch.int32), 0, dims[a] - 1))
        return (ids[0] * dims[1] + ids[1]) * dims[2] + ids[2]
    bx, by, bz = bounds
    ix = torch.clamp(torch.searchsorted(
        bx[1:-1].contiguous(), positions[:, 0].contiguous(),
        right=True).to(torch.int32), 0, dims[0] - 1)
    byr = by[ix.long()]
    iy = torch.sum(positions[:, 1][:, None] >= byr[:, 1:-1], dim=1)
    iy = torch.clamp(iy.to(torch.int32), 0, dims[1] - 1)
    bzr = bz[ix.long(), iy.long()]
    iz = torch.sum(positions[:, 2][:, None] >= bzr[:, 1:-1], dim=1)
    iz = torch.clamp(iz.to(torch.int32), 0, dims[2] - 1)
    return (ix * dims[1] + iy) * dims[2] + iz


def _segment_sum(w, idx, n: int):
    return torch.zeros(n, dtype=w.dtype, device=w.device).index_add_(
        0, idx.long(), w)


def _summed(hist, mesh: Mesh | None):
    return hist if mesh is None else mesh.all_reduce(hist)


def pair_cost_weights(positions, masses, box_size, *, ncell: int = 0,
                      mesh: Mesh | None = None):
    """Per-particle pair-cost weights: the occupancy of each particle's
    cell on an ncell^3 counting grid (dead rows 0), so a region's summed
    weight ~ sum over cells of occ^2. ncell = 0 sizes it to ~4 particles a
    cell of the global N, clamped to [8, 64]. With `mesh`, the rows are a
    rank's and the counts are summed over the ranks."""
    n = positions.shape[0] * (1 if mesh is None else mesh.size)
    if ncell <= 0:
        ncell = int(min(64, max(8, round((n / 4.0) ** (1.0 / 3.0)))))
    live = masses > 0
    cell = torch.clamp((_div(positions, box_size) * ncell).to(torch.int32),
                       0, ncell - 1)
    cidx = (cell[:, 0] * ncell + cell[:, 1]) * ncell + cell[:, 2]
    occ = _summed(_segment_sum(live.to(torch.float32), cidx, ncell ** 3),
                  mesh)
    return torch.where(live, occ[cidx.long()], 0.0)


def adaptive_slab_bounds(positions, masses, n_dev: int, box_size, *,
                         resolution: int = 512, weights=None,
                         mesh: Mesh | None = None):
    """Equal-load slab bounds [n_dev + 1] (0 and box at the ends) from the
    x histogram of live counts, or of `weights` (pair_cost_weights). With
    `mesh`, the rows are a rank's and the histogram is summed over the
    ranks."""
    live = masses > 0
    w = live.to(torch.float32) if weights is None \
        else torch.where(live, weights, 0.0)
    xbin = torch.clamp((_div(positions[:, 0], box_size)
                        * resolution).to(torch.int32), 0, resolution - 1)
    hist = _summed(_segment_sum(w, xbin, resolution), mesh)
    cum = torch.cumsum(hist, 0)
    total = cum[-1]
    targets = _div(total * torch.arange(1, n_dev, device=cum.device),
                   n_dev)
    cuts = torch.searchsorted(cum, targets).to(torch.float32)
    inner = (cuts + 1.0) * (box_size / resolution)
    return torch.cat([cum.new_zeros(1), inner, cum.new_full((1,),
                                                            box_size)])


def adaptive_bounds_nd(positions, masses, dims: tuple, box_size, *,
                       resolution: int = 256, weights=None,
                       mesh: Mesh | None = None):
    """Hierarchical equal-load brick bounds for a (dx, dy, dz) block
    decomposition: x planes from the x marginal, then y planes in each x
    slab, then z planes in each (x, y) block, with linear interpolation
    inside the boundary bin. Returns (bx [dx+1], by [dx, dy+1], bz [dx,
    dy, dz+1]) for find_owner_3d. With `mesh`, the rows are a rank's and
    each histogram is summed over the ranks."""
    dx, dy, dz = dims
    live = masses > 0
    w = live.to(torch.float32) if weights is None \
        else torch.where(live, weights, 0.0)
    r = resolution
    step = box_size / r

    def axbin(a):
        return torch.clamp((_div(positions[:, a], box_size)
                            * r).to(torch.int32), 0, r - 1)

    def equal_cuts(hist, n_parts):
        cum = torch.cumsum(hist, -1)
        total = cum[..., -1:]
        targets = total * _div(torch.arange(
            1, n_parts, dtype=torch.float32, device=hist.device), n_parts)
        cnt = torch.sum(cum[..., None, :] < targets[..., :, None], dim=-1)
        cum_pad = torch.cat([hist.new_zeros(hist.shape[:-1] + (1,)), cum],
                            -1)
        before = torch.gather(cum_pad, -1, cnt)
        h = torch.gather(hist, -1, torch.clamp(cnt, max=r - 1))
        frac = torch.clamp((targets - before) / torch.clamp(h, min=1e-30),
                           0.0, 1.0)
        inner = (cnt.to(torch.float32) + frac) * step
        shape = hist.shape[:-1]
        return torch.cat([hist.new_zeros(shape + (1,)), inner,
                          hist.new_full(shape + (1,), box_size)], -1)

    xb, yb, zb = axbin(0), axbin(1), axbin(2)
    bx = equal_cuts(_summed(_segment_sum(w, xb, r), mesh), dx)
    ix = torch.clamp(torch.searchsorted(
        bx[1:-1].contiguous(), positions[:, 0].contiguous(),
        right=True).to(torch.int32), 0, dx - 1)
    hy = _summed(_segment_sum(w, ix * r + yb, dx * r), mesh).reshape(dx, r)
    by = equal_cuts(hy, dy)
    byr = by[ix.long()]
    iy = torch.clamp(torch.sum(positions[:, 1][:, None] >= byr[:, 1:-1],
                               dim=1).to(torch.int32), 0, dy - 1)
    hz = _summed(_segment_sum(w, (ix * dy + iy) * r + zb, dx * dy * r),
                 mesh).reshape(dx, dy, r)
    bz = equal_cuts(hz, dz)
    return bx, by, bz


def _owner_of(pos, mass, box_size, n_dev: int, bounds, my_id: int):
    """Owning rank of each row (x slabs); dead rows stay home."""
    owner = find_owner(pos, box_size, n_dev, bounds=bounds)
    return torch.where(mass > 0, owner, my_id)


def _scatter(n_slots: int, slot, vals):
    """A zero buffer of n_slots rows with vals written at slot, rows whose
    slot is n_slots dropped (jnp .at[slot].set(mode="drop"))."""
    buf = vals.new_zeros((n_slots + 1,) + vals.shape[1:])
    buf[slot.long()] = vals
    return buf[:n_slots]


def _rank_in_owner(sel, owner, n_dev: int):
    """For each row, its rank among the selected rows of the same owner
    (the cumsum of a one-hot), int32."""
    onehot = (sel[:, None] & (owner[:, None] == torch.arange(
        n_dev, device=owner.device)[None, :])).to(torch.int32)
    rank = torch.cumsum(onehot, 0, dtype=torch.int32) - 1
    return torch.gather(rank, 1, owner[:, None].long())[:, 0]


def migrate_particles(positions, velocities, masses, *, box_size,
                      capacity: int, mesh: Mesh, bounds=None):
    """Re-home this rank's rows to their owning x-slab ranks: every live
    row goes through the all_to_all (the self bucket included, so a
    homed set needs capacity >= n_loc). Returns (positions, velocities,
    masses, overflow_total) with the same shapes: the rank's rows then
    hold only particles it owns, zero-mass padding elsewhere;
    overflow_total (an int, the sum over ranks) counts particles that
    did not fit a bucket or the local rows."""
    n_dev, my_id = mesh.size, mesh.rank
    n_loc = positions.shape[0]
    live = masses > 0
    owner = _owner_of(positions, masses, box_size, n_dev, bounds, my_id)
    my_rank = _rank_in_owner(torch.ones_like(live), owner, n_dev)
    ok = my_rank < capacity
    slot = torch.where(ok, owner * capacity + my_rank, n_dev * capacity)
    nbuf = n_dev * capacity
    bpos = _scatter(nbuf, slot, positions)
    bvel = _scatter(nbuf, slot, velocities)
    bmass = _scatter(nbuf, slot, torch.where(ok, masses, 0.0))
    ovf = torch.sum(~ok & live)
    recv = mesh.all_to_all(torch.cat([bpos, bvel, bmass[:, None]], 1)
                           .reshape(n_dev, capacity, 7)).reshape(nbuf, 7)
    rpos, rvel, rmass = recv[:, :3], recv[:, 3:6], recv[:, 6]
    filled = rmass > 0
    order = torch.argsort((~filled).to(torch.int8), stable=True)
    take = order[:n_loc]
    keep = filled[take]
    out_pos = torch.where(keep[:, None], rpos[take], 0.0)
    out_vel = torch.where(keep[:, None], rvel[take], 0.0)
    out_mass = torch.where(keep, rmass[take], 0.0)
    recv_ovf = torch.clamp(torch.sum(filled) - n_loc, min=0)
    total = mesh.all_reduce((ovf + recv_ovf).reshape(1).to(torch.int64))
    return out_pos, out_vel, out_mass, int(total)


def migrate_particles_emigrant(positions, velocities, masses, *, box_size,
                               capacity: int, mesh: Mesh, bounds=None):
    """Emigrant-only migration: only rows whose owner changed enter the
    all_to_all, so `capacity` (the per-(source, destination) bucket) can
    be a few % of n_loc. Sent rows are cleared at the source and
    immigrants fill free (zero-mass) local rows in order.

    On ANY overflow (a send bucket full, or too few free rows for the
    arrivals) the result is invalid: the caller must discard the returned
    arrays and retry from its own with a larger capacity (the engine
    doubles it); applying an overflowed result would lose particles.
    Returns (positions, velocities, masses, overflow_total), the last an
    int summed over the ranks."""
    n_dev, my_id = mesh.size, mesh.rank
    nbuf = n_dev * capacity
    live = masses > 0
    owner = _owner_of(positions, masses, box_size, n_dev, bounds, my_id)
    emig = live & (owner != my_id)
    my_rank = _rank_in_owner(emig, owner, n_dev)
    ok = emig & (my_rank < capacity)
    slot = torch.where(ok, owner * capacity + my_rank, nbuf)
    send = torch.cat([torch.where(ok[:, None], positions, 0.0),
                      torch.where(ok[:, None], velocities, 0.0),
                      torch.where(ok, masses, 0.0)[:, None]], 1)
    send_ovf = torch.sum(emig & ~ok)
    recv = mesh.all_to_all(_scatter(nbuf, slot, send)
                           .reshape(n_dev, capacity, 7)).reshape(nbuf, 7)

    filled = recv[:, 6] > 0
    imm = recv[torch.argsort((~filled).to(torch.int8), stable=True)]
    n_imm = torch.sum(filled)

    keep_mass = torch.where(ok, 0.0, masses)
    free = keep_mass == 0
    free_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    idx = torch.clamp(free_rank, 0, nbuf - 1).long()
    valid = free & (free_rank < nbuf)
    cand_mass = torch.where(valid, imm[idx, 6], 0.0)
    place = free & (cand_mass > 0)
    out_mass = torch.where(free, cand_mass, masses)
    gone = (ok | ~live)[:, None]
    out_pos = torch.where(place[:, None], imm[idx, :3],
                          torch.where(gone, 0.0, positions))
    out_vel = torch.where(place[:, None], imm[idx, 3:6],
                          torch.where(gone, 0.0, velocities))
    recv_ovf = torch.clamp(n_imm - torch.sum(free), min=0)
    total = mesh.all_reduce((send_ovf + recv_ovf).reshape(1)
                            .to(torch.int64))
    return out_pos, out_vel, out_mass, int(total)


def load_imbalance(masses, *, mesh: Mesh, weights=None) -> float:
    """(max - min) / max over the ranks of the live count of each rank's
    rows, or of their summed `weights` (pair_cost_weights)."""
    w = torch.ones_like(masses) if weights is None else weights
    count = torch.sum(torch.where(masses > 0, w, 0.0)).reshape(1)
    cmax = mesh.all_reduce(count, "max")
    cmin = mesh.all_reduce(count, "min")
    return float((cmax - cmin) / torch.clamp(cmax, min=1.0))
