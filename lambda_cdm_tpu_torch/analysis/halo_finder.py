"""Friends-of-friends halo finder + spherical-overdensity catalogue in
PyTorch (counterpart of lambda_cdm_tpu/analysis/halo_finder.py).

FoF is iterative minimum-label propagation over the 27-cell stencil with
pointer jumping: particles are bucketed into cells of size >= b, and each
round hooks every live slot to the least label within b (K5,
ops/fof_hook) and compresses the particle labels; the host loops rounds
until nothing changes. The fixpoint labels every particle with its
component's least particle index, as in the JAX package.

The catalogue segment-reduces the groups (centre of mass on the unit
circle per axis, mean velocity, mass), ranks them by particle count and
measures SO radius, v_max and angular momentum from radial mass
histograms around each centre -- over all particles (exact) or over a
bucketed window of cells around the centre (windowed, for large N).
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from ..forces.direct import min_image
from ..forces.treepm import bucket_gather, bucket_src_map
from ..ops.fof_hook import fof_hook, fof_hook_plain

_log = logging.getLogger("lambda_cdm_tpu")

# fof_plan's K5 cost model: blocks of _BLOCK_ROWS live rows (K5's first
# design, one block a chunk of 64 rows; K5 now runs one warp a unit of
# 32, and the model is kept so that the plan does not move), and a
# block's visit to one neighbour cell (count read, two barriers, tile
# load) costs about as much as scanning _BLOCK_VISIT_SLOTS of its slots
_BLOCK_ROWS = 64
_BLOCK_VISIT_SLOTS = 8

# the rounds the last fof_labels call took, whether it converged, and the
# particles it found beyond the cell capacity (adopted by their cell)
last_fof = {"rounds": 0, "converged": True, "overflow": 0}


@dataclasses.dataclass
class HaloCatalog:
    """Fixed-capacity halo catalogue (top `max_halos` by particle count);
    slots beyond `num_halos` are zero. Fields as in the JAX package."""
    num_halos: torch.Tensor          # [] int32
    n_particles: torch.Tensor        # [H] int32
    center: torch.Tensor             # [H, 3] centre of mass
    velocity: torch.Tensor           # [H, 3] centre-of-mass velocity
    mass: torch.Tensor               # [H]
    radius: torch.Tensor             # [H] R_Delta (SO radius)
    v_max: torch.Tensor              # [H] max circular velocity
    angular_momentum: torch.Tensor   # [H, 3]
    spin: torch.Tensor               # [H] Bullock spin parameter
    particle_label: torch.Tensor     # [N] halo id per particle (-1 field)
    # live particles missing from the windowed profiles because a window
    # cell exceeded the capacity (0 on the exact path and whenever the
    # window came from catalog_window_plan on the same positions)
    profile_dropped: torch.Tensor


def _box(box_size, like) -> torch.Tensor:
    """box as a 0-d float32 tensor: dividing by a tensor is exact on every
    device (PyTorch's CUDA division by a Python scalar multiplies by the
    reciprocal), as XLA divides."""
    return torch.tensor(float(box_size), dtype=torch.float32,
                        device=like.device)


def _cell_ids(positions, box_size, ncell: int):
    """Clamped z-major cell id of every particle (int64)."""
    cell = torch.clamp(torch.floor(positions / _box(box_size, positions)
                                   * ncell).long(), 0, ncell - 1)
    return (cell[:, 0] * ncell + cell[:, 1]) * ncell + cell[:, 2]


# ---------------------------------------------------------------------------
# FoF via label propagation
# ---------------------------------------------------------------------------

def _fof_setup(positions, live, box_size, ncell: int, capacity: int):
    """Bucket the particles and build the slot <-> particle maps. Dead
    rows go to bucket_src_map's virtual overflow cell: never bucketed,
    never counted as overflow. Returns (bx, by, bz [C, K] each, occupied
    [C, K], counts [C] int32, pslot [N] int64 (-1: not bucketed),
    slot_particle [C*K] int64 (n: empty), overflow)."""
    n = positions.shape[0]
    ncells = ncell ** 3
    nslots = ncells * capacity
    masses = live.to(torch.float32)
    src, slot, order, ok, overflow = bucket_src_map(
        positions, masses, box_size, ncell=ncell, capacity=capacity)
    bxyz = tuple(bucket_gather(positions[:, c], src, 0.0)
                 .reshape(ncells, capacity) for c in range(3))
    occupied = bucket_gather(masses, src, 0.0).reshape(ncells,
                                                       capacity) > 0
    pslot = torch.full((n,), -1, dtype=torch.int64, device=positions.device)
    pslot[order] = torch.where(ok, slot, -1)
    # slot -> particle (one-to-one on occupied slots; index nslots is the
    # drop row for particles that were not bucketed)
    slot_particle = torch.full((nslots + 1,), n, dtype=torch.int64,
                               device=positions.device)
    slot_particle[torch.where(pslot >= 0, pslot, nslots)] = torch.arange(
        n, device=positions.device)
    counts = occupied.sum(dim=1).to(torch.int32)
    return (bxyz, occupied, counts, pslot, slot_particle[:nslots],
            overflow)


def _fof_compress(lab1, lab_prev):
    """Pointer jumping on the [N] particle labels (lab[i] <= i, so chains
    strictly descend). Seventeen jumps: the JAX package's loop stops at
    a fixpoint or after seventeen, and jumps past a fixpoint change
    nothing, so the result is the same without a readback per jump.
    Returns (compressed labels, changed-vs-lab_prev 0-d bool)."""
    lab = lab1
    for _ in range(17):
        lab = lab[lab]
    return lab, torch.any(lab != lab_prev)


def _active_next(lab2, lab_p, pslot, ncell: int, capacity: int):
    """int32 [C] mask of the cells to sweep next round: the 27-dilation
    of every cell whose labels changed this round."""
    ncells = ncell ** 3
    changed = ((lab2 != lab_p) & (pslot >= 0)).to(torch.int32)
    cell = torch.where(pslot >= 0, pslot // capacity, ncells)
    ch = torch.zeros(ncells + 1, dtype=torch.int32, device=lab2.device)
    ch.index_add_(0, cell, changed)
    ch3 = (ch[:ncells] > 0).reshape(ncell, ncell, ncell)
    for ax in range(3):
        ch3 = ch3 | torch.roll(ch3, 1, ax) | torch.roll(ch3, -1, ax)
    return ch3.reshape(-1).to(torch.int32)


def _fof_round(lab_p, bxyz, counts, pslot, *, box_size: float,
               linking_length: float, ncell: int, capacity: int, hook_fn,
               active):
    """One hook-and-compress round: particle labels -> slot lattice
    (empty slots carry n), one sweep of `hook_fn` over the active cells,
    back to particle space, root hooking, pointer jumping. Particles that
    were not bucketed (capacity overflow) keep their label here; they
    adopt their cell's anchor at the end. Returns (labels, changed?,
    active next).

    Root hooking: the particle a label names (every particle's label is a
    particle of its component) takes the least label hooked by any
    particle that carried it, so the jumps carry a label found anywhere
    in a tree to the whole tree within the round. A Jacobi sweep moves a
    label one link a round; without this, a chain whose particle order is
    random needs about as many rounds as it has links (the TPU's
    Gauss-Seidel sweep runs along the chain within one sweep). Labels
    only fall and stay within their components, so the fixpoint -- every
    label its component's least index -- is unchanged."""
    n = lab_p.shape[0]
    ncells = ncell ** 3
    nslots = ncells * capacity
    ok = pslot >= 0
    slot_lab = torch.full((nslots + 1,), n, dtype=torch.int32,
                          device=lab_p.device)
    slot_lab[torch.where(ok, pslot, nslots)] = lab_p.to(torch.int32)
    hooked = hook_fn(bxyz[0], bxyz[1], bxyz[2],
                     slot_lab[:nslots].reshape(ncells, capacity), counts,
                     active, ncell=ncell, capacity=capacity, n_sentinel=n,
                     box_size=box_size, linking_length=linking_length)
    hooked = hooked.reshape(-1)[pslot.clamp_min(0)].long()
    lab1 = torch.where(ok, torch.minimum(lab_p, hooked), lab_p)
    lab1 = lab1.scatter_reduce(0, lab_p, lab1, reduce="amin")
    lab2, changed = _fof_compress(lab1, lab_p)
    return lab2, changed, _active_next(lab2, lab_p, pslot, ncell, capacity)


def _fof_adopt_overflow(lab_p, pslot, slot_particle, live, positions,
                        box_size, *, ncell: int, capacity: int):
    """Capacity-overflow particles (cells denser than the capacity) join
    their own cell's group through the cell's slot-0 anchor particle: a
    cell that overflows a sane capacity is far above the linking density,
    so FoF would link its contents anyway. The approximation is counted
    (`overflow` of fof_labels). Dead rows keep their own label."""
    n = lab_p.shape[0]
    cid = _cell_ids(positions, box_size, ncell)
    anchor = slot_particle[cid * capacity].clamp_max(n - 1)
    return torch.where(pslot >= 0, lab_p,
                       torch.where(live, lab_p[anchor], lab_p))


def fof_labels(positions, box_size, linking_length, *, ncell: int,
               capacity: int, max_rounds: int = 64, live=None,
               hook: str = "auto"):
    """Connected components under the FoF relation |xi - xj| < b.

    Returns (label [N] int32 = least particle index of each group,
    overflow = particles beyond the cell capacity, adopted by their
    cell's group). `live` (bool [N], default all) excludes zero-mass
    padding rows: they come back as field singletons. `hook`: "auto" or
    "pallas" sweep with K5 (fof_hook: the CUDA kernel for CUDA tensors,
    its plain version for CPU tensors), "jnp" with the plain version on
    any device. The host loops rounds, one scalar readback each, until
    nothing changes."""
    if hook == "jnp":
        hook_fn = fof_hook_plain
    elif hook in ("auto", "pallas"):
        hook_fn = fof_hook
    else:
        raise ValueError(f"unknown hook {hook!r} (auto, jnp, pallas)")
    n = positions.shape[0]
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=positions.device)
    bxyz, _, counts, pslot, slot_particle, overflow = _fof_setup(
        positions, live, box_size, ncell, capacity)
    lab = torch.arange(n, device=positions.device)
    active = torch.ones(ncell ** 3, dtype=torch.int32,
                        device=positions.device)
    converged = False
    rounds = 0
    while rounds < max_rounds:
        lab, changed, active = _fof_round(
            lab, bxyz, counts, pslot, box_size=float(box_size),
            linking_length=float(linking_length), ncell=ncell,
            capacity=capacity, hook_fn=hook_fn, active=active)
        rounds += 1
        if not bool(changed):
            converged = True
            _log.info("fof: converged after %d rounds", rounds)
            break
    last_fof.update(rounds=rounds, converged=converged,
                    overflow=int(overflow))
    if not converged:
        _log.warning("fof: labels still changing after max_rounds=%d",
                     max_rounds)
    lab = _fof_adopt_overflow(lab, pslot, slot_particle, live, positions,
                              box_size, ncell=ncell, capacity=capacity)
    return lab.to(torch.int32), overflow


_FOF_CAPS = (16, 32, 64, 128, 256, 512, 1024)


def fof_plan(num_particles: int, box_size: float, linking_length: float,
             capacity: int = 0, positions=None,
             max_capacity: int = 1024,
             memory_budget_bytes: int = 2 << 30, live=None) -> dict:
    """Cell geometry {"ncell", "capacity"} for FoF (cells of size >= b).

    Picks the cheapest layout subject to (i) merged-cell overflow at the
    chosen capacity <= 0.1% of the particles and (ii) the [ncell^3,
    capacity] layout within `memory_budget_bytes` at 16 B a slot; falls
    back to the least overflow when no level qualifies. Occupancy for
    every level comes from one pass (counts at the finest power-of-two
    lattice, pooled 2x per level).

    The cost model follows the hook that will run. For CPU positions it
    is the JAX package's CPU one, 27 ncell^3 capacity^2 (the padded
    lattice), so the plan is exactly the JAX package's CPU plan. For
    CUDA positions it is K5's, which follows occupancy: per block of
    _BLOCK_ROWS live rows, the slots of its 27 neighbour cells plus a fixed
    cost per neighbour visit; capacity then sizes only memory, and ties
    go to the least overflow."""
    nmax = max(min(int(math.floor(box_size / linking_length)), 128), 1)
    nf = 1 << (nmax.bit_length() - 1)         # finest power-of-2 level
    if capacity > 0:
        return {"ncell": nf, "capacity": capacity}
    caps = tuple(c for c in _FOF_CAPS if c <= max_capacity) or (16,)

    def cap_from_budget(ncell):
        cap = 16
        for c in caps:
            if 16 * ncell ** 3 * c <= memory_budget_bytes:
                cap = c
        return cap

    if positions is None:
        # no occupancy information: finest lattice, generous headroom
        mean_occ = num_particles / max(nf ** 3, 1)
        cap = int(max(16, math.ceil(8.0 * mean_occ)))
        cap = min(((cap + 7) // 8) * 8, max_capacity, cap_from_budget(nf))
        return {"ncell": nf, "capacity": cap}

    if live is None:
        live = torch.ones(positions.shape[0], dtype=torch.bool,
                          device=positions.device)
    stats = _occupancy_pyramid(positions, live, box_size, nf, caps)
    kernel = positions.device.type == "cuda"
    n = num_particles
    best_ok = None
    best_any = None
    for lvl, ncell in enumerate(_pyramid_levels(nf)):
        max_occ, ovf_tab, sweep = stats[lvl]
        cap_occ = max(16, 1 << (max(max_occ, 1) - 1).bit_length())
        # every tabulated capacity <= the occupancy bound: a smaller
        # capacity that overflows a handful of core cells can win
        for cap in caps:
            if cap > cap_occ or cap > max_capacity:
                break
            if 16 * ncell ** 3 * cap > memory_budget_bytes:
                continue                      # too fine for the budget
            ovf = 0 if cap >= max_occ else ovf_tab[caps.index(cap)]
            work = (sweep, ovf) if kernel else 27 * ncell ** 3 * cap * cap
            if ovf <= max(1, n // 1000):
                if best_ok is None or work < best_ok[0]:
                    best_ok = (work, ncell, cap)
            if best_any is None or (ovf, work) < best_any[:2]:
                best_any = (ovf, work, ncell, cap)
    if best_ok is not None:
        _, ncell, capacity = best_ok
    else:
        _, _, ncell, capacity = best_any
    return {"ncell": ncell, "capacity": capacity}


def _pyramid_levels(nf: int):
    levels = []
    ncell = nf
    while ncell >= 1:
        levels.append(ncell)
        if ncell == 1:
            break
        ncell //= 2
    return levels


def _occupancy_pyramid(positions, live, box_size, nf: int, caps: tuple):
    """Per level ncell = nf, nf/2, ..., 1: (max cell occupancy,
    [particles beyond cap summed over cells, for cap in caps], K5 sweep
    work in slot visits). Dead rows are dropped."""
    cid = torch.where(live, _cell_ids(positions, box_size, nf), nf ** 3)
    counts = torch.bincount(cid, minlength=nf ** 3 + 1)[:nf ** 3] \
        .reshape(nf, nf, nf)
    out = []
    for ncell in _pyramid_levels(nf):
        if ncell != nf:
            counts = counts.reshape(ncell, 2, ncell, 2, ncell, 2) \
                .sum(dim=(1, 3, 5))
        ovf = torch.stack([torch.clamp(counts - c, min=0).sum()
                           for c in caps])
        # slots of the 27 neighbour cells (aliases counted as often as
        # the kernel visits them on lattices of one or two cells)
        nbr = counts
        for ax in range(3):
            nbr = nbr + torch.roll(nbr, 1, ax) + torch.roll(nbr, -1, ax)
        blocks = (counts + _BLOCK_ROWS - 1) // _BLOCK_ROWS
        sweep = torch.sum(blocks * (nbr + 27 * _BLOCK_VISIT_SLOTS))
        out.append((int(counts.max()), ovf.tolist(), int(sweep)))
    return out


# ---------------------------------------------------------------------------
# Halo catalogue
# ---------------------------------------------------------------------------

def _window_occupancy(pos, lv, box):
    """Pooled live-cell occupancy maxima at nc = 32/16/8 (one pass)."""
    cid = torch.where(lv, _cell_ids(pos, box, 32), 32 ** 3)
    c32 = torch.bincount(cid, minlength=32 ** 3 + 1)[:32 ** 3] \
        .reshape(32, 32, 32)
    c16 = c32.reshape(16, 2, 16, 2, 16, 2).sum(dim=(1, 3, 5))
    c8 = c16.reshape(8, 2, 8, 2, 8, 2).sum(dim=(1, 3, 5))
    return int(c32.max()), int(c16.max()), int(c8.max())


def catalog_window_plan(positions, box_size, *, live=None, r_max=None,
                        mem_budget_mb: int = 768):
    """Plan for catalog_from_labels' windowed profiles: (ncell,
    capacity, pad) or None (exact scan). Capacity is the actual max
    occupancy (nothing is dropped), memory-bounded, and the smallest
    per-halo window work wins."""
    box = float(box_size)
    if r_max is None:
        r_max = 0.1 * box
    n = positions.shape[0]
    lv = torch.ones(n, dtype=torch.bool, device=positions.device) \
        if live is None else live
    m32, m16, m8 = _window_occupancy(positions, lv, box)
    best = None
    for nc, mx in ((32, m32), (16, m16), (8, m8)):
        pad = int(math.ceil(r_max * nc / box))
        if 2 * pad + 1 > nc:
            # window wider than the box: wrapped copies would double count
            continue
        cap = max(128, -(-(mx + 1) // 128) * 128)
        mem = 8 * (nc + 2 * pad) ** 3 * cap * 4
        if mem > mem_budget_mb * 1024 * 1024:
            continue
        work = (2 * pad + 1) ** 3 * cap
        if work >= n:           # no cheaper than the exact scan
            continue
        if best is None or work < best[0]:
            best = (work, nc, cap, pad)
    return None if best is None else (best[1], best[2], best[3])


def _chunks(total: int, per_item: int, budget: int = 1 << 22):
    """Ranges of items so that each chunk holds about `budget` elements."""
    step = max(1, budget // max(per_item, 1))
    return [(i, min(i + step, total)) for i in range(0, total, step)]


def _profile_tail(hist, d, rel_v, w_mass, member, *, edges, thr, g_const):
    """Batched over halos: (radial mass hist [H, B], offsets [H, M, 3],
    relative velocities [H, M, 3], masses [M] or [H, M], member mask
    [H, M]) -> (r_delta, m_delta, v_max, L [H, 3])."""
    nbins = edges.shape[0]
    m_enc = torch.cumsum(hist, dim=1)
    vol = 4.0 / 3.0 * math.pi * edges ** 3
    dens = m_enc / vol
    # largest radius with enclosed density >= Delta * rho_bar ...
    above = dens >= thr
    ar = torch.arange(nbins, device=hist.device)
    j = torch.max(torch.where(above, ar, -1), dim=1).values
    has = j >= 0
    jsafe = torch.clamp(j, 0, nbins - 1)
    # ... then the crossing inside the bracketing bin: enclosed mass
    # linear in x = r^3 across the bin gives a closed form
    nxt = torch.clamp(jsafe + 1, max=nbins - 1)
    x0 = edges[jsafe] ** 3
    x1 = edges[nxt] ** 3
    m0 = m_enc.gather(1, jsafe[:, None])[:, 0]
    m1 = m_enc.gather(1, nxt[:, None])[:, 0]
    s = (m1 - m0) / torch.clamp(x1 - x0, min=1e-30)
    c = 4.0 / 3.0 * math.pi * thr
    denom = torch.where(torch.abs(c - s) > 1e-30, c - s, 1e-30)
    x = torch.minimum(torch.maximum((m0 - s * x0) / denom, x0), x1)
    interior = has & (j < nbins - 1)
    r_delta = torch.where(interior, x.clamp_min(0).pow(1.0 / 3.0),
                          torch.where(has, edges[jsafe], 0.0))
    m_delta = torch.where(interior, c * x, torch.where(has, m0, 0.0))
    v_circ2 = g_const * m_enc / torch.clamp(edges, min=1e-8)
    inside = edges[None, :] <= torch.clamp(r_delta, min=edges[0])[:, None]
    v_max = torch.sqrt(torch.max(torch.where(inside, v_circ2, 0.0),
                                 dim=1).values)
    ell = torch.cross(d, rel_v, dim=-1) * w_mass[..., None]
    ell = torch.sum(torch.where(member[..., None], ell, 0.0), dim=1)
    return r_delta, m_delta, v_max, ell


def catalog_from_labels(positions, velocities, masses, labels, box_size,
                        *, max_halos: int = 256, min_particles: int = 20,
                        overdensity: float = 200.0, mean_density=None,
                        g_const: float = 43.0071057317063,
                        window: tuple | None = None):
    """Segment-reduce particle groups into a HaloCatalog.

    `window` = (ncell, capacity, pad) from catalog_window_plan switches
    the per-halo SO/vmax/L profiles from the exact O(N*H) scan to
    bucketed windows of (2*pad+1)^3 cells around each centre (pad*cell
    >= r_max, so every particle within r_max is seen; FoF members beyond
    r_max add to the angular momentum only on the exact path).

    Group sums are segment sums (index_add_ in float64 by group), never
    differences of a global float32 prefix sum, whose rounding grows
    with the prefix (several percent on small halos at 10M particles).
    Halos are ranked by particle count with a stable sort, so among
    equal counts the group that sorts first by label comes first, as
    lax.top_k orders them."""
    n = positions.shape[0]
    dev = positions.device
    box_t = _box(box_size, positions)
    box = float(box_size)
    labels = labels.long()
    order = torch.argsort(labels, stable=True)
    lab_s = labels[order]
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = lab_s[1:] != lab_s[:-1]
    group = torch.cumsum(is_start.long(), 0) - 1        # [N] run index
    size = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, group, torch.ones_like(group))
    counts_row = size[group]

    # periodic-safe centre of mass: average unit-circle phases per axis
    m_s = masses[order]
    theta_s = positions[order] / box_t * (2.0 * math.pi)
    chan = torch.cat([m_s[:, None], m_s[:, None] * torch.cos(theta_s),
                      m_s[:, None] * torch.sin(theta_s),
                      m_s[:, None] * velocities[order]], dim=1)  # [N, 10]
    sums = torch.zeros((n, 10), dtype=torch.float64, device=dev)
    sums.index_add_(0, group, chan.double())

    # rank halos by particle count (one candidate per group: its start)
    score = torch.where(is_start & (counts_row >= min_particles),
                        counts_row, 0)
    k = min(max_halos, n)
    sel = torch.sort(score, descending=True, stable=True).indices[:k]
    top_counts = score[sel]
    if k < max_halos:
        pad = torch.zeros(max_halos - k, dtype=torch.int64, device=dev)
        top_counts = torch.cat([top_counts, pad])
        sel = torch.cat([sel, pad])
    valid = top_counts >= min_particles
    num_halos = valid.sum().to(torch.int32)

    sel_safe = torch.where(valid, sel, 0)
    top_roots = lab_s[sel_safe]
    run_sum = sums[group[sel_safe]].to(torch.float32)
    msum_h, cx_h, sx_h, vsum_h = (run_sum[:, 0], run_sum[:, 1:4],
                                  run_sum[:, 4:7], run_sum[:, 7:10])
    ang = torch.atan2(sx_h, cx_h)
    h_com = torch.where(valid[:, None], torch.remainder(
        ang / (2.0 * math.pi), 1.0) * box_t, 0.0)
    h_mass = torch.where(valid, msum_h, 0.0)
    h_vel = torch.where(valid[:, None], vsum_h / torch.clamp(
        msum_h[:, None], min=1e-30), 0.0)

    # per-particle halo id; invalid slots write the dump index n
    halo_of_root = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    halo_of_root[torch.where(valid, top_roots, n)] = torch.arange(
        max_halos, device=dev)
    halo_of_root[n] = -1
    plabel = halo_of_root[labels.clamp_max(n)]

    nbins = 64
    if mean_density is None:
        mean_density = torch.sum(masses) / box_t ** 3
    thr = overdensity * torch.as_tensor(mean_density, dtype=torch.float32,
                                        device=dev)
    r_max = torch.tensor(0.1, dtype=torch.float32, device=dev) * box_t
    edges = torch.tensor(np.linspace(0.0, 0.1 * box, nbins + 1)[1:],
                         dtype=torch.float32, device=dev)
    tail = dict(edges=edges, thr=thr, g_const=g_const)

    def hist_of(r, w):
        bin_idx = torch.clamp((r / r_max * nbins).to(torch.int64), 0,
                              nbins - 1)
        return torch.zeros((r.shape[0], nbins), dtype=torch.float32,
                           device=dev).scatter_add_(1, bin_idx, w)

    parts = []
    if window is None:
        prof_dropped = torch.zeros((), dtype=torch.int32, device=dev)
        for h0, h1 in _chunks(max_halos, 3 * n):
            hid = torch.arange(h0, h1, device=dev)
            d = min_image(positions[None] - h_com[h0:h1, None], box_t)
            r = torch.sqrt(torch.sum(d * d, dim=-1))
            w = torch.where(r < r_max, masses[None], 0.0)
            parts.append(_profile_tail(
                hist_of(r, w), d, velocities[None] - h_vel[h0:h1, None],
                masses, plabel[None] == hid[:, None], **tail))
    else:
        nc_w, cap_w, p_w = window
        w_sz = 2 * p_w + 1
        cell_w = box_t / nc_w
        src, _, _, _, prof_dropped = bucket_src_map(
            positions, torch.where(masses > 0, 1.0, 0.0).to(positions.dtype),
            box_size, ncell=nc_w, capacity=cap_w)

        def bucketed(x, fill=0.0):
            return bucket_gather(x, src, fill).reshape(nc_w, nc_w, nc_w,
                                                       cap_w)

        wrap = torch.remainder(torch.arange(nc_w + 2 * p_w, device=dev)
                               - p_w, nc_w)

        def padded(x):
            return x[..., wrap, :, :, :][..., wrap, :, :][..., wrap, :]

        fc = padded(torch.stack(
            [bucketed(positions[:, 0]), bucketed(positions[:, 1]),
             bucketed(positions[:, 2]), bucketed(masses),
             bucketed(velocities[:, 0]), bucketed(velocities[:, 1]),
             bucketed(velocities[:, 2])]))       # [7, nc+2p, .., .., cap]
        pl_pad = padded(bucketed(plabel, -1))
        off = torch.arange(w_sz, device=dev)
        for h0, h1 in _chunks(max_halos, 8 * w_sz ** 3 * cap_w):
            hid = torch.arange(h0, h1, device=dev)
            center = h_com[h0:h1]
            base = torch.clamp(torch.floor(center / cell_w).long(), 0,
                               nc_w - 1)
            ix = (base[:, 0, None] + off)[:, :, None, None]
            iy = (base[:, 1, None] + off)[:, None, :, None]
            iz = (base[:, 2, None] + off)[:, None, None, :]
            hc = h1 - h0
            win = fc[:, ix, iy, iz, :].reshape(7, hc, -1)
            pl_w = pl_pad[ix, iy, iz, :].reshape(hc, -1)
            wpos = torch.stack([win[0], win[1], win[2]], dim=-1)
            w_mass = win[3]
            d = min_image(wpos - center[:, None], box_t)
            r = torch.sqrt(torch.sum(d * d, dim=-1))
            live_w = w_mass > 0
            w = torch.where(live_w & (r < r_max), w_mass, 0.0)
            rel_v = (torch.stack([win[4], win[5], win[6]], dim=-1)
                     - h_vel[h0:h1, None])
            parts.append(_profile_tail(
                hist_of(r, w), d, rel_v, w_mass,
                (pl_w == hid[:, None]) & live_w, **tail))
    r_delta, m_delta, v_max, ell = (torch.cat(p) for p in zip(*parts))
    r_delta = torch.where(valid, r_delta, 0.0)
    v_max = torch.where(valid, v_max, 0.0)
    ell = torch.where(valid[:, None], ell, 0.0)

    # Bullock spin lambda' = L / (sqrt(2) M V_delta R_delta)
    v_delta = torch.sqrt(g_const * torch.clamp(m_delta, min=1e-30)
                         / torch.clamp(r_delta, min=1e-8))
    l_mag = torch.sqrt(torch.sum(ell * ell, dim=-1))
    spin = torch.where(
        valid & (r_delta > 0),
        l_mag / (math.sqrt(2.0) * torch.clamp(h_mass, min=1e-30)
                 * v_delta * torch.clamp(r_delta, min=1e-8)),
        0.0)

    return HaloCatalog(
        num_halos=num_halos,
        n_particles=torch.where(valid, top_counts, 0).to(torch.int32),
        center=h_com, velocity=h_vel, mass=h_mass,
        radius=r_delta, v_max=v_max,
        angular_momentum=ell, spin=spin,
        particle_label=plabel.to(torch.int32),
        profile_dropped=torch.as_tensor(prof_dropped).to(torch.int32))


def count_groups(labels, min_particles: int = 20):
    """Number of FoF groups with >= min_particles members (0-d tensor)."""
    _, size = torch.unique_consecutive(torch.sort(labels).values,
                                       return_counts=True)
    return torch.sum(size >= min_particles)


def find_halos(positions, velocities, masses, box_size, *,
               linking_length_factor: float = 0.2,
               min_particles: int = 20, max_halos: int | None = None,
               overdensity: float = 200.0,
               g_const: float = 43.0071057317063,
               n_slabs: int = 0, plan: dict | None = None,
               hook: str = "auto",
               windowed: bool | None = None) -> HaloCatalog:
    """One-call FoF + SO catalogue: b = factor x mean separation;
    `n_slabs > 1` labels through fof_labels_slabwise; `max_halos=None`
    auto-sizes the catalogue from the exact qualifying-group count
    (a power of two >= 256); `windowed` (default: N >= 200k) takes the
    windowed profile path with a window planned on these positions."""
    n = positions.shape[0]
    b = linking_length_factor * box_size / n ** (1.0 / 3.0)
    live = masses > 0
    if plan is None:
        plan = fof_plan(n, float(box_size), float(b), positions=positions,
                        live=live)
    if n_slabs > 1:
        labels, overflow = fof_labels_slabwise(
            positions, box_size, b, n_slabs=n_slabs, ncell=plan["ncell"],
            capacity=plan["capacity"], live=live, hook=hook)
    else:
        labels, overflow = fof_labels(
            positions, box_size, b, ncell=plan["ncell"],
            capacity=plan["capacity"], live=live, hook=hook)
    _log.info("find_halos: labels done (overflow=%d); counting groups",
              int(overflow))
    n_groups = int(count_groups(labels, min_particles=min_particles))
    _log.info("find_halos: %d groups >= %d particles; building catalog",
              n_groups, min_particles)
    if max_halos is None:
        max_halos = max(256, 1 << max(n_groups - 1, 0).bit_length())
    elif n_groups > max_halos:
        _log.warning(
            "halo catalog: %d groups have >= %d particles but "
            "max_halos=%d -- the catalog keeps only the %d most massive "
            "(pass max_halos=None to auto-size)",
            n_groups, min_particles, max_halos, max_halos)
    if windowed is None:
        windowed = n >= 200_000
    window = (catalog_window_plan(positions, box_size, live=live)
              if windowed else None)
    cat = catalog_from_labels(
        positions, velocities, masses, labels, box_size,
        max_halos=max_halos, min_particles=min_particles,
        overdensity=overdensity, g_const=g_const, window=window)
    if int(cat.profile_dropped) > 0:
        _log.warning(
            "halo catalog: %d particles exceeded the profile window "
            "capacity and are missing from SO/vmax/L profiles",
            int(cat.profile_dropped))
    return cat


def mass_function(catalog: HaloCatalog, box_size, num_bins: int = 16,
                  m_min=None, m_max=None):
    """dn/dlog10(M) [(Mpc/h)^-3] from the catalogue -> (bin centres,
    dn/dlog10 M, counts)."""
    m = catalog.mass
    valid = m > 0

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=m.device)

    m_min = (torch.min(torch.where(valid, m, math.inf)) if m_min is None
             else f32(m_min))
    m_max = torch.max(m) if m_max is None else f32(m_max)
    lo, hi = torch.log10(m_min), torch.log10(m_max * (1 + 1e-6))
    edges = lo + (hi - lo) * (torch.arange(num_bins + 1, device=m.device)
                              / num_bins)
    idx = torch.clamp(((torch.log10(torch.clamp(m, min=1e-30)) - lo)
                       / (hi - lo) * num_bins).to(torch.int64), 0,
                      num_bins - 1)
    counts = torch.zeros(num_bins, dtype=torch.float32,
                         device=m.device).index_add_(0, idx, valid.float())
    dlog = (hi - lo) / num_bins
    centers = 10.0 ** (0.5 * (edges[1:] + edges[:-1]))
    volume = box_size ** 3
    return centers, counts / (volume * dlog), counts


def fof_labels_slabwise(positions, box_size, linking_length, *,
                        n_slabs: int, ncell: int, capacity: int,
                        live=None, max_rounds: int = 64,
                        hook: str = "auto"):
    """FoF across slab boundaries: the box is cut into `n_slabs`
    x-slabs, each labelled with fof_labels on its own particles plus a
    ghost layer of width b from both periodic neighbours (every FoF edge
    lies inside at least one subset), and the subsets' components are
    stitched on the host by min-label propagation over (particle, subset
    root) edges. Labels equal the global fof_labels'. Returns (labels
    [N] int32, overflow summed over slabs, an upper bound: ghosts can
    count twice; 0 when no slab overflowed)."""
    n = positions.shape[0]
    dev = positions.device
    pos_np = positions.detach().cpu().numpy()
    live_np = (np.ones(n, bool) if live is None
               else live.detach().cpu().numpy())
    x = pos_np[:, 0]
    width = box_size / n_slabs
    if width <= linking_length:
        raise ValueError(
            f"slab width {width:.3g} <= linking length {linking_length}"
            f" -- reduce n_slabs (ghost layers would overlap)")
    slab_of = np.minimum((x / width).astype(np.int64), n_slabs - 1)

    def in_ghost(s):
        lo, hi = s * width, (s + 1) * width
        dlo = (x - lo) % box_size            # distance "below" lo
        dhi = (hi - x) % box_size
        return ((dlo > box_size - linking_length)
                | (dhi > box_size - linking_length))

    sels = [np.nonzero(((slab_of == s) | in_ghost(s)) & live_np)[0]
            for s in range(n_slabs)]
    pad_n = max(max(int(i.size) for i in sels), 1)

    g_arr, r_arr = [], []
    overflow_total = 0
    for gids in sels:
        k = gids.size
        sub_pos = np.zeros((pad_n, 3), pos_np.dtype)
        sub_pos[:k] = pos_np[gids]
        sub_live = np.zeros((pad_n,), bool)
        sub_live[:k] = True
        lab_s, ovf = fof_labels(
            torch.from_numpy(sub_pos).to(dev), box_size, linking_length,
            ncell=ncell, capacity=capacity,
            live=torch.from_numpy(sub_live).to(dev), max_rounds=max_rounds,
            hook=hook)
        lab_s = lab_s.cpu().numpy()[:k]
        overflow_total += int(ovf)
        g_arr.append(gids)
        r_arr.append(gids[lab_s])            # subset root -> global id
    g_all = np.concatenate(g_arr)
    r_all = np.concatenate(r_arr)

    # host stitch: min-label propagation over star edges + pointer jumps
    lab = np.arange(n, dtype=np.int64)
    for _ in range(64):
        before = lab.copy()
        np.minimum.at(lab, g_all, lab[r_all])
        np.minimum.at(lab, r_all, lab[g_all])
        for _ in range(4):
            lab = lab[lab]
        if np.array_equal(lab, before):
            break
    lab = np.where(live_np, lab, np.arange(n))
    return (torch.from_numpy(lab.astype(np.int32)).to(dev),
            torch.tensor(overflow_total, dtype=torch.int32, device=dev))
