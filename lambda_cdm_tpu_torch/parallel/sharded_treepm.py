"""Multi-rank TreePM over the rank mesh: rank-local cell buckets and a
halo exchange of boundary cell planes (counterpart of
lambda_cdm_tpu/parallel/sharded_treepm.py).

  * The global cell lattice [nc, nc, nc] (cells >= r_cut) is split into
    blocks of nc / d cells along each sharded axis: x slabs of nc / D
    planes on the 1D mesh, (nc / dx, nc / dy, nc / dz) blocks on the 3D
    (shx, shy, shz) mesh (a (shx, shy) request is the (dx, dy, 1) grid).
    The plans (`sharded_treepm_plan`, `sharded_treepm_plan_3d`) are the
    JAX package's, None where the box is too small.
  * Each rank buckets ITS OWN rows (homed on uniform slabs or blocks by
    the migration) into its block, [nx, ny, nz, K] slots, live first in
    a stable order; rows that drifted past the block are clipped into
    its boundary cell (their true positions still enter the pair sum)
    and rows past a cell's capacity are overflow (PM force only, counted).
  * The block is extended by one cell plane on each side of each axis,
    the axes in order x, y, z: along a sharded axis by two shifts to the
    neighbours at coordinate +-1 (positions and masses in one tensor),
    along an axis the rank holds whole by the local periodic wrap (the
    JAX 1D pass's rolls). Shipping the planes received along earlier
    axes delivers edges and corners: faces, then edges, then corners, in
    six shifts on the 3D mesh (two on the 1D mesh).
  * The 27-offset stencil then takes pure slices of the extended block,
    the pair arithmetic of forces/treepm.short_range_bucketed, in batches
    of at most PAIR_SLOT_BUDGET pair slots. Slots past the fullest cell's
    count hold no particle in any cell (live-first packing), so the pair
    pass runs over that occupied depth (one host read a pass): the same
    pairs and sums as over the whole capacity.
  * The long range is parallel/sharded.sharded_pm_accelerations with the
    matching Gaussian split.

`ring_short_range_accelerations` is the exact S(r)-truncated pair sum as
a ring over the flattened rank order (O(N^2 / D) a rank): the fallback
where the 1D plan is None, and the oracle of the halo pass.

Each function takes this rank's rows and returns its rows (overflow
summed over the ranks), and is a collective: every rank calls it.
"""

from __future__ import annotations

import math

import torch

from .exchange import _div
from .mesh import Mesh


def _capacity(num_particles: int, nc: int, capacity: int,
              occupancy_headroom: float) -> int:
    if capacity > 0:
        cap = capacity
    else:
        mean_occ = num_particles / nc ** 3
        cap = int(max(16, math.ceil(occupancy_headroom * mean_occ)))
    return ((cap + 7) // 8) * 8


def sharded_treepm_plan(num_particles: int, box_size: float, pm_grid: int,
                        n_dev: int, *, split_factor: float = 1.25,
                        cut_factor: float = 4.5, capacity: int = 0,
                        occupancy_headroom: float = 3.0) -> dict | None:
    """Geometry of the 1D halo pass: {"rs", "r_cut", "nc", "capacity"}
    with nc the largest multiple of n_dev that keeps cells >= r_cut, or
    None when that leaves fewer than max(3, n_dev) cells (callers take the
    ring short range)."""
    rs = split_factor * box_size / pm_grid
    r_cut = cut_factor * rs
    nc_max = int(math.floor(box_size / r_cut))
    nc = (nc_max // n_dev) * n_dev
    if nc < max(3, n_dev):
        return None
    return {"rs": rs, "r_cut": r_cut, "nc": nc,
            "capacity": _capacity(num_particles, nc, capacity,
                                  occupancy_headroom)}


def sharded_treepm_plan_3d(num_particles: int, box_size: float,
                           pm_grid: int, dims: tuple, *,
                           split_factor: float = 1.25,
                           cut_factor: float = 4.5, capacity: int = 0,
                           occupancy_headroom: float = 3.0) -> dict | None:
    """Geometry of the 3D block halo pass: nc a multiple of every mesh dim
    (their lcm) with cells >= r_cut, or None when the box cannot hold one
    r_cut cell a rank along some axis."""
    rs = split_factor * box_size / pm_grid
    r_cut = cut_factor * rs
    nc_max = int(math.floor(box_size / r_cut))
    step = math.lcm(*dims)
    nc = (nc_max // step) * step
    if nc < max(3, *dims):
        return None
    return {"rs": rs, "r_cut": r_cut, "nc": nc,
            "capacity": _capacity(num_particles, nc, capacity,
                                  occupancy_headroom)}


def _bucket_local(pos, mass, nc: int, nloc: tuple, my_ids: tuple,
                  box_size, capacity: int):
    """This rank's rows into its [nx, ny, nz, K] cell block (the global
    cell of each axis rebased to the block and clipped into it).
    Returns (block [nx, ny, nz, K, 4]: positions and mass, zero-mass
    padding; pslot [n]: each row's flat slot, -1 for a dead or overflowed
    row; overflow, a 0-d count). The sort is stable, as jnp.argsort is, so
    the same rows overflow as in the JAX package."""
    n = pos.shape[0]
    ncells = math.prod(nloc)
    cell = torch.clamp(torch.floor(_div(pos, box_size) * nc)
                       .to(torch.int64), 0, nc - 1)
    loc = [torch.clamp(cell[:, a] - my_ids[a] * nloc[a], 0, nloc[a] - 1)
           for a in range(3)]
    cid = (loc[0] * nloc[1] + loc[1]) * nloc[2] + loc[2]
    live = mass > 0
    cid = torch.where(live, cid, ncells)

    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    live_s = live[order]
    idx = torch.arange(n, device=pos.device)
    is_start = torch.ones(n, dtype=torch.bool, device=pos.device)
    is_start[1:] = cid_s[1:] != cid_s[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    ok = (idx - run_start < capacity) & live_s
    nslots = ncells * capacity
    slot = torch.where(ok, cid_s * capacity + idx - run_start, nslots)

    rows = torch.cat([pos[order], torch.where(ok, mass[order], 0.0)[:, None]],
                     1)
    # slot nslots is the drop sentinel (sliced off)
    block = rows.new_zeros((nslots + 1, 4))
    block[slot] = rows
    pslot = torch.full((n,), -1, dtype=torch.int64, device=pos.device)
    pslot[order] = torch.where(ok, slot, -1)
    overflow = torch.sum(~ok & live_s)
    return (block[:nslots].reshape(*nloc, capacity, 4), pslot, overflow)


def _extend(block: torch.Tensor, mesh: Mesh, axes: tuple) -> torch.Tensor:
    """The block with one cell plane more on each side of dims 0-2, in
    that order: from the neighbours along axes[d] (a mesh axis name), or
    the local periodic wrap where axes[d] is None. Each dim ships the
    planes the earlier dims added, so edges and corners arrive too."""
    for d, axis in enumerate(axes):
        last = block.narrow(d, block.shape[d] - 1, 1)
        first = block.narrow(d, 0, 1)
        if axis is not None:
            # my last plane is my +1 neighbour's low halo
            last = mesh.shift(last, axis, 1)
            first = mesh.shift(first, axis, -1)
        block = torch.cat([last, block, first], d)
    return block


def _pair_accel(tgt, src, box_size, rs, soft2: float, s_fn):
    """S(r)-weighted min-image pair sums (unit G) -> [C, Kt, 3]: targets
    tgt [C, Kt, 3] against sources src [C, Ks, 4] (positions, mass) of the
    same index c, or one source set [1, Ks, 4] shared by every c; in
    batches of c of at most PAIR_SLOT_BUDGET pair slots."""
    from ..forces.direct import min_image
    from ..forces.treepm import PAIR_SLOT_BUDGET
    c, kt = tgt.shape[:2]
    ks = src.shape[1]
    step = max(1, PAIR_SLOT_BUDGET // max(kt * ks, 1))
    out = torch.empty_like(tgt)
    for c0 in range(0, c, step):
        t = tgt[c0:c0 + step]
        s = src if src.shape[0] == 1 else src[c0:c0 + step]
        dx = min_image(s[:, None, :, :3] - t[:, :, None, :], box_size)
        r2 = torch.sum(dx * dx, dim=-1) + soft2
        inv_r = torch.rsqrt(r2)
        w = (s[:, None, :, 3] * s_fn(r2 * inv_r, rs)
             * (inv_r * inv_r * inv_r))
        out[c0:c0 + step] = torch.sum(w[..., None] * dx, dim=2)
    return out


def _live_depth(block: torch.Tensor) -> int:
    """The most live slots of any cell of block [..., K, 4] (at least 1)."""
    return max(1, int(torch.sum(block[..., 3] > 0, dim=-1).max()))


def _halo_stencil_accel(block, ext, box_size, rs, softening,
                        use_poly: bool):
    """The 27-offset short range (unit G) of the block's slots [nx, ny, nz,
    K, 3] from its halo-extended block: each offset a pure slice of ext,
    over the occupied slot depth."""
    from ..forces.treepm import short_range_factor, short_range_factor_poly
    nx, ny, nz, k = block.shape[:4]
    s_fn = short_range_factor_poly if use_poly else short_range_factor
    kt, ks = _live_depth(block), _live_depth(ext)
    tgt = block[..., :kt, :3].reshape(-1, kt, 3)
    acc = torch.zeros_like(tgt)
    for ox in (0, 1, 2):
        for oy in (0, 1, 2):
            for oz in (0, 1, 2):
                nb = ext[ox:ox + nx, oy:oy + ny, oz:oz + nz, :ks]
                acc = acc + _pair_accel(tgt, nb.reshape(-1, ks, 4),
                                        box_size, rs, softening * softening,
                                        s_fn)
    out = block.new_zeros((nx, ny, nz, k, 3))
    out[..., :kt, :] = acc.reshape(nx, ny, nz, kt, 3)
    return out


def _halo(positions, masses, *, box_size, nc: int, capacity: int, rs,
          softening, use_poly: bool, mesh: Mesh, axes: tuple):
    """The halo pass with dims 0-2 sharded along axes (a mesh axis name or
    None each); returns (acc [n_loc, 3], overflow summed over ranks)."""
    dims = tuple(1 if a is None else mesh.shape[a] for a in axes)
    for a, d in zip(axes, dims):
        if nc % d:
            raise ValueError(f"nc={nc} not divisible by mesh axis {a}={d}")
    nloc = tuple(nc // d for d in dims)
    my_ids = tuple(0 if a is None else mesh.coord(a) for a in axes)
    block, pslot, ovf = _bucket_local(positions, masses, nc, nloc, my_ids,
                                      box_size, capacity)
    ext = _extend(block, mesh, axes)
    acc_b = _halo_stencil_accel(block, ext, box_size, rs, softening,
                                use_poly)
    flat = acc_b.reshape(-1, 3)
    acc = torch.where((pslot >= 0)[:, None], flat[torch.clamp(pslot, min=0)],
                      0.0)
    total = mesh.all_reduce(ovf.reshape(1).to(torch.int64))
    return acc, int(total)


def halo_short_range_accelerations(positions, masses, *, box_size,
                                   nc: int, capacity: int, rs, softening,
                                   use_poly: bool = False, mesh: Mesh):
    """Short-range accelerations [n_loc, 3] (no G factor) of this rank's
    rows, homed on uniform x slabs of the 1D mesh: the local cell
    buckets and the boundary-plane halo exchange. Returns (acc,
    overflow_total)."""
    if mesh.ndim != 1:
        raise ValueError("the slab halo pass runs on the 1D mesh; a 3D "
                         "mesh takes halo_short_range_accelerations_3d")
    return _halo(positions, masses, box_size=box_size, nc=nc,
                 capacity=capacity, rs=rs, softening=softening,
                 use_poly=use_poly, mesh=mesh,
                 axes=(mesh.axis_names[0], None, None))


def halo_short_range_accelerations_3d(positions, masses, *, box_size,
                                      nc: int, capacity: int, rs,
                                      softening, use_poly: bool = False,
                                      mesh: Mesh):
    """Short-range accelerations [n_loc, 3] (no G factor) of this rank's
    rows, homed on uniform blocks of the 3D mesh: local cell buckets and
    the dimension-ordered 26-neighbour halo exchange. Returns (acc,
    overflow_total)."""
    if mesh.ndim != 3:
        raise ValueError("the block halo pass runs on the 3D (shx, shy, "
                         "shz) mesh")
    return _halo(positions, masses, box_size=box_size, nc=nc,
                 capacity=capacity, rs=rs, softening=softening,
                 use_poly=use_poly, mesh=mesh, axes=mesh.axis_names)


def ring_short_range_accelerations(positions, masses, *, box_size, rs,
                                   softening, use_poly: bool = False,
                                   mesh: Mesh):
    """The exact S(r)-truncated pair sum (no G factor) on this rank's rows
    from every rank's, as a ring over the flattened rank order: the
    fallback where the box cannot hold a r_cut cell plane a rank, and
    the halo pass's oracle. Zero-mass rows pull nothing and get no
    force."""
    from ..forces.treepm import short_range_factor, short_range_factor_poly
    s_fn = short_range_factor_poly if use_poly else short_range_factor
    acc = torch.zeros_like(positions)
    block = torch.cat([positions, masses[:, None]], dim=1)
    for k in range(mesh.size):
        acc = acc + _pair_accel(positions[:, None, :], block[None], box_size,
                                rs, softening * softening, s_fn)[:, 0]
        if k + 1 < mesh.size:
            block = mesh.ring_shift(block)
    return torch.where((masses > 0)[:, None], acc, 0.0)


def sharded_treepm_accelerations(positions, masses, *, box_size,
                                 pm_grid: int, softening, g_const=1.0,
                                 split_factor: float = 1.25,
                                 cut_factor: float = 4.5,
                                 capacity: int = 0, use_poly: bool = False,
                                 occupancy_headroom: float = 3.0,
                                 mesh: Mesh,
                                 return_diagnostics: bool = False):
    """TreePM accelerations [n_loc, 3] of this rank's rows: the sharded PM
    with the split at rs plus G times the halo short range (1D slabs or 3D
    blocks, after the mesh), or on the 1D mesh the ring where the plan is
    None. The plan counts every rank's rows (the JAX package's global
    array). On the 3D mesh a None plan raises ValueError before the PM
    solve. With return_diagnostics, also {"overflow": int, "plan": dict
    or None}."""
    from .sharded import sharded_pm_accelerations
    if mesh.ndim not in (1, 3):
        raise ValueError(f"the sharded TreePM runs on a 1D or 3D mesh, not "
                         f"{mesh.shape}")
    is_3d = mesh.ndim == 3
    n_global = positions.shape[0] * mesh.size
    rs = split_factor * box_size / pm_grid
    kw = dict(split_factor=split_factor, cut_factor=cut_factor,
              capacity=capacity, occupancy_headroom=occupancy_headroom)
    if is_3d:
        plan = sharded_treepm_plan_3d(n_global, float(box_size), pm_grid,
                                      mesh.dims, **kw)
        if plan is None:
            raise ValueError(
                "box too small for one r_cut cell per device along every "
                "3D mesh axis; use a 1D slab mesh (ring fallback) instead")
    else:
        plan = sharded_treepm_plan(n_global, float(box_size), pm_grid,
                                   mesh.size, **kw)
    acc_long = sharded_pm_accelerations(positions, masses, pm_grid,
                                        box_size, g_const, split_scale=rs,
                                        mesh=mesh)
    if plan is None:
        acc_short = ring_short_range_accelerations(
            positions, masses, box_size=float(box_size), rs=float(rs),
            softening=float(softening), use_poly=use_poly, mesh=mesh)
        overflow = 0
    else:
        halo = (halo_short_range_accelerations_3d if is_3d
                else halo_short_range_accelerations)
        acc_short, overflow = halo(
            positions, masses, box_size=float(box_size), nc=plan["nc"],
            capacity=plan["capacity"], rs=float(plan["rs"]),
            softening=float(softening), use_poly=use_poly, mesh=mesh)
    acc = acc_long + g_const * acc_short
    if return_diagnostics:
        return acc, {"overflow": overflow, "plan": plan}
    return acc
