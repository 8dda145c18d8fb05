"""The sharded persistent cell-list TreePM stepper on the 2D (shx, shy)
rank grid (counterpart of lambda_cdm_tpu/parallel/fast_mesh2d.py): the
fast stepper's buckets stay resident and sharded between steps as
(cx, cy) rods of cells with z whole on each rank, z-pencils of the PM
grid.

Cell ids are BLOCK-MAJOR,

    cell = (((bx dy + by) nxl + lx) nyl + ly) nc + cz

(bx, by the rank's block, lx, ly the cell within it), so an equal split
of the C cells over the flattened (shx, shy) ranks is the rod
decomposition: rank r (index bx dy + by) holds the JAX package's global
rows r Cl ... (r + 1) Cl. `cell_order2d` / `cell_order2d_inv` convert
to and from the x-major order of ops/fast_treepm; anything that hands a
gathered state to a single-device function permutes it back first.

The force is parallel/fast_mesh's, on the geometry (shx, shy, None):

  * short range: the rank's [nxl, nyl, nc, K] block extended by one cell
    plane each way in x, then y (the y phase ships the x halos, so the
    corners come too), z by the local periodic wrap; the 27-offset
    stencil of slices with the polynomial split, over the occupied depth;
  * long range: each live slot's 8 CIC corners scatter-added into the
    (x, y) ghost-extended z-pencil (the window periodic on every dim),
    the x spills to the x neighbours, then the y spills of the x-merged
    pencil to the y neighbours (corners ride the y phase); the pencil
    FFT (parallel/fft.pencil_rfftn, two all_to_all transposes) solves
    Poisson with ops/bucketed_pm._greens; the fd4 halos of the potential
    come in two phases; the fields are gathered at the 8 corners;
  * every `rebucket_every` steps: the emigrants hop to their x neighbour,
    then the merged rows to their y neighbour (diagonal movers hop
    twice), each hop one capacity-bounded shift each way, then a local
    rebucket; lost emigrants, strays and overflow are counted.

The JAX module builds its deposit and gather from one-hot matrix
products over per-cell windows (`_fold_open`, `_extract_open`,
`_origins2d`), unwraps the halo planes' coordinates across the seam
(`_unwrap_axis`) and names its ppermute rings (`_ring`, `_halo_extend`);
here the same sums are scatter-adds and gathers on the ghost-extended
pencil, the pair pass takes the minimum image of every difference, and
`Mesh.shift` moves the planes. Each function is a collective: every
rank of the mesh calls it with its own slots.
"""

from __future__ import annotations

import math

import torch

from ..ops.fast_treepm import FastState
from .fast_mesh import (_bucket_rows, _cells, _fast_accel, _geometry,
                        _initialize, _pack, _plan_search, _rows, _run)
from .fft import pencil_block, pencil_irfftn, pencil_rfftn
from .mesh import X_AXIS, Y_AXIS, Mesh, axis_size

AXES = (X_AXIS, Y_AXIS, None)


def mesh_fast_plan2d(num_particles: int, box_size: float, pm_grid: int,
                     dxy: tuple, **kw) -> dict | None:
    """Static geometry of the pencil stepper: fast_mesh._plan_search with
    ncell a multiple of both mesh axes (their lcm) and pm_grid divisible
    by both (the pencil FFT). None where the box cannot hold it; `kw` as
    fast_mesh.mesh_fast_plan's."""
    dx, dy = dxy
    if pm_grid % dx or pm_grid % dy:
        return None
    return _plan_search(num_particles, box_size, pm_grid, math.lcm(dx, dy),
                        {"dx": dx, "dy": dy}, **kw)


def cell_order2d(ncell: int, dx: int, dy: int, device="cpu"):
    """Permutation p with p[block-major id] = x-major id: index x-major
    cells with p to get the block-major layout."""
    nxl, nyl, nc = ncell // dx, ncell // dy, ncell
    bm = torch.arange(ncell ** 3, device=device)
    cz = bm % nc
    ly = (bm // nc) % nyl
    lx = (bm // (nc * nyl)) % nxl
    by = (bm // (nc * nyl * nxl)) % dy
    bx = bm // (nc * nyl * nxl * dy)
    return ((bx * nxl + lx) * nc + by * nyl + ly) * nc + cz


def cell_order2d_inv(ncell: int, dx: int, dy: int, device="cpu"):
    """The inverse permutation: q with q[x-major id] = block-major id."""
    return torch.argsort(cell_order2d(ncell, dx, dy, device))


def _poisson_pencil(pencil, green, *, ng: int, mesh: Mesh, ax_x=X_AXIS,
                    ax_y=Y_AXIS):
    """The potential of this rank's z-pencil [ng/dx, ng/dy, ng] of the
    density: the pencil FFT, the whole Green's function green [ng, ng,
    ng//2+1] padded to the pencil layout and sliced to the rank's block,
    the inverse. `ax_x` / `ax_y` name the mesh axes splitting the
    pencil's x and y; either may be a tuple of axes, first-major (the 3D
    block stepper runs ax_y = (shy, shz))."""
    axes = (ax_x, ax_y)
    gk = pencil_rfftn(pencil, mesh=mesh, axes=axes)
    zp = axis_size(mesh, ax_y) * gk.shape[2]
    gpad = torch.nn.functional.pad(green, (0, zp - green.shape[2]))
    return pencil_irfftn(gk * pencil_block(gpad, mesh, axes), ng=ng,
                         mesh=mesh, axes=axes)


def mesh_fast_accel2d(bpos, bmass, *, mesh: Mesh, box_size, ng: int,
                      ncell: int, capacity: int, margin: int, rs, softening,
                      g_const):
    """TreePM accelerations of the rank's block-major slots, SoA bpos [3,
    Cl, K] and bmass [Cl, K] -> (acc [3, Cl, K]: G times the long plus the
    short range, 0 on zero-mass slots; dropped deposits summed over the
    ranks, 0-d int32)."""
    from ..ops.bucketed_pm import _greens
    geo = _geometry(mesh, AXES, ncell, ng, margin)

    def poisson(rho):
        return _poisson_pencil(rho, _greens(ng, float(box_size), float(rs),
                                            str(rho.device)), ng=ng,
                               mesh=mesh)

    return _fast_accel(bpos, bmass, poisson, geo=geo, mesh=mesh,
                       box_size=box_size, ng=ng, ncell=ncell,
                       capacity=capacity, margin=margin, rs=rs,
                       softening=softening, g_const=g_const)


def _hop(rows, ids, delta, *, mesh: Mesh, axis: str, mig: int):
    """One emigrant hop along `axis` for rows flagged by delta (0 stays, 1
    goes to the +1 neighbour, n - 1 to the -1 one; anything else is a
    stray): each direction packed into `mig` rows and shifted (the
    up-goers first, as the JAX package's), the movers' masses zeroed at
    home. Returns (own rows, then the rows from the -1 neighbour, then
    from the +1 one; their ids; the rows lost: past mig, or strays)."""
    n_dev = mesh.shape[axis]
    mass = rows[:, 9]
    live = mass > 0
    up = live & (delta == 1) & (n_dev > 1)
    down = live & (delta == n_dev - 1) & ~up & (n_dev > 1)
    strays = torch.sum(live & (delta != 0) & ~up & ~down)
    ubuf, uids, lost_u = _pack(rows, ids, up, mig)
    dbuf, dids, lost_d = _pack(rows, ids, down, mig)
    from_below = mesh.shift(ubuf, axis, 1)
    from_below_ids = mesh.shift(uids, axis, 1)
    from_above = mesh.shift(dbuf, axis, -1)
    from_above_ids = mesh.shift(dids, axis, -1)
    stay = torch.where(live & (delta == 0), mass, 0.0)
    rows = torch.cat([torch.cat([rows[:, :9], stay[:, None]], 1),
                      from_below, from_above])
    ids = torch.cat([ids, from_below_ids, from_above_ids])
    return rows, ids, lost_u + lost_d + strays


def _rebucket_blocks(bpos, bvel, bmass, bids, bacc, *, mesh: Mesh, axes,
                     box_size, ncell: int, capacity: int, mig: int):
    """The block steppers' rebucket: one hop along each split dim of
    `axes` in order (x, y[, z]; a later hop moves the earlier hops'
    arrivals too), then the rank's rows into its [Cl, K] buckets.
    Returns (bpos, bvel, bmass, ids, acc of the new slots; the rows lost,
    summed over the ranks)."""
    nc = ncell
    dims = [1 if a is None else mesh.shape[a] for a in axes]
    nloc = [nc // d for d in dims]
    me = [0 if a is None else mesh.coord(a) for a in axes]
    rows = _rows(bpos, bvel, bmass, bacc)
    ids = bids.reshape(-1)
    lost = torch.zeros((), dtype=torch.int64, device=rows.device)
    for d, axis in enumerate(axes):
        if axis is None:
            continue
        block = _cells(rows[:, :3], box_size, nc)[:, d] // nloc[d]
        rows, ids, hop_lost = _hop(
            rows, ids, torch.remainder(block - me[d], dims[d]), mesh=mesh,
            axis=axis, mig=mig)
        lost = lost + hop_lost
    cell = _cells(rows[:, :3], box_size, nc)
    local = [cell[:, d] - me[d] * nloc[d] for d in range(3)]
    in_blk = torch.ones_like(rows[:, 9], dtype=torch.bool)
    for d in range(3):
        in_blk &= (local[d] >= 0) & (local[d] < nloc[d])
    live = rows[:, 9] > 0
    cl = math.prod(nloc)
    cid = torch.where(live & in_blk,
                      (local[0] * nloc[1] + local[1]) * nloc[2] + local[2],
                      cl)
    strays = torch.sum(live & ~in_blk)
    *slots, overflow = _bucket_rows(rows, ids, cid, cl, capacity)
    total = mesh.all_reduce((overflow + lost + strays).reshape(1))
    return (*slots, total[0])


def mesh_rebucket2d(bpos, bvel, bmass, bids, bacc, *, mesh: Mesh, box_size,
                    ncell: int, capacity: int, mig_capacity: int = 0):
    """Re-bucket the rank's block-major slots: emigrants hop to their x
    neighbour, then to their y neighbour (diagonal movers take both),
    each hop at most `mig_capacity` rows each way (default max(256,
    max(nxl, nyl) nc K / 4): movers lie within a cell plane of a block
    face). Returns (bpos, bvel, bmass, ids, acc of the rank's new slots;
    the rows lost summed over the ranks: bucket overflow, emigrants past
    the capacity, strays). The sort is stable and the rows are the JAX
    package's (own, then from -1, then from +1, each hop), so every slot
    is JAX's."""
    nxl = ncell // mesh.shape[X_AXIS]
    nyl = ncell // mesh.shape[Y_AXIS]
    mig = mig_capacity if mig_capacity > 0 else \
        max(256, (max(nxl, nyl) * ncell * capacity) // 4)
    return _rebucket_blocks(bpos, bvel, bmass, bids, bacc, mesh=mesh,
                            axes=AXES, box_size=box_size, ncell=ncell,
                            capacity=capacity, mig=mig)


def initialize_mesh_fast2d(positions, velocities, masses, scale_factor, *,
                           mesh: Mesh, **kw):
    """Plan, bucket (every rank the same global rows [N, 3], [N]; it keeps
    its block-major cell range) and prime the accelerations. Returns (the
    rank's FastState, the kwargs of mesh_fast_run2d); `kw` as
    fast_mesh._initialize's (plan_override and ids included)."""
    dx, dy = mesh.shape[X_AXIS], mesh.shape[Y_AXIS]
    r = mesh.axis_index((X_AXIS, Y_AXIS))

    def cells(nc):
        cl = nc ** 3 // (dx * dy)
        return cell_order2d(nc, dx, dy)[r * cl:(r + 1) * cl]

    return _initialize(
        positions, velocities, masses, scale_factor, mesh=mesh,
        plan_fn=lambda n, box, ng, **o: mesh_fast_plan2d(n, box, ng,
                                                         (dx, dy), **o),
        cells_fn=cells, accel=mesh_fast_accel2d, **kw)


def mesh_fast_run2d(fstate: FastState, params, dt, *, mesh: Mesh,
                    **kw) -> FastState:
    """Advance the pencil stepper: fast_mesh._run with the two-phase
    rebucket (mesh_rebucket2d) between segments; positions wrap at every
    step; `kw` as mesh_fast_run's (initialize_mesh_fast2d's dict)."""
    return _run(fstate, params, dt, mesh=mesh, accel=mesh_fast_accel2d,
                rebucket=mesh_rebucket2d, **kw)
