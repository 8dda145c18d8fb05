"""The sharded persistent cell-list TreePM stepper on the 3D (shx, shy,
shz) rank grid (counterpart of lambda_cdm_tpu/parallel/fast_mesh3d.py):
the fast stepper's buckets stay resident and sharded between steps as
blocks of cells, the last step of the decomposition ladder (slabs in
parallel/fast_mesh, z-pencil rods in parallel/fast_mesh2d).

Cell ids are BLOCK-MAJOR over all three axes,

    cell = (((((bx dy + by) dz + bz) nxl + lx) nyl + ly) nzl + lz)

so an equal split of the C cells over the flattened (shx, shy, shz)
ranks is the block decomposition: rank r (index (bx dy + by) dz + bz)
holds the JAX package's global rows r Cl ... (r + 1) Cl.
`cell_order3d` / `cell_order3d_inv` convert to and from the x-major
order of ops/fast_treepm.

The force is parallel/fast_mesh's on the geometry (shx, shy, shz):

  * short range: the rank's [nxl, nyl, nzl, K] block extended by one
    cell plane each way along x, y, then z (a later phase ships the
    earlier phases' halos: faces, edges, corners), every one of the 27
    offsets a slice;
  * long range: the CIC corners scatter-added into the ghost-extended
    [ng/dx, ng/dy, ng/dz] cube, whose spills go to the x, then the y,
    then the z neighbours (a later phase carries the earlier phases'
    edges and corners); Poisson by one all_to_all over shz that turns the
    cube into a z-pencil [ng/dx, ng/(dy dz), ng] whose y splits over the
    combined (shy, shz) axis (global y = iy yl + iz yl / dz + local,
    first-major, as the tuple-axis collectives order their ranks), the
    pencil solve of fast_mesh2d, and the inverse all_to_all; the fd4
    halos in three phases and the gather at the 8 corners;
  * every `rebucket_every` steps: emigrant hops along x, y, then z
    (corner movers hop up to three times), then a local rebucket.

Each function is a collective: every rank calls it with its own slots.
"""

from __future__ import annotations

import math

import torch

from ..ops.fast_treepm import FastState
from .fast_mesh import _fast_accel, _geometry, _initialize, _plan_search, \
    _run
from .fast_mesh2d import _poisson_pencil, _rebucket_blocks
from .mesh import AXES_3D, X_AXIS, Y_AXIS, Z_AXIS, Mesh


def mesh_fast_plan3d(num_particles: int, box_size: float, pm_grid: int,
                     dxyz: tuple, **kw) -> dict | None:
    """Static geometry of the block stepper: fast_mesh._plan_search with
    ncell a multiple of every mesh axis (their lcm) and pm_grid divisible
    by dx and by dy dz (the cube -> pencil exchange). None where the box
    cannot hold it; `kw` as fast_mesh.mesh_fast_plan's."""
    dx, dy, dz = dxyz
    if pm_grid % dx or pm_grid % (dy * dz):
        return None
    return _plan_search(num_particles, box_size, pm_grid,
                        math.lcm(dx, dy, dz), {"dx": dx, "dy": dy, "dz": dz},
                        **kw)


def cell_order3d(ncell: int, dx: int, dy: int, dz: int, device="cpu"):
    """Permutation p with p[block-major id] = x-major id."""
    nxl, nyl, nzl = ncell // dx, ncell // dy, ncell // dz
    bm = torch.arange(ncell ** 3, device=device)
    lz = bm % nzl
    ly = (bm // nzl) % nyl
    lx = (bm // (nzl * nyl)) % nxl
    bz = (bm // (nzl * nyl * nxl)) % dz
    by = (bm // (nzl * nyl * nxl * dz)) % dy
    bx = bm // (nzl * nyl * nxl * dz * dy)
    return (((bx * nxl + lx) * ncell + by * nyl + ly) * ncell
            + bz * nzl + lz)


def cell_order3d_inv(ncell: int, dx: int, dy: int, dz: int, device="cpu"):
    """The inverse permutation: q with q[x-major id] = block-major id."""
    return torch.argsort(cell_order3d(ncell, dx, dy, dz, device))


def _poisson_block(cube, green, *, ng: int, mesh: Mesh):
    """The potential of this rank's density cube [ng/dx, ng/dy, ng/dz]:
    one all_to_all over shz trades y chunks for z blocks (the cube becomes
    a z-pencil [ng/dx, ng/(dy dz), ng], its y split over (shy, shz)), the
    pencil solve with ax_y = (shy, shz), then the inverse all_to_all."""
    dz = mesh.shape[Z_AXIS]
    xl, yl, zl = cube.shape
    yc = yl // dz
    # y-chunk c -> the rank at z index c; the z blocks arrive in z order
    rec = mesh.all_to_all(cube.reshape(xl, dz, yc, zl).movedim(1, 0)
                          .contiguous(), Z_AXIS)
    pencil = rec.permute(1, 2, 0, 3).reshape(xl, yc, dz * zl)
    phi = _poisson_pencil(pencil, green, ng=ng, mesh=mesh, ax_x=X_AXIS,
                          ax_y=(Y_AXIS, Z_AXIS))
    # z-block c -> the rank at z index c; the y chunks arrive in y order
    rec = mesh.all_to_all(phi.reshape(xl, yc, dz, zl).permute(2, 0, 1, 3)
                          .contiguous(), Z_AXIS)
    return rec.movedim(0, 1).reshape(xl, dz * yc, zl)


def mesh_fast_accel3d(bpos, bmass, *, mesh: Mesh, box_size, ng: int,
                      ncell: int, capacity: int, margin: int, rs, softening,
                      g_const):
    """TreePM accelerations of the rank's block-major slots, SoA bpos [3,
    Cl, K] and bmass [Cl, K] -> (acc [3, Cl, K]: G times the long plus the
    short range, 0 on zero-mass slots; dropped deposits summed over the
    ranks, 0-d int32)."""
    from ..ops.bucketed_pm import _greens
    geo = _geometry(mesh, AXES_3D, ncell, ng, margin)
    if ng % (mesh.shape[Y_AXIS] * mesh.shape[Z_AXIS]):
        raise ValueError(f"the cube -> pencil exchange needs the PM grid "
                         f"({ng}) divisible by dy dz")

    def poisson(rho):
        return _poisson_block(rho, _greens(ng, float(box_size), float(rs),
                                           str(rho.device)), ng=ng,
                              mesh=mesh)

    return _fast_accel(bpos, bmass, poisson, geo=geo, mesh=mesh,
                       box_size=box_size, ng=ng, ncell=ncell,
                       capacity=capacity, margin=margin, rs=rs,
                       softening=softening, g_const=g_const)


def mesh_rebucket3d(bpos, bvel, bmass, bids, bacc, *, mesh: Mesh, box_size,
                    ncell: int, capacity: int, mig_capacity: int = 0):
    """Re-bucket the rank's block-major slots: emigrants hop along x, then
    y, then z (each hop at most `mig_capacity` rows each way; default the
    JAX package's max(256, face nc / max(nxl, nyl, nzl) K / 4), face the
    largest block face in cells). Returns (bpos, bvel, bmass, ids, acc of
    the rank's new slots; the rows lost summed over the ranks), every slot
    JAX's."""
    nxl, nyl, nzl = (ncell // mesh.shape[a] for a in AXES_3D)
    face = max(nyl * nzl, nxl * nzl, nxl * nyl)
    mig = mig_capacity if mig_capacity > 0 else \
        max(256, (face * ncell // max(nxl, nyl, nzl) * capacity) // 4)
    return _rebucket_blocks(bpos, bvel, bmass, bids, bacc, mesh=mesh,
                            axes=AXES_3D, box_size=box_size, ncell=ncell,
                            capacity=capacity, mig=mig)


def initialize_mesh_fast3d(positions, velocities, masses, scale_factor, *,
                           mesh: Mesh, **kw):
    """Plan, bucket (every rank the same global rows; it keeps its
    block-major cell range) and prime the accelerations. Returns (the
    rank's FastState, the kwargs of mesh_fast_run3d); `kw` as
    fast_mesh._initialize's."""
    dims = tuple(mesh.shape[a] for a in AXES_3D)
    r = mesh.axis_index(AXES_3D)

    def cells(nc):
        cl = nc ** 3 // math.prod(dims)
        return cell_order3d(nc, *dims)[r * cl:(r + 1) * cl]

    return _initialize(
        positions, velocities, masses, scale_factor, mesh=mesh,
        plan_fn=lambda n, box, ng, **o: mesh_fast_plan3d(n, box, ng, dims,
                                                         **o),
        cells_fn=cells, accel=mesh_fast_accel3d, **kw)


def mesh_fast_run3d(fstate: FastState, params, dt, *, mesh: Mesh,
                    **kw) -> FastState:
    """Advance the block stepper: fast_mesh._run with the three-phase
    rebucket (mesh_rebucket3d) between segments; `kw` as
    mesh_fast_run's (initialize_mesh_fast3d's dict)."""
    return _run(fstate, params, dt, mesh=mesh, accel=mesh_fast_accel3d,
                rebucket=mesh_rebucket3d, **kw)
