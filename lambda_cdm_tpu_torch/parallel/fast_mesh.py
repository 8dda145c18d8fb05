"""The sharded persistent cell-list TreePM stepper on the 1D slab mesh
(counterpart of lambda_cdm_tpu/parallel/fast_mesh.py): the fast
stepper's state stays bucketed and sharded between steps.

  * Each rank holds a FastState (ops/fast_treepm) over its contiguous
    range of cells: cell ids are x-major, ((cx nc) + cy) nc + cz, so an
    equal split of the C cells is an x-slab of nc / D cell planes a rank.
    Slots are SoA [3, Cl, K] vectors and [Cl, K] masses and ids,
    live first; `scale_factor`, `time` and `step` are the same host
    tensors on every rank, `overflow` and `dropped` the totals over the
    ranks (every rank holds them, so every rank takes the same
    decisions).
  * Short range: the rank's slots as a [nx_l, nc, nc, K, 4] block,
    extended by one cell plane each way in x (two shifts) and by the
    local periodic wrap in y and z (parallel/sharded_treepm._extend),
    then the 27-offset stencil with the polynomial split
    (short_range_factor_poly) over the occupied slot depth, in batches of
    forces/treepm.PAIR_SLOT_BUDGET pair slots.
  * Long range: each live slot's 8 CIC corners (the deposit drop rule of
    ops/pm_rods._cic_corners, its window periodic) scatter-added into a ghost-extended slab
    [ghost + ng/D + ghost, ng, ng] (ghost = margin + 1, y and z wrapped
    mod ng); the two spill slabs go to the x neighbours by one shift each
    and are added into their edge planes (the seam is periodic). The
    slab FFT (parallel/fft) solves Poisson with ops/bucketed_pm._greens
    (the CIC deconvolution and the Gaussian split at rs). The potential
    gets an fd4 halo of ghost + 2 planes each way (one shift each way):
    x derivatives are slices of the extended slab, y and z rolls; the
    three fields are gathered at the 8 corners (a dropped or dead slot
    gathers 0).
  * Every `rebucket_every` steps: a local rebucket plus a
    capacity-bounded emigrant exchange with the +-x neighbours. Drift
    between rebuckets is bounded by the deposit margin, less than a cell
    plane, so only adjacent slabs receive particles; lost emigrants,
    farther strays and bucket overflow are counted, never lost silently.

The JAX package builds its deposit and gather from one-hot matrix
products (a TPU workaround for scatters); the functions are the same
here, written as scatter-adds and gathers. They take the rank's block
geometry (`_geometry`: the mesh axis splitting each grid dim, or None
where the rank holds it whole), and the pencil and block steppers
(parallel/fast_mesh2d, fast_mesh3d) run the same force, segment and run
loop on their own geometries. Each function is a collective: every rank
of the mesh calls it with its own slots.
"""

from __future__ import annotations

import math

import torch

from ..ops.fast_treepm import BucketOverflowError, FastState, \
    build_fast_state
from ..ops.pm_rods import _inv_12h, _mesh_scale
from ..physics.integrators import (drift_factor, kick_factor,
                                   update_scale_factor, wrap_positions)
from .exchange import _div
from .fft import distributed_irfftn, distributed_rfftn, ky_slab
from .mesh import SHARD_AXIS, Mesh
from .sharded_treepm import _extend, _halo_stencil_accel

# the keys of initialize_mesh_fast's dict that mesh_fast_accel takes
ACCEL_KEYS = ("box_size", "ng", "ncell", "capacity", "margin", "rs",
              "softening", "g_const")


def _plan_search(num_particles: int, box_size: float, pm_grid: int,
                 step: int, extra: dict, *, split_factor: float = 1.25,
                 cut_factor: float = 4.5, capacity: int = 0,
                 margin: int = 1,
                 occupancy_headroom: float = 1.75) -> dict | None:
    """The JAX package's plan rule, shared by the three steppers: ncell a
    multiple of `step` (whole cells a rank along every split axis) that
    divides pm_grid, at least 3, with cells >= r_cut, the cheapest by
    ncell^3 27 K^2; K the headroom times the mean occupancy rounded up to
    128 slots (at least 128), or `capacity` rounded up. The plan dict,
    `extra` (the mesh's shape) joined; None where no ncell fits."""
    rs = split_factor * box_size / pm_grid
    r_cut = cut_factor * rs

    def cap_for(nc):
        if capacity > 0:
            return ((capacity + 127) // 128) * 128
        mean_occ = num_particles / max(nc ** 3, 1)
        c = int(math.ceil(occupancy_headroom * mean_occ))
        return max(128, ((c + 127) // 128) * 128)

    best = None
    for d in range(step, pm_grid + 1, step):
        if pm_grid % d == 0 and box_size / d >= r_cut and d >= 3:
            cap = cap_for(d)
            cost = d ** 3 * 27 * cap * cap
            if best is None or cost < best[0]:
                best = (cost, d, cap)
    if best is None:
        return None
    _, ncell, cap = best
    return {"rs": rs, "r_cut": r_cut, "ncell": ncell, "capacity": cap,
            "margin": margin, **extra}


def mesh_fast_plan(num_particles: int, box_size: float, pm_grid: int,
                   n_dev: int, **kw) -> dict | None:
    """Static geometry of the slab stepper: `_plan_search` with ncell a
    multiple of n_dev (whole cell planes a rank) and pm_grid divisible by
    n_dev. None where the box cannot hold it (callers take the stateless
    sharded TreePM). `kw`: split_factor, cut_factor, capacity, margin,
    occupancy_headroom."""
    if pm_grid % n_dev:
        return None
    return _plan_search(num_particles, box_size, pm_grid, n_dev,
                        {"n_dev": n_dev}, **kw)


def _geometry(mesh: Mesh, axes: tuple, ncell: int, ng: int,
              margin: int) -> dict:
    """The rank's block of cells and of the PM grid: per grid dim the
    mesh axis that splits it (`axes`, None where the rank holds the dim
    whole), its cells `nloc`, its first cell `c0`, its PM planes `ngl`,
    the extended array's length `ext` (ghost planes each side on a split
    dim, ng on a whole one); PM cells a bucket cell `ppc`, `ghost`."""
    dims = tuple(1 if a is None else mesh.shape[a] for a in axes)
    for d in dims:
        if ncell % d or ng % d or ng % ncell:
            raise ValueError(f"the fast mesh needs ncell ({ncell}) and the "
                             f"PM grid ({ng}) divisible by the ranks "
                             f"{dims} of each axis and the PM grid by "
                             f"ncell")
    ghost = margin + 1
    nloc = tuple(ncell // d for d in dims)
    ngl = tuple(ng // d for d in dims)
    for a, n in zip(axes, ngl):
        if a is not None and n < ghost + 2:
            raise ValueError(f"a PM block of {n} planes along {a} is "
                             f"thinner than the {ghost + 2} planes the fd4 "
                             f"halo ships")
    return {"axes": tuple(axes), "nloc": nloc,
            "c0": tuple(0 if a is None else mesh.coord(a) * n
                        for a, n in zip(axes, nloc)),
            "ngl": ngl, "ppc": ng // ncell, "ghost": ghost,
            "ext": tuple(ng if a is None else n + 2 * ghost
                         for a, n in zip(axes, ngl))}


def _corners(bpos, bmass, *, geo: dict, ncell: int, ng: int, box_size,
             margin: int):
    """The CIC corners of the rank's slots: (lower corners [3, Cl, K]
    int64, on a split dim a row of the ghost-extended block, on a whole
    dim global; fractions [3, Cl, K]; use [Cl, K]: live slots inside the
    drop rule's window; dropped, the live slots outside it). The window is
    pm_rods._cic_corners's, offset by the rank's first cell and periodic
    on every dim: positions wrap at every step, so a slot that crossed the
    box's seam since its rebucket keeps its window (the JAX package's
    window is not periodic and drops it, as it would not the same slot
    unwrapped)."""
    ppc = geo["ppc"]
    ell = ppc + 2 * (margin + 1)
    u = bpos * _mesh_scale(ng, box_size)
    f0 = torch.floor(u - 0.5)
    frac = (u - 0.5) - f0
    i0 = f0.to(torch.int64)
    c = torch.arange(bmass.shape[0], device=bpos.device)
    _, ny, nz = geo["nloc"]
    loc = torch.stack([c // (ny * nz), (c // nz) % ny, c % nz])
    cell = loc + torch.tensor(geo["c0"], device=bpos.device)[:, None]
    il = torch.remainder(i0 - (cell * ppc - (margin + 1))[:, :, None], ng)
    ok = torch.all(il <= ell - 2, dim=0)
    live = bmass > 0
    use = live & ok
    dropped = torch.sum(live & ~ok)
    # on a split dim, the window's row plus the cell's first row, its
    # local cell times ppc
    idx = torch.stack([i0[a] if axis is None
                       else torch.where(use, il[a] + loc[a][:, None] * ppc, 0)
                       for a, axis in enumerate(geo["axes"])])
    return idx, frac, use, dropped


def _corner_index(i0, dx, dy, dz, *, geo: dict, ng: int):
    """Flat index of one corner into the extended [ext] block (a whole
    dim wrapped mod ng)."""
    ix, iy, iz = (torch.remainder(i + d, ng) if axis is None else i + d
                  for i, d, axis in zip(i0, (dx, dy, dz), geo["axes"]))
    _, ey, ez = geo["ext"]
    return ((ix * ey + iy) * ez + iz).reshape(-1)


def _weights(frac, dx, dy, dz):
    wx = frac[0] if dx else 1.0 - frac[0]
    wy = frac[1] if dy else 1.0 - frac[1]
    wz = frac[2] if dz else 1.0 - frac[2]
    return wx, wy, wz


def _deposit(i0, frac, w, *, geo: dict, ng: int, mesh: Mesh):
    """The rank's density block [ngl] (mass a PM cell): the corners
    scatter-added into the ghost-extended block, then along each split dim
    in order its two spill planes go to the neighbours and are added into
    their edge planes (the JAX fold's phases: a later dim's spills carry
    the earlier dims' edges and corners; the seam is periodic)."""
    ghost = geo["ghost"]
    ext = torch.zeros(math.prod(geo["ext"]), dtype=torch.float32,
                      device=w.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wx, wy, wz = _weights(frac, dx, dy, dz)
                ext.index_add_(0, _corner_index(i0, dx, dy, dz, geo=geo,
                                                ng=ng),
                               ((wx * wy) * (wz * w)).reshape(-1))
    ext = ext.reshape(geo["ext"])
    for d, axis in enumerate(geo["axes"]):
        if axis is None:
            continue
        n = geo["ngl"][d]
        block = ext.narrow(d, ghost, n).clone()
        # my low spill belongs to my -1 neighbour's tail, my high spill to
        # my +1 neighbour's head (the JAX order: tail first)
        block.narrow(d, n - ghost, ghost).add_(
            mesh.shift(ext.narrow(d, 0, ghost), axis, -1))
        block.narrow(d, 0, ghost).add_(
            mesh.shift(ext.narrow(d, ghost + n, ghost), axis, 1))
        ext = block
    return ext


def _gather_fd4(phi, i0, frac, use, *, geo: dict, ng: int, box_size,
                mesh: Mesh):
    """-(fd4 gradient of the potential block) CIC-gathered at the rank's
    slots -> [3, Cl, K] (0 where `use` is False): along each split dim in
    order one shift each way brings ghost + 2 planes (a later dim ships
    the earlier dims' halos); a derivative along a split dim is a slice,
    along a whole dim a roll."""
    h4 = geo["ghost"] + 2
    split = [axis is not None for axis in geo["axes"]]
    ext = phi
    for d, axis in enumerate(geo["axes"]):
        if axis is not None:
            n = ext.shape[d]
            ext = torch.cat([mesh.shift(ext.narrow(d, n - h4, h4), axis, 1),
                             ext,
                             mesh.shift(ext.narrow(d, 0, h4), axis, -1)], d)
    inv_12h = _inv_12h(ng, box_size)

    def trim(f, keep):
        # the rows of the deposit's block on every split dim but `keep`
        for d in range(3):
            if split[d] and d != keep:
                f = f.narrow(d, 2, f.shape[d] - 4)
        return f

    fields = []
    for d in range(3):
        f = trim(ext, d)
        if split[d]:
            n = f.shape[d]
            grad = (8.0 * (f.narrow(d, 3, n - 4) - f.narrow(d, 1, n - 4))
                    - (f.narrow(d, 4, n - 4) - f.narrow(d, 0, n - 4)))
        else:
            grad = (8.0 * (torch.roll(f, -1, d) - torch.roll(f, 1, d))
                    - (torch.roll(f, -2, d) - torch.roll(f, 2, d)))
        fields.append(-grad * inv_12h)
    flat = torch.stack(fields).reshape(3, -1)
    mask = use.to(torch.float32)
    acc = torch.zeros_like(frac)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wx, wy, wz = _weights(frac, dx, dy, dz)
                vals = flat[:, _corner_index(i0, dx, dy, dz, geo=geo, ng=ng)]
                acc = acc + vals.reshape(frac.shape) * ((wx * wy)
                                                        * (wz * mask))
    return acc


def _short_range(bpos, bmass, *, geo: dict, box_size, rs, softening,
                 mesh: Mesh):
    """The 27-cell short range (unit G) of the rank's slots -> [3, Cl, K]:
    the block extended by one cell plane each side of each dim
    (sharded_treepm._extend: from the neighbours along a split dim, the
    local periodic wrap along a whole one), then the stencil of slices.
    The JAX package shifts the coordinates of halo planes that crossed the
    periodic seam by one box before its minimum-image differences; the
    pair pass here takes the minimum image of every difference, which
    gives the same pairs."""
    k = bmass.shape[1]
    block = torch.cat([bpos.permute(1, 2, 0), bmass[..., None]], -1)
    block = block.reshape(*geo["nloc"], k, 4)
    ext = _extend(block, mesh, geo["axes"])
    acc = _halo_stencil_accel(block, ext, box_size, rs, softening,
                              use_poly=True)
    return acc.reshape(-1, k, 3).permute(2, 0, 1)


def _fast_accel(bpos, bmass, poisson, *, geo: dict, mesh: Mesh, box_size,
                ng: int, ncell: int, capacity: int, margin: int, rs,
                softening, g_const):
    """TreePM accelerations of the rank's slots on the geometry `geo`:
    (acc [3, Cl, K], dropped summed over the ranks, 0-d int32).
    `poisson(rho)` turns the rank's density block (mass a unit volume)
    into its block of the potential."""
    cl = math.prod(geo["nloc"])
    if bpos.shape != (3, cl, capacity) or bmass.shape != (cl, capacity):
        raise ValueError(f"the rank's slots must be [3, {cl}, {capacity}] "
                         f"and [{cl}, {capacity}], got "
                         f"{tuple(bpos.shape)}, {tuple(bmass.shape)}")
    i0, frac, use, dropped = _corners(bpos, bmass, geo=geo, ncell=ncell,
                                      ng=ng, box_size=box_size,
                                      margin=margin)
    rho = _deposit(i0, frac, torch.where(use, bmass, 0.0), geo=geo, ng=ng,
                   mesh=mesh)
    phi = poisson(rho / (box_size / ng) ** 3)
    acc_long = _gather_fd4(phi, i0, frac, use, geo=geo, ng=ng,
                           box_size=box_size, mesh=mesh)
    acc_short = _short_range(bpos, bmass, geo=geo, box_size=float(box_size),
                             rs=float(rs), softening=float(softening),
                             mesh=mesh)
    acc = torch.where((bmass > 0)[None], g_const * (acc_long + acc_short),
                      0.0)
    total = mesh.all_reduce(dropped.reshape(1).to(torch.int64))[0]
    return acc, total.to(torch.int32)


def mesh_fast_accel(bpos, bmass, *, mesh: Mesh, box_size, ng: int,
                    ncell: int, capacity: int, margin: int, rs, softening,
                    g_const, axis_name: str = SHARD_AXIS):
    """TreePM accelerations of the rank's slots, SoA bpos [3, Cl, K] and
    bmass [Cl, K] -> (acc [3, Cl, K]: G times the long plus the short
    range, 0 on zero-mass slots; dropped deposits summed over the ranks,
    0-d int32)."""
    from ..ops.bucketed_pm import _greens
    geo = _geometry(mesh, (axis_name, None, None), ncell, ng, margin)

    def poisson(rho):
        rho_k = distributed_rfftn(rho, mesh=mesh)
        # symmetric in kx <-> ky: the transposed layout is the array itself
        green = ky_slab(_greens(ng, float(box_size), float(rs),
                                str(rho.device)), mesh)
        return distributed_irfftn(green * rho_k, ng=ng, mesh=mesh)

    return _fast_accel(bpos, bmass, poisson, geo=geo, mesh=mesh,
                       box_size=box_size, ng=ng, ncell=ncell,
                       capacity=capacity, margin=margin, rs=rs,
                       softening=softening, g_const=g_const)


def _rows(bpos, bvel, bmass, bacc):
    """The slots as rows [S, 10]: position, velocity, acceleration,
    mass."""
    return torch.cat([bpos.reshape(3, -1).T, bvel.reshape(3, -1).T,
                      bacc.reshape(3, -1).T, bmass.reshape(-1, 1)], 1)


def _cells(pos, box_size, nc: int):
    """The global cell of each row [S, 3] (clamped into the box)."""
    return torch.clamp(torch.floor(_div(pos, box_size) * nc)
                       .to(torch.int64), 0, nc - 1)


def _pack(rows, ids, sel, mig: int):
    """The rows (and ids) flagged by `sel`, in order, into a buffer of
    `mig` rows (zero rows and id -1 past them); the flagged rows that did
    not fit, counted."""
    rank = torch.cumsum(sel, 0) - 1
    keep = sel & (rank < mig)
    slot = torch.where(keep, rank, mig)            # mig: the drop sentinel
    buf = rows.new_zeros((mig + 1, rows.shape[1]))
    buf[slot] = rows
    buf_ids = torch.full((mig + 1,), -1, dtype=ids.dtype, device=ids.device)
    buf_ids[slot] = ids
    return buf[:mig], buf_ids[:mig], torch.sum(sel & (rank >= mig))


def _bucket_rows(rows, ids, cid, cl: int, cap: int):
    """Rows [S, 10] and ids into the rank's [Cl, K] buckets by cell id
    (cl for a row that goes nowhere): a stable sort, so rows keep their
    order within a cell (jnp.argsort's), the first `cap` of a cell kept.
    Returns (bpos, bvel, bmass, ids, acc of the new slots, overflow)."""
    dev = rows.device
    na = cid.shape[0]
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    idx = torch.arange(na, device=dev)
    is_start = torch.ones(na, dtype=torch.bool, device=dev)
    is_start[1:] = cid_s[1:] != cid_s[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - run_start
    ok = (rank < cap) & (cid_s < cl)
    slot = torch.where(ok, cid_s * cap + rank, cl * cap)
    overflow = torch.sum(~ok & (cid_s < cl))
    # the inverse slot map (slot cl * cap is the drop sentinel), then one
    # row gather with a zero pad row
    src = torch.full((cl * cap + 1,), na, dtype=torch.int64, device=dev)
    src[slot] = order
    src = src[:cl * cap]
    out = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])[src]
    nids = torch.cat([ids, ids.new_full((1,), -1)])[src]

    def soa(c0):
        return out[:, c0:c0 + 3].T.reshape(3, cl, cap).contiguous()

    return (soa(0), soa(3), out[:, 9].reshape(cl, cap).contiguous(),
            nids.reshape(cl, cap), soa(6), overflow)


def mesh_rebucket(bpos, bvel, bmass, bids, bacc, *, mesh: Mesh, box_size,
                  ncell: int, capacity: int, mig_capacity: int = 0,
                  axis_name: str = SHARD_AXIS):
    """Re-bucket the rank's slots and exchange emigrants with the +-x
    neighbour slabs (one shift each way, at most `mig_capacity` rows,
    default max(256, nc^2 K / 8)). Returns (bpos, bvel, bmass, ids, acc
    of the rank's new slots; the rows lost summed over the ranks: bucket
    overflow, emigrants past mig_capacity and strays bound farther than a
    neighbour; the rows received summed over the ranks). The sort is
    stable, as jnp.argsort is, and the rows are the JAX package's (local,
    then from the left, then from the right), so every slot is JAX's."""
    d = mesh.shape[axis_name]
    nc, cap = ncell, capacity
    nx_l = nc // d
    cl = nx_l * nc * nc
    mig = mig_capacity if mig_capacity > 0 else max(256, nc * nc * cap // 8)
    di = mesh.coord(axis_name)
    rows = _rows(bpos, bvel, bmass, bacc)
    ids = bids.reshape(-1)
    mass = rows[:, 9]
    live = mass > 0
    # destination slab: delta 0 stays, 1 is the right neighbour, d - 1
    # the left one; anything farther is a stray (the drift bound broke)
    delta = torch.remainder(_cells(rows[:, :3], box_size, nc)[:, 0] // nx_l
                            - di, d)
    stay = live & (delta == 0)
    go_right = live & (delta == 1)
    go_left = live & (delta == d - 1) & ~go_right
    pre_strays = torch.sum(live & ~stay & ~go_left & ~go_right)
    lbuf, lids, lost_l = _pack(rows, ids, go_left, mig)
    rbuf, rids, lost_r = _pack(rows, ids, go_right, mig)
    # the right neighbour's left-goers arrive here, then the left one's
    # right-goers (on two ranks both come from the one peer, in that
    # order on every rank)
    from_right = mesh.shift(lbuf, axis_name, -1)
    from_right_ids = mesh.shift(lids, axis_name, -1)
    from_left = mesh.shift(rbuf, axis_name, 1)
    from_left_ids = mesh.shift(rids, axis_name, 1)
    rows_a = torch.cat([torch.cat([rows[:, :9],
                                   torch.where(stay, mass, 0.0)[:, None]],
                                  1), from_left, from_right])
    ids_a = torch.cat([ids, from_left_ids, from_right_ids])

    cell = _cells(rows_a[:, :3], box_size, nc)
    lxa = cell[:, 0] - di * nx_l
    in_slab = (lxa >= 0) & (lxa < nx_l)
    livea = rows_a[:, 9] > 0
    cid = torch.where(livea & in_slab,
                      (lxa * nc + cell[:, 1]) * nc + cell[:, 2], cl)
    strays = torch.sum(livea & ~in_slab)
    *slots, overflow = _bucket_rows(rows_a, ids_a, cid, cl, cap)
    counts = torch.stack([overflow + lost_l + lost_r + strays + pre_strays,
                          torch.sum(from_left[:, 9] > 0)
                          + torch.sum(from_right[:, 9] > 0)])
    counts = mesh.all_reduce(counts)
    return (*slots, counts[0], counts[1])


def gather_fast_state(fstate: FastState, mesh: Mesh) -> FastState:
    """The global FastState ([3, C, K] slots in the JAX package's cell
    order) from every rank's cell range; a collective."""
    def cells(x, soa):
        if soa:
            return mesh.all_gather(x.transpose(0, 1).contiguous()) \
                .transpose(0, 1).contiguous()
        return mesh.all_gather(x)
    return fstate.replace(bpos=cells(fstate.bpos, True),
                          bvel=cells(fstate.bvel, True),
                          acc=cells(fstate.acc, True),
                          bmass=cells(fstate.bmass, False),
                          ids=cells(fstate.ids, False))


def initialize_mesh_fast(positions, velocities, masses, scale_factor, *,
                         mesh: Mesh, axis_name: str = SHARD_AXIS, **kw):
    """Plan, bucket and prime the accelerations of the slab stepper:
    every rank buckets the same global rows ([N, 3], [N]) and keeps its
    cell range. Returns (the rank's FastState, the kwargs of
    mesh_fast_run); `kw` as `_initialize`'s."""
    n_dev = mesh.shape[axis_name]
    r = mesh.coord(axis_name)

    def cells(nc):
        cl = nc ** 3 // n_dev
        return torch.arange(r * cl, (r + 1) * cl)

    return _initialize(
        positions, velocities, masses, scale_factor, mesh=mesh,
        plan_fn=lambda n, box, ng, **o: mesh_fast_plan(n, box, ng, n_dev,
                                                       **o),
        cells_fn=cells, accel=mesh_fast_accel,
        mesh_kw={"axis_name": axis_name}, **kw)


def _initialize(positions, velocities, masses, scale_factor, *, mesh: Mesh,
                plan_fn, cells_fn, accel, mesh_kw=None, box_size, pm_grid,
                softening, g_const=43.0071057317063, split_factor=1.25,
                cut_factor=4.5, margin=1, capacity=0, time=0.0, step=0,
                h0_internal=100.0, kick_mode="reference", sf_method="rk4",
                cosmological=True, plan_override=None, ids=None):
    """initialize_mesh_fast* on one stepper: `plan_fn(num_particles,
    box_size, pm_grid, **options)` its plan, `cells_fn(ncell)` the x-major
    ids of the rank's cells in its slot order, `accel` its
    mesh_fast_accel* (given `mesh_kw` beside the plan's keys). Raises
    ValueError where the plan is None. `plan_override` ({"ncell",
    "capacity", "margin", "rs"}) and `ids` rebuild at a grown capacity
    with the geometry and particle identities kept (grow-and-retry)."""
    plan = plan_override or plan_fn(
        positions.shape[0], float(box_size), pm_grid,
        split_factor=split_factor, cut_factor=cut_factor,
        capacity=capacity, margin=margin)
    if plan is None:
        raise ValueError(
            f"mesh fast plan: box/pm_grid {pm_grid} cannot shard over the "
            f"mesh {mesh.shape} with cells >= r_cut")
    fstate = _init_slots(positions, velocities, masses, scale_factor,
                         mesh=mesh, plan=plan, box_size=box_size,
                         cells=cells_fn(plan["ncell"]), time=time,
                         step=step, ids=ids)
    kw = _plan_kw(plan, box_size=box_size, pm_grid=pm_grid,
                  softening=softening, g_const=g_const,
                  h0_internal=h0_internal, kick_mode=kick_mode,
                  sf_method=sf_method, cosmological=cosmological)
    acc, dropped = accel(fstate.bpos, fstate.bmass, mesh=mesh,
                         **(mesh_kw or {}), **_split_kw(kw)[0])
    return fstate.replace(acc=acc, dropped=fstate.dropped + dropped), kw


def _init_slots(positions, velocities, masses, scale_factor, *, mesh: Mesh,
                plan: dict, box_size, cells, time, step,
                ids=None) -> FastState:
    """The rank's FastState: every rank buckets the same global rows into
    the x-major cells of ops/fast_treepm and keeps the cells `cells` (the
    x-major ids of its slots' cells, in its own order); acc 0, overflow
    the global bucketing's."""
    dev = mesh.device
    full = build_fast_state(
        positions.to(dev), velocities.to(dev), masses.to(dev),
        scale_factor, box_size=box_size, plan=plan, time=time, step=step,
        ids=None if ids is None else ids.to(dev))
    cells = cells.to(dev)
    bpos = full.bpos[:, cells].contiguous()
    return full.replace(bpos=bpos, bvel=full.bvel[:, cells].contiguous(),
                        bmass=full.bmass[cells].contiguous(),
                        ids=full.ids[cells].contiguous(),
                        acc=torch.zeros_like(bpos))


def _plan_kw(plan: dict, *, box_size, pm_grid, softening, g_const,
             h0_internal, kick_mode, sf_method, cosmological) -> dict:
    """The mesh steppers' kwargs (the JAX package's dict)."""
    return dict(box_size=float(box_size), ng=pm_grid, ncell=plan["ncell"],
                capacity=plan["capacity"], margin=plan["margin"],
                rs=float(plan["rs"]), softening=float(softening),
                g_const=float(g_const), h0_internal=float(h0_internal),
                kick_mode=str(kick_mode), sf_method=str(sf_method),
                cosmological=bool(cosmological))


def _kdk_segment(fstate: FastState, params, dt, accel, *, box_size: float,
                 h0_internal: float = 100.0, kick_mode: str = "reference",
                 sf_method: str = "rk4", cosmological: bool = True,
                 n_steps: int = 1) -> FastState:
    """`n_steps` KDK steps on the rank's slots, one force evaluation
    `accel(bpos, bmass) -> (acc, dropped)` each. Unlike the single-device
    segment, positions wrap into the box at every step (the JAX package's
    mesh steppers do)."""
    dt = float(dt)
    fs = fstate
    live = (fs.bmass > 0)[None]
    for _ in range(n_steps):
        a0 = fs.scale_factor
        vel = fs.bvel + fs.acc * (0.5 * dt) * kick_factor(a0, kick_mode)
        if cosmological:
            a_half = update_scale_factor(params, a0, 0.5 * dt, h0_internal,
                                         sf_method)
            a1 = update_scale_factor(params, a_half, 0.5 * dt, h0_internal,
                                     sf_method)
        else:
            a_half, a1 = a0, a0
        pos = fs.bpos + vel * dt * drift_factor(a_half, kick_mode)
        pos = torch.where(live, wrap_positions(pos, box_size), 0.0)
        fs = fs.replace(bpos=pos, bvel=vel, scale_factor=a1,
                        time=fs.time + dt, step=fs.step + 1)
        acc_new, dropped = accel(fs.bpos, fs.bmass)
        vel = fs.bvel + acc_new * (0.5 * dt) * kick_factor(a1, kick_mode)
        fs = fs.replace(bvel=vel, acc=acc_new, dropped=fs.dropped + dropped)
    return fs


def _split_kw(kw: dict) -> tuple:
    """initialize_mesh_fast*'s dict as (the force's keys, the KDK's)."""
    accel = {k: kw[k] for k in ACCEL_KEYS}
    kdk = {k: v for k, v in kw.items() if k not in ACCEL_KEYS}
    return accel, dict(kdk, box_size=kw["box_size"])


def _run(fstate: FastState, params, dt, *, mesh: Mesh, accel, rebucket,
         mesh_kw=None, rebucket_every: int = 16, n_steps: int = 1,
         steps_since_rebucket: int = 0, on_overflow: str = "count",
         **kw) -> FastState:
    """mesh_fast_run* on one stepper: segments of `rebucket_every` KDK
    steps (`_kdk_segment`, one `accel`, the stepper's mesh_fast_accel*, a
    step) with `rebucket` (its mesh_rebucket*) between them; both take
    `mesh_kw` beside the plan's keys, `kw` is initialize_mesh_fast*'s
    dict. `steps_since_rebucket` carries the cadence across calls
    (ops/fast_treepm.next_rebucket_offset). on_overflow="raise" throws
    BucketOverflowError, carrying the intact pre-rebucket state and the
    steps done, when a rebucket would lose rows ("count" counts them in
    `overflow`)."""
    mesh_kw = mesh_kw or {}
    akw, kdk = _split_kw(kw)

    def force(bp, bm):
        return accel(bp, bm, mesh=mesh, **mesh_kw, **akw)

    remaining = n_steps
    since = max(0, int(steps_since_rebucket))
    while remaining > 0:
        if since >= rebucket_every:
            nbp, nbv, nbm, nbi, nba, lost = rebucket(
                fstate.bpos, fstate.bvel, fstate.bmass, fstate.ids,
                fstate.acc, mesh=mesh, box_size=kw["box_size"],
                ncell=kw["ncell"], capacity=kw["capacity"], **mesh_kw)[:6]
            if on_overflow == "raise" and int(lost) > 0:
                raise BucketOverflowError(fstate, n_steps - remaining)
            fstate = fstate.replace(
                bpos=nbp, bvel=nbv, bmass=nbm, ids=nbi, acc=nba,
                overflow=fstate.overflow + lost.to(torch.int32))
            since = 0
        seg = min(rebucket_every - since, remaining)
        fstate = _kdk_segment(fstate, params, dt, force, n_steps=seg, **kdk)
        remaining -= seg
        since += seg
    return fstate


def mesh_fast_run(fstate: FastState, params, dt, *, mesh: Mesh,
                  axis_name: str = SHARD_AXIS, **kw) -> FastState:
    """Advance the slab stepper: `_run` with the emigrant rebucket
    (mesh_rebucket) between segments; `kw` holds rebucket_every, n_steps,
    steps_since_rebucket, on_overflow and initialize_mesh_fast's dict."""
    return _run(fstate, params, dt, mesh=mesh, accel=mesh_fast_accel,
                rebucket=mesh_rebucket, mesh_kw={"axis_name": axis_name},
                **kw)
