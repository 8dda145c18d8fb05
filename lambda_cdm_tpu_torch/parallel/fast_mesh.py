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
here, written as scatter-adds and gathers. Each function is a collective:
every rank of the mesh calls it with its own slots.
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


def mesh_fast_plan(num_particles: int, box_size: float, pm_grid: int,
                   n_dev: int, *, split_factor: float = 1.25,
                   cut_factor: float = 4.5, capacity: int = 0,
                   margin: int = 1,
                   occupancy_headroom: float = 1.75) -> dict | None:
    """Static geometry, the JAX package's rules: ncell a multiple of n_dev
    (whole cell planes a rank) that divides pm_grid, at least 3, with
    cells >= r_cut, the cheapest by ncell^3 27 K^2; K the headroom times
    the mean occupancy rounded up to 128 slots (at least 128). None where
    the box cannot hold it (callers take the stateless sharded TreePM)."""
    rs = split_factor * box_size / pm_grid
    r_cut = cut_factor * rs
    if pm_grid % n_dev:
        return None

    def cap_for(nc):
        if capacity > 0:
            return ((capacity + 127) // 128) * 128
        mean_occ = num_particles / max(nc ** 3, 1)
        c = int(math.ceil(occupancy_headroom * mean_occ))
        return max(128, ((c + 127) // 128) * 128)

    best = None
    d = n_dev
    while d <= pm_grid:
        if (d % n_dev == 0 and pm_grid % d == 0
                and box_size / d >= r_cut and d >= 3):
            cap = cap_for(d)
            cost = d ** 3 * 27 * cap * cap
            if best is None or cost < best[0]:
                best = (cost, d, cap)
        d += n_dev
    if best is None:
        return None
    _, ncell, cap = best
    return {"rs": rs, "r_cut": r_cut, "ncell": ncell, "capacity": cap,
            "margin": margin, "n_dev": n_dev}


def _geometry(mesh: Mesh, axis_name: str, ncell: int, ng: int,
              margin: int) -> dict:
    """The rank's slab: cell planes nx_l, first cell plane x0, PM planes
    ngl, PM cells a bucket cell ppc, ghost planes."""
    d = mesh.shape[axis_name]
    if ncell % d or ng % d or ng % ncell:
        raise ValueError(f"the fast mesh needs ncell ({ncell}) and the PM "
                         f"grid ({ng}) divisible by the {d} ranks and the "
                         f"PM grid by ncell")
    nx_l = ncell // d
    ghost = margin + 1
    ngl = ng // d
    if ngl < ghost + 2:
        raise ValueError(f"a PM slab of {ngl} planes is thinner than the "
                         f"{ghost + 2} planes the fd4 halo ships")
    return {"nx_l": nx_l, "x0": mesh.coord(axis_name) * nx_l,
            "ngl": ngl, "ppc": ng // ncell, "ghost": ghost}


def _corners(bpos, bmass, *, geo: dict, ncell: int, ng: int, box_size,
             margin: int):
    """The CIC corners of the rank's slots: (lower corners [3, Cl, K]
    int64 with x as a row of the ghost-extended slab and y, z global;
    fractions [3, Cl, K]; use [Cl, K]: live slots inside the drop rule's
    window; dropped, the live slots outside it). The window is
    pm_rods._cic_corners's, offset by the rank's first cell plane and
    periodic: positions wrap at every step, so a slot that crossed the
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
    cell = torch.stack([c // (ncell * ncell) + geo["x0"],
                        (c // ncell) % ncell, c % ncell])
    il = torch.remainder(i0 - (cell * ppc - (margin + 1))[:, :, None], ng)
    ok = torch.all(il <= ell - 2, dim=0)
    live = bmass > 0
    use = live & ok
    dropped = torch.sum(live & ~ok)
    # x as a row of the extended slab: the window's row plus the cell's
    # first row, (cell x - x0) ppc
    ix = torch.where(use, il[0] + (cell[0] - geo["x0"])[:, None] * ppc, 0)
    return torch.stack([ix, i0[1], i0[2]]), frac, use, dropped


def _corner_index(i0, dx, dy, dz, ng: int):
    """Flat index into an [rows, ng, ng] slab of one corner."""
    iy = torch.remainder(i0[1] + dy, ng)
    iz = torch.remainder(i0[2] + dz, ng)
    return (((i0[0] + dx) * ng + iy) * ng + iz).reshape(-1)


def _weights(frac, dx, dy, dz):
    wx = frac[0] if dx else 1.0 - frac[0]
    wy = frac[1] if dy else 1.0 - frac[1]
    wz = frac[2] if dz else 1.0 - frac[2]
    return wx, wy, wz


def _deposit_slab(i0, frac, w, *, geo: dict, ng: int, mesh: Mesh,
                  axis_name: str):
    """The rank's density slab [ngl, ng, ng] (mass a PM cell): the corners
    scatter-added into the ghost-extended slab, whose spill slabs are
    added into the x neighbours' edge planes."""
    ngl, ghost = geo["ngl"], geo["ghost"]
    rows = ngl + 2 * ghost
    ext = torch.zeros(rows * ng * ng, dtype=torch.float32,
                      device=w.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wx, wy, wz = _weights(frac, dx, dy, dz)
                ext.index_add_(0, _corner_index(i0, dx, dy, dz, ng),
                               ((wx * wy) * (wz * w)).reshape(-1))
    ext = ext.reshape(rows, ng, ng)
    slab = ext[ghost:ghost + ngl].clone()
    # my low spill belongs to my left neighbour's tail, my high spill to
    # my right neighbour's head (the JAX order: tail first)
    slab[-ghost:] += mesh.shift(ext[:ghost], axis_name, -1)
    slab[:ghost] += mesh.shift(ext[ghost + ngl:], axis_name, 1)
    return slab


def _gather_fd4(phi, i0, frac, use, *, geo: dict, ng: int, box_size,
                mesh: Mesh, axis_name: str):
    """-(fd4 gradient of the potential slab) CIC-gathered at the rank's
    slots -> [3, Cl, K] (0 where `use` is False): one shift each way
    brings ghost + 2 planes, x derivatives are slices, y and z rolls."""
    h4 = geo["ghost"] + 2
    ext = torch.cat([mesh.shift(phi[-h4:], axis_name, 1), phi,
                     mesh.shift(phi[:h4], axis_name, -1)])
    inv_12h = _inv_12h(ng, box_size)
    mid = ext[2:-2]                       # rows of the deposit's slab
    fx = -(8.0 * (ext[3:-1] - ext[1:-3]) - (ext[4:] - ext[:-4])) * inv_12h
    fy, fz = (-(8.0 * (torch.roll(mid, -1, ax) - torch.roll(mid, 1, ax))
                - (torch.roll(mid, -2, ax) - torch.roll(mid, 2, ax)))
              * inv_12h for ax in (1, 2))
    flat = torch.stack([fx, fy, fz]).reshape(3, -1)
    mask = use.to(torch.float32)
    acc = torch.zeros_like(frac)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wx, wy, wz = _weights(frac, dx, dy, dz)
                vals = flat[:, _corner_index(i0, dx, dy, dz, ng)]
                acc = acc + vals.reshape(frac.shape) * ((wx * wy)
                                                        * (wz * mask))
    return acc


def _short_range(bpos, bmass, *, geo: dict, ncell: int, box_size, rs,
                 softening, mesh: Mesh, axis_name: str):
    """The 27-cell short range (unit G) of the rank's slots -> [3, Cl, K].
    The JAX package shifts the x of halo planes that crossed the periodic
    seam by one box before its plain differences; the pair pass here
    takes the minimum image of every difference, which gives the same
    pairs."""
    k = bmass.shape[1]
    block = torch.cat([bpos.permute(1, 2, 0), bmass[..., None]], -1)
    block = block.reshape(geo["nx_l"], ncell, ncell, k, 4)
    ext = _extend(block, mesh, (axis_name, None, None))
    acc = _halo_stencil_accel(block, ext, box_size, rs, softening,
                              use_poly=True)
    return acc.reshape(-1, k, 3).permute(2, 0, 1)


def mesh_fast_accel(bpos, bmass, *, mesh: Mesh, box_size, ng: int,
                    ncell: int, capacity: int, margin: int, rs, softening,
                    g_const, axis_name: str = SHARD_AXIS):
    """TreePM accelerations of the rank's slots, SoA bpos [3, Cl, K] and
    bmass [Cl, K] -> (acc [3, Cl, K]: G times the long plus the short
    range, 0 on zero-mass slots; dropped deposits summed over the ranks,
    0-d int32)."""
    geo = _geometry(mesh, axis_name, ncell, ng, margin)
    cl = geo["nx_l"] * ncell * ncell
    if bpos.shape != (3, cl, capacity) or bmass.shape != (cl, capacity):
        raise ValueError(f"the rank's slots must be [3, {cl}, {capacity}] "
                         f"and [{cl}, {capacity}], got "
                         f"{tuple(bpos.shape)}, {tuple(bmass.shape)}")
    from ..ops.bucketed_pm import _greens
    i0, frac, use, dropped = _corners(bpos, bmass, geo=geo, ncell=ncell,
                                      ng=ng, box_size=box_size,
                                      margin=margin)
    w = torch.where(use, bmass, 0.0)
    slab = _deposit_slab(i0, frac, w, geo=geo, ng=ng, mesh=mesh,
                         axis_name=axis_name)
    rho_k = distributed_rfftn(slab / (box_size / ng) ** 3, mesh=mesh)
    # symmetric in kx <-> ky: the transposed layout is the array itself
    green = ky_slab(_greens(ng, float(box_size), float(rs),
                            str(bpos.device)), mesh)
    phi = distributed_irfftn(green * rho_k, ng=ng, mesh=mesh)
    acc_long = _gather_fd4(phi, i0, frac, use, geo=geo, ng=ng,
                           box_size=box_size, mesh=mesh,
                           axis_name=axis_name)
    acc_short = _short_range(bpos, bmass, geo=geo, ncell=ncell,
                             box_size=float(box_size), rs=float(rs),
                             softening=float(softening), mesh=mesh,
                             axis_name=axis_name)
    acc = torch.where((bmass > 0)[None], g_const * (acc_long + acc_short),
                      0.0)
    total = mesh.all_reduce(dropped.reshape(1).to(torch.int64))[0]
    return acc, total.to(torch.int32)


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
    x0 = di * nx_l
    dev = bpos.device
    rows = torch.cat([bpos.reshape(3, -1).T, bvel.reshape(3, -1).T,
                      bacc.reshape(3, -1).T, bmass.reshape(-1, 1)], 1)
    ids = bids.reshape(-1)
    mass = rows[:, 9]

    def cells(pos):
        return torch.clamp(torch.floor(_div(pos, box_size) * nc)
                           .to(torch.int64), 0, nc - 1)

    live = mass > 0
    # destination slab: delta 0 stays, 1 is the right neighbour, d - 1
    # the left one; anything farther is a stray (the drift bound broke)
    delta = torch.remainder(cells(rows[:, 0]) // nx_l - di, d)
    stay = live & (delta == 0)
    go_right = live & (delta == 1)
    go_left = live & (delta == d - 1) & ~go_right
    pre_strays = torch.sum(live & ~stay & ~go_left & ~go_right)

    def pack(sel):
        rank = torch.cumsum(sel, 0) - 1
        keep = sel & (rank < mig)
        slot = torch.where(keep, rank, mig)        # mig: the drop sentinel
        buf = rows.new_zeros((mig + 1, 10))
        buf[slot] = rows
        buf_ids = torch.full((mig + 1,), -1, dtype=ids.dtype, device=dev)
        buf_ids[slot] = ids
        return buf[:mig], buf_ids[:mig], torch.sum(sel & (rank >= mig))

    lbuf, lids, lost_l = pack(go_left)
    rbuf, rids, lost_r = pack(go_right)
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

    cell = cells(rows_a[:, :3])
    lxa = cell[:, 0] - x0
    in_slab = (lxa >= 0) & (lxa < nx_l)
    livea = rows_a[:, 9] > 0
    cid = torch.where(livea & in_slab,
                      (lxa * nc + cell[:, 1]) * nc + cell[:, 2], cl)
    strays = torch.sum(livea & ~in_slab)

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
    out = torch.cat([rows_a, rows_a.new_zeros((1, 10))])[src]
    nids = torch.cat([ids_a, ids_a.new_full((1,), -1)])[src]

    def soa(c0):
        return out[:, c0:c0 + 3].T.reshape(3, cl, cap).contiguous()

    counts = torch.stack([overflow + lost_l + lost_r + strays + pre_strays,
                          torch.sum(from_left[:, 9] > 0)
                          + torch.sum(from_right[:, 9] > 0)])
    counts = mesh.all_reduce(counts)
    return (soa(0), soa(3), out[:, 9].reshape(cl, cap).contiguous(),
            nids.reshape(cl, cap), soa(6), counts[0], counts[1])


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
                         mesh: Mesh, box_size, pm_grid, softening,
                         g_const=43.0071057317063, split_factor=1.25,
                         cut_factor=4.5, margin=1, capacity=0, time=0.0,
                         step=0, h0_internal=100.0, kick_mode="reference",
                         sf_method="rk4", cosmological=True,
                         axis_name: str = SHARD_AXIS, plan_override=None,
                         ids=None):
    """Plan, bucket and prime the accelerations: every rank buckets the
    same global rows ([N, 3], [N]) and keeps its cell range. Returns (the
    rank's FastState, the kwargs of mesh_fast_run). Raises ValueError
    where the plan is None. `plan_override` ({"ncell", "capacity",
    "margin", "rs"}) and `ids` rebuild at a grown capacity with the
    geometry and particle identities kept (grow-and-retry)."""
    n_dev = mesh.shape[axis_name]
    plan = plan_override or mesh_fast_plan(
        positions.shape[0], float(box_size), pm_grid, n_dev,
        split_factor=split_factor, cut_factor=cut_factor,
        capacity=capacity, margin=margin)
    if plan is None:
        raise ValueError(
            f"mesh_fast_plan: box/pm_grid {pm_grid} cannot shard over "
            f"{n_dev} devices with cells >= r_cut")
    nc, cap = plan["ncell"], plan["capacity"]
    dev = mesh.device
    full = build_fast_state(
        positions.to(dev), velocities.to(dev), masses.to(dev),
        scale_factor, box_size=box_size, plan=plan, time=time, step=step,
        ids=None if ids is None else ids.to(dev))
    cl = nc ** 3 // n_dev
    sl = slice(mesh.coord(axis_name) * cl,
               (mesh.coord(axis_name) + 1) * cl)
    bpos = full.bpos[:, sl].contiguous()
    fstate = full.replace(bpos=bpos, bvel=full.bvel[:, sl].contiguous(),
                          bmass=full.bmass[sl].contiguous(),
                          ids=full.ids[sl].contiguous(),
                          acc=torch.zeros_like(bpos))
    kw = dict(box_size=float(box_size), ng=pm_grid, ncell=nc,
              capacity=cap, margin=plan["margin"], rs=float(plan["rs"]),
              softening=float(softening), g_const=float(g_const),
              h0_internal=float(h0_internal), kick_mode=str(kick_mode),
              sf_method=str(sf_method), cosmological=bool(cosmological))
    acc, dropped = mesh_fast_accel(fstate.bpos, fstate.bmass, mesh=mesh,
                                   axis_name=axis_name,
                                   **{k: kw[k] for k in ACCEL_KEYS})
    return fstate.replace(acc=acc, dropped=fstate.dropped + dropped), kw


def _mesh_fast_segment(fstate: FastState, params, dt, *, mesh: Mesh,
                       axis_name: str = SHARD_AXIS, box_size: float,
                       ng: int, ncell: int, capacity: int, margin: int,
                       rs: float, softening: float, g_const: float,
                       h0_internal: float = 100.0,
                       kick_mode: str = "reference", sf_method: str = "rk4",
                       cosmological: bool = True,
                       n_steps: int = 1) -> FastState:
    """`n_steps` KDK steps on the rank's slots, one force evaluation
    each. Unlike the single-device segment, positions wrap into the box
    at every step (the JAX package's mesh stepper does)."""
    accel = dict(box_size=box_size, ng=ng, ncell=ncell, capacity=capacity,
                 margin=margin, rs=rs, softening=softening, g_const=g_const)
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
        acc_new, dropped = mesh_fast_accel(fs.bpos, fs.bmass, mesh=mesh,
                                           axis_name=axis_name, **accel)
        vel = fs.bvel + acc_new * (0.5 * dt) * kick_factor(a1, kick_mode)
        fs = fs.replace(bvel=vel, acc=acc_new, dropped=fs.dropped + dropped)
    return fs


def mesh_fast_run(fstate: FastState, params, dt, *, mesh: Mesh,
                  rebucket_every: int = 16, n_steps: int = 1,
                  axis_name: str = SHARD_AXIS,
                  steps_since_rebucket: int = 0, on_overflow: str = "count",
                  **kw) -> FastState:
    """Advance `n_steps` steps: segments of `rebucket_every` steps with a
    rebucket and the emigrant exchange between them.
    `steps_since_rebucket` carries the cadence across calls
    (ops/fast_treepm.next_rebucket_offset). on_overflow="raise" throws
    BucketOverflowError, carrying the intact pre-rebucket state and the
    steps done, when a rebucket would lose rows ("count" counts them in
    `overflow`); `kw` is initialize_mesh_fast's dict."""
    remaining = n_steps
    since = max(0, int(steps_since_rebucket))
    while remaining > 0:
        if since >= rebucket_every:
            nbp, nbv, nbm, nbi, nba, ovf, _ = mesh_rebucket(
                fstate.bpos, fstate.bvel, fstate.bmass, fstate.ids,
                fstate.acc, mesh=mesh, box_size=kw["box_size"],
                ncell=kw["ncell"], capacity=kw["capacity"],
                axis_name=axis_name)
            if on_overflow == "raise" and int(ovf) > 0:
                raise BucketOverflowError(fstate, n_steps - remaining)
            fstate = fstate.replace(
                bpos=nbp, bvel=nbv, bmass=nbm, ids=nbi, acc=nba,
                overflow=fstate.overflow + ovf.to(torch.int32))
            since = 0
        seg = min(rebucket_every - since, remaining)
        fstate = _mesh_fast_segment(fstate, params, dt, mesh=mesh,
                                    axis_name=axis_name, n_steps=seg, **kw)
        remaining -= seg
        since += seg
    return fstate

