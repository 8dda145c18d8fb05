"""K1 (CIC deposit) and K2 (fused CIC x fd4 gather) of the PyTorch port:
their plain versions against the JAX package's CPU reference
(ops/bucketed_pm) and the TPU kernels in Pallas interpret mode
(ops/pallas_pm_rods), plus the whole fd4 PM route."""

import numpy as np
import torch
import pytest

from _torch_parity import clustered_particles, max_rel, nn, tt, \
    uniform_particles

import jax.numpy as jnp

import lambda_cdm_tpu.forces.pm as jpm
import lambda_cdm_tpu.ops.bucketed_pm as jbpm
from lambda_cdm_tpu.forces.treepm import bucket_particles
from lambda_cdm_tpu.ops.pallas_pm_rods import (assemble_rods,
                                               pallas_deposit_rods,
                                               pallas_gather_fd4)
import lambda_cdm_tpu_torch.forces.pm as tpm
import lambda_cdm_tpu_torch.ops.bucketed_pm as tbpm
from lambda_cdm_tpu_torch.ops import pm_rods

N, BOX, NG, NC, CAP, MARGIN = 3000, 12.0, 16, 4, 128, 1
GEO = dict(ncell=NC, ng=NG, box_size=BOX, margin=MARGIN)

# Relative to the largest value. The CPU reference sums in another order
# and computes u = x / box * ng where the kernels (TPU and CUDA) use
# x * (ng / box): measured <= 1.3e-6 for the deposit and the whole fd4
# route. The TPU kernels in interpret mode run their GEMMs as three bf16
# passes ("bf16x3"): measured 4.7e-6 (deposit) and 6.2e-6 (gather).
DEPOSIT_TOL = 1e-5
GATHER_TOL = 2e-5


def _state(seed=0, push_frac=0.0):
    """SoA bucketed state [3, C, K] with live-first slots; `push_frac` of
    the live slots drift 2.5 PM cells along x and z (unwrapped), so some
    leave their home block window and some leave the box."""
    pos, m = uniform_particles(N, BOX, seed)
    bpos, bmass, _, ovf = bucket_particles(jnp.asarray(pos), jnp.asarray(m),
                                           BOX, ncell=NC, capacity=CAP)
    assert int(ovf) == 0
    bpos = np.moveaxis(np.array(bpos), -1, 0)
    bmass = np.array(bmass)
    if push_frac:
        rng = np.random.default_rng(seed + 1)
        push = (rng.random(bmass.shape) < push_frac) & (bmass > 0)
        step = 2.5 * BOX / NG
        bpos[0] += np.where(push, step, 0.0).astype(np.float32)
        bpos[2] -= np.where(push, step, 0.0).astype(np.float32)
    counts = (bmass > 0).sum(axis=1).astype(np.int32)
    return bpos.astype(np.float32), bmass, counts


@pytest.mark.parametrize("push_frac", [0.0, 0.05])
def test_deposit_plain_matches_jnp_reference(push_frac):
    bpos, bmass, counts = _state(1, push_frac)
    ref, rdrop = jbpm.deposit_from_buckets(
        jnp.asarray(np.moveaxis(bpos, 0, -1)), jnp.asarray(bmass), **GEO)
    grid, drop = pm_rods.cic_deposit(tt(bpos), tt(bmass), tt(counts, None),
                                     **GEO)
    assert grid.shape == (NG, NG, NG)
    assert max_rel(grid, ref) < DEPOSIT_TOL
    assert int(drop) == int(rdrop)
    assert (int(drop) > 0) == (push_frac > 0)
    # mass of the deposited particles is conserved exactly up to round-off
    kept = float(np.asarray(ref).sum())
    assert abs(float(grid.sum()) - kept) < 1e-5 * kept


def test_deposit_plain_matches_pallas_interpret():
    bpos, bmass, counts = _state(2, 0.05)
    blocks, rdrop = pallas_deposit_rods(
        jnp.asarray(bpos), jnp.asarray(bmass), counts=jnp.asarray(counts),
        interpret=True, **GEO)
    ref = assemble_rods(blocks, ncell=NC, ng=NG, margin=MARGIN)
    grid, drop = pm_rods.cic_deposit(tt(bpos), tt(bmass), tt(counts, None),
                                     **GEO)
    assert max_rel(grid, ref) < DEPOSIT_TOL
    assert int(drop) == int(rdrop) > 0


def _phi(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(NG, NG, NG)).astype(np.float32)


def _live(counts):
    return np.arange(CAP)[None, :] < counts[:, None]


def test_gather_plain_matches_pallas_interpret():
    """The TPU kernel's contract: -(fd4 grad phi) CIC-gathered at live
    slots, zero on dead and dropped ones."""
    bpos, bmass, counts = _state(3, 0.05)
    phi = _phi(4)
    ref = pallas_gather_fd4(jnp.asarray(phi), jnp.asarray(bpos),
                            counts=jnp.asarray(counts), interpret=True,
                            **GEO)
    got = pm_rods.fd4_gather(tt(phi), tt(bpos), tt(counts, None), **GEO)
    assert got.shape == (3, NC ** 3, CAP)
    live = _live(counts)
    assert max_rel(got, ref, live[None]) < GATHER_TOL
    assert np.all(nn(got)[:, ~live] == 0.0)


def test_gather_plain_zero_on_dropped_slots():
    bpos, bmass, counts = _state(5, 0.2)
    got = nn(pm_rods.fd4_gather(tt(_phi(6)), tt(bpos), tt(counts, None),
                                **GEO))
    _, _, ok = pm_rods._cic_corners(tt(bpos), **GEO)
    dropped = _live(counts) & ~nn(ok)
    assert dropped.sum() > 0
    assert np.all(got[:, dropped] == 0.0)
    assert np.all(np.abs(got[:, _live(counts) & nn(ok)]).max(axis=0) > 0)


@pytest.mark.parametrize("split", [0.0, 1.0])
def test_greens_function(split):
    ref = jpm.poisson_greens_function(NG, BOX, split_scale=split)
    got = tpm.poisson_greens_function(NG, BOX, split_scale=split,
                                      device="cpu")
    assert max_rel(got, ref) < 2e-6


def test_block_geometry_and_origins():
    assert tbpm.block_geometry(NG, NC, MARGIN) == \
        jbpm.block_geometry(NG, NC, MARGIN)
    np.testing.assert_array_equal(
        nn(tbpm._block_origins(NC, NG // NC, MARGIN)),
        np.asarray(jbpm._block_origins(NC, NG // NC, MARGIN)))
    with pytest.raises(ValueError, match="multiple"):
        tbpm.block_geometry(18, 4)


@pytest.mark.parametrize("split", [0.0, 1.0])
@pytest.mark.parametrize("push_frac", [0.0, 0.05])
def test_pm_route_fd4_matches_jnp_reference(split, push_frac):
    """deposit -> FFT Poisson -> fd4 gather, against
    pm_accelerations_bucketed(gradient="fd4", use_pallas=False)."""
    bpos, bmass, _ = _state(7, push_frac)
    g = 43.0071057317063
    ref, rdrop = jbpm.pm_accelerations_bucketed(
        jnp.asarray(bpos), jnp.asarray(bmass), g_const=g,
        split_scale=split, gradient="fd4", use_pallas=False, **GEO)
    got, drop = tbpm.pm_accelerations_bucketed(
        tt(bpos), tt(bmass), g_const=g, split_scale=split, gradient="fd4",
        **GEO)
    live = np.asarray(bmass) > 0
    assert max_rel(got, ref, live[None]) < GATHER_TOL
    assert int(drop) == int(rdrop)


def test_pm_route_refuses_unported_gradients():
    """Every gradient of the JAX package is ported: spectral and interp
    (which this test once saw refused) run and match the JAX package's
    XLA path on live slots at GATHER_TOL (the drop-rule and interp cases
    are tests/test_torch_fast_options.py's); any other name is refused."""
    bpos, bmass, _ = _state(8)
    live = (bmass > 0)[None]
    for gradient in ("spectral", "interp"):
        ref, _ = jbpm.pm_accelerations_bucketed(
            jnp.asarray(bpos), jnp.asarray(bmass), split_scale=1.0,
            gradient=gradient, use_pallas=False, **GEO)
        got, _ = tbpm.pm_accelerations_bucketed(
            tt(bpos), tt(bmass), split_scale=1.0, gradient=gradient, **GEO)
        assert max_rel(got, ref, live) < GATHER_TOL
    with pytest.raises(ValueError, match="gradient"):
        tbpm.pm_accelerations_bucketed(tt(bpos), tt(bmass),
                                       gradient="fd2", **GEO)


# ---- the kernels' schedule (csrc/cic_deposit.cu, csrc/fd4_gather.cu),
# emulated in plain PyTorch: one block a tile of cells, its threads
# walking the tile's live rows laid end to end. K2 reads a staged window;
# K1 pushes a light tile's rows to the grid and sums a dense tile in a
# window of exact fixed-point sums.

from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st


def _tile_rows(counts, ncell, tile):
    """K2's rows in the kernel's order -> (block [R], cell [R], row [R]):
    block b is tile (b // nt^2, b // nt % nt, b % nt) of nt = ncell / tile
    a side; its cells in (jx, jy, jz) order, each cell's live slots
    0 .. counts - 1 in turn."""
    counts = np.asarray(counts)
    nt = ncell // tile
    c = np.arange(ncell ** 3)
    cx, cy, cz = c // ncell ** 2, c // ncell % ncell, c % ncell
    block = ((cx // tile) * nt + cy // tile) * nt + cz // tile
    j = ((cx % tile) * tile + cy % tile) * tile + cz % tile
    order = np.lexsort((j, block))
    n = counts[order]
    cell = np.repeat(order, n)
    row = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    return np.repeat(block[order], n), cell, row


def _tile_origins(ncell, ng, tile):
    """[3, B] first mesh point of each block's tile."""
    nt = ncell // tile
    b = np.arange(nt ** 3)
    return np.stack([b // nt ** 2, b // nt % nt, b % nt]) * tile * (ng //
                                                                   ncell)


def _corners(bpos, ncell, ng, box, margin):
    i0, frac, ok = pm_rods._cic_corners(bpos, ncell=ncell, ng=ng,
                                        box_size=box, margin=margin)
    return nn(i0), frac, nn(ok)


def _gather_tiled(phi, bpos, counts, *, ncell, ng, box_size, margin):
    """K2 in the kernel's order: each block's window staged from phi, each
    kept row's 56 points read from it at local coordinates, the per-line
    differences and sums as the kernel takes them; 0 elsewhere."""
    tp = pm_rods.tile_plan(ncell, ng, margin)
    tile, win = tp["gather_tile"], tp["gather_win"]
    blk, cell, row = _tile_rows(nn(counts), ncell, tile)
    i0, frac, ok = _corners(bpos, ncell, ng, box_size, margin)
    i0, frac, ok = i0[:, cell, row], frac[:, cell, row], ok[cell, row]
    wo = _tile_origins(ncell, ng, tile) - (margin + 1) - 2        # [3, B]
    idx = torch.as_tensor((wo[:, :, None] + np.arange(win)) % ng)
    windows = phi[idx[0][:, :, None, None], idx[1][:, None, :, None],
                  idx[2][:, None, None, :]]                  # [B, w, w, w]
    l = i0 - wo[:, blk]
    assert np.all((l[:, ok] >= 2) & (l[:, ok] <= win - 4))
    l = torch.as_tensor(np.where(ok, l, 2))
    b = torch.as_tensor(blk)
    w = [(1.0 - frac[a], frac[a]) for a in range(3)]
    inv_12h = pm_rods._inv_12h(ng, box_size)
    acc = []
    for a in range(3):
        ab, ae = (a + 1) % 3, (a + 2) % 3
        total = 0.0
        for db in (0, 1):
            for de in (0, 1):
                q = [l[0], l[1], l[2]]
                q[ab] = q[ab] + db
                q[ae] = q[ae] + de
                p = []
                for jj in range(6):
                    q[a] = l[a] - 2 + jj
                    p.append(windows[b, q[0], q[1], q[2]])
                d0 = 8.0 * (p[3] - p[1]) - (p[4] - p[0])
                d1 = 8.0 * (p[4] - p[2]) - (p[5] - p[1])
                total = total + (w[ab][db] * w[ae][de]) * (w[a][0] * d0
                                                           + w[a][1] * d1)
        acc.append(-total * inv_12h)
    out = torch.zeros_like(bpos)
    keep = torch.as_tensor(ok)
    for a in range(3):
        out[a, cell, row] = torch.where(keep, acc[a], 0.0)
    return out


def _deposit_tiled(bpos, bmass, counts, *, ncell, ng, box_size, margin):
    """K1 in the kernel's order and arithmetic -> (grid, dropped, window
    blocks): where the window fits, each non-empty tile adds each kept
    row's float32 terms times 2^k, rounded to integers, to its window's
    64-bit sums (2^k bounds its rows times their largest mass below 2^62),
    then adds each nonzero point, rounded to float32 times 2^-k, to the
    grid; else each term goes to the grid."""
    tp = pm_rods.tile_plan(ncell, ng, margin)
    tile, win = tp["deposit_tile"], tp["deposit_win"]
    blk, cell, row = _tile_rows(nn(counts), ncell, tile)
    i0, frac, ok = _corners(bpos, ncell, ng, box_size, margin)
    i0, frac, ok = i0[:, cell, row], nn(frac)[:, cell, row], ok[cell, row]
    m = nn(bmass)[cell, row]
    origins = _tile_origins(ncell, ng, tile) - (margin + 1)
    n_blocks = origins.shape[1]
    rows = np.bincount(blk, minlength=n_blocks)
    dense = tp["deposit_windowed"] & (rows > 0)
    l = i0 - origins[:, blk]
    assert np.all((l[:, ok] >= 0) & (l[:, ok] <= win - 2))
    one = np.float32(1.0)
    wz = ((one - frac[2]) * m, frac[2] * m)
    grid = np.zeros(ng ** 3, np.float32)
    windows = np.zeros((n_blocks, win ** 3), np.uint64)
    scale = np.ones(n_blocks, np.float32)
    for b in np.nonzero(dense)[0]:
        bound = np.float32(rows[b]) * m[blk == b].max()
        scale[b] = np.float32(2.0 ** min(126, 61 - (np.frexp(bound)[1]
                                                     - 1)))
    for dx in (0, 1):
        wx = frac[0] if dx else one - frac[0]
        for dy in (0, 1):
            wxy = wx * (frac[1] if dy else one - frac[1])
            for dz in (0, 1):
                v = wxy * wz[dz]
                sel = ok & dense[blk]
                local = ((l[0] + dx) * win + l[1] + dy) * win + l[2] + dz
                np.add.at(windows, (blk[sel], local[sel]), np.rint(
                    (v[sel] * scale[blk[sel]]).astype(np.float64)).astype(
                        np.uint64))
                sel = ok & ~dense[blk]
                g = (((i0[0] + dx) % ng * ng + (i0[1] + dy) % ng) * ng
                     + (i0[2] + dz) % ng)
                np.add.at(grid, g[sel], v[sel])
    pts = np.arange(win ** 3)
    loc = np.stack([pts // win ** 2, pts // win % win, pts % win])
    for b in np.nonzero(dense)[0]:
        g = (origins[:, b, None] + loc) % ng
        nz = windows[b] != 0
        np.add.at(grid, ((g[0] * ng + g[1]) * ng + g[2])[nz],
                  windows[b][nz].astype(np.float32) / scale[b])
    return (torch.from_numpy(grid.reshape(ng, ng, ng)), int((~ok).sum()),
            int(dense.sum()))


def test_tile_plan_geometries():
    """The two plans the port runs and a degenerate one-cell plan."""
    assert pm_rods.tile_plan(32, 192) == {
        "gather_tile": 2, "gather_win": 20, "gather_staged": True,
        "deposit_tile": 2, "deposit_win": 16, "deposit_windowed": True}
    assert pm_rods.tile_plan(16, 192) == {
        "gather_tile": 1, "gather_win": 20, "gather_staged": True,
        "deposit_tile": 1, "deposit_win": 16, "deposit_windowed": True}
    one = pm_rods.tile_plan(1, 96)
    assert one["gather_tile"] == 1 and not one["gather_staged"] \
        and one["deposit_tile"] == 1 and not one["deposit_windowed"]
    assert pm_rods.tile_plan(3, 24)["gather_tile"] == 1
    with pytest.raises(ValueError, match="margin \\+ 3 < ng"):
        pm_rods._check_kernel_geometry(4, 4, 1)


@pytest.mark.parametrize("ncell,tile,heavy", [(4, 2, False), (4, 1, True),
                                              (16, 2, False), (6, 2, True)])
def test_tile_rows_cover_live_rows_once(ncell, tile, heavy):
    """Every live slot is walked by exactly one thread of one block, that
    of its cell's tile, and no dead slot is."""
    rng = np.random.default_rng(ncell + tile)
    cap = 5000 if heavy else 40
    counts = rng.integers(0, 41, ncell ** 3)
    if heavy:
        counts[rng.integers(ncell ** 3)] = 5000
    blk, cell, row = _tile_rows(counts, ncell, tile)
    assert len(cell) == counts.sum()
    slots = cell * cap + row
    assert len(np.unique(slots)) == len(slots)
    assert np.all(row < counts[cell])
    nt = ncell // tile
    c = np.stack([cell // ncell ** 2, cell // ncell % ncell, cell % ncell])
    np.testing.assert_array_equal(
        blk, ((c[0] // tile) * nt + c[1] // tile) * nt + c[2] // tile)
    # a block's rows are contiguous, in block order
    assert np.all(np.diff(blk) >= 0)


def _bucketed_rows(rng, ncell, ppc, margin, cap, counts, push):
    """SoA bpos [3, C, cap] with box = ng (scale 1): each live row at a
    lower corner anywhere the drop rule admits for its cell, `push` of
    them moved up to 3 mesh cells further (many of those dropped)."""
    ng = ncell * ppc
    cc = ncell ** 3
    c = np.arange(cc)
    cxyz = np.stack([c // ncell ** 2, c // ncell % ncell, c % ncell])
    u = (cxyz[:, :, None] * ppc + rng.uniform(
        -margin - 0.5, ppc + margin + 0.5, (3, cc, cap)))
    moved = rng.random((cc, cap)) < push
    u += np.where(moved, rng.uniform(-3.0, 3.0, (3, cc, cap)), 0.0)
    live = np.arange(cap)[None] < counts[:, None]
    return np.where(live, u, 0.0).astype(np.float32), ng


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ncell=st.sampled_from([1, 2, 3, 4, 6, 8, 16]),
       ppc=st.integers(1, 14), margin=st.integers(0, 2),
       cap=st.integers(1, 48), push=st.floats(0.0, 0.5),
       heavy=st.booleans(), seed=st.integers(0, 2 ** 16))
@example(ncell=16, ppc=12, margin=1, cap=8, push=0.1, heavy=False, seed=1)
@example(ncell=4, ppc=6, margin=1, cap=48, push=0.05, heavy=True, seed=2)
def test_tile_windows_hold_every_admitted_corner(ncell, ppc, margin, cap,
                                                 push, heavy, seed):
    """Each block's windows hold every corner the drop rule admits for its
    tile's cells (K1's) and every point of their fd4 stencils (K2's),
    over the whole admitted range and on sampled rows, as tile_plan sizes
    them, wherever the wrappers take the geometry."""
    rng = np.random.default_rng(seed)
    if heavy:
        ncell = min(ncell, 4)
        cap = 5000
    counts = rng.integers(0, min(cap, 48) + 1, ncell ** 3)
    if heavy:
        counts[rng.integers(ncell ** 3)] = 5000
    ng = ncell * ppc
    try:
        pm_rods._check_kernel_geometry(ncell, ng, margin)
    except ValueError:
        assert margin + 3 >= ng
        return
    tp = pm_rods.tile_plan(ncell, ng, margin)
    windows = {"gather": (tp["gather_tile"], tp["gather_win"], 2, 3),
               "deposit": (tp["deposit_tile"], tp["deposit_win"], 0, 1)}
    assert tp["gather_staged"] == (4 * (tp["gather_win"] ** 3
                                        + 3 * tp["gather_win"])
                                   <= pm_rods.MAX_SMEM)
    assert tp["deposit_windowed"] == (8 * tp["deposit_win"] ** 3
                                   <= pm_rods.DEPOSIT_WINDOW_BYTES)
    u, ng = _bucketed_rows(rng, ncell, ppc, margin, cap, counts, push)
    i0, _, ok = _corners(tt(u), ncell, ng, float(ng), margin)
    for tile, win, below, above in windows.values():
        assert ncell % tile == 0
        # every admitted lower corner of every cell of a tile, relative to
        # the window's first point (the tile's origin - margin - 1 - below)
        for j in range(tile):
            lo = j * ppc + below
            hi = lo + ppc + 2 * (margin + 1) - 2
            assert lo - below >= 0 and hi + above <= win - 1
        # on rows
        blk, cell, row = _tile_rows(counts, ncell, tile)
        keep = ok[cell, row]
        lw = i0[:, cell, row] - (_tile_origins(ncell, ng, tile)[:, blk]
                                 - (margin + 1) - below)
        assert np.all((lw[:, keep] - below >= 0)
                      & (lw[:, keep] + above <= win - 1))


def _clumped_state(seed):
    """ncell 8 on a 32^3 mesh (tiles of 2^3 cells, deposit windows of 12^3
    points): a uniform background whose tiles are light and a clump that
    makes a tile dense; some rows pushed out of their block window."""
    box, ncell, ng, cap = 24.0, 8, 32, 256
    pos, m = clustered_particles(3000, box, seed, n_clump=700, sigma=1.2,
                                 centre=(9.0, 9.0, 9.0))
    bpos, bmass, _, ovf = bucket_particles(jnp.asarray(pos), jnp.asarray(m),
                                           box, ncell=ncell, capacity=cap)
    assert int(ovf) == 0
    bpos = np.moveaxis(np.array(bpos), -1, 0).astype(np.float32)
    bmass = np.array(bmass)
    rng = np.random.default_rng(seed + 1)
    push = (rng.random(bmass.shape) < 0.05) & (bmass > 0)
    bpos[1] -= np.where(push, 2.5 * box / ng, 0.0).astype(np.float32)
    counts = (bmass > 0).sum(axis=1).astype(np.int32)
    return bpos, bmass, counts, dict(ncell=ncell, ng=ng, box_size=box,
                                     margin=1)


@pytest.mark.parametrize("clumped", [False, True])
def test_deposit_in_kernel_order_matches_plain_and_pallas(clumped,
                                                          monkeypatch):
    """K1's schedule (every non-empty tile through its fixed-point window;
    where no window fits, every row straight to the grid) gives the plain
    deposit and the TPU kernel's (interpret mode), with plain's drop
    count."""
    if clumped:
        bpos, bmass, counts, geo = _clumped_state(11)
    else:
        bpos, bmass, counts = _state(10, 0.05)
        geo = GEO
    grid, drop, n_win = _deposit_tiled(tt(bpos), tt(bmass), counts, **geo)
    assert n_win == np.sum(np.bincount(_tile_rows(
        counts, geo["ncell"], pm_rods.tile_plan(
            geo["ncell"], geo["ng"])["deposit_tile"])[0]) > 0) > 0
    monkeypatch.setattr(pm_rods, "DEPOSIT_WINDOW_BYTES", 0)
    pushed, pdrop, n_win = _deposit_tiled(tt(bpos), tt(bmass), counts,
                                          **geo)
    assert n_win == 0 and pdrop == drop
    assert max_rel(pushed, grid) < DEPOSIT_TOL
    ref, rdrop = pm_rods.cic_deposit(tt(bpos), tt(bmass), tt(counts, None),
                                     **geo)
    assert max_rel(grid, ref) < DEPOSIT_TOL
    assert drop == int(rdrop) > 0
    blocks, pdrop = pallas_deposit_rods(
        jnp.asarray(bpos), jnp.asarray(bmass), counts=jnp.asarray(counts),
        interpret=True, **geo)
    pref = assemble_rods(blocks, ncell=geo["ncell"], ng=geo["ng"],
                         margin=geo["margin"])
    assert max_rel(grid, pref) < DEPOSIT_TOL
    assert drop == int(pdrop)


@pytest.mark.parametrize("clumped", [False, True])
def test_gather_in_kernel_order_matches_plain_and_pallas(clumped):
    """K2's schedule (each tile's staged window, local coordinates) gives
    the plain gather and the TPU kernel's (interpret mode) on live slots,
    and 0 on dead and dropped slots."""
    if clumped:
        bpos, _, counts, geo = _clumped_state(12)
    else:
        bpos, _, counts = _state(13, 0.05)
        geo = GEO
    ng = geo["ng"]
    phi = np.random.default_rng(14).normal(size=(ng, ng, ng)).astype(
        np.float32)
    got = _gather_tiled(tt(phi), tt(bpos), tt(counts, None), **geo)
    ref = pm_rods.fd4_gather(tt(phi), tt(bpos), tt(counts, None), **geo)
    cap = bpos.shape[2]
    live = np.arange(cap)[None, :] < counts[:, None]
    assert max_rel(got, ref, live[None]) < GATHER_TOL
    assert np.all(nn(got)[nn(ref) == 0.0] == 0.0)
    assert np.all(nn(got)[:, ~live] == 0.0)
    pref = pallas_gather_fd4(jnp.asarray(phi), jnp.asarray(bpos),
                             counts=jnp.asarray(counts), interpret=True,
                             **geo)
    assert max_rel(got, pref, live[None]) < GATHER_TOL
