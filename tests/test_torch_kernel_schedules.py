"""The schedules of K4 and K4s (the direct sums), K5 (the FoF hook
sweep) and K8 (the rod-dense pair sum), emulated on the CPU in the order
their CUDA kernels take them:

* K4: j slices (ops/direct.j_slices, slice_bounds) of whole j tiles; in a
  slice, warp w sums j 32w..32w+31 of every tile, each 32-j sub-tile
  apart; the warps' totals are added in warp order, the slices' in slice
  order. Against pairwise_accelerations_plain and the JAX package's
  pallas_direct_accelerations in interpret mode at 1e-5 of the largest
  |a| (float32 sums in another order; the JAX package's own bar for its
  kernel).
* K4s: the blocks of ops/direct.sym_schedule (tile p against a run of
  tiles (p + k) mod P); in a block warp w takes columns 32w..32w+31 of
  each tile, lane l rows l + 32 r; for k >= 1 lane l takes column (l + s)
  mod 32 at step s and the column sums pass lane to lane; rows summed a
  tile apart, the warps' in warp order; the reduce adds a particle's row
  partials run by run, then its column partials k = 1..half. Against
  the plain version and the JAX kernel in interpret mode at 1e-5 of the
  largest |a|; a coverage check of the schedule; the threshold image
  against min_image bit for bit.
* K5: one warp a unit of ops/short_range.unit_plan over the counts of the
  active cells; a batch of 32 j skipped whole when its least label is
  not below the unit's largest minimum, a j skipped when no row's
  minimum is above its label. Labels are integers: the emulation must
  equal fof_hook_plain exactly, on a first sweep and on a late round.
* K8: work items of GROUP consecutive 16-row chunks of a rod
  (ops/short_range_rd.rd_plan_plain); the union of the group's tile
  ranges an entry, staged `cap` tiles at a time in the group's list
  order; each warp sums its own chunk's coverage from the stage, entry by
  entry, lane l the j of parity l / 16 into K8_ILP partial sums (partial
  u the j = l / 16 + 2u mod 2 K8_ILP), the partials added in order, then
  the two halves. Against short_range_rd_plain at 1e-5 of the largest
  |a| (float32 sums in another order), dead slots exactly 0; the stage
  size splits the group's list of tiles but keeps every sum's order.
"""

import numpy as np
import pytest
import torch

from _torch_parity import K8_ILP, K8_STAGE_TILES, half_box_lattice, \
    k8_union_tiles, max_rel, tt, uniform_particles

import jax.numpy as jnp

from lambda_cdm_tpu.ops.pallas_direct import pallas_direct_accelerations
from lambda_cdm_tpu_torch.analysis import halo_finder as thf
from lambda_cdm_tpu_torch.forces.direct import direct_accelerations, \
    min_image
from lambda_cdm_tpu_torch.ops import direct as tops
from lambda_cdm_tpu_torch.ops import fof_hook, short_range
from lambda_cdm_tpu_torch.ops import short_range_rd as rd

TOL = 1e-5
WARPS = tops.THREADS // 32


# -- K4 ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 77, 127, 128, 129, 777, 3585, 10_648,
                               50_000, 99_999, 100_000, 1_000_000])
def test_j_slices_cover_every_j_once(n):
    """Slices are whole J_TILE tiles (the last one cut at n) that cover
    0..n-1 exactly once, in order, none empty; S fills the card (about
    TARGET_BLOCKS blocks) and is 1 from 100k particles up."""
    s = tops.j_slices(n)
    bounds = tops.slice_bounds(n)
    assert len(bounds) == s >= 1
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0
    for j0, j1 in bounds:
        assert j1 > j0 and j0 % tops.J_TILE == 0
        assert j1 % tops.J_TILE == 0 or j1 == n
    tiles = -(-n // tops.TILE_ROWS)
    assert tiles * s <= max(tops.TARGET_BLOCKS, tiles)
    if n >= 100_000:
        assert s == 1
    if n == 10_648:
        assert s > 1 and tiles * s > 4 * 132


def _terms(p, m, i0, i1, j0, j1, box, soft2, variant, periodic):
    """[i1 - i0, 3] sums over j in [j0, j1) of m_j r^-3 d, each variant's
    arithmetic (coordinates already in its units)."""
    d = [p[None, j0:j1, c] - p[i0:i1, c, None] for c in range(3)]
    if periodic:
        d = [dc - torch.round(dc) if variant == "v2"
             else min_image(dc, box) for dc in d]
    dx, dy, dz = d
    r2 = (dx * dx + dy * dy + dz * dz + soft2 if variant == "v1"
          else dx * dx + (dy * dy + (dz * dz + soft2)))
    inv_r = torch.rsqrt(r2)
    w = m[None, j0:j1] * (inv_r * inv_r * inv_r)
    return torch.stack([torch.sum(w * dc, dim=1) for dc in d], dim=1)


def _k4_emulated(pos, m, box, soft, g, variant, periodic=True):
    """K4's sum in the kernel's order (see the module docstring)."""
    scale = 1.0 / box if variant == "v2" else 1.0
    p = tt(pos) * scale
    mm = tt(m)
    soft2 = (soft * scale) ** 2
    n = p.shape[0]
    total = None
    for j0, j1 in tops.slice_bounds(n):
        warps = [torch.zeros((n, 3)) for _ in range(WARPS)]
        for jb in range(j0, j1, 32):
            w = (jb - j0) // 32 % WARPS
            warps[w] = warps[w] + _terms(p, mm, 0, n, jb, min(jb + 32, j1),
                                         box, soft2, variant, periodic)
        block = warps[0]
        for w in warps[1:]:
            block = block + w
        total = block if total is None else total + block
    return (g * scale * scale) * total


@pytest.mark.parametrize("n,variant", [(777, "v1"), (777, "v2"),
                                       (6000, "v1"), (6000, "v2")])
def test_k4_schedule_matches_plain_and_pallas(n, variant):
    """S = 7 one-tile slices at 777 (a ragged tile), S = 30 slices of one
    or two tiles at 6000: the emulated K4 against the plain version and
    the JAX kernel in interpret mode."""
    box, soft = 20.0, 0.05
    pos, m = uniform_particles(n, box, seed=n)
    assert tops.j_slices(n) > 1
    got = _k4_emulated(pos, m, box, soft, 2.0, variant)
    plain = tops.pairwise_accelerations_plain(tt(pos), tt(m), box, soft, 2.0,
                                              variant=variant)
    assert max_rel(got, plain) < TOL
    ref = pallas_direct_accelerations(jnp.asarray(pos), jnp.asarray(m), box,
                                      soft, 2.0, interpret=True,
                                      variant=variant)
    assert max_rel(got, ref) < TOL
    assert max_rel(plain, ref) < TOL


@pytest.mark.parametrize("periodic", [True, False])
def test_k4_schedule_at_direct_10k(periodic):
    """direct_10k's 10,648 particles: S = 17 slices of four or five tiles;
    the emulated K4 against the plain version."""
    n, box, soft = 10_648, 20.0, 0.05
    pos, m = uniform_particles(n, box, seed=11)
    assert tops.j_slices(n) == 17
    got = _k4_emulated(pos, m, box, soft, 1.0, "v1", periodic)
    plain = tops.pairwise_accelerations_plain(tt(pos), tt(m), box, soft,
                                              periodic=periodic)
    assert max_rel(got, plain) < TOL


def test_check_range_without_launches():
    """check_range reads nothing and raises nothing before any launch on a
    card (CPU calls set no flag)."""
    pos, m = uniform_particles(64, 10.0, seed=2)
    tops.pairwise_accelerations(tt(pos) + 3e7, tt(m), 10.0, 0.1)
    tops.check_range()


# -- K4s ---------------------------------------------------------------------

SYM_ROWS = tops.SYM_TILE // 32      # i rows a lane (kSymRows)


def _sym_terms(pi, pj, mi, mj, box, soft2, periodic):
    """[rows, cols, 3] pair forces m_i m_j r^-3 d with K4s's arithmetic
    (coordinates in the variant's units, box 1 for sym2)."""
    d = pj[None, :, :] - pi[:, None, :]
    if periodic:
        d = min_image(d, box)
    dx, dy, dz = d.unbind(-1)
    r2 = dx * dx + (dy * dy + (dz * dz + soft2))
    inv_r = torch.rsqrt(r2)
    w = (mj[None, :] * mi[:, None]) * (inv_r * inv_r * inv_r)
    return w[..., None] * d


def _k4s_emulated(pos, m, box, soft, g, variant, periodic=True):
    """K4s's sum in the kernel's order: blocks of sym_schedule; in a block
    warp w takes columns 32w..32w+31 of each tile q against the tile's
    rows, lane l holding rows l + 32 r; for k >= 1 lane l takes column
    (l + s) mod 32 at step s (its rows' tile sums) and column c's sums are
    added lane c, c - 1, ... (rows r = 0..7 of each); the diagonal block
    adds its columns in order to the rows only; each tile's row sums added
    to the run's, the warps' in warp order; the reduce adds a particle's
    row partials run by run, then its column partials k = 1..half."""
    t_ = tops.SYM_TILE
    scale = 1.0 / box if variant == "sym2" else 1.0
    b = 1.0 if variant == "sym2" else box
    soft2 = (soft * scale) ** 2
    n = pos.shape[0]
    ntiles, runs = tops.sym_tiles(n), tops.sym_runs(n)
    half = (ntiles - 1) // 2
    p = torch.zeros((ntiles * t_, 3))
    p[:n] = tt(pos) * scale
    mm = torch.zeros(ntiles * t_)
    mm[:n] = tt(m)
    lane_of = torch.arange(t_) % 32                  # the lane of each row
    warp_col = 32 * torch.arange(t_ // 32)[None, :]  # [1, warps]
    rows = torch.arange(t_)[:, None]
    rowpart, colpart = {}, {}
    for blk, (pt, k0, k1) in enumerate(tops.sym_schedule(n)):
        if pt * t_ >= n:
            continue
        ri = slice(pt * t_, pt * t_ + t_)
        total = torch.zeros((t_, t_ // 32, 3))        # [row, warp, 3]
        for k in range(k0, k1):
            q = (pt + k) % ntiles
            terms = _sym_terms(p[ri], p[q * t_:q * t_ + t_], mm[ri],
                               mm[q * t_:q * t_ + t_], b, soft2, periodic)
            tile = torch.zeros((t_, t_ // 32, 3))
            if k == 0:
                for t in range(32):
                    tile = tile + terms[:, warp_col[0] + t]
            else:
                for s in range(32):
                    tile = tile + terms[rows, warp_col + (lane_of[:, None]
                                                          + s) % 32]
                carry = torch.zeros((t_, 3))           # [column, 3]
                cols = torch.arange(t_)
                for s in range(32):
                    lane = (cols % 32 - s) % 32
                    for r in range(SYM_ROWS):
                        carry = carry + terms[32 * r + lane, cols]
                colpart[(pt, k)] = -carry
            total = total + tile
        part = total[:, 0]
        for w in range(1, t_ // 32):
            part = part + total[:, w]
        rowpart[blk] = part
    out = torch.zeros((n, 3))
    for t in range(ntiles):
        i0, i1 = t * t_, min(n, t * t_ + t_)
        if i0 >= n:
            continue
        f = torch.zeros((i1 - i0, 3))
        for r in range(runs):
            f = f + rowpart[t * runs + r][:i1 - i0]
        for k in range(1, half + 1):
            pt = (t - k) % ntiles
            if pt * t_ < n:
                f = f + colpart[(pt, k)][:i1 - i0]
        mi = mm[i0:i1]
        inv_m = torch.where(mi > 0, 1.0 / torch.where(mi > 0, mi, 1.0), 0.0)
        out[i0:i1] = f * inv_m[:, None]
    return (g * scale * scale) * out


@pytest.mark.parametrize("blocks", [None, 10, 1])
@pytest.mark.parametrize("n,variant", [(777, "sym"), (777, "sym2"),
                                       (1100, "sym"), (1100, "sym2")])
def test_k4s_schedule_matches_plain_and_pallas(n, variant, blocks,
                                               monkeypatch):
    """777 (a ragged tile and the odd count's pad tile) and 1100 (five
    tiles): one run a k (the default at this size), runs of one and two k
    (SYM_BLOCKS 10) and one run a tile (1); the emulated K4s against the
    plain version and the JAX kernel in interpret mode, zero-mass rows 0."""
    if blocks is not None:
        monkeypatch.setattr(tops, "SYM_BLOCKS", blocks)
    box, soft = 20.0, 0.05
    pos, m = uniform_particles(n, box, seed=n + 2)
    m[[3, n - 1]] = 0.0
    assert tops.sym_tiles(n) == 5
    assert tops.sym_runs(n) == {None: 3, 10: 2, 1: 1}[blocks]
    got = _k4s_emulated(pos, m, box, soft, 2.0, variant)
    assert torch.all(got[[3, n - 1]] == 0)
    plain = tops.pairwise_accelerations_plain(tt(pos), tt(m), box, soft, 2.0,
                                              variant=variant)
    assert max_rel(got, plain) < TOL
    ref = pallas_direct_accelerations(jnp.asarray(pos), jnp.asarray(m), box,
                                      soft, 2.0, interpret=True,
                                      variant=variant)
    assert max_rel(got, ref) < TOL


@pytest.mark.parametrize("periodic", [True, False])
def test_k4s_schedule_runs_cut(periodic, monkeypatch):
    """Nine tiles (2100 particles), five k a tile cut into runs of 2, 1
    and 2 (SYM_BLOCKS 27: three runs), periodic and not."""
    monkeypatch.setattr(tops, "SYM_BLOCKS", 27)
    n, box, soft = 2100, 30.0, 0.05
    pos, m = uniform_particles(n, box, seed=5)
    assert tops.sym_tiles(n) == 9 and tops.sym_runs(n) == 3
    assert [k1 - k0 for p, k0, k1 in tops.sym_schedule(n)[:3]] == [1, 2, 2]
    got = _k4s_emulated(pos, m, box, soft, 1.0, "sym", periodic)
    plain = tops.pairwise_accelerations_plain(tt(pos), tt(m), box, soft,
                                              periodic=periodic,
                                              variant="sym")
    assert max_rel(got, plain) < TOL


@pytest.mark.parametrize("variant", ["sym", "sym2"])
def test_k4s_schedule_half_box_lattice(variant):
    """The lattice whose middle layer sits one ulp past half a box (box 50,
    two tiles and the pad): the emulated K4s, whose image is the true
    quotient's, holds the solver's direct_accelerations and the plain
    version at 1e-5 (the box-unit variant rounds its own image: the plain
    sym2)."""
    box = 50.0
    pos, m, flips = half_box_lattice(box, seed=3)
    assert flips > 0
    got = _k4s_emulated(pos, m, box, 0.1, 1.0, variant)
    plain = tops.pairwise_accelerations_plain(tt(pos), tt(m), box, 0.1,
                                              variant=variant)
    assert max_rel(got, plain) < TOL
    if variant == "sym":
        oracle = direct_accelerations(tt(pos), tt(m), box, 0.1)
        assert max_rel(got, oracle) < TOL


@pytest.mark.parametrize("n,blocks", [(1, None), (2, None), (31, None),
                                      (33, None), (256, None), (257, None),
                                      (257, 1), (777, 2), (2100, None),
                                      (2100, 27)])
def test_k4s_schedule_covers_each_pair_once(n, blocks, monkeypatch):
    """Every unordered tile pair is one block's (p, k) once; the force on
    i from j (i != j) is added once: as a row of the diagonal block, or as
    the row or the column of an off-diagonal one; and each particle's
    partials are read by the reduce exactly once: its tile's row partials,
    one a run, and the column partials the other tiles wrote for it."""
    if blocks is not None:
        monkeypatch.setattr(tops, "SYM_BLOCKS", blocks)
    t_ = tops.SYM_TILE
    ntiles, runs = tops.sym_tiles(n), tops.sym_runs(n)
    half = (ntiles - 1) // 2
    sched = tops.sym_schedule(n)
    assert ntiles % 2 == 1 and len(sched) == ntiles * runs
    assert 1 <= runs <= half + 1
    tile_pairs = {}
    for pt, k0, k1 in sched:
        assert 0 <= k0 < k1 <= half + 1
        for k in range(k0, k1):
            key = frozenset((pt, (pt + k) % ntiles))
            tile_pairs[key] = tile_pairs.get(key, 0) + 1
    assert len(tile_pairs) == ntiles * (ntiles + 1) // 2
    assert set(tile_pairs.values()) == {1}
    tile = torch.arange(n) // t_
    adds = torch.zeros((n, n), dtype=torch.int8)    # force on i from j
    written = {}       # particle -> partial slots that hold its terms
    for blk, (pt, k0, k1) in enumerate(sched):
        if pt * t_ >= n:
            continue
        rows = tile == pt
        for i in torch.nonzero(rows).flatten().tolist():
            written.setdefault(i, []).append(("row", blk))
        for k in range(k0, k1):
            cols = tile == (pt + k) % ntiles
            block = rows[:, None] & cols[None, :]
            if k == 0:
                adds += block & ~torch.eye(n, dtype=torch.bool)
            else:
                adds += block + block.T
                for j in torch.nonzero(cols).flatten().tolist():
                    written.setdefault(j, []).append(("col", pt, k))
    assert bool(torch.all(adds == 1 - torch.eye(n, dtype=torch.int8)))
    for i in range(n):
        t = i // t_
        read = [("row", t * runs + r) for r in range(runs)]
        read += [("col", (t - k) % ntiles, k) for k in range(1, half + 1)
                 if (t - k) % ntiles * t_ < n]
        assert sorted(read) == sorted(written[i])
        assert len(set(read)) == len(read)


@pytest.mark.parametrize("box", [1.0, 0.7, 3.0, 20.0, 50.0, 100.0, 1e-3,
                                 12345.678])
def test_k4s_image_thresholds(box):
    """T and T2 bracket the quotient's rounding: fl(T / box) <= 0.5 <
    fl(next(T) / box), fl(T2 / box) < 1.5 <= fl(next(T2) / box); and on
    |d| <= T2 the kernel's image d - (|d| > T) copysign(box, d), rounded
    once, equals min_image's d - box rint(d / box) bit for bit (a sweep of
    floats across both ties and random ones)."""
    b = np.float32(box)
    t1, t2 = (np.float32(x) for x in tops.image_thresholds(box))
    up = np.float32(np.inf)
    assert t1 / b <= np.float32(0.5) < np.nextafter(t1, up) / b
    assert t2 / b < np.float32(1.5) <= np.nextafter(t2, up) / b
    rng = np.random.default_rng(int(box * 1000) % 2 ** 32)
    sweep = []                  # 8 floats either side of each threshold
    for x in (t1, t2):
        for _ in range(8):
            x = np.nextafter(x, np.float32(0))
        for _ in range(17):
            sweep.append(x)
            x = np.nextafter(x, up)
    d = np.concatenate([np.array(sweep, np.float32),
                        rng.uniform(0, float(t2), 4000).astype(np.float32)])
    d = np.concatenate([d, -d, np.zeros(1, np.float32)])
    d = d[np.abs(d) <= t2]
    f = (np.abs(d) > t1).astype(np.float32)
    got = (d.astype(np.float64) - f.astype(np.float64)
           * np.copysign(np.float64(b), d)).astype(np.float32)
    ref = min_image(torch.tensor(d), float(box)).numpy()
    assert np.array_equal(got, ref)


# -- K5 ----------------------------------------------------------------------

def _fof_state(seed, ncell=4, cap=256, box=10.0, n=1500):
    """A clumpy box bucketed for the hook: (bx, by, bz, counts, pslot, n)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3))
    pos[:600] = 5.0 + 0.5 * rng.standard_normal((600, 3))
    pos = tt(np.mod(pos, box))
    bxyz, _, counts, pslot, _, ovf = thf._fof_setup(
        pos, torch.ones(n, dtype=torch.bool), box, ncell, cap)
    assert int(ovf) == 0 and int(counts.max()) > short_range.UNIT_ROWS
    return bxyz, counts, pslot, n


def _slot_labels(lab_p, pslot, ncell, cap):
    nslots = ncell ** 3 * cap
    n = lab_p.shape[0]
    lab = torch.full((nslots + 1,), n, dtype=torch.int32)
    lab[torch.where(pslot >= 0, pslot, nslots)] = lab_p.to(torch.int32)
    return lab[:nslots].reshape(ncell ** 3, cap)


def _k5_emulated(bxyz, lab, counts, active, ncell, cap, box, b):
    """K5's sweep in the kernel's order, with its skips -> (labels, j
    batches skipped whole, j skipped by the vote, j tested)."""
    masked = torch.where(active != 0, counts, 0)
    plan = short_range.unit_plan(masked, ncell)
    b2 = torch.tensor(fof_hook._b2(b), dtype=torch.float32)
    flat = [t.reshape(-1) for t in bxyz]
    flat_lab = lab.reshape(-1)
    out = flat_lab.clone()
    big = torch.iinfo(torch.int32).max
    skipped_batches = voted = tested = 0
    for cell, row0, rows in short_range.plan_units(plan, masked,
                                                   ncell).tolist():
        si = cell * cap + row0 + torch.arange(rows)
        xi = [f[si] for f in flat]
        m = flat_lab[si].clone()
        ncid, shift = short_range._neighbours(torch.tensor([cell]), ncell,
                                              box)
        for nb in range(27):
            cn = int(ncid[0, nb])
            nj = int(counts[cn])
            for jb in range(0, nj, 32):
                sj = cn * cap + torch.arange(jb, min(jb + 32, nj))
                lj = flat_lab[sj]
                if int(lj.min()) >= int(m.max()):
                    skipped_batches += 1
                    continue
                pj = [flat[c][sj] + shift[c][0, nb] for c in range(3)]
                for t in range(sj.numel()):
                    if not bool(torch.any(lj[t] < m)):
                        voted += 1
                        continue
                    tested += 1
                    d = [pj[c][t] - xi[c] for c in range(3)]
                    r2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
                    m = torch.where((r2 < b2) & (lj[t] < m), lj[t], m)
        assert int(m.max()) < big
        out[si] = m
    return out.reshape(lab.shape), skipped_batches, voted, tested


def test_k5_units_cover_active_rows_once():
    """unit_plan over the active-masked counts: every live row of every
    active cell in exactly one unit, no row of an inactive cell."""
    ncell, cap = 4, 256
    _, counts, _, _ = _fof_state(3, ncell, cap)
    active = torch.tensor(np.arange(ncell ** 3) % 3 != 1, dtype=torch.int32)
    masked = torch.where(active != 0, counts, 0)
    units = short_range.plan_units(short_range.unit_plan_plain(masked,
                                                               ncell),
                                   masked, ncell)
    seen = torch.zeros(ncell ** 3 * cap, dtype=torch.int64)
    for cell, row0, rows in units.tolist():
        assert int(active[cell]) == 1 and 1 <= rows <= short_range.UNIT_ROWS
        seen[cell * cap + row0:cell * cap + row0 + rows] += 1
    want = ((torch.arange(cap)[None] < counts[:, None])
            & (active != 0)[:, None]).reshape(-1)
    assert torch.equal(seen, want.long())


@pytest.mark.parametrize("late", [False, True])
def test_k5_schedule_matches_plain(late):
    """First sweep (random labels, every cell active) and a late round
    (the labels and active mask that fof_labels' last round which still
    changes a label is given): the emulated K5 equals fof_hook_plain
    exactly, and both skips are taken."""
    ncell, cap, box, b = 8, 256, 10.0, 0.35
    bxyz, counts, pslot, n = _fof_state(5, ncell, cap, box)
    rng = np.random.default_rng(6)
    lab_p = torch.tensor(rng.permutation(n), dtype=torch.int64)
    active = torch.ones(ncell ** 3, dtype=torch.int32)
    if late:
        state = (torch.arange(n), active)
        while True:
            nxt, changed, act = thf._fof_round(
                *state[:1], bxyz, counts, pslot, box_size=box,
                linking_length=b, ncell=ncell, capacity=cap,
                hook_fn=fof_hook.fof_hook_plain, active=state[1])
            if not bool(changed):
                break
            lab_p, active = state
            state = (nxt, act)
        assert 0 < int(active.sum()) < ncell ** 3
    lab = _slot_labels(lab_p, pslot, ncell, cap)
    kw = dict(ncell=ncell, capacity=cap, n_sentinel=n, box_size=box,
              linking_length=b)
    ref = fof_hook.fof_hook_plain(*bxyz, lab, counts, active, **kw)
    got, batches, voted, tested = _k5_emulated(bxyz, lab, counts, active,
                                               ncell, cap, box, b)
    assert torch.equal(got, ref)
    assert int((ref != lab).sum()) > 0
    assert batches > 0 and voted > 0 and tested > 0


# -- K8 ----------------------------------------------------------------------

K8_BOX, K8_NCELL, K8_RS, K8_SOFT = 64.0, 4, 2.0, 0.1


def _k8_inputs(scenario, n=5000, seed=8):
    """Rod-dense K8 inputs: uniform; half the particles in thin z slabs at
    both faces (every rod's wrap segments in use); or rod (0, 0) filled
    past its capacity (counts == k_rod there). The last 20 rows are dead."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, K8_BOX, (n, 3))
    if scenario == "edges":
        dz = rng.uniform(0.0, 3.0, n // 2)
        pos[:n // 2, 2] = np.where(np.arange(n // 2) % 2 == 0, dz,
                                   K8_BOX - dz)
    if scenario == "full":
        pos[:1500, :2] = rng.uniform(1.0, 15.0, (1500, 2))
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    m[-20:] = 0.0
    k_rod = rd.rd_geometry(n, K8_NCELL)
    rpos, rmass, counts, rzq, _, _ = rd.rd_pack(
        tt(pos.astype(np.float32)), tt(m), K8_BOX, ncell=K8_NCELL,
        k_rod=k_rod)
    tables = rd.rd_window_tables(rzq, counts, ncell=K8_NCELL, k_rod=k_rod,
                                 box_size=K8_BOX, window=4.5 * K8_RS)
    return rpos, rmass, counts, tables, k_rod


def _k8_emulated(rpos, rmass, counts, tables, k_rod, cap):
    """K8's sum in the kernel's order (see the module docstring)."""
    _, v_scale, c1 = short_range._poly_even_coeffs(K8_RS)
    pts = torch.cat([rpos, (rmass * c1)[..., None]], dim=-1)  # [R, K, 4]
    nc, box, tile = K8_NCELL, K8_BOX, rd.TILE
    group, ilp = rd.GROUP, K8_ILP
    nch = k_rod // rd.CH
    gpr = nch // group
    soft2 = K8_SOFT ** 2
    out = torch.zeros_like(rpos)
    for item in rd.rd_plan_plain(counts, k_rod=k_rod).tolist():
        r, g = divmod(item, gpr)
        cnt = int(counts[r])
        ents = tables[r, g * group:(g + 1) * group].to(torch.int64)
        live = [(g * group + w) * rd.CH < cnt for w in range(group)]
        st, nt, zsel = ents >> 10, (ents >> 2) & 255, ents & 3
        nt = torch.where(torch.tensor(live)[:, None], nt, 0)
        # the union an entry, its offset in the group's list, its rod
        u_st, u_off, u_rod, u_shift = [], [0], [], []
        for e in range(rd.ENT):
            has = nt[:, e] > 0
            lo = int(st[has, e].min()) if bool(has.any()) else 0
            hi = int((st + nt)[has, e].max()) if bool(has.any()) else 0
            u_st.append(lo)
            u_off.append(u_off[-1] + max(hi - lo, 0))
            nb = e // 3
            rx, ry = r // nc + nb // 3 - 1, r % nc + nb % 3 - 1
            u_rod.append(((rx + nc) % nc) * nc + (ry + nc) % nc)
            u_shift.append(((-box if rx < 0 else box if rx >= nc else 0.0),
                            (-box if ry < 0 else box if ry >= nc else 0.0)))
        total = u_off[-1]
        # each warp's j, in the order it sums them: (slot values, shifts)
        seq = [[] for _ in range(group)]
        for p0 in range(0, total, cap):
            p1 = min(total, p0 + cap)
            stage = torch.zeros(((p1 - p0) * tile, 4))
            for e in range(rd.ENT):
                k0, k1 = max(u_off[e], p0), min(u_off[e + 1], p1)
                if k0 < k1:
                    a = (u_st[e] + k0 - u_off[e]) * tile
                    stage[(k0 - p0) * tile:(k1 - p0) * tile] = \
                        pts[u_rod[e], a:a + (k1 - k0) * tile]
            for w in range(group):
                for e in range(rd.ENT):
                    if int(nt[w, e]) == 0:
                        continue
                    a0 = u_off[e] + int(st[w, e]) - u_st[e]
                    k0, k1 = max(a0, p0), min(a0 + int(nt[w, e]), p1)
                    if k0 < k1:
                        zs = int(zsel[w, e])
                        seq[w].append((stage[(k0 - p0) * tile:
                                             (k1 - p0) * tile],
                                       u_shift[e],
                                       -box if zs == 1 else
                                       box if zs == 2 else 0.0))
        for w in range(group):
            t = g * group + w
            if not live[w]:
                continue
            rows = torch.arange(t * rd.CH, (t + 1) * rd.CH)
            pi = pts[r, rows]                                  # [16, 4]
            terms = []
            for sp, (sx, sy), zs in seq[w]:
                dx = (sp[None, :, 0] + sx) - pi[:, 0, None]
                dy = (sp[None, :, 1] + sy) - pi[:, 1, None]
                dz = sp[None, :, 2] - (pi[:, 2, None] + zs)
                r2 = dx * dx + (dy * dy + (dz * dz + soft2))
                wgt = sp[None, :, 3] * short_range.pair_weight(r2, "vpu3",
                                                               K8_RS)
                terms.append(torch.stack([wgt * dx, wgt * dy, wgt * dz],
                                         -1))
            terms = torch.cat(terms, dim=1).numpy()         # [16, n, 3]
            assert terms.shape[1] % (2 * ilp) == 0
            halves = []
            for h in (0, 1):
                parts = [np.cumsum(terms[:, h + 2 * u::2 * ilp],
                                   axis=1, dtype=np.float32)[:, -1]
                         for u in range(ilp)]
                tot = parts[0]
                for part in parts[1:]:
                    tot = tot + part
                halves.append(tot)
            acc = torch.from_numpy(halves[0] + halves[1])
            keep = rows < cnt
            out[r, rows[keep]] = acc[keep]
    return out


@pytest.mark.parametrize("scenario", ["uniform", "edges", "full"])
@pytest.mark.parametrize("cap", [K8_STAGE_TILES, 3])
def test_k8_schedule_matches_plain(scenario, cap):
    """The emulated K8 at the kernel's stage (uniform and z-edge groups
    whose unions take two passes) and at 3 tiles a pass (every group
    streams) against short_range_rd_plain."""
    rpos, rmass, counts, tables, k_rod = _k8_inputs(scenario)
    if scenario == "full":
        assert int(counts.max()) == k_rod
    else:
        tiles = k8_union_tiles(tables, counts, k_rod, rd.GROUP)
        assert int(tiles.max()) > K8_STAGE_TILES
    if scenario == "edges":
        zsel, nt, _ = rd._decode(tables)
        assert bool(torch.any((zsel > 0) & (nt > 0)))
    geo = dict(ncell=K8_NCELL, k_rod=k_rod, box_size=K8_BOX, rs=K8_RS,
               softening=K8_SOFT)
    ref = rd.short_range_rd_plain(rpos, rmass, counts, tables, **geo)
    got = _k8_emulated(rpos, rmass, counts, tables, k_rod, cap)
    assert max_rel(got, ref) < TOL
    live = torch.arange(k_rod)[None] < counts[:, None]
    assert bool(torch.all(got[~live] == 0))


@pytest.mark.parametrize("scenario", ["edges", "full"])
def test_k8_stage_size_keeps_the_sum(scenario):
    """The passes split the group's entry-major list of tiles, so a warp
    meets its j in the same order at any stage size: the emulated K8 at 3
    tiles a pass equals it at the kernel's stage bit for bit."""
    rpos, rmass, counts, tables, k_rod = _k8_inputs(scenario)
    assert torch.equal(
        _k8_emulated(rpos, rmass, counts, tables, k_rod, 3),
        _k8_emulated(rpos, rmass, counts, tables, k_rod, K8_STAGE_TILES))


@pytest.mark.parametrize("scenario", ["uniform", "full"])
def test_k8_plan_covers_live_groups(scenario):
    """rd_plan_plain: every group holding a live row exactly once, the full
    groups first, then by live rows, most first."""
    _, _, counts, _, k_rod = _k8_inputs(scenario)
    items = rd.rd_plan_plain(counts, k_rod=k_rod)
    rows = rd.GROUP * rd.CH
    gpr = k_rod // rows
    r, g = items // gpr, items % gpr
    live_rows = torch.clamp(counts[r] - g * rows, 0, rows)
    assert bool(torch.all(live_rows > 0))
    assert bool(torch.all(live_rows[1:] <= live_rows[:-1]))
    want = sum(-(-int(c) // rows) for c in counts)
    assert items.numel() == want == torch.unique(items).numel()
