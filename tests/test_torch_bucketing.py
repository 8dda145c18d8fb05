"""Cell bucketing, the fast-stepper plan, the bucketed state and its
re-bucketing pass: the PyTorch port against the JAX package. All of it is
integer bookkeeping plus copies, so it must agree exactly."""

import numpy as np
import pytest

from _torch_parity import clustered_particles, nn, tt, uniform_particles

import jax.numpy as jnp

import lambda_cdm_tpu.forces.treepm as jtp
import lambda_cdm_tpu.ops.fast_treepm as jft
import lambda_cdm_tpu_torch.forces.treepm as ttp
import lambda_cdm_tpu_torch.ops.fast_treepm as tft
from lambda_cdm_tpu_torch import interop


def _boundary_particles(n, box, ncell, seed):
    """Uniform particles, a quarter of them on or one ulp beside a cell
    boundary (where the float32 arithmetic order decides the cell)."""
    pos, m = uniform_particles(n, box, seed)
    rng = np.random.default_rng(seed + 100)
    k = n // 4
    edges = (rng.integers(0, ncell, (k, 3)) * np.float32(box / ncell)) \
        .astype(np.float32)
    nudge = rng.integers(-1, 2, (k, 3))
    pos[:k] = np.nextafter(edges, np.where(nudge > 0, np.inf, -np.inf)) \
        .astype(np.float32)
    pos[:k] = np.where(nudge == 0, edges, pos[:k])
    pos = np.where(pos < 0, pos + np.float32(box), pos).astype(np.float32)
    m[rng.random(n) < 0.05] = 0.0           # some dead rows
    return pos, m


@pytest.mark.parametrize("soa", [False, True])
@pytest.mark.parametrize("ncell,cap", [(4, 16), (5, 8), (3, 64)])
def test_bucket_src_map_exact(ncell, cap, soa):
    box = 30.0
    pos, m = _boundary_particles(1500, box, ncell, seed=ncell * 10 + cap)
    p = pos.T.copy() if soa else pos
    ref = jtp.bucket_src_map(jnp.asarray(p), jnp.asarray(m), box,
                             ncell=ncell, capacity=cap)
    got = ttp.bucket_src_map(tt(p), tt(m), box, ncell=ncell, capacity=cap)
    for name, r, g in zip(("src", "slot", "order", "ok", "overflow"),
                          ref, got):
        np.testing.assert_array_equal(nn(g), np.asarray(r), err_msg=name)


def test_bucket_particles_exact():
    box, ncell, cap = 20.0, 4, 8            # small capacity: overflow
    pos, m = clustered_particles(800, box, 5, n_clump=200, sigma=1.0,
                                 centre=(5.0, 5.0, 5.0))
    ref = jtp.bucket_particles(jnp.asarray(pos), jnp.asarray(m), box,
                               ncell=ncell, capacity=cap)
    got = ttp.bucket_particles(tt(pos), tt(m), box, ncell=ncell,
                               capacity=cap)
    assert int(ref[3]) > 0
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(nn(g), np.asarray(r))


def test_short_poly_fit_identical():
    jc, jx = jtp._fit_short_poly()
    tc, tx = ttp._fit_short_poly()
    np.testing.assert_array_equal(tc, np.asarray(jc))
    assert tx == jx


GEOMETRIES = [
    (1_000_000, 100.0, 192, 0),     # the main path: ncell 32, cap 64
    (100_000, 100.0, 96, 0),
    (32 ** 3, 50.0, 64, 0),
    (4096, 40.0, 32, 0),
    (4096, 40.0, 32, 300),          # explicit (grown) capacity
    (1_000_000, 100.0, 192, 256),   # vpu5 pool
    (512, 5.0, 32, 0),              # single-cell degenerate plan
    (10_000_000, 500.0, 384, 0),
]


@pytest.mark.parametrize("n,box,ng,cap", GEOMETRIES)
def test_fast_plan_identical(n, box, ng, cap):
    ref = jft.fast_plan(n, box, ng, capacity=cap, align_ncell=False)
    got = tft.fast_plan(n, box, ng, capacity=cap)
    assert got == ref


def test_main_path_plan():
    plan = tft.fast_plan(1_000_000, 100.0, 192)
    assert (plan["ncell"], plan["capacity"]) == (32, 64)


@pytest.mark.parametrize("since,n,every", [
    (s, n, e) for s in (0, 3, 16, 20) for n in (0, 1, 7, 32)
    for e in (1, 4, 16)])
def test_next_rebucket_offset(since, n, every):
    assert tft.next_rebucket_offset(since, n, every) == \
        jft.next_rebucket_offset(since, n, every)


def _fast_states(n=1200, box=24.0, ncell=4, cap=128, seed=3):
    pos, m = uniform_particles(n, box, seed)
    vel = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    plan = {"ncell": ncell, "capacity": cap, "margin": 1, "rs": 1.0}
    js = jft.build_fast_state(jnp.asarray(pos), jnp.asarray(vel),
                              jnp.asarray(m), 0.25, box_size=box, plan=plan,
                              time=1.5, step=7)
    ts = tft.build_fast_state(tt(pos), tt(vel), tt(m), 0.25, box_size=box,
                              plan=plan, time=1.5, step=7)
    return js, ts


def _assert_same_state(ts, js):
    ref = {k: np.asarray(v) for k, v in vars(js).items()}
    got = interop.fast_state_to_arrays(ts)
    for k, r in ref.items():
        np.testing.assert_array_equal(got[k], r, err_msg=k)
        assert got[k].dtype == r.dtype, k


def test_build_and_flatten_fast_state():
    js, ts = _fast_states()
    _assert_same_state(ts, js)
    for r, g in zip(jft.flatten_fast_state(js, with_ids=True),
                    tft.flatten_fast_state(ts, with_ids=True)):
        np.testing.assert_array_equal(nn(g), np.asarray(r))


def test_interop_fast_state_round_trip():
    js, _ = _fast_states()
    arrays = {k: np.asarray(v) for k, v in vars(js).items()}
    ts = interop.fast_state_from_arrays(arrays, device="cpu")
    _assert_same_state(ts, js)


@pytest.mark.parametrize("cap", [128, 24])
def test_rebucket_gather_form_exact(cap):
    """Drift the bucketed particles (some across cells and out of the box,
    as between rebuckets) and re-bucket; with cap 24 some overflow."""
    js, ts = _fast_states(cap=cap)
    rng = np.random.default_rng(9)
    shift = rng.normal(scale=4.0, size=np.asarray(js.bpos).shape) \
        .astype(np.float32)
    live = np.asarray(js.bmass) > 0
    bpos = np.where(live[None], np.asarray(js.bpos) + shift, 0.0) \
        .astype(np.float32)
    js = js.replace(bpos=jnp.asarray(bpos))
    ts = ts.replace(bpos=tt(bpos))
    kw = dict(box_size=24.0, ncell=4, capacity=cap)
    jr = jft._rebucket(js, **kw)
    tr = tft._rebucket(ts, **kw)
    _assert_same_state(tr, jr)
    if cap == 24:
        assert int(tr.overflow) > 0


@pytest.mark.parametrize("ncell,cap,extra", [(4, 128, 0), (4, 128, 40),
                                             (8, 12, 0)])
def test_rebucket_compact_form_exact(ncell, cap, extra):
    """A sparse layout (C*K > 4 n_rows) re-buckets through the compact
    form: equal to the gather form and to the JAX compact form, field by
    field. `extra` pads n_rows past the live count (dead rows of the
    particle set); on 8^3 cells of capacity 12, 40 particles drifted onto
    one point overflow their cell."""
    n, box = 1200, 24.0
    js, ts = _fast_states(n=n, box=box, ncell=ncell, cap=cap)
    assert int(ts.overflow) == 0
    rng = np.random.default_rng(9)
    bpos = np.asarray(js.bpos) + rng.normal(
        scale=2.0, size=np.asarray(js.bpos).shape)
    live = np.asarray(js.bmass) > 0
    if cap == 12:
        crowd = np.nonzero(live.reshape(-1))[0][:40]
        bpos.reshape(3, -1)[:, crowd] = 12.0 + rng.uniform(
            0, 1, (3, crowd.size))
    bpos = np.where(live[None], bpos, 0.0).astype(np.float32)
    js, ts = js.replace(bpos=jnp.asarray(bpos)), ts.replace(bpos=tt(bpos))
    kw = dict(box_size=box, ncell=ncell, capacity=cap)
    n_rows = n + extra
    assert ncell ** 3 * cap > 4 * n_rows
    compact = tft._rebucket(ts, n_rows=n_rows, **kw)
    _assert_same_state(compact, jft._rebucket(js, n_rows=n_rows, **kw))
    gather = interop.fast_state_to_arrays(tft._rebucket(ts, **kw))
    for k, v in interop.fast_state_to_arrays(compact).items():
        np.testing.assert_array_equal(v, gather[k], err_msg=k)
    assert (int(compact.overflow) > 0) == (cap == 12)


def _src_map_cummax(positions, masses, box_size, *, ncell, capacity):
    """bucket_src_map as the port first wrote it: each row's rank in its
    cell from a serial cummax of the runs' starts over the sorted ids."""
    import torch
    soa = positions.ndim == 2 and positions.shape[0] == 3
    n = positions.shape[1] if soa else positions.shape[0]
    ncells = ncell ** 3
    comps = ((positions[0], positions[1], positions[2]) if soa else
             (positions[:, 0], positions[:, 1], positions[:, 2]))
    box = torch.tensor(box_size, dtype=comps[0].dtype)
    cx, cy, cz = (torch.clamp(torch.floor(c / box * ncell)
                              .to(torch.int64), 0, ncell - 1)
                  for c in comps)
    live = masses > 0
    cid = torch.where(live, (cx * ncell + cy) * ncell + cz, ncells)
    order = torch.argsort(cid, stable=True)
    cid_s, live_s = cid[order], live[order]
    idx = torch.arange(n)
    is_start = torch.ones(n, dtype=torch.bool)
    is_start[1:] = cid_s[1:] != cid_s[:-1]
    rank = idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    ok = (rank < capacity) & live_s
    slot = torch.where(ok, cid_s * capacity + rank, ncells * capacity)
    src = torch.full((ncells * capacity + 1,), n, dtype=torch.int64)
    src[slot] = order
    return src[:-1], slot, order, ok, torch.sum(~ok & live_s)


def _src_map_case(case, seed=4):
    """(positions [N, 3], masses, box, ncell, capacity) of one case."""
    rng = np.random.default_rng(seed)
    box, ncell = 16.0, 4
    if case == "ties":          # many rows on a few points, in two cells
        pos = np.repeat(rng.uniform(0, 4, (5, 3)), 40, axis=0)
        m = np.ones(len(pos))
        return pos, m, box, ncell, 256
    if case == "empty_cells":   # rows in one octant: most cells empty
        pos = rng.uniform(0, 7.9, (300, 3))
        m = rng.uniform(0.5, 1.0, 300)
        m[::7] = 0.0
        return pos, m, box, ncell, 64
    if case == "overflow":      # a clump over its cell's capacity
        pos = np.concatenate([rng.uniform(0, box, (400, 3)),
                              rng.uniform(9, 11, (200, 3))])
        return pos, np.ones(len(pos)), box, ncell, 24
    if case == "all_dead":
        pos = rng.uniform(0, box, (200, 3))
        return pos, np.zeros(200), box, ncell, 8
    if case == "edges":         # on and beside cell faces, and outside
        pos, m = _boundary_particles(1200, box, ncell, seed)
        pos[:50] += np.float32(box)
        pos[50:100] -= np.float32(box)
        return pos, m, box, ncell, 128
    raise ValueError(case)


@pytest.mark.parametrize("soa", [False, True])
@pytest.mark.parametrize("case", ["ties", "empty_cells", "overflow",
                                  "all_dead", "edges"])
def test_bucket_src_map_ranks_from_cell_starts(case, soa):
    """The ranks from the cells' starts give every output of the serial
    cummax form, exactly, on ties, empty cells, overflow, an all-dead
    input and rows on or outside the cells' faces, in both layouts."""
    pos, m, box, ncell, cap = _src_map_case(case)
    pos = pos.astype(np.float32)
    p = tt(pos.T.copy() if soa else pos)
    want = _src_map_cummax(p, tt(m.astype(np.float32)), box, ncell=ncell,
                           capacity=cap)
    got = ttp.bucket_src_map(p, tt(m.astype(np.float32)), box, ncell=ncell,
                             capacity=cap)
    for name, w, g in zip(("src", "slot", "order", "ok", "overflow"),
                          want, got):
        np.testing.assert_array_equal(nn(g), nn(w), err_msg=name)
        assert g.dtype == w.dtype, name
    assert (int(got[4]) > 0) == (case == "overflow")
