"""The treepm_fast slice at stepper level: JAX 2LPT initial conditions run
through the JAX package's initialize_fast + fast_run and through the
port's, with re-bucketing inside the run, compared particle by particle
(sorted by persistent id); and the port's KDK updates over live slots
(ops/kdk_update.py): their plain versions against the stepper's former
expressions, one live count a segment, the wrappers' checks."""

import numpy as np
import pytest
import torch

from _torch_parity import nn, tt

import lambda_cdm_tpu.ops.fast_treepm as jft
from lambda_cdm_tpu.core.config import SimulationConfig as JConfig
from lambda_cdm_tpu.physics.cosmology import CosmologyParams as JParams
from lambda_cdm_tpu.physics.initial_conditions import generate_state
import lambda_cdm_tpu_torch.ops.fast_treepm as tft
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams as TParams

BOX, NG, N_SIDE = 50.0, 32, 16
DT, N_STEPS, REBUCKET = 2e-5, 8, 3     # a from 0.1 to ~0.13; 2 rebuckets


@pytest.fixture(scope="module")
def runs():
    cfg = JConfig()
    cfg.particles.num_particles = N_SIDE ** 3
    cfg.particles.box_size = BOX
    ic = cfg.particles.initial_conditions
    ic.type, ic.grid_size, ic.random_seed = "2lpt", N_SIDE, 21
    cfg.cosmology.initial_redshift = 9.0
    st = generate_state(cfg)
    pos, vel, m = (np.asarray(st.positions), np.asarray(st.velocities),
                   np.asarray(st.masses))
    a0 = float(st.scale_factor)
    kw = dict(box_size=BOX, pm_grid=NG, softening=0.05, kick_mode="comoving")

    jfs, jkw = jft.initialize_fast(pos, vel, m, a0, **kw)
    tfs, tkw = tft.initialize_fast(tt(pos), tt(vel), tt(m), a0, **kw)
    out = {"init": (jfs, tfs)}
    jfs = jft.fast_run(jfs, JParams(), DT, n_steps=N_STEPS,
                       rebucket_every=REBUCKET, **jkw)
    tfs = tft.fast_run(tfs, TParams(), DT, n_steps=N_STEPS,
                       rebucket_every=REBUCKET, **tkw)
    out["run"] = (jfs, tfs)
    out["kw"] = (jkw, tkw)
    out["n"] = pos.shape[0]
    return out


def _by_id(fs, n):
    """Flat per-particle arrays in id order (ids -1 are padding)."""
    ids = nn(fs.ids).reshape(-1)
    live = ids >= 0
    assert np.array_equal(np.sort(ids[live]), np.arange(n))
    out = {}
    for name in ("bpos", "bvel", "acc"):
        x = nn(getattr(fs, name)).reshape(3, -1).T
        arr = np.zeros((n, 3), np.float64)
        arr[ids[live]] = x[live]
        out[name] = arr
    mass = np.zeros(n)
    mass[ids[live]] = nn(fs.bmass).reshape(-1)[live]
    out["mass"] = mass
    return out


def test_plans_agree(runs):
    jkw, tkw = runs["kw"]
    # every key of the JAX dict, pm_only, variant and n_rows included
    assert jkw == tkw
    assert (tkw["ncell"], tkw["capacity"], tkw["variant"]) == (4, 128,
                                                               "vpu3")
    assert tkw["n_rows"] == runs["n"] and tkw["pm_only"] is False


def test_initial_accelerations(runs):
    """The x-space erfc polynomial of the JAX CPU path against vpu3's even
    one, plus the PM route: measured 3.8e-4 of the largest acceleration."""
    jfs, tfs = runs["init"]
    n = runs["n"]
    j, t = _by_id(jfs, n), _by_id(tfs, n)
    scale = np.abs(j["acc"]).max()
    assert np.abs(t["acc"] - j["acc"]).max() / scale < 1e-3
    assert np.array_equal(nn(tfs.ids), np.asarray(jfs.ids))


def test_run_matches(runs):
    """After 8 KDK steps and 2 rebuckets, measured: positions 6.9e-7 of
    the box, velocities 1.3e-4 of the largest, kinetic energy 1.7e-4,
    scale factor identical. Bounds: 1e-5 of the box, 1e-3 and 1e-3 (the
    force difference above), counters equal."""
    jfs, tfs = runs["run"]
    n = runs["n"]
    j, t = _by_id(jfs, n), _by_id(tfs, n)
    d = (t["bpos"] - j["bpos"] + BOX / 2) % BOX - BOX / 2
    assert np.abs(d).max() < 1e-5 * BOX
    vscale = np.abs(j["bvel"]).max()
    assert np.abs(t["bvel"] - j["bvel"]).max() / vscale < 1e-3
    ke_j = float(np.sum(j["mass"][:, None] * j["bvel"] ** 2))
    ke_t = float(np.sum(t["mass"][:, None] * t["bvel"] ** 2))
    assert ke_t == pytest.approx(ke_j, rel=1e-3)
    np.testing.assert_array_equal(t["mass"], j["mass"])
    assert float(tfs.scale_factor) == pytest.approx(
        float(jfs.scale_factor), rel=1e-6)
    assert float(tfs.time) == pytest.approx(float(jfs.time), rel=1e-6)
    assert int(tfs.step) == int(jfs.step) == N_STEPS
    assert int(tfs.overflow) == int(jfs.overflow)
    assert int(tfs.dropped) == int(jfs.dropped)
    assert tfs.scale_factor.dtype == torch.float32
    assert tfs.step.dtype == torch.int32


def test_overflow_raises_with_intact_state():
    """on_overflow="raise": a rebucket that would drop particles raises
    and carries the pre-rebucket state and the steps done, as in JAX."""
    n, box = 400, 30.0
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.0, box, (n, 3)).astype(np.float32)
    vel = ((box / 2 - pos) * 0.118).astype(np.float32)
    m = np.full(n, 1e-6, np.float32)
    kw = dict(box_size=box, pm_grid=24, softening=1.0, g_const=1e-8,
              kick_mode="newtonian", cosmological=False)
    out = []
    for mod, params, arr in ((jft, JParams(), np.asarray),
                             (tft, TParams(), tt)):
        fs, fkw = mod.initialize_fast(arr(pos), arr(vel), arr(m), 1.0, **kw)
        with pytest.raises(mod.BucketOverflowError) as exc:
            mod.fast_run(fs, params, 1.0, n_steps=16, rebucket_every=4,
                         on_overflow="raise", **fkw)
        out.append(exc.value)
    jexc, texc = out
    assert texc.steps_done == jexc.steps_done > 0
    assert int(texc.fstate.step) == int(jexc.fstate.step)
    assert int(texc.fstate.overflow) == int(jexc.fstate.overflow) == 0


@pytest.mark.parametrize("capacity, grown, variant", [
    (64, 128, "vpu3"), (64, 256, "vpu5"), (128, 256, "vpu5")])
def test_regrown_state_equals_the_engines_rebuild(capacity, grown, variant):
    """Grow-and-retry's rebuild, initialize_fast(plan_override=grown_plan(
    kw, K), ids=...) on a state's live rows, equals build_fast_state plus
    _accel at the grown capacity K (the engine's rebuild before), bit for
    bit in every field, at the variant the JAX engine's rule picks (a
    grown capacity leaves vpu4b's 64-slot pairing, above 128 vpu5); the
    dict is the old one at K and that variant."""
    rng = np.random.default_rng(6)
    n = 2000
    fs, kw = tft.initialize_fast(
        tt(rng.uniform(0.0, BOX, (n, 3)).astype(np.float32)),
        tt(rng.normal(0.0, 20.0, (n, 3)).astype(np.float32)),
        torch.ones(n), 0.2, box_size=BOX, pm_grid=NG, softening=0.05,
        capacity=capacity, kick_mode="comoving")
    assert kw["variant"] == ("vpu4b" if capacity == 64 else "vpu3")
    pos, vel, mass, ids = tft.flatten_fast_state(fs, with_ids=True)
    live = ids >= 0
    pos, vel, mass, ids = pos[live], vel[live], mass[live], ids[live]
    assert ids.numel() == n
    got, got_kw = tft.initialize_fast(
        pos, vel, mass, fs.scale_factor, box_size=BOX, pm_grid=NG,
        softening=0.05, kick_mode="comoving", time=fs.time, step=fs.step,
        plan_override=tft.grown_plan(kw, grown), ids=ids)
    assert got_kw == dict(kw, capacity=grown, variant=variant)
    want = tft.build_fast_state(
        pos, vel, mass, fs.scale_factor, box_size=BOX,
        plan={"ncell": kw["ncell"], "capacity": grown,
              "margin": kw["margin"], "rs": kw["rs"]},
        time=fs.time, step=fs.step, ids=ids)
    acc, dropped = tft._accel(want, **{
        k: got_kw[k] for k in ("box_size", "ng", "ncell", "capacity",
                               "margin", "rs", "softening", "g_const",
                               "gradient", "pm_only", "variant")})
    want = want.replace(acc=acc, dropped=want.dropped + dropped)
    for name in ("bpos", "bvel", "bmass", "ids", "acc", "scale_factor",
                 "time", "step", "overflow", "dropped"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert int(got.overflow) == 0


# ---- the KDK updates over live slots (ops/kdk_update.py) ----

from lambda_cdm_tpu_torch.ops import kdk_update  # noqa: E402
from lambda_cdm_tpu_torch.ops.bucketed_pm import (  # noqa: E402
    live_counts, pm_accelerations_bucketed)
from lambda_cdm_tpu_torch.ops.short_range import short_range  # noqa: E402
from lambda_cdm_tpu_torch.physics.integrators import (  # noqa: E402
    drift_factor, kick_factor, update_scale_factor)


def _clumped_state(pm_only=False, kick_mode="comoving"):
    """A CPU stepper state with dead slots (a 4^3 plan of capacity 128
    for 3,000 particles) and one clump that fills its cell to capacity,
    with seeded velocities; its initialize_fast dict without n_rows."""
    rng = np.random.default_rng(5)
    n = 3000
    pos = rng.uniform(0.0, BOX, (n, 3))
    pos[:300] = 3.0 + rng.uniform(0.0, 2.0, (300, 3))
    vel = rng.normal(0.0, 20.0, (n, 3))
    fs, kw = tft.initialize_fast(tt(pos.astype(np.float32)),
                                 tt(vel.astype(np.float32)),
                                 torch.ones(n), 0.2, box_size=BOX,
                                 pm_grid=NG, softening=0.05, capacity=128,
                                 kick_mode=kick_mode, pm_only=pm_only)
    kw = dict(kw)
    kw.pop("n_rows")
    counts = live_counts(fs.bmass)
    assert int(counts.max()) == fs.bmass.shape[1]          # a full cell
    assert int(counts.sum()) < fs.bmass.numel()            # dead slots
    return fs, kw


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("kick_mode", ["reference", "comoving",
                                       "newtonian"])
@pytest.mark.parametrize("pm_only", [False, True])
def test_plain_updates_equal_the_old_expressions(kick_mode, pm_only):
    """The open and the kick, as closing half kick and as the force's
    combine (wrappers and plain versions, on the CPU), give the bits of
    the inline expressions the stepper used before them, dead slots 0."""
    fs, kw = _clumped_state(pm_only, kick_mode)
    counts = live_counts(fs.bmass)
    dt, a0 = 3e-4, fs.scale_factor
    params = TParams()
    a_half = update_scale_factor(params, a0, 0.5 * dt, 100.0, "rk4")
    a1 = update_scale_factor(params, a_half, 0.5 * dt, 100.0, "rk4")
    live = (fs.bmass > 0)[None]
    vel = fs.bvel + fs.acc * (0.5 * dt) * kick_factor(a0, kick_mode)
    pos = torch.where(live, fs.bpos + vel * dt * drift_factor(
        a_half, kick_mode), 0.0)
    sc = dict(half_dt=0.5 * dt, kf=kick_factor(a0, kick_mode), dt=dt,
              df=drift_factor(a_half, kick_mode))
    for got in (kdk_update.kdk_open(fs.bpos, fs.bvel, fs.acc, counts, **sc),
                kdk_update.kdk_open_plain(fs.bpos, fs.bvel, fs.acc, counts,
                                          *map(float, sc.values()))):
        assert torch.equal(_bits(got[0]), _bits(pos))
        assert torch.equal(_bits(got[1]), _bits(vel))
    acc_long, _ = pm_accelerations_bucketed(
        pos, fs.bmass, ncell=kw["ncell"], ng=NG, box_size=BOX,
        g_const=kw["g_const"], split_scale=0.0 if pm_only else kw["rs"],
        margin=kw["margin"], counts=counts)
    if pm_only:
        acc = acc_long
    else:
        acc_short = short_range(pos, fs.bmass, counts, ncell=kw["ncell"],
                                capacity=kw["capacity"], box_size=BOX,
                                rs=kw["rs"], softening=kw["softening"],
                                variant=kw["variant"])
        acc = acc_long + kw["g_const"] * acc_short
        for got in (kdk_update.kdk_kick(acc_long, acc_short, counts,
                                        s1=kw["g_const"], s2=1.0),
                    kdk_update.kdk_kick_plain(acc_long, acc_short,
                                              kw["g_const"], 1.0)):
            assert torch.equal(_bits(got), _bits(acc))
    closed = vel + acc * (0.5 * dt) * kick_factor(a1, kick_mode)
    for got in (kdk_update.kdk_kick(vel, acc, counts, s1=0.5 * dt,
                                    s2=kick_factor(a1, kick_mode)),
                kdk_update.kdk_kick_plain(vel, acc, 0.5 * dt,
                                          float(kick_factor(a1, kick_mode)))):
        assert torch.equal(_bits(got), _bits(closed))
    dead = ~live
    for x in (pos, closed, acc):
        assert not x.masked_select(dead).any()


@pytest.mark.parametrize("pm_only", [False, True])
def test_one_live_count_a_segment(pm_only, monkeypatch):
    """A segment takes the live counts once and hands them to every
    force: the state equals a segment whose forces each recount them, and
    live_counts runs once a segment."""
    fs, kw = _clumped_state(pm_only)
    params = TParams()
    calls = []
    recount = tft.live_counts

    def counting(bmass):
        calls.append(1)
        return recount(bmass)

    monkeypatch.setattr(tft, "live_counts", counting)
    once = tft._fast_segment(fs, params, 3e-4, n_steps=3, **kw)
    assert len(calls) == 1
    accel = tft._accel
    monkeypatch.setattr(tft, "_accel", lambda f, counts=None, **k:
                        accel(f, **k))
    calls.clear()
    each = tft._fast_segment(fs, params, 3e-4, n_steps=3, **kw)
    assert len(calls) == 1 + 3
    for name in ("bpos", "bvel", "acc", "dropped"):
        assert torch.equal(getattr(once, name), getattr(each, name)), name


def _faulty(fault):
    """Arguments of kdk_open (three vectors) and kdk_kick (the first two)
    with one fault."""
    c, k = 8, 16
    vec = [torch.zeros(3, c, k) for _ in range(3)]
    counts = torch.full((c,), 4, dtype=torch.int32)
    if fault == "float64 vector":
        vec[1] = vec[1].double()
    elif fault == "int64 counts":
        counts = counts.long()
    elif fault == "counts of another C":
        counts = counts[:-1]
    elif fault == "vectors of two shapes":
        vec[1] = torch.zeros(3, c, k + 1)
    elif fault == "AoS vectors":
        vec = [v.reshape(c, k, 3) for v in vec]
    elif fault == "non-contiguous vector":
        vec[1] = torch.zeros(3, k, c).transpose(1, 2)
    elif fault == "another device":
        vec[1] = vec[1].to("meta")
    elif fault == "int32 vector":
        vec[1] = vec[1].int()
    elif fault == "2-D counts":
        counts = counts[:, None]
    elif fault == "non-contiguous counts":
        counts = torch.full((2 * c,), 4, dtype=torch.int32)[::2]
    elif fault == "counts on another device":
        counts = counts.to("meta")
    elif fault == "meta tensors":
        vec = [v.to("meta") for v in vec]
        counts = counts.to("meta")
    return vec, counts


@pytest.mark.parametrize("fault", [
    "float64 vector", "int64 counts", "counts of another C",
    "vectors of two shapes", "AoS vectors", "non-contiguous vector",
    "another device", "meta tensors", "int32 vector", "2-D counts",
    "non-contiguous counts", "counts on another device"])
@pytest.mark.parametrize("update", ["open", "kick"])
def test_update_wrappers_raise_on_what_they_do_not_take(update, fault):
    """Each wrapper raises on a wrongly typed, mis-shaped, non-contiguous
    or misplaced input rather than running either version."""
    vec, counts = _faulty(fault)
    calls = {
        "open": lambda: kdk_update.kdk_open(
            *vec, counts, half_dt=0.5, kf=1.0, dt=1.0, df=1.0),
        "kick": lambda: kdk_update.kdk_kick(vec[0], vec[1], counts,
                                            s1=0.5, s2=1.0)}
    before = dict(kdk_update.launches)
    with pytest.raises(ValueError):
        calls[update]()
    assert kdk_update.launches == before
