"""The port's sharded fast stepper (lambda_cdm_tpu_torch/parallel/
fast_mesh.py) and the engine's treepm_fast on ranks, held against the
JAX package's parallel/fast_mesh and engine on the conftest's virtual CPU
devices: spawned gloo ranks (tests/_torch_mesh_worker.py) in three
groups, 8 ranks (the plan's nc 8, one cell plane a rank), 4 ranks with an
explicit nc 8 (two planes a rank) and 2 ranks (both neighbours one peer),
each started once for the module, at tests/test_fast_mesh.py's geometry
(4096 particles in a 50 Mpc/h box, PM 48, softening 0.05) from one numpy
seed. Rank r's [Cl, K] slots are JAX's global rows r Cl ... (r + 1) Cl.

The JAX functions run under jax.jit here (patched into the JAX module for
the module's references; called eagerly, its shard_map bodies compile
again at every call, 20-60 s each on the CPU).

Bars: the plans, every rebucketed slot (ids, positions, velocities,
masses, accelerations) and every overflow, migrated and dropped count
exactly; mesh_fast_accel 1e-5 of the largest |a| on live slots (float32
sums in another order), zero on zero-mass slots; mesh_fast_run and the
engines by id: positions 1e-5 of the box (periodic), velocities 1e-4 of
the largest, the step exactly and the scale factor to 1e-6 (the fast
stepper's bar in tests/test_torch_fast_treepm.py).
"""

import numpy as np
import pytest

from _torch_mesh_worker import start_ranks
from _torch_parity import max_rel

import jax.numpy as jnp

import lambda_cdm_tpu as jlc
from lambda_cdm_tpu.core.state import make_state
from lambda_cdm_tpu.forces.treepm import bucket_particles
from lambda_cdm_tpu.parallel import fast_mesh as jfm
from lambda_cdm_tpu.parallel.mesh import make_mesh
from lambda_cdm_tpu.physics.cosmology import CosmologyParams
from lambda_cdm_tpu_torch.parallel import fast_mesh as tfm

N, BOX, NG, SOFT, G = 4096, 50.0, 48, 0.05, 43.0071057317063
DT, STEPS = 2e-4, 8
GROUPS = (8, 4, 2)
# the engine's integration settings (its config's defaults), so the
# function-level run and the engines share the JAX segment's compile
RUN_KW = dict(kick_mode="comoving", h0_internal=100.0, g_const=G)
PLAN_NC8 = {"ncell": 8, "capacity": 128, "margin": 1, "rs": 1.25 * BOX / NG}
MIG_SMALL = 16
N_SRC = 4                      # cells a rank piles into one point


def _particles(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, BOX, (N, 3)).astype(np.float32),
            (0.1 * rng.normal(size=(N, 3))).astype(np.float32),
            np.full(N, 2.0, np.float32))


def _buckets(pos, vel, mass, nc, cap):
    """JAX's global buckets of (pos, vel, mass) with ids 0..N-1."""
    import jax
    bucket = jax.jit(bucket_particles, static_argnums=(2,),
                     static_argnames=("ncell", "capacity"))
    bpos, bmass, pslot, ovf = bucket(jnp.asarray(pos), jnp.asarray(mass),
                                     BOX, ncell=nc, capacity=cap)
    assert int(ovf) == 0
    bpos, bmass, pslot = (np.asarray(x) for x in (bpos, bmass, pslot))
    bvel = np.zeros((nc ** 3 * cap, 3), np.float32)
    ids = np.full(nc ** 3 * cap, -1, np.int32)
    bvel[pslot] = vel
    ids[pslot] = np.arange(N, dtype=np.int32)
    return bpos, bvel.reshape(bpos.shape), bmass, ids.reshape(bmass.shape)


def _drifted(bpos, bmass, nc, frac=0.6):
    """JAX's rebucket case: every live slot +frac cells in x, wrapped."""
    cell = BOX / nc
    shift = np.array([frac * cell, 0.0, 0.0], np.float32)
    return np.where((bmass > 0)[..., None],
                    np.asarray((jnp.asarray(bpos) + shift) % BOX), 0.0)


def _dropping(bpos, bmass, seed=3):
    """A copy of bpos with a tenth of the live slots pushed 2.5 PM cells
    in x: their lower corners leave the window and the deposit drops
    them."""
    rng = np.random.default_rng(seed)
    push = (bmass > 0) & (rng.uniform(size=bmass.shape) < 0.1)
    out = bpos.copy()
    out[..., 0] += np.where(push, 2.5 * BOX / NG, 0.0).astype(np.float32)
    return out


def _seam(bpos, bmass, nc):
    """The live slots of the first cell plane moved -0.3 PM cells in x,
    so some cross the box's seam: (unwrapped, wrapped as the stepper
    wraps them)."""
    plane0 = ((np.arange(nc ** 3) // (nc * nc)) == 0)[:, None] & (bmass > 0)
    moved = bpos.copy()
    moved[..., 0] -= np.where(plane0, 0.3 * BOX / NG, 0.0).astype(np.float32)
    wrapped = moved.copy()
    wrapped[..., 0] = np.where(plane0, np.mod(moved[..., 0], np.float32(BOX)),
                               moved[..., 0])
    assert np.any(moved[..., 0] < 0)
    return moved, wrapped


def _engine_config(ng=NG):
    """tests/test_fast_mesh.py's TestEngineMeshFast config, on the mesh."""
    return {"particles": {"num_particles": N, "box_size": BOX,
                          "initial_conditions": {"type": "uniform_random"}},
            "forces": {"type": "treepm_fast", "pm_grid_size": ng,
                       "softening_length": SOFT, "rebucket_every": 4},
            "time": {"initial_timestep": DT, "final_time": 1e9},
            "cosmology": {"initial_redshift": 49.0},
            "simulation": {"output_frequency": 4, "checkpoint_frequency": 0},
            "compute": {"mesh": {"enabled": True}},
            "profiling": {"output_file": ""},
            "logging": {"performance_logging": False}}


def _overflow_state():
    """A start whose first rebucket overflows: 65 rows at the +x face of
    cell (0, 0, 0) (rank 0's), moving +x into cell (1, 0, 0) (rank 1's)
    within a step, which holds 65 more beside them in y and z (the
    capacity is 128); both cells start within capacity."""
    pos, vel, mass = _particles(11)
    rng = np.random.default_rng(12)
    cell = BOX / 8
    for k, (x0, x1), (y0, y1) in (
            (0, (cell - 0.03, cell - 0.01), (0.5, 3.0)),
            (1, (cell + 0.1, cell + 0.5), (3.25, cell - 0.5))):
        rows = slice(k * 65, (k + 1) * 65)
        pos[rows, 0] = rng.uniform(x0, x1, 65)
        pos[rows, 1:] = rng.uniform(y0, y1, (65, 2))
    vel[:65] = [40.0, 0.0, 0.0]
    return pos, vel, mass


def _state(p):
    pos, vel, mass = p
    return {"pos": pos, "vel": vel, "mass": mass, "a": 0.5}


ENGINE = {"engine": _engine_config(), "overflow": _engine_config(),
          "plan_none": _engine_config(ng=24)}
# the overflowing start: a chunk of 4, then one step (its rebucket raises
# and the capacity grows); the plan-None box: a chunk of 2
ENGINE_STEPS = {"engine": STEPS, "overflow": 5, "plan_none": 2}


def _payload(n_ranks):
    pos, vel, mass = _particles()
    plan = PLAN_NC8 if n_ranks == 4 else jfm.mesh_fast_plan(N, BOX, NG,
                                                             n_ranks)
    nc, cap = plan["ncell"], plan["capacity"]
    bpos, bvel, bmass, ids = _buckets(pos, vel, mass, nc, cap)
    acc = np.random.default_rng(9).normal(size=bpos.shape).astype(np.float32)
    mass_dead = mass.copy()
    mass_dead[::5] = 0.0
    dpos, _, dmass, _ = _buckets(pos, vel, mass_dead, nc, cap)
    rb = {"bpos": _drifted(bpos, bmass, nc), "bvel": bvel, "bmass": bmass,
          "ids": ids, "acc": acc}
    unwrapped, wrapped = _seam(bpos, bmass, nc)
    p = {"geo": {"box": BOX, "ng": NG, "nc": nc, "cap": cap,
                 "rs": plan["rs"], "soft": SOFT, "g": G},
         "accel": {"accel": (bpos, bmass), "dead": (dpos, dmass),
                   "dropping": (_dropping(bpos, bmass), bmass),
                   "seam": (wrapped, bmass)},
         "seam_unwrapped": unwrapped,
         "rebucket": {"rebucket": dict(rb, mig=0),
                      "rebucket_small": dict(rb, mig=MIG_SMALL)},
         "run": {"pos": pos, "vel": vel, "mass": mass, "a": 0.5, "dt": DT,
                 "steps": STEPS, "n_src": N_SRC, "kw": RUN_KW,
                 "plan": PLAN_NC8 if n_ranks == 4 else None}}
    if n_ranks == 2:
        # the plan's nc 4 ships 0.6 of a 1024-row plane each way: more
        # than the default 256 rows, so also a capacity that loses none
        del p["run"], p["accel"]
        p["rebucket"]["rebucket_wide"] = dict(rb, mig=1024)
    if n_ranks == 8:
        p.update(engine=ENGINE, steps=ENGINE_STEPS,
                 states={"engine": _state(_particles()),
                         "overflow": _state(_overflow_state()),
                         "plan_none": _state(_particles())})
    return p


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{ranks: (payload, JAX's results, each rank's results)}: the three
    groups start together and run while the JAX references are
    computed."""
    import jax
    payloads = {n: _payload(n) for n in GROUPS}
    finish = {n: start_ranks("fast_mesh", n, tmp_path_factory.mktemp(f"g{n}"),
                             payloads[n]) for n in GROUPS}
    accel = jax.jit(jfm.mesh_fast_accel, static_argnames=(
        "mesh", "box_size", "ng", "ncell", "capacity", "margin", "rs",
        "softening", "g_const", "axis_name"))
    rebucket = jax.jit(jfm.mesh_rebucket, static_argnames=(
        "mesh", "box_size", "ncell", "capacity", "mig_capacity",
        "axis_name"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfm, "mesh_fast_accel", accel)
        mp.setattr(jfm, "mesh_rebucket", rebucket)
        jax_out = {n: _jax(n, payloads[n]) for n in GROUPS}
        jax_out[8].update(_jax_engines(payloads[8]))
    return {n: (payloads[n], jax_out[n], finish[n]()) for n in GROUPS}


def _jax(n, p):
    """JAX's results of every function check of p on n devices."""
    mesh = make_mesh(n)
    geo = p["geo"]
    kw = dict(box_size=BOX, ncell=geo["nc"], capacity=geo["cap"])
    out = {}
    for name, (bpos, bmass) in p.get("accel", {}).items():
        if name == "seam":
            bpos = p["seam_unwrapped"]
        acc, dropped = jfm.mesh_fast_accel(
            jnp.asarray(bpos), jnp.asarray(bmass), mesh=mesh, ng=NG,
            margin=1, rs=geo["rs"], softening=SOFT, g_const=G, **kw)
        out.update({name: np.asarray(acc), f"{name}_dropped": int(dropped)})
    for name, c in p["rebucket"].items():
        r = jfm.mesh_rebucket(*(jnp.asarray(c[k]) for k in
                                ("bpos", "bvel", "bmass", "ids", "acc")),
                              mesh=mesh, mig_capacity=c["mig"], **kw)
        out.update({f"{name}_pos": r[0], f"{name}_vel": r[1],
                    f"{name}_mass": r[2], f"{name}_ids": r[3],
                    f"{name}_acc": r[4], f"{name}_overflow": int(r[5]),
                    f"{name}_migrated": int(r[6])})
    if "run" in p:
        run = p["run"]
        fs, fkw = jfm.initialize_mesh_fast(
            jnp.asarray(run["pos"]), jnp.asarray(run["vel"]),
            jnp.asarray(run["mass"]), run["a"], mesh=mesh, box_size=BOX,
            pm_grid=NG, softening=SOFT, plan_override=run["plan"], **RUN_KW)
        out.update(run_kw=fkw, run_init_acc=np.asarray(fs.acc),
                   run_init_ids=np.asarray(fs.ids),
                   run_init_dropped=int(fs.dropped))
        fs = jfm.mesh_fast_run(fs, CosmologyParams(), run["dt"], mesh=mesh,
                               n_steps=run["steps"], rebucket_every=4, **fkw)
        out.update(run_ids=np.asarray(fs.ids), run_pos=np.asarray(fs.bpos),
                   run_vel=np.asarray(fs.bvel),
                   run_mass=np.asarray(fs.bmass), run_step=int(fs.step),
                   run_a=float(fs.scale_factor),
                   run_overflow=int(fs.overflow),
                   run_dropped=int(fs.dropped))
    return {k: np.asarray(v) if not isinstance(v, (int, float, dict))
            else v for k, v in out.items()}


def _jax_engines(p):
    """The JAX engine (on every virtual device) on each of p's configs."""
    out = {}
    for name, d in p["engine"].items():
        s = p["states"][name]
        eng = jlc.SimulationEngine(jlc.SimulationConfig.from_dict(d))
        eng.initialize(state=make_state(s["pos"], s["vel"], s["mass"],
                                        scale_factor=s["a"]))
        kw = getattr(eng, "_fast_mesh_kw", None)
        out[f"{name}_fast_mesh"] = kw is not None
        out[f"{name}_cap0"] = kw["capacity"] if kw else None
        if name == "plan_none":
            continue          # the stateless TreePM's parity: mesh engine
        eng.run(num_steps=p["steps"][name])
        st = eng.state
        out.update({f"{name}_pos": np.asarray(st.positions),
                    f"{name}_vel": np.asarray(st.velocities),
                    f"{name}_mass": np.asarray(st.masses),
                    f"{name}_step": int(st.step),
                    f"{name}_cap": eng._fast_mesh_kw["capacity"],
                    f"{name}_overflow": int(eng._fstate.overflow),
                    f"{name}_dropped": int(eng._fstate.dropped)})
    return out


def joined(res, key):
    return np.concatenate([r[key] for r in res])


def by_id(ids, *arrays):
    """Each array's live slots in id order."""
    ids = np.asarray(ids).reshape(-1)
    keep = ids >= 0
    order = np.argsort(ids[keep])
    return [np.asarray(a).reshape(ids.shape[0], -1)[keep][order]
            for a in arrays]


def periodic(d):
    d = np.abs(d)
    return np.minimum(d, BOX - d)


@pytest.mark.parametrize("args, kw", [
    ((N, BOX, NG, 8), {}), ((N, BOX, NG, 4), {}), ((N, BOX, NG, 2), {}),
    ((1_000_000, 100.0, 192, 4), {}), ((N, BOX, NG, 8), {"capacity": 200}),
    ((N, BOX, 24, 8), {}),                                   # r_cut: None
    ((N, 1.0, 8, 64), {}),                                   # JAX's None
    ((N, BOX, 50, 8), {})])                                  # slabs: None
def test_plan(args, kw):
    got = tfm.mesh_fast_plan(*args, **kw)
    assert got == jfm.mesh_fast_plan(*args, **kw)
    assert (got is None) == (args[2] in (24, 50) or args[1] == 1.0)


@pytest.mark.parametrize("n", (8, 4))
@pytest.mark.parametrize("name", ["accel", "dead", "dropping", "seam"])
def test_mesh_fast_accel(groups, n, name):
    """The sharded forces on JAX's global buckets: live slots at 1e-5 of
    the largest |a|, the dropped count exactly (a tenth of the slots
    pushed 2.5 PM cells), zero on every zero-mass slot. "seam": slots that
    crossed the box's seam, wrapped as the stepper wraps positions, keep
    their deposit window (no drop): the port's forces are JAX's on the
    same slots unwrapped (JAX's window is not periodic, so it would drop
    the wrapped ones)."""
    p, ref, res = groups[n]
    bmass = p["accel"][name][1]
    live = bmass > 0
    got = joined(res, name)
    assert all(r[f"{name}_dropped"] == ref[f"{name}_dropped"] for r in res)
    assert (ref[f"{name}_dropped"] > 0) == (name == "dropping")
    assert max_rel(got[live], ref[name][live]) <= 1e-5
    assert np.all(got[~live] == 0.0)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("n, name, lossless", [
    (8, "rebucket", True), (8, "rebucket_small", False),
    (4, "rebucket", True), (4, "rebucket_small", False),
    (2, "rebucket", False), (2, "rebucket_small", False),
    (2, "rebucket_wide", True)])
def test_mesh_rebucket(groups, n, name, lossless):
    """After JAX's drift of +0.6 cells in x, every slot equals JAX's, at
    the default emigrant capacity, at 16 rows and (2 ranks, where the
    default loses emigrants) at 1024; overflow and migrated counts
    exactly; every id once where nothing is lost."""
    p, ref, res = groups[n]
    for r in res:
        assert r[f"{name}_overflow"] == ref[f"{name}_overflow"]
        assert r[f"{name}_migrated"] == ref[f"{name}_migrated"]
    assert ref[f"{name}_migrated"] > 0
    assert (ref[f"{name}_overflow"] == 0) == lossless
    for k in ("ids", "pos", "vel", "mass", "acc"):
        np.testing.assert_array_equal(joined(res, f"{name}_{k}"),
                                      ref[f"{name}_{k}"])
    ids = ref[f"{name}_ids"]
    assert (np.array_equal(np.sort(ids[ids >= 0]), np.arange(N))
            == lossless)


@pytest.mark.parametrize("n", (8, 4))
def test_initialize_mesh_fast(groups, n):
    """The rank's slots of the global bucketing (ids exactly) and the
    primed accelerations (1e-5 of the largest |a|)."""
    p, ref, res = groups[n]
    assert all(r["run_kw"] == ref["run_kw"] for r in res)
    assert ref["run_kw"]["ncell"] == 8
    np.testing.assert_array_equal(joined(res, "run_init_ids"),
                                  ref["run_init_ids"])
    live = ref["run_init_ids"] >= 0
    assert max_rel(joined(res, "run_init_acc")[live],
                   ref["run_init_acc"][live]) <= 1e-5
    assert all(r["run_init_dropped"] == ref["run_init_dropped"] == 0
               for r in res)


@pytest.mark.parametrize("n", (8, 4))
def test_mesh_fast_run(groups, n):
    """8 steps, a rebucket every 4, by id against JAX's run."""
    p, ref, res = groups[n]
    got = res[0]
    for r in res[1:]:
        np.testing.assert_array_equal(r["run_pos"], got["run_pos"])
    assert got["run_step"] == ref["run_step"] == STEPS
    assert got["run_a"] == pytest.approx(ref["run_a"], rel=1e-6)
    assert all(r["run_overflow"] == ref["run_overflow"] == 0 for r in res)
    assert all(r["run_dropped"] == ref["run_dropped"] == 0 for r in res)
    tp, tv = by_id(got["run_ids"], got["run_pos"], got["run_vel"])
    jp, jv = by_id(ref["run_ids"], ref["run_pos"], ref["run_vel"])
    assert tp.shape == jp.shape == (N, 3)
    assert periodic(tp - jp).max() <= 1e-5 * BOX
    assert np.abs(tv - jv).max() <= 1e-4 * np.abs(jv).max()


@pytest.mark.parametrize("n", (8, 4))
def test_overflowing_rebucket_raises_with_the_state(groups, n):
    """A rebucket that would lose rows (the live slots of each rank's
    first cells piled into one point) raises BucketOverflowError before
    any step, carrying the state it was given unchanged."""
    _, _, res = groups[n]
    assert all(r["raised"] == (0, True) for r in res)


@pytest.mark.parametrize("name", ["engine", "overflow"])
def test_engine_mesh_fast_matches_jax(groups, name):
    """compute.mesh treepm_fast on 8 ranks takes the sharded fast stepper
    and tracks the JAX engine's on 8 devices: the state in id order,
    capacities (the overflowing start grows 128 -> 256 at its first
    rebucket, losing nothing), counters and steps."""
    p, ref, res = groups[8]
    got = res[0]
    for r in res[1:]:
        for k in ("pos", "vel", "mass"):
            np.testing.assert_array_equal(r[f"{name}_{k}"],
                                          got[f"{name}_{k}"])
    assert got[f"{name}_fast_mesh"] and ref[f"{name}_fast_mesh"]
    assert got[f"{name}_cap0"] == ref[f"{name}_cap0"] == 128
    assert got[f"{name}_cap"] == ref[f"{name}_cap"] == \
        (256 if name == "overflow" else 128)
    assert got[f"{name}_overflow"] == ref[f"{name}_overflow"] == 0
    assert got[f"{name}_dropped"] == ref[f"{name}_dropped"] == 0
    assert got[f"{name}_step"] == ref[f"{name}_step"] == ENGINE_STEPS[name]
    np.testing.assert_array_equal(got[f"{name}_mass"], ref[f"{name}_mass"])
    assert np.all(got[f"{name}_mass"] > 0)
    assert periodic(got[f"{name}_pos"] - ref[f"{name}_pos"]).max() <= \
        1e-5 * BOX
    assert np.abs(got[f"{name}_vel"] - ref[f"{name}_vel"]).max() <= \
        1e-4 * np.abs(ref[f"{name}_vel"]).max()
    assert np.isfinite(got[f"{name}_pe"]) and got[f"{name}_ke"] > 0


def test_engine_plan_none_takes_the_stateless_treepm(groups):
    """A box whose fast plan is None (PM 24: cells of r_cut 11.7 do not
    fit 8 planes) takes the stateless sharded TreePM, as the JAX engine
    does, and runs."""
    p, ref, res = groups[8]
    assert not ref["plan_none_fast_mesh"]
    for r in res:
        assert not r["plan_none_fast_mesh"] and r["plan_none_stateless"]
        assert r["plan_none_step"] == ENGINE_STEPS["plan_none"]
        assert np.all(np.isfinite(r["plan_none_pos"]))
