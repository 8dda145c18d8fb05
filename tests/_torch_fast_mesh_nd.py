"""Shared cases of tests/test_torch_fast_mesh2d.py and
tests/test_torch_fast_mesh3d.py: the port's pencil and block fast
steppers against the JAX package's parallel/fast_mesh2d and fast_mesh3d
on the conftest's virtual CPU devices, at the JAX tests' geometry (6000
particles in a 64 Mpc/h box, PM 48, softening 0.3) from numpy seeds.

A group is one mesh shape: its payload (global block-major arrays, JAX's
layout; rank r takes rows r Cl ... (r + 1) Cl), the spawned ranks' job
(tests/_torch_mesh_worker.job_fast_mesh_nd) and JAX's results of the same
calls. The JAX functions run under jax.jit, patched into the JAX module
for the module's references (called eagerly, its shard_map bodies
compile again at every call, 20-60 s each on the CPU).

Bars: the plans, every rebucketed slot and every overflow and dropped
count exactly; mesh_fast_accel* 1e-5 of the largest |a| on live slots,
zero on zero-mass slots; runs and engines by id: positions 1e-5 of the
box (periodic), velocities 1e-4 of the largest, the step exactly; the
engines' energies 1e-6 of the plain single-device sums on their state.
"""

import numpy as np
import pytest

from _torch_mesh_worker import start_ranks
from _torch_parity import max_rel

import jax
import jax.numpy as jnp

import lambda_cdm_tpu as jlc
from lambda_cdm_tpu.core.state import make_state
from lambda_cdm_tpu.forces.treepm import bucket_particles
from lambda_cdm_tpu.physics.cosmology import CosmologyParams

N, BOX, NG, SOFT, G = 6000, 64.0, 48, 0.3, 43.0071057317063
DT, STEPS, EVERY = 2e-4, 8, 4
# the engine's integration settings (its config's defaults), so the
# function-level run and the engines share the JAX segment's compile
RUN_KW = dict(kick_mode="comoving", h0_internal=100.0, g_const=G)
MIG_SMALL = 16
ACCEL_ARGS = ("mesh", "box_size", "ng", "ncell", "capacity", "margin", "rs",
              "softening", "g_const")
REBUCKET_ARGS = ("mesh", "box_size", "ncell", "capacity", "mig_capacity")


class Stepper:
    """The JAX module of a mesh shape's stepper and its functions."""

    def __init__(self, dims):
        from lambda_cdm_tpu.parallel import mesh as jmesh
        self.dims = tuple(dims)
        if len(dims) == 2:
            from lambda_cdm_tpu.parallel import fast_mesh2d as m
            self.mod, self.sfx, self.make = m, "2d", jmesh.make_mesh2d
        else:
            from lambda_cdm_tpu.parallel import fast_mesh3d as m
            self.mod, self.sfx, self.make = m, "3d", jmesh.make_mesh3d

    def fn(self, name):
        return getattr(self.mod, f"{name}{self.sfx}")

    def order(self, nc):
        """cell_order*: p[block-major id] = x-major id (numpy)."""
        return np.asarray(self.fn("cell_order")(nc, *self.dims))

    def plan(self, n=N, box=BOX, ng=NG, **kw):
        return self.fn("mesh_fast_plan")(n, box, ng, self.dims, **kw)


def particles(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, BOX, (N, 3)).astype(np.float32),
            (0.05 * rng.normal(size=(N, 3))).astype(np.float32),
            np.full(N, 13.0, np.float32))


def buckets(pos, vel, mass, nc, cap, order):
    """JAX's global buckets of (pos, vel, mass), ids 0..N-1, in the
    block-major cell order `order`."""
    bucket = jax.jit(bucket_particles, static_argnums=(2,),
                     static_argnames=("ncell", "capacity"))
    bpos, bmass, pslot, ovf = bucket(jnp.asarray(pos), jnp.asarray(mass),
                                     BOX, ncell=nc, capacity=cap)
    assert int(ovf) == 0
    bpos, bmass, pslot = (np.asarray(x) for x in (bpos, bmass, pslot))
    bvel = np.zeros((nc ** 3 * cap, 3), np.float32)
    ids = np.full(nc ** 3 * cap, -1, np.int32)
    live = pslot >= 0
    bvel[pslot[live]] = vel[live]
    ids[pslot[live]] = np.arange(pos.shape[0], dtype=np.int32)[live]
    return (bpos[order], bvel.reshape(bpos.shape)[order], bmass[order],
            ids.reshape(bmass.shape)[order])


def xmajor_cells(nc, order):
    """[C, 3] global (cx, cy, cz) of each block-major cell."""
    p = order
    return np.stack([p // (nc * nc), (p // nc) % nc, p % nc], -1)


def drifted(bpos, bmass, nc, frac=0.9):
    """The JAX tests' rebucket case: every live slot +frac cells along
    every axis (diagonal movers), wrapped."""
    shift = np.float32(frac * BOX / nc)
    return np.where((bmass > 0)[..., None],
                    np.asarray((jnp.asarray(bpos) + shift) % BOX), 0.0)


def dropping(bpos, bmass, seed=5):
    """A tenth of the live slots pushed 2.5 PM cells in x: their lower
    corners leave the window and the deposit drops them."""
    rng = np.random.default_rng(seed)
    push = (bmass > 0) & (rng.uniform(size=bmass.shape) < 0.1)
    out = bpos.copy()
    out[..., 0] += np.where(push, 2.5 * BOX / NG, 0.0).astype(np.float32)
    return out


def seam(bpos, bmass, nc, order, n_axes):
    """The live slots of the first cell plane of each of the first
    n_axes axes moved -0.3 PM cells along it, so some cross the box's
    seam: (unwrapped, wrapped as the stepper wraps them)."""
    cell = xmajor_cells(nc, order)
    moved = bpos.copy()
    wrapped = bpos.copy()
    for a in range(n_axes):
        plane = (cell[:, a] == 0)[:, None] & (bmass > 0)
        moved[..., a] -= np.where(plane, 0.3 * BOX / NG,
                                  0.0).astype(np.float32)
        wrapped[..., a] = np.where(plane, np.mod(moved[..., a],
                                                 np.float32(BOX)),
                                   moved[..., a])
        assert np.any(moved[..., a] < 0)
    return moved, wrapped


def blob(bpos, bmass, cap, seed=8):
    """JAX test_fast_mesh3d.py's overflow: the live slots of the first
    3 cap / 128 + 8 block-major cells piled into a tight blob around
    (0.5, 0.5, 0.5). Returns (the blob's positions, NaN where a slot is
    not moved; the rows moved)."""
    n_src = 3 * cap // 128 + 8
    move = (np.arange(bmass.shape[0])[:, None] < n_src) & (bmass > 0)
    rng = np.random.default_rng(seed)
    pos = (0.5 + 0.02 * rng.normal(size=bpos.shape)).astype(np.float32)
    out = np.where(move[..., None], pos, np.nan).astype(np.float32)
    return out, int(move.sum())


def engine_config(axes, ng=NG) -> dict:
    """The JAX tests' TestEngineMeshFast config on the mesh axes."""
    return {"particles": {"num_particles": N, "box_size": BOX,
                          "initial_conditions": {"type": "uniform_random"}},
            "forces": {"type": "treepm_fast", "pm_grid_size": ng,
                       "softening_length": SOFT, "rebucket_every": EVERY},
            "time": {"initial_timestep": DT, "final_time": 1e9},
            "cosmology": {"initial_redshift": 49.0},
            "simulation": {"output_frequency": 4, "checkpoint_frequency": 0},
            "compute": {"mesh": {"enabled": True, "axes": axes}},
            "profiling": {"output_file": ""},
            "logging": {"performance_logging": False}}


def payload(dims, *, engine: bool):
    """The group's payload: the accel, rebucket and run cases, and with
    `engine` the engine configs ("engine": the stepper for 8 steps;
    "plan_none": PM 50, whose grid does not divide by the ranks, so the
    stepper's plan is None and the stateless sharded TreePM runs, 2
    steps)."""
    st = Stepper(dims)
    plan = st.plan()
    nc, cap = plan["ncell"], plan["capacity"]
    order = st.order(nc)
    pos, vel, mass = particles()
    bpos, bvel, bmass, ids = buckets(pos, vel, mass, nc, cap, order)
    acc = np.random.default_rng(9).normal(size=bpos.shape).astype(np.float32)
    mass_dead = mass.copy()
    mass_dead[::5] = 0.0
    dpos, _, dmass, _ = buckets(pos, vel, mass_dead, nc, cap, order)
    rb = {"bpos": drifted(bpos, bmass, nc), "bvel": bvel, "bmass": bmass,
          "ids": ids, "acc": acc}
    unwrapped, wrapped = seam(bpos, bmass, nc, order, len(dims))
    tight, n_moved = blob(bpos, bmass, cap)
    p = {"dims": dims,
         "geo": {"box": BOX, "ng": NG, "nc": nc, "cap": cap,
                 "rs": plan["rs"], "soft": SOFT, "g": G},
         "accel": {"accel": (bpos, bmass), "dead": (dpos, dmass),
                   "dropping": (dropping(bpos, bmass), bmass),
                   "seam": (wrapped, bmass)},
         "seam_unwrapped": unwrapped,
         "rebucket": {"rebucket": dict(rb, mig=2048 * (len(dims) - 1)),
                      "rebucket_default": dict(rb, mig=0),
                      "rebucket_small": dict(rb, mig=MIG_SMALL)},
         "run": {"pos": pos, "vel": vel, "mass": mass, "a": 0.5, "dt": DT,
                 "steps": STEPS, "every": EVERY, "kw": RUN_KW,
                 "blob": tight, "n_moved": n_moved,
                 "regrow_cap": -(-(n_moved + cap) // 128) * 128}}
    if engine:
        names = ("shx", "shy", "shz")[:len(dims)]
        axes = dict(zip(names, dims))
        p.update(engine={"engine": engine_config(axes),
                         "plan_none": engine_config(axes, ng=50)},
                 steps={"engine": STEPS, "plan_none": 2},
                 states={name: {"pos": pos, "vel": vel, "mass": mass,
                                "a": 0.5}
                         for name in ("engine", "plan_none")})
    return p


def _jax(st, p):
    """JAX's results of every function check of p on its mesh."""
    mesh = st.make(st.dims)
    geo = p["geo"]
    kw = dict(box_size=BOX, ncell=geo["nc"], capacity=geo["cap"])
    out = {"plan": st.plan()}
    for name, (bpos, bmass) in p["accel"].items():
        if name == "seam":
            bpos = p["seam_unwrapped"]
        acc, dropped = st.fn("mesh_fast_accel")(
            jnp.asarray(bpos), jnp.asarray(bmass), mesh=mesh, ng=NG,
            margin=1, rs=geo["rs"], softening=SOFT, g_const=G, **kw)
        out.update({name: np.asarray(acc), f"{name}_dropped": int(dropped)})
    for name, c in p["rebucket"].items():
        r = st.fn("mesh_rebucket")(
            *(jnp.asarray(c[k]) for k in ("bpos", "bvel", "bmass", "ids",
                                          "acc")),
            mesh=mesh, mig_capacity=c["mig"], **kw)
        out.update({f"{name}_pos": np.asarray(r[0]),
                    f"{name}_vel": np.asarray(r[1]),
                    f"{name}_mass": np.asarray(r[2]),
                    f"{name}_ids": np.asarray(r[3]),
                    f"{name}_acc": np.asarray(r[4]),
                    f"{name}_overflow": int(r[5])})
    run = p["run"]
    fs, fkw = st.fn("initialize_mesh_fast")(
        jnp.asarray(run["pos"]), jnp.asarray(run["vel"]),
        jnp.asarray(run["mass"]), run["a"], mesh=mesh, box_size=BOX,
        pm_grid=NG, softening=SOFT, **RUN_KW)
    out.update(run_kw=fkw, run_init_acc=np.asarray(fs.acc),
               run_init_ids=np.asarray(fs.ids),
               run_init_dropped=int(fs.dropped),
               run_init_overflow=int(fs.overflow))
    end = st.fn("mesh_fast_run")(fs, CosmologyParams(), run["dt"], mesh=mesh,
                                 n_steps=run["steps"],
                                 rebucket_every=run["every"], **fkw)
    out.update(run_ids=np.asarray(end.ids), run_pos=np.asarray(end.bpos),
               run_vel=np.asarray(end.bvel), run_mass=np.asarray(end.bmass),
               run_step=int(end.step), run_a=float(end.scale_factor),
               run_overflow=int(end.overflow),
               run_dropped=int(end.dropped))
    # the regrowth's buckets: the raised state's live rows in slot order
    # (flatten_fast_state's), bucketed at the grown capacity
    ids0 = np.asarray(fs.ids)
    moved = ~np.isnan(run["blob"][..., 0])
    tight = np.where(moved[..., None], run["blob"], np.asarray(fs.bpos))
    live = ids0.reshape(-1) >= 0
    regrow = buckets(tight.reshape(-1, 3)[live],
                     np.zeros((int(live.sum()), 3), np.float32),
                     np.asarray(fs.bmass).reshape(-1)[live], geo["nc"],
                     run["regrow_cap"], st.order(geo["nc"]))
    # buckets() numbers the rows 0..n-1: map them back to the rows' ids
    rows_ids = ids0.reshape(-1)[live]
    out["regrow_ids"] = np.where(regrow[3] >= 0,
                                 rows_ids[np.maximum(regrow[3], 0)], -1)
    return out


def _jax_engines(p):
    """The JAX engine (on the mesh's virtual devices) on each config."""
    out = {}
    for name, d in p["engine"].items():
        s = p["states"][name]
        eng = jlc.SimulationEngine(jlc.SimulationConfig.from_dict(d))
        eng.initialize(state=make_state(s["pos"], s["vel"], s["mass"],
                                        scale_factor=s["a"]))
        kw = getattr(eng, "_fast_mesh_kw", None)
        out[f"{name}_fast_mesh"] = kw is not None
        out[f"{name}_grid"] = (bool(getattr(eng, "_fast_mesh_2d", False)),
                               bool(getattr(eng, "_fast_mesh_3d", False)))
        eng.run(num_steps=p["steps"][name])
        st = eng.state
        out.update({f"{name}_pos": np.asarray(st.positions),
                    f"{name}_vel": np.asarray(st.velocities),
                    f"{name}_mass": np.asarray(st.masses),
                    f"{name}_step": int(st.step)})
        if kw is not None:
            out.update({f"{name}_cap": kw["capacity"],
                        f"{name}_overflow": int(eng._fstate.overflow),
                        f"{name}_dropped": int(eng._fstate.dropped)})
    return out


def run_groups(tmp_path_factory, groups: dict):
    """{dims: (payload, JAX's results, each rank's results)} for
    groups {dims: engine?}: the ranks of every group start together and
    run while the JAX references are computed."""
    payloads = {d: payload(d, engine=e) for d, e in groups.items()}
    finish = {d: start_ranks("fast_mesh_nd", int(np.prod(d)),
                             tmp_path_factory.mktemp("g" + "x".join(
                                 map(str, d))), payloads[d])
              for d in groups}
    jax_out = {}
    with pytest.MonkeyPatch.context() as mp:
        for d in groups:
            st = Stepper(d)
            mp.setattr(st.mod, f"mesh_fast_accel{st.sfx}",
                       jax.jit(st.fn("mesh_fast_accel"),
                               static_argnames=ACCEL_ARGS))
            mp.setattr(st.mod, f"mesh_rebucket{st.sfx}",
                       jax.jit(st.fn("mesh_rebucket"),
                               static_argnames=REBUCKET_ARGS))
            jax_out[d] = _jax(st, payloads[d])
            if groups[d]:
                jax_out[d].update(_jax_engines(payloads[d]))
    return {d: (payloads[d], jax_out[d], finish[d]()) for d in groups}


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


# ---------------------------------------------------------------------------
# the checks (each test file parametrises them over its groups)
# ---------------------------------------------------------------------------

def check_accel(group, name):
    p, ref, res = group
    assert [r["rank"] for r in res] == list(range(len(res)))
    bmass = p["accel"][name][1]
    live = bmass > 0
    got = joined(res, name)
    assert all(r[f"{name}_dropped"] == ref[f"{name}_dropped"] for r in res)
    assert (ref[f"{name}_dropped"] > 0) == (name == "dropping")
    assert max_rel(got[live], ref[name][live]) <= 1e-5
    assert np.all(got[~live] == 0.0)
    assert np.all(np.isfinite(got))


def check_rebucket(group, name):
    p, ref, res = group
    for r in res:
        assert r[f"{name}_overflow"] == ref[f"{name}_overflow"]
    lossless = ref[f"{name}_overflow"] == 0
    assert lossless or name != "rebucket"
    assert not lossless or name != "rebucket_small"
    for k in ("ids", "pos", "vel", "mass", "acc"):
        np.testing.assert_array_equal(joined(res, f"{name}_{k}"),
                                      ref[f"{name}_{k}"])
    ids = ref[f"{name}_ids"]
    assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(N)) == lossless
    if lossless:
        # every row in its own cell's bucket (the JAX tests' check)
        nc = p["geo"]["nc"]
        cell = xmajor_cells(nc, Stepper(p["dims"]).order(nc))
        pos = joined(res, f"{name}_pos")
        home = np.clip(np.floor(pos / (BOX / nc)).astype(np.int64), 0, nc - 1)
        live = joined(res, f"{name}_mass") > 0
        assert np.all(np.all(home == cell[:, None, :], -1) | ~live)


def check_initialize(group):
    p, ref, res = group
    assert all(r["run_kw"] == ref["run_kw"] for r in res)
    np.testing.assert_array_equal(joined(res, "run_init_ids"),
                                  ref["run_init_ids"])
    live = ref["run_init_ids"] >= 0
    assert max_rel(joined(res, "run_init_acc")[live],
                   ref["run_init_acc"][live]) <= 1e-5
    assert all(r["run_init_dropped"] == ref["run_init_dropped"] == 0
               and r["run_init_overflow"] == ref["run_init_overflow"] == 0
               for r in res)


def check_run(group):
    p, ref, res = group
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


def check_overflow(group):
    """A rebucket that would lose rows raises BucketOverflowError before
    any step, carrying the state it was given; that state's live rows
    rebuilt at the grown capacity (the engine's plan_override route)
    lose nothing and fill JAX's slots."""
    p, ref, res = group
    assert p["run"]["n_moved"] > p["geo"]["cap"]
    assert all(r["raised"] == (0, True) for r in res)
    assert all(r["regrow_overflow"] == 0 and
               r["regrow_cap"] == p["run"]["regrow_cap"] for r in res)
    got = joined(res, "regrow_ids")
    np.testing.assert_array_equal(got, ref["regrow_ids"])
    assert np.array_equal(np.sort(got[got >= 0]), np.arange(N))


def check_engine(group, flags):
    """The engine on the mesh takes the stepper (`flags`: _fast_mesh_2d,
    _fast_mesh_3d) and tracks the JAX engine's: the state in id order,
    capacity, counters and steps."""
    p, ref, res = group
    name = "engine"
    got = res[0]
    for r in res[1:]:
        for k in ("pos", "vel", "mass"):
            np.testing.assert_array_equal(r[f"{name}_{k}"],
                                          got[f"{name}_{k}"])
    assert got[f"{name}_fast_mesh"] and ref[f"{name}_fast_mesh"]
    assert tuple(got[f"{name}_grid"]) == ref[f"{name}_grid"] == flags
    assert got[f"{name}_cap"] == ref[f"{name}_cap"]
    assert got[f"{name}_overflow"] == ref[f"{name}_overflow"] == 0
    assert got[f"{name}_dropped"] == ref[f"{name}_dropped"] == 0
    assert got[f"{name}_step"] == ref[f"{name}_step"] == STEPS
    np.testing.assert_array_equal(got[f"{name}_mass"], ref[f"{name}_mass"])
    assert periodic(got[f"{name}_pos"] - ref[f"{name}_pos"]).max() <= \
        1e-5 * BOX
    assert np.abs(got[f"{name}_vel"] - ref[f"{name}_vel"]).max() <= \
        1e-4 * np.abs(ref[f"{name}_vel"]).max()
    check_energies(got, name)


def check_energies(got, name):
    """The mesh engine's compute_energy (the ring's sharded_energy over
    the ranks) against the plain single-device sums of forces/direct on
    its gathered state, to 1e-6 (both sum the pairs in float64)."""
    import torch
    from lambda_cdm_tpu_torch.forces.direct import kinetic_energy, \
        potential_energy
    pos, vel, mass = (torch.as_tensor(got[f"{name}_{k}"])
                      for k in ("pos", "vel", "mass"))
    ke = float(kinetic_energy(vel, mass))
    pe = float(potential_energy(pos, mass, BOX, SOFT, G))
    assert ke > 0 and pe < 0
    assert abs(got[f"{name}_ke"] - ke) <= 1e-6 * ke
    assert abs(got[f"{name}_pe"] - pe) <= 1e-6 * abs(pe)


def check_plan_none(group):
    """PM 50 does not divide by the mesh axes' ranks: the stepper's plan
    is None, so the engine takes the stateless sharded TreePM (its PM
    solving the whole grid on every rank), as the JAX engine does. Its 2
    steps track the JAX engine's row for row (the same rows, masses
    exactly, positions 1e-5 of the box, velocities 1e-4 of the largest),
    and its energies the plain single-device sums."""
    p, ref, res = group
    name = "plan_none"
    assert Stepper(p["dims"]).plan(ng=50) is None
    assert not ref[f"{name}_fast_mesh"]
    got = res[0]
    for r in res:
        assert not r[f"{name}_fast_mesh"] and r[f"{name}_stateless"]
        for k in ("pos", "vel", "mass"):
            np.testing.assert_array_equal(r[f"{name}_{k}"],
                                          got[f"{name}_{k}"])
    assert got[f"{name}_step"] == ref[f"{name}_step"] == p["steps"][name]
    assert got[f"{name}_pos"].shape == ref[f"{name}_pos"].shape
    np.testing.assert_array_equal(got[f"{name}_mass"], ref[f"{name}_mass"])
    assert np.sum(ref[f"{name}_mass"] > 0) == N
    assert periodic(got[f"{name}_pos"] - ref[f"{name}_pos"]).max() <= \
        1e-5 * BOX
    assert np.abs(got[f"{name}_vel"] - ref[f"{name}_vel"]).max() <= \
        1e-4 * np.abs(ref[f"{name}_vel"]).max()
    check_energies(got, name)
