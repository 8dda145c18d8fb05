"""The treepm_fast slice at engine level: both packages' SimulationBuilder
from one config dict and one initial SimState, run through `run()`, with
the public SimState compared after the run -- a cosmological 2LPT start,
a collapsing start that forces grow-and-retry, a streaming start whose
drift guard shortens the rebucket cadence, and an infall that drops
deposits and halves it."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import fields, nn

import lambda_cdm_tpu as jlc
from lambda_cdm_tpu.core.state import make_state
from lambda_cdm_tpu.physics.initial_conditions import generate_state
import lambda_cdm_tpu_torch as tlc
from lambda_cdm_tpu_torch import interop


def _engines(cfg_dict, jstate, tweak=None):
    """(JAX engine, port engine) built from cfg_dict and the JAX state."""
    out = []
    for lc in (jlc, tlc):
        cfg = lc.SimulationConfig.from_dict(cfg_dict)
        if tweak:
            tweak(cfg)
        builder = lc.SimulationBuilder() if lc is jlc else \
            lc.SimulationBuilder(device="cpu")
        st = jstate if lc is jlc else \
            interop.sim_state_from_arrays(fields(jstate), device="cpu")
        out.append(builder.with_config(cfg).with_initial_state(st).build())
    return out


def _public(eng):
    st = eng.state
    return {f.name: nn(getattr(st, f.name))
            for f in dataclasses.fields(st) if f.name != "rng_key"}


def _collapse_dict(n, box, rebucket_every):
    return {
        "particles": {"num_particles": n, "box_size": box},
        "forces": {"type": "treepm_fast", "pm_grid_size": 24,
                   "softening_length": 1.0,
                   "rebucket_every": rebucket_every},
        "cosmology": {"model": "Newtonian", "final_redshift": -0.5},
        "time": {"initial_timestep": 1.0, "final_time": 1e9},
        "units": {"system": "box", "G": 1e-8},
        "simulation": {"output_frequency": 16, "checkpoint_frequency": 0},
        "profiling": {"output_file": ""},
        "logging": {"performance_logging": False},
    }


def test_cosmological_run_matches():
    """2LPT start at z=9, 8 steps in chunks of 4 with a rebucket every 4
    and the adaptive timestep (max_dloga): measured positions 4.1e-7 of
    the box, velocities 8.1e-5 of the largest, dt identical."""
    box = 37.5
    d = {"particles": {"num_particles": 12 ** 3, "box_size": box},
         "forces": {"type": "treepm_fast", "pm_grid_size": 24,
                    "softening_length": 0.05, "rebucket_every": 4},
         "cosmology": {"initial_redshift": 9.0},
         "time": {"initial_timestep": 2e-5},
         "integration": {"max_dloga": 0.02},
         "simulation": {"output_frequency": 4, "checkpoint_frequency": 0},
         "profiling": {"output_file": ""},
         "logging": {"performance_logging": False}}

    def ics(cfg):
        ic = cfg.particles.initial_conditions
        ic.type, ic.grid_size, ic.random_seed = "2lpt", 12, 21

    cfg = jlc.SimulationConfig.from_dict(d)
    ics(cfg)
    jstate = generate_state(cfg)
    jeng, teng = _engines(d, jstate, ics)
    assert teng._fast_kw["capacity"] == jeng._fast_kw["capacity"]
    jeng.run(num_steps=8)
    teng.run(num_steps=8)
    j, t = _public(jeng), _public(teng)
    dpos = (t["positions"] - j["positions"] + box / 2) % box - box / 2
    assert np.abs(dpos).max() < 1e-5 * box
    assert bool(np.all((t["positions"] >= 0) & (t["positions"] < box)))
    vscale = np.abs(j["velocities"]).max()
    assert np.abs(t["velocities"] - j["velocities"]).max() / vscale < 1e-3
    np.testing.assert_array_equal(t["masses"], j["masses"])
    assert t["scale_factor"] == pytest.approx(j["scale_factor"], rel=1e-6)
    assert int(t["step"]) == int(j["step"]) == 8
    assert teng.statistics.total_steps == jeng.statistics.total_steps
    assert teng._fast_since_rebucket == jeng._fast_since_rebucket
    assert int(teng._fstate.dropped) == int(jeng._fstate.dropped) == 0
    # max_dloga engages the adaptive limiter (expansion-limited here)
    assert float(teng._dt) < 2e-5
    assert float(teng._dt) == pytest.approx(float(jeng._dt), rel=1e-6)


def test_grow_and_retry_matches():
    """Everything collapses onto the box centre within ~8 steps: the
    rebucket overflows the planned capacity, both engines re-plan with the
    same doubled capacity and lose no particle."""
    n, box = 600, 30.0
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.0, box, (n, 3)).astype(np.float32)
    vel = ((box / 2.0 - pos) * 0.118).astype(np.float32)
    jstate = make_state(pos, vel, np.full(n, 1e-6, np.float32),
                        scale_factor=1.0)
    jeng, teng = _engines(_collapse_dict(n, box, 8), jstate)
    cap0 = jeng._fast_kw["capacity"]
    assert teng._fast_kw == jeng._fast_kw
    jeng.run(num_steps=16)
    teng.run(num_steps=16)
    assert teng._fast_kw["capacity"] == jeng._fast_kw["capacity"] > cap0
    assert teng._fast_kw == jeng._fast_kw         # the variant switch too
    j, t = _public(jeng), _public(teng)
    assert int((t["masses"] > 0).sum()) == n
    np.testing.assert_array_equal(t["masses"], j["masses"])
    dpos = (t["positions"] - j["positions"] + box / 2) % box - box / 2
    assert np.abs(dpos).max() < 1e-5 * box
    np.testing.assert_allclose(t["velocities"], j["velocities"],
                               atol=1e-5 * np.abs(j["velocities"]).max())
    assert int(teng._fstate.overflow) == int(jeng._fstate.overflow)
    assert int(teng._fstate.dropped) == int(jeng._fstate.dropped)
    assert int(t["step"]) == int(j["step"]) == 16


def test_drift_guard_matches():
    """Uniform streaming of ~0.6 PM cells a step would drift past the
    deposit margin within a 16-step segment: both engines' proactive drift
    guard shortens the rebucket cadence alike, so neither drops a
    deposit."""
    n, box = 512, 32.0
    rng = np.random.default_rng(9)
    pos = rng.uniform(0.0, box, (n, 3)).astype(np.float32)
    vel = np.tile(np.asarray([[0.8, 0.3, 0.0]], np.float32), (n, 1))
    jstate = make_state(pos, vel, np.full(n, 1e-6, np.float32),
                        scale_factor=1.0)
    jeng, teng = _engines(_collapse_dict(n, box, 16), jstate)
    for _ in range(2):
        jeng.run(num_steps=16)
        teng.run(num_steps=16)
        assert teng._fast_since_rebucket == jeng._fast_since_rebucket
        assert int(teng._fstate.dropped) == int(jeng._fstate.dropped) == 0
    dpos = (_public(teng)["positions"] - _public(jeng)["positions"]
            + box / 2) % box - box / 2
    assert np.abs(dpos).max() < 1e-5 * box


def test_drops_halve_the_cadence_alike():
    """Test particles falling from rest onto one heavy point mass: at the
    chunk's start no particle moves, so the drift guard cannot bound the
    cadence; 43 deposits drop in both packages and both halve the cadence
    to 8. (Positions are not compared: close passes by the point mass
    amplify the two force splits' 4e-4 difference.)"""
    n, box = 512, 32.0
    rng = np.random.default_rng(9)
    pos = rng.uniform(0.0, box, (n, 3)).astype(np.float32)
    pos[0] = box / 2
    mass = np.full(n, 1e-6, np.float32)
    mass[0] = 1.0
    jstate = make_state(pos, np.zeros_like(pos), mass, scale_factor=1.0)
    d = _collapse_dict(n, box, 16)
    d["units"]["G"] = 1.0
    jeng, teng = _engines(d, jstate)
    jeng.run(num_steps=16)
    teng.run(num_steps=16)
    assert int(teng._fstate.dropped) == int(jeng._fstate.dropped) > 0
    assert teng._fast_rebucket_every == jeng._fast_rebucket_every == 8


def test_builder_device_and_refusals(tmp_path):
    """The builder defaults to the card; the stateless solvers initialize
    and step on the CPU (their parity with the JAX engine is
    test_stateless_run_matches); pm_fast runs as the JAX engine does
    (_check_pm_fast_run); warmup needs initialize() first, as the JAX
    engine's does; the orbax form round-trips through the engine; a
    mesh config at world size 1 runs on one device, as the JAX engine
    does on one device, and the mesh configs this port does not cover
    (treepm_fast, the shx/shy axes) raise."""
    cfg = tlc.SimulationConfig()
    cfg.forces.type = "treepm_fast"
    b = tlc.SimulationBuilder()
    assert b._device == "cuda"
    eng = tlc.SimulationEngine(cfg, device="cpu")
    assert eng.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        eng.validate_force_accuracy()
    for kind in ("direct", "pm", "treepm"):
        c = tlc.SimulationConfig.from_dict(
            {"particles": {"num_particles": 512, "box_size": 64.0},
             "forces": {"type": kind, "pm_grid_size": 16}})
        c.particles.initial_conditions.grid_size = 8
        e = tlc.SimulationEngine(c, device="cpu")
        e.initialize()
        assert e.accel_fn is not None and e._fstate is None
        e.step(2)
        assert int(e.state.step) == 2 and e._acc.shape == (512, 3)
        assert e.validate_force_accuracy(n_sample=16)["n_sample"] == 16
    _check_pm_fast_run()
    with pytest.raises(RuntimeError, match="initialize"):
        eng.warmup()
    with pytest.raises(RuntimeError, match="not initialized"):
        eng.compute_energy()
    e.config.io.output_format = "orbax"
    out = e.save_checkpoint(str(tmp_path / "x"))
    assert out.endswith("step_00000002")
    fresh = tlc.SimulationEngine(e.config, device="cpu")
    fresh.load_checkpoint(str(tmp_path / "x"))
    assert int(fresh.state.step) == 2
    assert torch.equal(fresh.state.positions, e.state.positions)
    # treepm_fast where the JAX engine takes its pencil or block fast
    # stepper refuses on any number of ranks
    for axes in ({"shx": 2, "shy": 4}, {"shx": 2, "shy": 2, "shz": 2}):
        c = tlc.SimulationConfig()
        c.forces.type = "treepm_fast"
        c.compute.mesh.enabled = True
        c.compute.mesh.axes = axes
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlc.SimulationEngine(c, device="cpu").initialize()
    # every other mesh config runs (treepm_fast on the slab mesh: the
    # sharded fast stepper on ranks); on one rank, single-device
    for kind, axes in (("direct", None), ("treepm", None),
                       ("direct", {"shx": 2, "shy": 4}),
                       ("pm_fast", {"shx": 2, "shy": 2, "shz": 2}),
                       ("treepm_fast", {"shz": 4}), ("treepm_fast", None),
                       ("treepm_fast", {"shx": 2})):
        c = tlc.SimulationConfig.from_dict(
            {"particles": {"num_particles": 512, "box_size": 64.0},
             "forces": {"type": kind, "softening_length": 0.5,
                        "pm_grid_size": 32},
             "compute": {"mesh": {"enabled": True}}})
        if axes:
            c.compute.mesh.axes = axes
        c.particles.initial_conditions.grid_size = 8
        e = tlc.SimulationEngine(c, device="cpu")
        e.initialize()
        assert e._mesh is None and e.state.positions.shape == (512, 3)
        e.step(1)


def _check_pm_fast_run():
    """forces.type="pm_fast" (the persistent-bucket stepper with the
    unsplit PM alone) on a 12^3 2LPT start at z=9, 8 steps in chunks of 4
    with a rebucket every 4, against the JAX engine: positions to 1e-5 of
    the box, velocities to 1e-4 of the largest (the stateless runs' bars:
    no short-range split lies between the packages here), then
    validate_force_accuracy through the stateless pm solver."""
    box = 37.5
    d = {"particles": {"num_particles": 12 ** 3, "box_size": box},
         "forces": {"type": "pm_fast", "pm_grid_size": 24,
                    "softening_length": 0.05, "rebucket_every": 4},
         "cosmology": {"initial_redshift": 9.0},
         "time": {"initial_timestep": 2e-5},
         "simulation": {"output_frequency": 4, "checkpoint_frequency": 0},
         "profiling": {"output_file": ""},
         "logging": {"performance_logging": False}}

    def ics(cfg):
        ic = cfg.particles.initial_conditions
        ic.type, ic.grid_size, ic.random_seed = "2lpt", 12, 23

    cfg = jlc.SimulationConfig.from_dict(d)
    ics(cfg)
    jeng, teng = _engines(d, generate_state(cfg), ics)
    assert teng._fast_kw == jeng._fast_kw and teng._fast_kw["pm_only"]
    jeng.run(num_steps=8)
    teng.run(num_steps=8)
    j, t = _public(jeng), _public(teng)
    dpos = (t["positions"] - j["positions"] + box / 2) % box - box / 2
    assert np.abs(dpos).max() < 1e-5 * box
    vscale = np.abs(j["velocities"]).max()
    assert np.abs(t["velocities"] - j["velocities"]).max() / vscale < 1e-4
    assert int(t["step"]) == int(j["step"]) == 8
    assert int(teng._fstate.dropped) == int(jeng._fstate.dropped) == 0
    res = teng.validate_force_accuracy(n_sample=64)
    assert res["solver"] == "pm" and res["n_sample"] == 64


def test_observers_fire():
    n, box = 512, 32.0
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.0, box, (n, 3)).astype(np.float32)
    st = tlc.make_state(pos, np.zeros_like(pos), np.full(n, 1e-6),
                        scale_factor=1.0)
    cfg = tlc.SimulationConfig.from_dict(_collapse_dict(n, box, 4))
    cfg.simulation.output_frequency = 4
    rec = tlc.MetricsRecorder()
    eng = (tlc.SimulationBuilder(device="cpu").with_config(cfg)
           .with_initial_state(st).with_observer(rec).build())
    eng.run(num_steps=8)
    assert [r["step"] for r in rec.records] == [4, 8]
    assert eng.lifecycle == tlc.LifecycleState.FINISHED
    assert eng.statistics.total_steps == 8
    assert "run.chunk" in eng.profiler.summary()


def _stateless_dict(kind, adaptive=False):
    d = {"particles": {"num_particles": 512, "box_size": 64.0},
         "forces": {"type": kind, "pm_grid_size": 32,
                    "softening_length": 0.2},
         "cosmology": {"initial_redshift": 9.0},
         "time": {"initial_timestep": 2e-4},
         "simulation": {"output_frequency": 5, "checkpoint_frequency": 0},
         "profiling": {"output_file": ""},
         "logging": {"performance_logging": False}}
    if adaptive:
        d["integration"] = {"adaptive_timestep": True, "max_dloga": 0.01}
    return d


@pytest.mark.parametrize("kind,adaptive", [
    ("direct", False), ("direct", True), ("pm", False), ("treepm", False)])
def test_stateless_run_matches(kind, adaptive):
    """A 2LPT start at z=9 (512 particles, 64 Mpc/h), 20 fused KDK steps
    in chunks of 5 through run(): positions to 1e-5 of the box, velocities
    to 1e-4 of the largest, the scale factor and (adaptive) dt to 1e-6.
    treepm runs on 5^3 cells of a 32^3 mesh."""
    d = _stateless_dict(kind, adaptive)

    def ics(cfg):
        ic = cfg.particles.initial_conditions
        ic.type, ic.grid_size, ic.random_seed = "2lpt", 16, 31

    cfg = jlc.SimulationConfig.from_dict(d)
    ics(cfg)
    jstate = generate_state(cfg)
    jeng, teng = _engines(d, jstate, ics)
    jeng.run(num_steps=20)
    teng.run(num_steps=20)
    j, t = _public(jeng), _public(teng)
    box = d["particles"]["box_size"]
    dpos = (t["positions"] - j["positions"] + box / 2) % box - box / 2
    assert np.abs(dpos).max() < 1e-5 * box
    vscale = np.abs(j["velocities"]).max()
    assert np.abs(t["velocities"] - j["velocities"]).max() / vscale < 1e-4
    assert t["scale_factor"] == pytest.approx(j["scale_factor"], rel=1e-6)
    assert t["time"] == pytest.approx(j["time"], rel=1e-6)
    assert int(t["step"]) == int(j["step"]) == 20
    assert teng.statistics.total_steps == jeng.statistics.total_steps == 20
    assert float(teng._dt) == pytest.approx(float(jeng._dt), rel=1e-6)
    if adaptive:
        assert float(teng._dt) < 2e-4
    # the cached acceleration is the solver's at the final positions
    acc = teng.accel_fn(teng.state)
    assert float((acc - teng._acc).abs().max()) <= 1e-6 * float(
        acc.abs().max())
