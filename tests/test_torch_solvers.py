"""The stateless force solvers of the PyTorch port against the JAX package:
the registry and its fallback chain, each built-in solver on one state,
the TreePM pieces, validate_force_accuracy, glass relaxation and the
EnergyMonitor. Inputs are made with numpy from a seed and handed to both
packages."""

import numpy as np
import pytest
import torch

from _torch_parity import fields, max_rel, nn, tt, uniform_particles

import jax
import jax.numpy as jnp

import lambda_cdm_tpu as jlc
import lambda_cdm_tpu.forces as jforces
from lambda_cdm_tpu.core.state import make_state as jmake_state
from lambda_cdm_tpu.forces import pm as jpm, treepm as jtreepm
from lambda_cdm_tpu.physics import initial_conditions as jic
import lambda_cdm_tpu_torch as tlc
import lambda_cdm_tpu_torch.forces as tforces
from lambda_cdm_tpu_torch import interop
from lambda_cdm_tpu_torch.forces import pm as tpm, treepm as ttreepm
from lambda_cdm_tpu_torch.physics import initial_conditions as tic

# float32 FFTs in two libraries and scatter-add deposits in another order:
# measured <= 2e-6 of the largest |a| for PM and TreePM; the direct sums
# agree to 3.4e-7 (tests/test_torch_direct.py)
TOL = 1e-5


def _configs(d):
    return jlc.SimulationConfig.from_dict(d), tlc.SimulationConfig.from_dict(d)


def _states(pos, m, vel=None):
    vel = np.zeros_like(pos) if vel is None else vel
    js = jmake_state(pos, vel, m, scale_factor=0.5)
    return js, interop.sim_state_from_arrays(fields(js), device="cpu")


def test_available_force_computers_equal():
    assert tforces.available_force_computers() == \
        jforces.available_force_computers() == \
        ["direct", "direct_reference", "pm", "treepm"]
    for n in (1000, 40_000, 300_000):
        assert tforces.select_optimal_method(n) == \
            jforces.select_optimal_method(n)
        assert tforces.get_recommended_parameters(n) == \
            jforces.get_recommended_parameters(n)


SOLVER_CASES = [("direct_reference", 40.0, 0), ("direct", 40.0, 0),
                ("pm", 40.0, 32), ("treepm", 40.0, 32),
                ("treepm", 40.0, 16)]


@pytest.mark.parametrize("kind,box,ng", SOLVER_CASES)
def test_solver_matches(kind, box, ng):
    """Each built-in on one state (1000 particles, masses 0.5-2); treepm
    on a 32^3 mesh (5^3 cells) and on a 16^3 mesh, where fewer than 3
    cells fit and it degrades to PM."""
    d = {"particles": {"num_particles": 1000, "box_size": box},
         "forces": {"type": kind, "pm_grid_size": ng,
                    "softening_length": 0.2, "force_kernel":
                    "modified_gravity", "modified_gravity_strength": 0.1},
         "units": {"system": "box", "G": 1.0}}
    jc, tc = _configs(d)
    pos, m = uniform_particles(1000, box, seed=11)
    js, ts = _states(pos, m)
    ref = jforces.create_force_computer(jc)(js)
    got = tforces.create_force_computer(tc)(ts)
    assert got.shape == (1000, 3) and got.device.type == "cpu"
    assert max_rel(got, ref) < TOL
    if kind == "treepm":
        plan = ttreepm.treepm_plan(1000, box, ng)
        assert plan == jtreepm.treepm_plan(1000, box, ng)
        assert plan["ncell"] == (5 if ng == 32 else 1)


def test_fallback_and_unknown():
    d = {"forces": {"type": "bogus", "fallback": "direct_reference"},
         "particles": {"num_particles": 64, "box_size": 10.0}}
    jc, tc = _configs(d)
    pos, m = uniform_particles(64, 10.0, seed=2)
    js, ts = _states(pos, m)
    ref = jforces.create_force_computer(jc)(js)
    got = tforces.create_force_computer(tc)(ts)
    assert max_rel(got, ref) < TOL
    for cfg, mod in ((jc, jforces), (tc, tforces)):
        cfg.forces.fallback = "also_bogus"
        with pytest.raises(KeyError, match="bogus"):
            mod.create_force_computer(cfg)


def test_register_and_load_plugin(monkeypatch):
    name = "zero_test_solver"
    try:
        @tforces.register_force_computer(name)
        def _build(config):
            return lambda st: torch.zeros_like(st.positions)
        assert name in tforces.available_force_computers()
        cfg = tlc.SimulationConfig()
        cfg.forces.type = name
        pos, m = uniform_particles(8, 10.0, seed=0)
        _, ts = _states(pos, m)
        assert torch.all(tforces.create_force_computer(cfg)(ts) == 0)
        # an importable module that registers nothing new
        monkeypatch.setenv("LCDM_FORCE_PLUGINS", "json:math")
        assert tforces.load_plugins_from_env() == []
    finally:
        tforces._REGISTRY.pop(name, None)


def test_pm_pieces():
    box, ng = 32.0, 16
    pos, m = uniform_particles(500, box, seed=4)
    field = np.random.default_rng(5).normal(size=(ng,) * 3).astype(
        np.float32)
    assert max_rel(tpm.cic_gather(tt(field), tt(pos), ng, box),
                   jpm.cic_gather(jnp.asarray(field), jnp.asarray(pos), ng,
                                  box)) < 1e-6
    assert max_rel(tpm.potential_grid(tt(pos), tt(m), ng, box, 2.0),
                   jpm.potential_grid(jnp.asarray(pos), jnp.asarray(m), ng,
                                      box, 2.0)) < TOL
    assert max_rel(tpm.pm_potential(tt(pos), tt(m), ng, box, 2.0),
                   jpm.pm_potential(jnp.asarray(pos), jnp.asarray(m), ng,
                                    box, 2.0)) < TOL
    split = tpm.pm_accelerations(tt(pos), tt(m), ng, box, split_scale=2.5)
    ref = jpm.pm_accelerations(jnp.asarray(pos), jnp.asarray(m), ng, box,
                               split_scale=2.5)
    assert max_rel(split, ref) < TOL


def test_short_range_pieces():
    """S(r), its polynomial, the lattice pass and the targets form."""
    r = np.linspace(0.0, 8.0, 301).astype(np.float32)
    # the degree-10 Horner sum cancels terms of ~1e2 in float32, and XLA
    # contracts it into FMAs: 6.5e-5 apart, inside the fit's own 5e-4
    for tf, jf, atol in ((ttreepm.short_range_factor,
                          jtreepm.short_range_factor, 2e-6),
                         (ttreepm.short_range_factor_poly,
                          jtreepm.short_range_factor_poly, 1e-4)):
        np.testing.assert_allclose(nn(tf(tt(r), 1.3)),
                                   np.asarray(jf(jnp.asarray(r), 1.3)),
                                   atol=atol)
    box, nc, cap = 30.0, 4, 48
    pos, m = uniform_particles(600, box, seed=6)
    jb = jtreepm.bucket_particles(jnp.asarray(pos), jnp.asarray(m), box,
                                  ncell=nc, capacity=cap)
    tb = ttreepm.bucket_particles(tt(pos), tt(m), box, ncell=nc,
                                  capacity=cap)
    assert int(tb[3]) == int(jb[3]) == 0
    kw = dict(ncell=nc, capacity=cap)
    for poly in (False, True):
        ref = jtreepm.short_range_bucketed(jb[0], jb[1], box, 2.0, 0.1,
                                           use_poly=poly, **kw)
        got = ttreepm.short_range_bucketed(tb[0], tb[1], box, 2.0, 0.1,
                                           use_poly=poly, **kw)
        live = nn(tb[1]) > 0
        assert max_rel(got, ref, live[..., None]) < TOL
    rows = np.nonzero(live.reshape(-1))[0][::7]
    soa = np.ascontiguousarray(np.moveaxis(np.asarray(jb[0]), -1, 0))
    ref = jtreepm.short_range_targets(jnp.asarray(soa), jb[1],
                                      jnp.asarray(rows, jnp.int32), box, 2.0,
                                      0.1, **kw)
    got = ttreepm.short_range_targets(tt(soa), tb[1], torch.as_tensor(rows),
                                      box, 2.0, 0.1, **kw)
    assert max_rel(got, ref) < TOL


def test_short_range_batches_alike(monkeypatch):
    """The x-slab batch size changes nothing: one slab a batch (as the JAX
    package scans) against all slabs at once."""
    box, nc, cap = 30.0, 4, 48
    pos, m = uniform_particles(600, box, seed=6)
    tb = ttreepm.bucket_particles(tt(pos), tt(m), box, ncell=nc,
                                  capacity=cap)
    whole = ttreepm.short_range_bucketed(tb[0], tb[1], box, 2.0, 0.1,
                                         ncell=nc, capacity=cap)
    monkeypatch.setattr(ttreepm, "PAIR_SLOT_BUDGET", 1)
    one = ttreepm.short_range_bucketed(tb[0], tb[1], box, 2.0, 0.1,
                                       ncell=nc, capacity=cap)
    assert torch.equal(one, whole)


def _engine_pair(d, pos, m, vel=None):
    jc, tc = _configs(d)
    js, ts = _states(pos, m, vel)
    jeng = jlc.SimulationBuilder().with_config(jc).with_initial_state(
        js).build()
    teng = tlc.SimulationBuilder(device="cpu").with_config(
        tc).with_initial_state(ts).build()
    return jeng, teng


@pytest.mark.parametrize("kind", ["pm", "direct"])
def test_validate_force_accuracy_matches(kind):
    """Same numbers on the same state, which holds only if both packages
    sampled the same 64 rows (the pm errors vary by row)."""
    box = 40.0
    d = {"particles": {"num_particles": 1000, "box_size": box},
         "forces": {"type": kind, "pm_grid_size": 16,
                    "softening_length": 0.2},
         "units": {"system": "box", "G": 1.0}}
    pos, m = uniform_particles(1000, box, seed=12)
    jeng, teng = _engine_pair(d, pos, m)
    jr = jeng.validate_force_accuracy(n_sample=64, seed=3)
    tr = teng.validate_force_accuracy(n_sample=64, seed=3)
    assert tr["n_sample"] == jr["n_sample"] == 64
    assert tr["solver"] == jr["solver"] == kind
    for key in ("avg_err", "max_err", "avg_rel_err", "max_rel_err"):
        if kind == "pm":
            assert tr[key] == pytest.approx(jr[key], rel=1e-4)
        else:              # both at float32 round-off: ~1e-7 of rms |a|
            assert tr[key] < 1e-5 and jr[key] < 1e-5
    assert teng.statistics.force_avg_err == tr["avg_err"]


def test_validate_forces_at_initialize():
    d = {"particles": {"num_particles": 512, "box_size": 40.0},
         "forces": {"type": "pm", "pm_grid_size": 16},
         "validation": {"validate_forces": True, "force_samples": 32},
         "units": {"system": "box", "G": 1.0}}
    pos, m = uniform_particles(512, 40.0, seed=13)
    jeng, teng = _engine_pair(d, pos, m)
    assert teng.statistics.force_avg_err > 0
    assert teng.statistics.force_avg_err == pytest.approx(
        jeng.statistics.force_avg_err, rel=1e-4)


def test_glass_relaxation_matches():
    """Both packages relax the same start positions (JAX's uniform draw
    handed over as numpy): positions to 1e-5 of the box after 5 steps."""
    n, box = 343, 20.0
    key = jax.random.PRNGKey(17)
    start = np.asarray(jax.random.uniform(key, (n, 3), minval=0.0,
                                          maxval=box))
    ref = np.asarray(jic.glass_positions(key, n, box, iterations=5))
    got = nn(tic.glass_relax(tt(start), box, iterations=5))
    d = (got - ref + box / 2) % box - box / 2
    assert np.abs(d).max() < 1e-5 * box
    moved = (ref - start + box / 2) % box - box / 2
    assert np.abs(moved).max() > 0.1 * box / 7    # mean spacing box / 7


def test_energy_monitor_matches():
    d = {"particles": {"num_particles": 512, "box_size": 40.0},
         "forces": {"type": "direct", "softening_length": 0.5},
         "cosmology": {"model": "Newtonian"},
         "time": {"initial_timestep": 0.05},
         "units": {"system": "box", "G": 1.0},
         "simulation": {"output_frequency": 5, "checkpoint_frequency": 0},
         "profiling": {"output_file": ""}}
    pos, m = uniform_particles(512, 40.0, seed=14)
    vel = np.random.default_rng(15).normal(0, 0.1, pos.shape).astype(
        np.float32)
    jeng, teng = _engine_pair(d, pos, m, vel)
    jmon, tmon = jlc.EnergyMonitor(), tlc.EnergyMonitor()
    jeng.add_observer(jmon)
    teng.add_observer(tmon)
    jeng.run(num_steps=10)
    teng.run(num_steps=10)
    assert [h["step"] for h in tmon.history] == \
        [h["step"] for h in jmon.history] == [5, 10]
    assert tmon.initial_energy == pytest.approx(jmon.initial_energy,
                                                rel=1e-5)
    for th, jh in zip(tmon.history, jmon.history):
        for k in ("kinetic", "potential", "total"):
            assert th[k] == pytest.approx(jh[k], rel=1e-5)
        assert abs(th["relative_error"] - jh["relative_error"]) < 1e-5
    assert teng.last_energy_error == tmon.history[-1]["relative_error"]
    assert tmon.history[-1]["relative_error"] > 0
