"""The plain reference against the port's CPU path at a tiny size, the
control's separation, and the inputs (deterministic, and the same work
for every seed)."""

import json
import math
import shutil

import numpy as np
import pytest
import torch

from nbody_bench import harness, inputs, reference


def _tiny_state(tiny_dir, traffic, seed=3, config="tiny"):
    cell = harness.Cell(f"{config}.{traffic}", root=tiny_dir,
                        bench_dir=tiny_dir)
    st = inputs.start_state(cell.config, cell.traffic, seed, "cpu",
                            cache="")
    mass = torch.full((cell.n,), st["mass"])
    return cell, st, mass


def _port_forces(cell, st, mass, pm_only=False):
    """The port's treepm_fast (pm_fast with `pm_only`) forces (its CPU
    plain path) on the state, in particle order."""
    from lambda_cdm_tpu_torch.ops.fast_treepm import initialize_fast
    g = cell.geometry
    f = cell.config["forces"]
    fs, kw = initialize_fast(
        st["pos"], st["vel"], mass, st["a"], box_size=g["box"],
        pm_grid=g["ng"], softening=g["softening"], g_const=g["g_const"],
        split_factor=f["split_factor"], cut_factor=f["cut_factor"],
        capacity=f["bucket_capacity"], kick_mode="comoving",
        pm_only=pm_only)
    ids = fs.ids.reshape(-1)
    acc = fs.acc.reshape(3, -1).T
    out = torch.zeros((cell.n, 3))
    out[ids[ids >= 0].long()] = acc[ids >= 0]
    return out, fs, kw


def _stateless_pm_forces(cell, st, mass):
    """The port's stateless PM (forces.type pm, its CPU path)."""
    from lambda_cdm_tpu_torch.forces.pm import pm_accelerations
    g = cell.geometry
    return pm_accelerations(st["pos"], mass, g["ng"], g["box"],
                            g["g_const"])


@pytest.mark.parametrize("config, traffic, law", [
    pytest.param("tiny", "early", "treepm_fast", id="early"),
    pytest.param("tiny", "late", "treepm_fast", id="late"),
    pytest.param("tiny_pm", "late", "pm", id="pm.late"),
    pytest.param("tiny", "late", "pm_fast", id="pm_fast.late")])
def test_reference_matches_the_ports_cpu_path(tiny_dir, config, traffic,
                                              law):
    """Each law against the port's path that runs it: treepm_fast and
    pm_fast (ops/fast_treepm, pm_only) on the tiny cut, pm
    (forces/pm.pm_accelerations) on its forces.type pm twin."""
    cell, st, mass = _tiny_state(tiny_dir, traffic, config=config)
    if law == "pm":
        port = _stateless_pm_forces(cell, st, mass)
    else:
        port, _, _ = _port_forces(cell, st, mass, pm_only=law == "pm_fast")
    geometry = dict(cell.geometry, law=law)
    targets = torch.arange(cell.n)
    ref = reference.forces(st["pos"], mass, targets, geometry=geometry)
    scale = torch.sqrt(torch.mean(torch.sum(ref * ref, dim=1)))
    gap = torch.max(torch.linalg.norm(port.double() - ref, dim=1)) / scale
    assert float(gap) < 2e-5
    # the TF32 control reads two orders of magnitude further off
    low = reference.forces(st["pos"], mass, targets, geometry=geometry,
                           precision="tf32")
    gap_low = torch.max(torch.linalg.norm(low.double() - ref, dim=1)) / scale
    assert float(gap_low) > 100 * float(gap)


@pytest.mark.parametrize("forces", [
    {"type": "direct"}, {"type": "treepm"}, {"type": "pm_fast",
                                             "gradient": "spectral"},
    {"type": "pm", "modified_gravity_strength": 0.1}])
def test_a_configuration_without_a_law_is_refused(tiny_dir, tmp_path,
                                                   forces):
    """Cell refuses, when it loads, a configuration whose forces.type the
    reference states no law for: it is never checked against another's."""
    bench = tmp_path / "bench"
    shutil.copytree(tiny_dir, bench)
    path = bench / "configs" / "tiny_pm.json"
    cfg = json.loads(path.read_text())
    cfg["forces"].update(forces)
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="no law"):
        harness.Cell("tiny_pm.late", root=str(bench), bench_dir=str(bench))


def test_split_fit_and_cells_are_the_ports(tiny_dir):
    from lambda_cdm_tpu_torch.ops.short_range import _poly_even_coeffs
    for rs in (0.6510416666666666, 1.25):
        coeffs, v_scale, c1 = _poly_even_coeffs(rs)
        assert reference.even_split(rs) == (tuple(coeffs), v_scale, c1)
    cell, st, mass = _tiny_state(tiny_dir, "late")
    _, fs, kw = _port_forces(cell, st, mass)
    slot_cell = torch.arange(fs.ids.numel()) // fs.ids.shape[1]
    ids = fs.ids.reshape(-1)
    port_cell = torch.empty(cell.n, dtype=torch.int64)
    port_cell[ids[ids >= 0].long()] = slot_cell[ids >= 0]
    got = reference.cell_ids(st["pos"], cell.geometry["box"], kw["ncell"])
    assert torch.equal(got, port_cell)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0e-5])
    y = reference.tf32(x)
    assert y[0] == 1.0 and y[2] == x[2]
    assert y[1] in (1.0, 1.0 + 2.0 ** -10)
    assert abs(float(y[3] / x[3]) - 1.0) <= 2.0 ** -11


def test_kdk_is_the_comoving_kick_drift_kick():
    a0, dt = 0.5, 1e-3
    acc = torch.ones(1, 3, dtype=torch.float64)
    v0 = torch.full((1, 3), 2.0, dtype=torch.float64)
    kick, drift = reference.kdk(acc, acc, v0, a0=a0, dt=dt, omega_m=0.31,
                                omega_lambda=0.69)
    # a over each half step, da/dt = a 100 E(a), in many small Euler steps
    def advance(a, t, n=200000):
        for _ in range(n):
            a += t / n * a * 100 * math.sqrt(0.31 / a ** 3 + 0.69)
        return a
    a_half = advance(a0, 0.5 * dt)
    a1 = advance(a_half, 0.5 * dt)
    assert float(kick[0, 0]) == pytest.approx(0.5 * dt * (1 / a0 + 1 / a1),
                                              rel=1e-6)
    want = (2.0 + 0.5 * dt / a0) * dt / a_half ** 2
    assert float(drift[0, 0]) == pytest.approx(want, rel=1e-6)
    _, long = reference.kdk(acc, acc, v0, a0=a0, dt=dt, omega_m=0.31,
                            omega_lambda=0.69, drift_scale=1.01)
    assert float(long[0, 0]) == pytest.approx(1.01 * want, rel=1e-6)


def test_inputs_are_deterministic_and_the_seed_reorders_the_same_work(
        tiny_dir):
    cell = harness.Cell("tiny.late", root=tiny_dir, bench_dir=tiny_dir)
    a = inputs.start_state(cell.config, cell.traffic, 5, "cpu", cache="")
    b = inputs.start_state(cell.config, cell.traffic, 5, "cpu", cache="")
    c = inputs.start_state(cell.config, cell.traffic, 2 ** 31 + 11, "cpu",
                           cache="")
    assert torch.equal(a["pos"], b["pos"]) and torch.equal(a["vel"],
                                                           b["vel"])
    assert not torch.equal(a["pos"], c["pos"])
    assert a["dt"] == c["dt"] and a["a"] == c["a"]
    # a signed axis permutation maps every cubic grid onto itself
    for ncell in (3, 4, 5):
        occ = [np.sort(torch.bincount(reference.cell_ids(
            s["pos"], cell.geometry["box"], ncell),
            minlength=ncell ** 3).numpy()) for s in (a, c)]
        assert np.abs(occ[0] - occ[1]).sum() <= 2
    # speeds are a property of the state, not of its orientation
    va = np.sort(torch.linalg.norm(a["vel"], dim=1).numpy())
    vc = np.sort(torch.linalg.norm(c["vel"], dim=1).numpy())
    np.testing.assert_allclose(va, vc, rtol=1e-6)


def test_the_state_is_made_once_and_then_read_from_the_cache(tiny_dir,
                                                             tmp_path):
    cell = harness.Cell("tiny.late", root=tiny_dir, bench_dir=tiny_dir)
    made = inputs.start_state(cell.config, cell.traffic, 5, "cpu",
                              cache=str(tmp_path))
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".pt"
    read = inputs.start_state(cell.config, cell.traffic, 5, "cpu",
                              cache=str(tmp_path))
    assert torch.equal(made["pos"], read["pos"])
    assert torch.equal(made["vel"], read["vel"])
    assert (made["a"], made["dt"]) == (read["a"], read["dt"])
    # another traffic is another file
    other = dict(cell.traffic, realisation=8)
    inputs.start_state(cell.config, other, 5, "cpu", cache=str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 2


@pytest.mark.parametrize("traffic", ["early", "late"])
def test_the_step_rule_is_the_ports(tiny_dir, traffic):
    """The rule's dt at the start state, with |a|max from the reference,
    is the one the port's adaptive_dt takes from its own forces (every
    particle of the tiny cell is in the rule's sample)."""
    from lambda_cdm_tpu_torch.physics.integrators import (adaptive_dt,
                                                          hubble_internal)
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    cell, st, mass = _tiny_state(tiny_dir, traffic)
    port, _, _ = _port_forces(cell, st, mass)
    c = cell.config
    h = hubble_internal(CosmologyParams(omega_m=c["cosmology"]["omega_m"],
                                        omega_lambda=c["cosmology"][
                                            "omega_lambda"]),
                        st["a"], 100.0)
    want = adaptive_dt(port, c["forces"]["softening_length"],
                       c["time"]["initial_timestep"],
                       c["integration"]["min_timestep"],
                       c["integration"]["max_timestep"], hubble=h,
                       max_dloga=c["integration"]["max_dloga"])
    assert st["dt"] == pytest.approx(float(want), rel=1e-5)
