"""The port's example scripts (lambda_cdm_tpu_torch/examples) on the CPU
at reduced sizes, held against the JAX package's examples/: the JAX script
run in-process at the same size (its printed numbers parsed) where its
command line sets the size (basic_simulation through a config file,
nbody_benchmark, solver_accuracy, cosmology_tables, multichip_demo,
pencil2d_demo and mesh3d_demo on the conftest's 8 virtual devices against
8 spawned gloo ranks), otherwise the
JAX functions the script calls, at the port's reduced size
(twolpt_comparison, zeldovich_demo, lensing_demo).

Bars: a printed number may differ by one unit of its last printed digit
plus 1e-4 of itself (float32 arithmetic in another order); numbers taken
from a short run, 1e-3 (positions after the run differ at ~1e-6).
"""

import json
import os
import re
import runpy
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NUM = re.compile(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?")


def _tokens(text: str) -> list:
    """(value, unit of the last printed digit) of every decimal number."""
    out = []
    for tok in _NUM.findall(text):
        mant = tok.split("e")[0]
        unit = 10.0 ** -len(mant.split(".")[1])
        if "e" in tok:
            unit *= 10.0 ** int(tok.split("e")[1])
        out.append((float(tok), unit))
    return out


def _same_printout(got: str, ref: str, rel: float = 1e-4) -> None:
    a, b = _tokens(got), _tokens(ref)
    assert len(a) == len(b) > 0
    for (x, ux), (y, uy) in zip(a, b):
        assert abs(x - y) <= max(ux, uy) + rel * abs(y), (x, y)


def _run_jax(capsys, monkeypatch, name: str, *argv) -> str:
    """The JAX example's stdout, run in-process with `argv`."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path, *argv])
    capsys.readouterr()
    runpy.run_path(path, run_name="__main__")
    return capsys.readouterr().out


def _run_port(capsys, name: str, *argv):
    """(the port example's stdout, its returned numbers)."""
    import importlib
    mod = importlib.import_module(f"lambda_cdm_tpu_torch.examples.{name}")
    capsys.readouterr()
    out = mod.main([*argv, "--device", "cpu"])
    return capsys.readouterr().out, out


def _lines(text: str, word: str) -> str:
    return "\n".join(line for line in text.splitlines() if word in line)


def test_cosmology_tables(capsys, monkeypatch):
    ref = _run_jax(capsys, monkeypatch, "cosmology_tables")
    got, _ = _run_port(capsys, "cosmology_tables")
    _same_printout(got, ref)


def test_basic_simulation(capsys, monkeypatch, tmp_path):
    """Both scripts on one small config file (512 particles, TreePM on
    16^3, 60 steps): the same last P(k) table."""
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps({
        "particles": {"num_particles": 512, "box_size": 50.0},
        "forces": {"type": "treepm", "pm_grid_size": 16,
                   "softening_length": 0.2},
        "cosmology": {"initial_redshift": 49.0, "final_redshift": 20.0},
        "time": {"initial_timestep": 1e-6},
        "simulation": {"output_frequency": 10},
        "profiling": {"output_file": ""}}))
    ref = _run_jax(capsys, monkeypatch, "basic_simulation", str(cfg))
    got, out = _run_port(capsys, "basic_simulation", str(cfg))
    assert len(out["pk"]) > 3
    _same_printout(_lines(got, "k=") + _lines(got, "P(k) at"),
                   _lines(ref, "k=") + _lines(ref, "P(k) at"), rel=1e-3)


def test_nbody_benchmark(capsys, monkeypatch):
    ref = _run_jax(capsys, monkeypatch, "nbody_benchmark", "512", "10")
    got, out = _run_port(capsys, "nbody_benchmark", "512", "10")
    drift = float(re.search(r"energy drift: (\S+)", ref).group(1))
    assert out["n"] == 512 and out["steps"] == 10
    assert abs(out["drift"] - drift) <= 1e-6
    assert ("PASS" in got) == ("PASS" in ref)


def test_solver_accuracy(capsys, monkeypatch):
    """N = 2048: the same error table against direct summation; the
    port's Ewald line agrees with its min-image note (TreePM closer to
    Ewald than the min-image oracle is)."""
    ref = _run_jax(capsys, monkeypatch, "solver_accuracy", "2048")
    got, out = _run_port(capsys, "solver_accuracy", "2048",
                         "--ewald-targets", "64")
    pat = re.compile(r"^(\S+): .* rel err avg (\S+) max (\S+)$", re.M)
    ref_err = {m[0]: (float(m[1]), float(m[2])) for m in pat.findall(ref)}
    got_err = {m[0]: (float(m[1]), float(m[2])) for m in pat.findall(got)}
    assert got_err.keys() == ref_err.keys() == out["solvers"].keys()
    for k, (avg, mx) in ref_err.items():
        assert abs(got_err[k][0] - avg) <= 1e-4 + 1e-3 * avg
        assert abs(got_err[k][1] - mx) <= 1e-4 + 1e-3 * mx
    assert out["solvers"]["treepm(ng=64)"]["ewald_avg"] < \
        out["minimage_vs_ewald"]


def test_multichip_demo(capsys, monkeypatch):
    """The JAX demo on the 8 virtual devices, the port's on 8 spawned
    gloo ranks: the same migrations, imbalance and final energies."""
    assert len(jax.devices()) == 8
    ref = _run_jax(capsys, monkeypatch, "multichip_demo")
    _, out = _run_port(capsys, "multichip_demo", "--ranks", "8")
    mig = re.findall(r"step (\d+): migrated \(overflow=(\d+)\), load "
                     r"imbalance (\S+)", ref)
    assert [(m["step"], m["overflow"]) for m in out["migrations"]] == \
        [(int(s), int(o)) for s, o, _ in mig]
    for m, (_, _, imb) in zip(out["migrations"], mig):
        assert abs(m["imbalance"] - float(imb)) <= 1e-3
    ke, pe = re.search(r"KE=(\S+) PE=(\S+)", ref).groups()
    assert out["kinetic"] == pytest.approx(float(ke), rel=1e-3)
    assert out["potential"] == pytest.approx(float(pe), rel=1e-3)
    assert out["live"] == 512 * 8 and out["transport"] == "gloo"


def _run_jax_jitted(capsys, monkeypatch, name: str) -> str:
    """The JAX example's stdout with its mesh steppers' shard_map functions
    under jax.jit (called eagerly, they compile again at every call),
    patched into their modules for the script's references."""
    from lambda_cdm_tpu.parallel import fast_mesh2d, fast_mesh3d
    accel = ("mesh", "box_size", "ng", "ncell", "capacity", "margin", "rs",
             "softening", "g_const")
    rebucket = ("mesh", "box_size", "ncell", "capacity", "mig_capacity")
    for mod, sfx in ((fast_mesh2d, "2d"), (fast_mesh3d, "3d")):
        monkeypatch.setattr(mod, f"mesh_fast_accel{sfx}", jax.jit(
            getattr(mod, f"mesh_fast_accel{sfx}"), static_argnames=accel))
        monkeypatch.setattr(mod, f"mesh_rebucket{sfx}", jax.jit(
            getattr(mod, f"mesh_rebucket{sfx}"), static_argnames=rebucket))
    return _run_jax(capsys, monkeypatch, name)


def test_pencil2d_demo(capsys, monkeypatch):
    """The JAX demo on the 8 virtual devices ((2, 4)), the port's on 8
    spawned gloo ranks: the same plan, steps, scale factor, overflow and
    dropped counts of the direct run and the engine's steps and scale
    factor (the engine on the pencil stepper)."""
    ref = _run_jax_jitted(capsys, monkeypatch, "pencil2d_demo")
    _, out = _run_port(capsys, "pencil2d_demo", "--ranks", "8")
    nc, cap, rs = re.search(r"plan: ncell=(\d+) capacity=(\d+) rs=(\S+)",
                            ref).groups()
    assert (out["ncell"], out["capacity"]) == (int(nc), int(cap))
    assert abs(out["rs"] - float(rs)) <= 1e-3
    steps, a, ovf, drop = re.search(
        r"ran (\d+) steps: a=(\S+) overflow=(\d+) dropped=(\d+)",
        ref).groups()
    assert (out["steps"], out["overflow"], out["dropped"]) == \
        (int(steps), int(ovf), int(drop))
    assert abs(out["a"] - float(a)) <= 1e-4 + 1e-4 * float(a)
    esteps, ea = re.search(r"engine \(2D mesh\): (\d+) steps, a=(\S+)",
                           ref).groups()
    assert out["engine_steps"] == int(esteps) and out["engine_pencils"]
    assert abs(out["engine_a"] - float(ea)) <= 1e-4 + 1e-4 * float(ea)


def test_mesh3d_demo(capsys, monkeypatch):
    """The JAX demo on the 8 virtual devices ((2, 2, 2)), the port's on 8
    spawned gloo ranks: the migration, the block-halo TreePM (plan,
    overflow, median |a|) and the 3D fast stepper (plan, steps, counters)
    print the same numbers. The JAX script's last section raises
    KeyError in SimulationEngine.compute_energy on the 3D fast mesh (it
    passes sharded_energy the 1D axis name; ROADMAP Queue 3); the port's
    engine runs its 4 steps on the block stepper, and its energies (the
    ring over the ranks) are the plain single-device sums on its gathered
    state to 1e-6."""
    with pytest.raises(KeyError, match="shard"):
        _run_jax_jitted(capsys, monkeypatch, "mesh3d_demo")
    ref = capsys.readouterr().out
    _, out = _run_port(capsys, "mesh3d_demo", "--ranks", "8")
    ovf, live = re.search(r"overflow=(\d+) \(live rows per block: (\d+)",
                          ref).groups()
    assert (out["migration_overflow"], out["live"]) == (int(ovf), int(live))
    nc, cap, hovf, p50 = re.search(
        r"plan nc=(\d+) cap=(\d+) overflow=(\d+) \|acc\| p50=(\S+)",
        ref).groups()
    assert (out["halo_nc"], out["halo_cap"], out["halo_overflow"]) == \
        (int(nc), int(cap), int(hovf))
    assert out["acc_p50"] == pytest.approx(float(p50), rel=1e-3)
    fnc, fcap, fstep, fovf, fdrop = re.search(
        r"fast stepper: ncell=(\d+) cap=(\d+) step=(\d+) overflow=(\d+) "
        r"dropped=(\d+)", ref).groups()
    assert (out["fast_ncell"], out["fast_cap"], out["fast_step"],
            out["fast_overflow"], out["fast_dropped"]) == \
        tuple(int(x) for x in (fnc, fcap, fstep, fovf, fdrop))
    assert out["engine_blocks"] and out["engine_step"] == 4
    import torch
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.forces.direct import kinetic_energy, \
        potential_energy
    pos, vel, mass = (torch.tensor(x, dtype=torch.float32)
                      for x in out["engine_state"])
    cfg = SimulationConfig()
    ke = float(kinetic_energy(vel, mass))
    pe = float(potential_energy(pos, mass, 100.0, 0.5, cfg.units.G))
    assert abs(out["engine_kinetic"] - ke) <= 1e-6 * ke
    assert abs(out["engine_potential"] - pe) <= 1e-6 * abs(pe)
    assert out["engine_total"] == pytest.approx(ke + pe, rel=1e-6)


def test_twolpt_comparison(capsys):
    """At ng = 16 against the JAX script's lines at that size."""
    from lambda_cdm_tpu.forces.direct import min_image
    from lambda_cdm_tpu.physics import initial_conditions as ics
    from lambda_cdm_tpu.physics.cosmology import CosmologyParams
    ng, box, a = 16, 200.0, 1.0 / 25.0
    key, p = jax.random.PRNGKey(7), CosmologyParams()
    p1, v1 = ics.lpt_displacements(key, p, ng=ng, n_side=ng, box_size=box,
                                   a_init=a, use_2lpt=False)
    p2, v2 = ics.lpt_displacements(key, p, ng=ng, n_side=ng, box_size=box,
                                   a_init=a, use_2lpt=True)
    q = ics.lattice_positions(ng, box)
    d1, d2 = min_image(p1 - q, box), min_image(p2 - q, box)

    def rms(x):
        return float(jnp.sqrt(jnp.mean(jnp.sum(x ** 2, -1))))

    ref = {"rms1": rms(d1), "rms2": rms(d2), "vrms1": rms(v1),
           "vrms2": rms(v2), "rms_2nd": rms(min_image(p2 - p1, box)),
           "corr": float(np.corrcoef(np.asarray(d1).ravel(),
                                     np.asarray(d2).ravel())[0, 1])}
    _, out = _run_port(capsys, "twolpt_comparison", "--ng", str(ng))
    for k, v in ref.items():
        assert out[k] == pytest.approx(v, rel=1e-4), k


def test_zeldovich_demo(capsys):
    """At ng = 16 against the JAX script's lines at that size."""
    from lambda_cdm_tpu.analysis.power_spectrum import \
        measure_power_spectrum
    from lambda_cdm_tpu.physics import initial_conditions as ics
    from lambda_cdm_tpu.physics.cosmology import CosmologyParams, \
        growth_factor
    from lambda_cdm_tpu.physics.power_spectra import linear_power
    ng, box, a = 16, 250.0, 1.0 / 50.0
    p = CosmologyParams()
    pos, vel = ics.lpt_displacements(jax.random.PRNGKey(42), p, ng=ng,
                                     n_side=ng, box_size=box, a_init=a,
                                     use_2lpt=False)
    stats = ics.displacement_statistics(pos, box, ng)
    data = measure_power_spectrum(pos, box, ng=ng, num_bins=16,
                                  subtract_shot_noise=False)
    d = float(growth_factor(p, a))
    k, pw, c = (np.asarray(x) for x in (data.k, data.power, data.counts))
    rows = [(k[i], pw[i], float(linear_power(p, k[i])) * d * d)
            for i in range(len(k)) if c[i] > 20 and k[i] < 0.3]
    _, out = _run_port(capsys, "zeldovich_demo", "--ng", str(ng))
    assert out["rms"] == pytest.approx(float(stats["rms_displacement"]),
                                       rel=1e-4)
    assert out["max"] == pytest.approx(float(stats["max_displacement"]),
                                       rel=1e-4)
    assert out["vrms"] == pytest.approx(
        float(jnp.sqrt(jnp.mean(jnp.sum(vel ** 2, -1)))), rel=1e-4)
    assert len(out["pk"]) == len(rows) > 3
    for g, r in zip(out["pk"], rows):
        assert g == pytest.approx(r, rel=1e-4)


def test_lensing_demo(capsys):
    """8^3 particles, 4 steps, 16^2 maps: the port's printed numbers
    against the JAX script's lines run on the JAX engine's state of the
    same config."""
    import lambda_cdm_tpu as jlc
    from lambda_cdm_tpu.analysis.power_spectrum import (
        angular_power_spectrum, shear_eb_spectra)
    from lambda_cdm_tpu.physics.cosmology import comoving_distance
    from lambda_cdm_tpu.raytracing import lensing as lz
    n_side, steps, ng = 8, 4, 16
    _, out = _run_port(capsys, "lensing_demo", "--n-side", str(n_side),
                       "--steps", str(steps), "--ng", str(ng))
    eng = (jlc.SimulationBuilder()
           .with_particles(n_side ** 3).with_box_size(200.0)
           .with_time_step(5e-6)
           .with_force_computer("treepm", pm_grid_size=2 * n_side,
                                softening_length=0.1)
           .with_cosmology(initial_redshift=24.0)
           .with_initial_conditions("2lpt", grid_size=n_side,
                                    random_seed=5)
           .build())
    eng.run(num_steps=steps)
    st, params, box = eng.state, eng.config.cosmology_params(), 200.0
    kappa = lz.convergence_map_from_state(st, params, box, ng=ng,
                                          n_planes=8, z_source=1.0)
    gamma = lz.shear_from_kappa(kappa, box, ng=ng)
    planes, d_chi = lz.snapshot_lightcone_planes(
        st.positions, st.masses, box, ng=ng, n_planes=8)
    chi_s = float(comoving_distance(params, 1.0) * params.h)
    chis = jnp.linspace(0.3 * chi_s, 0.7 * chi_s, 8)
    a_l = jnp.full((8,), st.scale_factor)
    th = jnp.stack(jnp.meshgrid(
        jnp.linspace(0.2, 0.8, 16) * box / chis[0],
        jnp.linspace(0.2, 0.8, 16) * box / chis[0],
        indexing="ij"), -1).reshape(-1, 2)
    bundle = lz.trace_rays(params, planes, chis, a_l, d_chi, box, th,
                           chi_s, ng=ng, jacobian=True)
    ref = {"kappa_rms": float(jnp.std(kappa)),
           "kappa_min": float(jnp.min(kappa)),
           "kappa_max": float(jnp.max(kappa)),
           "shear_rms": float(jnp.sqrt(jnp.mean(jnp.sum(gamma ** 2, 0)))),
           "mean_deflection": float(jnp.mean(jnp.sqrt(jnp.sum(
               (bundle.theta - th) ** 2, -1)))),
           "ray_kappa_rms": float(jnp.std(bundle.kappa)),
           "ray_shear_rms": float(jnp.sqrt(jnp.mean(jnp.sum(
               bundle.gamma ** 2, -1)))),
           "mu_rms": float(jnp.std(bundle.mu))}
    for k, v in ref.items():
        assert out[k] == pytest.approx(v, rel=1e-3), k
    fov = box / chi_s
    ell, cl, counts = angular_power_spectrum(kappa, fov, num_bins=8)
    _, cee, _, _, _ = shear_eb_spectra(gamma[0], gamma[1], fov, num_bins=8)
    cl_th = lz.limber_convergence_cl(params, ell, 1.0)
    rows = [(float(ell[i]), float(cl[i]), float(cee[i]), float(cl_th[i]))
            for i in range(len(ell)) if float(counts[i]) > 0]
    assert len(out["spectra"]) == len(rows) > 3
    for g, r in zip(out["spectra"], rows):
        assert (g[0], g[1], g[2], g[4]) == pytest.approx(r, rel=1e-3)
