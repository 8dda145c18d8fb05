"""The port's diagnostics, snapshot and checkpoint I/O, config-driven
observers and CLI against the JAX package's, on the CPU.

Tolerances: kinetic and potential energy within 1e-5 relative (float32
pair terms, block sums in float64 in the port and float32 in the JAX
package); momentum within 1e-5 of the largest component; checkpoint and
snapshot arrays bitwise; the CLI's printed bin and halo counts equal.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from _torch_parity import max_rel, nn, tt

import jax.numpy as jnp

import lambda_cdm_tpu as jlc
from lambda_cdm_tpu import cli as jcli
from lambda_cdm_tpu.core import analysis_observers as jao
from lambda_cdm_tpu.core.state import make_state as jmake_state
from lambda_cdm_tpu.forces import direct as jdirect
from lambda_cdm_tpu.utils import checkpoint as jckpt
import lambda_cdm_tpu_torch as tlc
from lambda_cdm_tpu_torch import cli as tcli
from lambda_cdm_tpu_torch.core import analysis_observers as tao
from lambda_cdm_tpu_torch.core.state import make_state as tmake_state
from lambda_cdm_tpu_torch.forces import direct as tdirect
from lambda_cdm_tpu_torch.utils import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "examples", "configs")


def _clustered(n_blob=300, n_field=2000, box=100.0, seed=0):
    """(positions, velocities, masses) numpy: two blobs and a field."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([c + rng.standard_normal((n_blob, 3))
                          for c in ((20, 20, 20), (70, 70, 70))]
                         + [rng.uniform(0, box, (n_field, 3))]) % box
    n = len(pos)
    vel = 0.05 * rng.standard_normal((n, 3))
    mass = rng.uniform(0.5, 1.5, n)
    return (pos.astype(np.float32), vel.astype(np.float32),
            mass.astype(np.float32))


def test_energies_match():
    pos, vel, m = _clustered(n_blob=200, n_field=1200, box=50.0)
    pos %= 50.0
    for soft, g in ((0.1, 1.0), (0.5, 43.0071)):
        pj = float(jdirect.potential_energy(jnp.asarray(pos), jnp.asarray(m),
                                            50.0, soft, g))
        pt = float(tdirect.potential_energy(tt(pos), tt(m), 50.0, soft, g,
                                            chunk_size=256))
        assert max_rel(pt, pj) <= 1e-5
    kj = float(jdirect.kinetic_energy(jnp.asarray(vel), jnp.asarray(m)))
    kt = float(tdirect.kinetic_energy(tt(vel), tt(m)))
    assert max_rel(kt, kj) <= 1e-5
    d = (np.random.default_rng(1).uniform(-1.5, 1.5, (500, 3)) * 50.0) \
        .astype(np.float32)
    d[:6, 0] = [25.0, -25.0, 75.0, 0.0, 50.0, -75.0]  # halves: to even
    np.testing.assert_array_equal(nn(tdirect.min_image(tt(d), 50.0)),
                                  np.asarray(jdirect.min_image(
                                      jnp.asarray(d), 50.0)))


def _cfg_dict(tmp, n=4096, **io):
    """A small treepm_fast run with every observer of the main config on,
    writing only under `tmp`."""
    out = os.path.join(str(tmp), "out")
    return {
        "simulation": {"name": "Small", "output_directory": out,
                       "output_frequency": 4, "checkpoint_frequency": 8},
        "cosmology": {"initial_redshift": 9.0},
        "forces": {"type": "treepm_fast", "pm_grid_size": 32,
                   "softening_length": 0.1, "rebucket_every": 4},
        "particles": {"num_particles": n, "box_size": 50.0},
        "time": {"initial_timestep": 2e-5, "max_steps": 8},
        "profiling": {"output_file": os.path.join(out, "prof.json")},
        "logging": {"performance_logging": False},
        "io": dict({"snapshots": {"frequency": 8},
                    "analysis": {"enabled": True,
                                 "power_spectrum": {
                                     "enabled": True, "frequency": 4,
                                     "grid_size": 32, "num_bins": 16},
                                 "halo_finder": {
                                     "enabled": True, "frequency": 8,
                                     "linking_length": 0.2,
                                     "min_particles": 10}}}, **io),
    }


def _engines(tmp):
    """(JAX engine, port engine) from one config and one 2LPT state."""
    from lambda_cdm_tpu.physics.initial_conditions import generate_state
    from lambda_cdm_tpu_torch import interop
    from _torch_parity import fields
    d = _cfg_dict(tmp)
    jcfg = jlc.SimulationConfig.from_dict(d)
    st = generate_state(jcfg)
    jeng = jlc.SimulationBuilder().with_config(jcfg) \
        .with_initial_state(st).build()
    teng = tlc.SimulationBuilder(device="cpu").with_config(
        tlc.SimulationConfig.from_dict(d)).with_initial_state(
        interop.sim_state_from_arrays(fields(st), device="cpu")).build()
    return jeng, teng


def test_engine_diagnostics_and_checkpoints(tmp_path):
    """compute_energy / momentum / angular_momentum against the JAX
    engine; a checkpoint of either engine loads in the other with bitwise
    arrays, and resumes with its statistics."""
    jeng, teng = _engines(tmp_path)
    ej, et = jeng.compute_energy(), teng.compute_energy()
    for k in ("kinetic", "potential", "total"):
        assert max_rel(et[k], ej[k]) <= 1e-5
    for f in ("momentum", "angular_momentum"):
        assert max_rel(getattr(teng, f)(), getattr(jeng, f)()) <= 1e-5

    seen = []

    class Spy(tlc.Observer):
        def on_checkpoint(self, engine, path):
            seen.append(path)

    teng.add_observer(Spy())
    teng.statistics.total_steps = 7
    pt = teng.save_checkpoint(str(tmp_path / "ck_torch"))
    assert seen == [pt] and pt.endswith(".npz")
    pj = jeng.save_checkpoint(str(tmp_path / "ck_jax"))
    st_j, cfg_j, stats_j = jckpt.load_checkpoint(pt)
    st_t, cfg_t, stats_t = tckpt.load_checkpoint(pj, device="cpu")
    assert stats_j["total_steps"] == 7
    assert cfg_j["particles"]["num_particles"] == 4096
    for f in ("positions", "velocities", "masses", "scale_factor", "time",
              "step"):
        np.testing.assert_array_equal(np.asarray(getattr(st_j, f)),
                                      nn(getattr(teng.state, f)))
        np.testing.assert_array_equal(nn(getattr(st_t, f)),
                                      np.asarray(getattr(jeng.state, f)))
    assert np.asarray(st_j.rng_key).dtype == np.uint32

    fresh = tlc.SimulationEngine(tlc.SimulationConfig.from_dict(cfg_j),
                                 device="cpu")
    fresh.load_checkpoint(pt)
    assert fresh.statistics.total_steps == 7
    assert torch.equal(fresh.state.positions, teng.state.positions)
    # the port's orbax form: a step directory of a torch.save file
    od = tckpt.save_checkpoint_orbax(str(tmp_path / "orbax"), teng.state)
    assert os.path.basename(od) == f"step_{int(teng.state.step):08d}"
    back = tckpt.load_checkpoint_orbax(str(tmp_path / "orbax"),
                                       device="cpu")
    for f in ("positions", "velocities", "masses", "scale_factor", "time",
              "step"):
        assert torch.equal(getattr(back, f), getattr(teng.state, f))


def test_snapshots_match(tmp_path):
    pos, vel, m = _clustered(n_blob=20, n_field=60)
    js = jmake_state(pos, vel, m, scale_factor=0.5, time=0.25, step=12)
    ts = tmake_state(pos, vel, m, scale_factor=0.5, time=0.25, step=12)
    cfg = tlc.SimulationConfig()
    # npz with a field filter, both directions
    pt = tckpt.save_snapshot(str(tmp_path / "t"), ts, cfg,
                             fields=["positions"])
    sj, meta = jckpt.load_snapshot(pt)
    np.testing.assert_array_equal(np.asarray(sj.positions), pos)
    np.testing.assert_array_equal(np.asarray(sj.velocities), 0.0)
    assert meta["config"]["particles"]["box_size"] == cfg.particles.box_size
    pj = jckpt.save_snapshot(str(tmp_path / "j.npz"), js)
    st, _ = tckpt.load_snapshot(pj, device="cpu")
    for f in ("positions", "velocities", "masses", "scale_factor", "step"):
        np.testing.assert_array_equal(nn(getattr(st, f)),
                                      np.asarray(getattr(js, f)))
    # ascii: the same text
    at = tckpt.save_snapshot(str(tmp_path / "t.txt"), ts)
    aj = jckpt.save_snapshot(str(tmp_path / "j.txt"), js)
    assert open(at).read() == open(aj).read()
    # hdf5 and lcdm: written by the port, read by the JAX package
    for ext in (".h5", ".lcdm"):
        px = tckpt.save_snapshot(str(tmp_path / f"x{ext}"), ts)
        sx, _ = jckpt.load_snapshot(px)
        for f in ("positions", "velocities", "masses", "scale_factor",
                  "time", "step"):
            np.testing.assert_array_equal(np.asarray(getattr(sx, f)),
                                          nn(getattr(ts, f)))


def test_engine_snapshot_path_follows_output_format(tmp_path):
    _, teng = _engines(tmp_path)
    cfg = teng.config
    cfg.io.snapshots.filename_pattern = str(
        tmp_path / "snap_{step:04d}_{redshift:.1f}.npz")
    cfg.io.output_format = "ascii"
    assert teng.save_snapshot().endswith("snap_0000_9.0.txt")
    cfg.io.output_format = "npz"
    assert teng.save_snapshot().endswith(".npz")
    cfg.io.output_format = "orbax"
    out = teng.save_checkpoint(str(tmp_path / "ck"))
    assert os.path.isdir(out) and os.path.basename(out) == "step_00000000"


def _observer_set(observers):
    out = []
    for o in observers:
        attrs = {k: v for k, v in vars(o).items()
                 if not isinstance(v, list) and not k.startswith("_")}
        out.append((type(o).__name__, json.dumps(attrs, sort_keys=True)))
    return out


@pytest.mark.parametrize("name", ["treepm_1m.json", "basic_lambda_cdm.json",
                                  None])
def test_build_observers_from_config_matches(name):
    if name is None:
        cfgs = [lc.SimulationConfig() for lc in (jlc, tlc)]
    else:
        cfgs = [lc.SimulationConfig.from_file(os.path.join(CONFIGS, name))
                for lc in (jlc, tlc)]
    js = _observer_set(jao.build_observers_from_config(cfgs[0]))
    ts = _observer_set(tao.build_observers_from_config(cfgs[1]))
    assert ts == js and len(ts) >= 3
    # no config block asks for lensing in either package; the observer
    # added by hand builds with the JAX defaults
    assert _observer_set([tao.LensingObserver()]) == _observer_set(
        [jao.LensingObserver()])


def _printed(out, pattern):
    m = re.search(pattern, out)
    assert m, out
    return m.group(1)


def test_cli_analyze_matches_jax(tmp_path, capsys):
    pos, vel, m = _clustered()
    cfg = jlc.SimulationConfig()
    cfg.particles.box_size = 100.0
    snap = jckpt.save_snapshot(str(tmp_path / "snap.npz"),
                               jmake_state(pos, vel, m), config=cfg)
    args = ["analyze", snap, "--ng", "32", "--linking-length", "0.3"]
    assert jcli.main(args) == 0
    out_j = capsys.readouterr().out
    halos = str(tmp_path / "h.npz")
    assert tcli.main(args + ["--halos-out", halos, "--pk-out",
                             str(tmp_path / "pk.txt")], device="cpu") == 0
    out_t = capsys.readouterr().out
    for pat in (r"P\(k\): (\d+) bins", r"halos: (\d+) with",
                r"N=(\d+) box"):
        assert _printed(out_t, pat) == _printed(out_j, pat)
    assert int(_printed(out_t, r"halos: (\d+) with")) == 2
    h = np.load(halos)
    assert int(h["num_halos"]) == 2 and h["particle_label"].shape == (2600,)
    assert tcli.main(["analyze", jckpt.save_snapshot(
        str(tmp_path / "bare.npz"), jmake_state(pos, vel, m))],
        device="cpu") == 2                              # no box size


def test_cli_run_resume_validate_info(tmp_path, capsys):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_cfg_dict(tmp_path)))
    assert tcli.main(["run", str(cfg_path)], device="cpu") == 0
    out = capsys.readouterr().out
    assert "final: steps=8" in out
    outdir = tmp_path / "out"
    names = sorted(os.listdir(outdir))
    assert "checkpoint_000008.npz" in names
    assert {"power_000004.txt", "power_000008.txt"} <= set(names)
    assert any(n.startswith("snapshot_000008") for n in names)
    prof = json.loads((outdir / "prof.json").read_text())
    assert {"analysis.power_spectrum", "analysis.halo_finder",
            "diagnostics.energy"} <= set(prof["timers"])
    pk = np.loadtxt(outdir / "power_000008.txt")
    assert pk.shape[1] == 3 and np.all(np.isfinite(pk))

    ckpt = str(outdir / "checkpoint_000008.npz")
    assert tcli.main(["resume", ckpt, "--time.max_steps=4"],
                     device="cpu") == 0
    assert "resumed from step 8" in capsys.readouterr().out
    assert "checkpoint_000016.npz" not in os.listdir(outdir)
    st, _, stats = tckpt.load_checkpoint(ckpt, device="cpu")
    assert int(st.step) == 8 and stats["total_steps"] == 8

    cfg_1m = os.path.join(CONFIGS, "treepm_1m.json")
    assert jcli.main(["validate", cfg_1m]) == 0
    out_j = capsys.readouterr().out
    assert tcli.main(["validate", cfg_1m], device="cpu") == 0
    assert capsys.readouterr().out == out_j
    assert tcli.main(["info"], device="cpu") == 0
    assert "torch" in capsys.readouterr().out
    assert tcli.main(["bogus"], device="cpu") == 2


@pytest.mark.parametrize("entry", ["cli", "science_run"])
def test_entry_points_turn_tf32_off(entry, monkeypatch, capsys):
    """cli.main and science_run.main leave both TF32 flags False (float32
    products in full float32, as the JAX package's Precision.HIGHEST), even
    when they were set True before."""
    from lambda_cdm_tpu_torch import science_run
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    if entry == "cli":
        assert tcli.main(["validate", os.path.join(
            CONFIGS, "treepm_1m.json")], device="cpu") == 0
    else:
        with pytest.raises(SystemExit):
            science_run.main(["--help"])
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
