"""The port's snapshot and checkpoint formats against the JAX package's
(lambda_cdm_tpu/utils/checkpoint.py): hdf5 and lcdm snapshots written by
either package load in the other bit for bit (the hdf5 layout, its gzip
and its config attribute included); the port's "orbax" checkpoint
directory (torch.save entries, port-only) round-trips through the engine,
and a directory the JAX package's Orbax wrote is refused with an error
that says so."""

import os

import numpy as np
import pytest
import torch

from _torch_parity import nn

import jax  # noqa: F401  (JAX on the CPU before the packages load)

import lambda_cdm_tpu as jlc
from lambda_cdm_tpu.core.state import make_state as jmake_state
from lambda_cdm_tpu.utils import checkpoint as jckpt
import lambda_cdm_tpu_torch as tlc
from lambda_cdm_tpu_torch.core.state import make_state as tmake_state
from lambda_cdm_tpu_torch.utils import checkpoint as tckpt

FIELDS = ("positions", "velocities", "masses", "scale_factor", "time",
          "step")


def _arrays(n=333, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 40.0, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


def _states():
    pos, vel, m = _arrays()
    kw = dict(scale_factor=0.375, time=1.75, step=23)
    return jmake_state(pos, vel, m, **kw), tmake_state(
        torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(m),
        **kw)


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(nn(getattr(a, f))),
                                      np.asarray(nn(getattr(b, f))))


@pytest.mark.parametrize("ext", [".h5", ".hdf5", ".lcdm"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_cross_package(tmp_path, ext, writer):
    if ext != ".lcdm":
        pytest.importorskip("h5py")
    js, ts = _states()
    cfg_t = tlc.SimulationConfig()
    cfg_j = jlc.SimulationConfig()
    path = str(tmp_path / f"snap{ext}")
    if writer == "port":
        out = tckpt.save_snapshot(path, ts, cfg_t)
        got, meta = jckpt.load_snapshot(out)
        _same(got, ts)
    else:
        out = jckpt.save_snapshot(path, js, cfg_j)
        got, meta = tckpt.load_snapshot(out, device="cpu")
        _same(got, js)
        assert got.positions.device.type == "cpu"
    assert out == path
    if ext != ".lcdm":           # the config rides in the hdf5 attributes
        assert meta["config"]["particles"]["box_size"] == \
            cfg_t.particles.box_size


def test_hdf5_layout_and_fields(tmp_path):
    """The port's hdf5 file has the JAX package's layout (gzip level 4
    datasets under `particles`, scalars and format_version as file
    attributes), and a field filter keeps the scalars: the same file bytes
    as the JAX writer's, dataset by dataset."""
    h5py = pytest.importorskip("h5py")
    js, ts = _states()
    pt = tckpt.save_snapshot(str(tmp_path / "t.h5"), ts,
                             fields=["positions"])
    pj = jckpt.save_snapshot(str(tmp_path / "j.h5"), js,
                             fields=["positions"])
    with h5py.File(pt, "r") as ft, h5py.File(pj, "r") as fj:
        assert set(ft["particles"]) == set(fj["particles"]) == \
            {"positions", "rng_key"}
        for k in ft["particles"]:
            dt, dj = ft["particles"][k], fj["particles"][k]
            assert dt.compression == dj.compression == "gzip"
            assert dt.compression_opts == dj.compression_opts == 4
            assert dt.dtype == dj.dtype
        assert set(ft.attrs) == set(fj.attrs)
        for k in ("scale_factor", "time", "step", "format_version"):
            assert ft.attrs[k] == fj.attrs[k]
            assert np.asarray(ft.attrs[k]).dtype == \
                np.asarray(fj.attrs[k]).dtype
    got, _ = tckpt.load_snapshot(pt, device="cpu")
    assert torch.equal(got.positions, ts.positions)
    assert float(got.velocities.abs().max()) == 0.0


def test_lcdm_bytes_match(tmp_path):
    js, ts = _states()
    pt = tckpt.save_snapshot(str(tmp_path / "t.lcdm"), ts)
    pj = jckpt.save_snapshot(str(tmp_path / "j.lcdm"), js)
    assert open(pt, "rb").read() == open(pj, "rb").read()


def _engine(tmp_path, fmt):
    d = {"particles": {"num_particles": 512, "box_size": 32.0},
         "forces": {"type": "direct", "softening_length": 0.5},
         "io": {"output_format": fmt},
         "time": {"initial_timestep": 2e-5},
         "cosmology": {"initial_redshift": 24.0, "final_redshift": 0.0},
         "simulation": {"output_frequency": 2, "checkpoint_frequency": 0,
                        "output_directory": str(tmp_path / "out")},
         "profiling": {"output_file": ""}}
    cfg = tlc.SimulationConfig.from_dict(d)
    cfg.particles.initial_conditions.grid_size = 8
    eng = tlc.SimulationEngine(cfg, device="cpu")
    eng.initialize()
    return eng


def test_orbax_directory_through_the_engine(tmp_path):
    """io.output_format="orbax": save_checkpoint writes step_XXXXXXXX
    directories under the path; load_checkpoint takes the parent (the
    latest step) or a step directory, and the resumed run is the same
    run."""
    eng = _engine(tmp_path, "orbax")
    eng.run(num_steps=2)
    first = eng.save_checkpoint(str(tmp_path / "ck"))
    eng.run(num_steps=2)
    second = eng.save_checkpoint(str(tmp_path / "ck"))
    assert os.path.basename(first) == "step_00000002"
    assert os.path.basename(second) == "step_00000004"
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002",
                                                   "step_00000004"]
    fresh = tlc.SimulationEngine(eng.config, device="cpu")
    fresh.load_checkpoint(str(tmp_path / "ck"))
    _same(fresh.state, eng.state)
    older = tlc.SimulationEngine(eng.config, device="cpu")
    older.load_checkpoint(first)
    assert int(older.state.step) == 2
    older.run(num_steps=2)
    _same(older.state, eng.state)


def test_jax_orbax_directory_is_refused(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    js, _ = _states()
    path = jckpt.save_checkpoint_orbax(str(tmp_path / "jax_ck"), js)
    with pytest.raises(ValueError, match="across packages"):
        tckpt.load_checkpoint_orbax(path, device="cpu")
    with pytest.raises(ValueError, match="across packages"):
        tckpt.load_checkpoint_orbax(str(tmp_path / "jax_ck"), device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint_orbax(str(tmp_path), device="cpu")
