"""The port's SimulationEngine.warmup (tests/test_warmup.py's contract),
CompiledForceEngine (tests/test_capabilities.py's four cases, against the
JAX package's engine with solver="reference") and the profiler trace
(profiling.trace_dir, read back by trace_summary), on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import nn, tt

import jax.numpy as jnp

from lambda_cdm_tpu.forces.direct import direct_accelerations as jdirect
from lambda_cdm_tpu.utils.aot import CompiledForceEngine as JEngine
from lambda_cdm_tpu_torch.core.config import SimulationConfig
from lambda_cdm_tpu_torch.core.engine import SimulationEngine
from lambda_cdm_tpu_torch.core.state import make_state
from lambda_cdm_tpu_torch.utils.aot import CompiledForceEngine
from lambda_cdm_tpu_torch.utils.profiling import trace_summary


def _config(n, solver="treepm_fast", chunk=4):
    cfg = SimulationConfig()
    cfg.particles.num_particles = n
    cfg.particles.box_size = 50.0
    cfg.forces.type = solver
    cfg.forces.softening_length = 0.5
    cfg.forces.rebucket_every = 2
    cfg.time.initial_timestep = 1e-5
    cfg.time.final_time = 1e9
    cfg.cosmology.initial_redshift = 9.0
    cfg.simulation.output_frequency = chunk
    cfg.simulation.checkpoint_frequency = 0
    cfg.profiling.output_file = ""
    return cfg


def _engine(n, **kw):
    pos = np.random.default_rng(0).uniform(0, 50.0, (n, 3)).astype(
        np.float32)
    eng = SimulationEngine(_config(n, **kw), device="cpu")
    eng.initialize(state=make_state(pos, np.zeros_like(pos),
                                    np.ones((n,), np.float32),
                                    scale_factor=0.1, device="cpu"))
    return eng


def _snapshot(eng) -> dict:
    """Every tensor of the engine's state and fast state, and its
    statistics."""
    out = {f"state.{k}": v.clone() for k, v in vars(eng.state).items()}
    if eng._fstate is not None:
        out.update({f"fast.{k}": v.clone()
                    for k, v in vars(eng._fstate).items()
                    if isinstance(v, torch.Tensor)})
    out["stats"] = eng.statistics.to_dict()
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("solver,programs", [("treepm_fast", 2),
                                             ("direct", 1)])
def test_warmup_then_run(solver, programs):
    """test_warmup.py's contract: chunk 4 over a rebucket cadence of 2 is
    the segment program and the rebucket pass on the fast path, one chunk
    program on direct; warmup leaves the state, the
    step count and the statistics untouched, and the run after it equals a
    run without it bit for bit."""
    n = 2048 if solver == "treepm_fast" else 512
    eng = _engine(n, solver=solver)
    before = _snapshot(eng)
    out = eng.warmup()
    assert out["programs"] >= programs if solver == "treepm_fast" \
        else out["programs"] == programs
    assert out["seconds"] > 0
    _assert_same(before, _snapshot(eng))
    eng.run(num_steps=4)
    assert int(eng.statistics.total_steps) >= 4
    ref = _engine(n, solver=solver)
    ref.run(num_steps=4)
    assert torch.equal(eng.state.positions, ref.state.positions)
    assert torch.equal(eng.state.velocities, ref.state.velocities)


def test_warmup_remainder_segment():
    """A chunk of 5 over a cadence of 2 has no remainder segment: run()
    snaps the cadence to a divisor of the chunk (1 here), and warmup runs
    that segment and the rebucket pass."""
    eng = _engine(2048)
    assert eng._fast_cadence(5) == 1 and eng._fast_cadence(4) == 2
    assert eng.warmup(chunk_len=5)["programs"] == 2


def test_warmup_requires_initialize():
    eng = SimulationEngine(_config(512), device="cpu")
    with pytest.raises(RuntimeError):
        eng.warmup()


def _uniform(n, box, seed):
    return np.random.default_rng(seed).uniform(0, box, (n, 3)).astype(
        np.float32)


def test_compiled_matches_direct_solver():
    """test_capabilities.py: against the direct solver at rtol 5e-4, atol
    1e-5; and against the JAX engine (solver="reference") on the same
    particles at the same bar, with both solvers and with bf16."""
    pos = _uniform(500, 20.0, 0)
    m = np.ones((500,), np.float32)
    eng = CompiledForceEngine(20.0, softening=0.1, profiles=(1024, 4096),
                              device="cpu")
    assert eng.solver == ("cuda" if torch.cuda.is_available()
                          else "reference")
    out = eng.compute_forces(tt(pos), tt(m))
    ref = jdirect(jnp.asarray(pos), jnp.asarray(m), 20.0, 0.1)
    np.testing.assert_allclose(nn(out), np.asarray(ref), rtol=5e-4,
                               atol=1e-5)
    for kw in ({}, {"use_bf16": True}):
        jout = JEngine(20.0, softening=0.1, profiles=(1024, 4096),
                       solver="reference", **kw).compute_forces(
            jnp.asarray(pos), jnp.asarray(m))
        for solver in ("reference", "cuda"):
            got = CompiledForceEngine(20.0, softening=0.1,
                                      profiles=(1024, 4096), solver=solver,
                                      device="cpu", **kw).compute_forces(
                tt(pos), tt(m))
            np.testing.assert_allclose(nn(got), np.asarray(jout),
                                       rtol=5e-4, atol=1e-5)


def test_compiled_profile_padding_no_recompile():
    eng = CompiledForceEngine(20.0, profiles=(256, 1024), device="cpu")
    for n in (100, 200, 256, 700):
        out = eng.compute_forces(tt(_uniform(n, 20.0, 1)),
                                 torch.ones((n,)))
        assert out.shape == (n, 3)
    assert set(eng._programs) <= {256, 1024}


def test_compiled_exceeding_max_profile_raises():
    eng = CompiledForceEngine(20.0, profiles=(256,), device="cpu")
    with pytest.raises(ValueError):
        eng.compute_forces(torch.zeros((300, 3)), torch.ones((300,)))
    with pytest.raises(ValueError):
        CompiledForceEngine(20.0, solver="pallas", device="cpu")


def test_compiled_save_load_roundtrip(tmp_path):
    """The JAX test's round trip (its rtol 1e-6; here bit for bit), the
    file's config, and a file saved by the JAX package refused."""
    pos = tt(_uniform(200, 10.0, 2))
    m = torch.ones((200,))
    eng = CompiledForceEngine(10.0, softening=0.05, profiles=(256,),
                              use_bf16=True, device="cpu")
    ref = eng.compute_forces(pos, m)
    path = eng.save(str(tmp_path / "engine.json"))
    with open(path) as f:
        assert json.load(f)["config"]["profiles"] == [256]
    eng2 = CompiledForceEngine.load(path, device="cpu")
    assert eng2.config() == eng.config() and set(eng2._programs) == {256}
    assert torch.equal(eng2.compute_forces(pos, m), ref)
    jpath = JEngine(10.0, softening=0.05, profiles=(256,),
                    solver="reference").save(str(tmp_path / "jax.lcdmx"))
    with pytest.raises(ValueError, match="JAX package"):
        CompiledForceEngine.load(jpath, device="cpu")
    with open(tmp_path / "other.json", "w") as f:
        json.dump({"config": {}}, f)
    with pytest.raises(ValueError):
        CompiledForceEngine.load(str(tmp_path / "other.json"), device="cpu")


def test_trace_dir_run(tmp_path):
    """profiling.trace_dir on the engine's run loop (the JAX engine's
    jax_trace) writes a trace that trace_summary reads: a window with CPU
    activity and, on the CPU, no device events."""
    eng = _engine(512, solver="direct")
    eng.config.profiling.enabled = True
    eng.config.profiling.trace_dir = str(tmp_path / "trace")
    eng.run(num_steps=2)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    s = trace_summary(str(tmp_path / "trace"))
    assert s["window_ms"] > 0 and s["device_events"] == 0
    assert s["device_busy_share"] == 0.0 and s["top_kernels"] == []


def test_trace_summary_device_events(tmp_path):
    """The reader on a hand-made trace: busy time is the union of the
    device intervals, the share is of the first-to-last window, kernels
    rank by total time."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "a", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 60,
           "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 80, "dur": 40},
          {"ph": "i", "cat": "kernel", "name": "x", "ts": 500}]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace_summary(str(path), top=1)
    assert s["window_ms"] == pytest.approx(0.120)
    assert s["device_busy_ms"] == pytest.approx(0.030 + 0.010 + 0.040)
    assert s["device_busy_share"] == pytest.approx(80 / 120)
    assert s["top_kernels"] == [{"name": "k1", "ms": pytest.approx(0.06),
                                 "count": 2}]
