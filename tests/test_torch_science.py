"""The port's science run (lambda_cdm_tpu_torch/science_run.py) against the
JAX package's science_run.py at the repository root, on the CPU at small
sizes: the Layzer-Irvine ledger driven through one (a, T, U) sequence,
records written by each package and read by the other, analyze_phase of
both packages on one clumpy record, the engine's release_force_state, and
a 16^3 plumbing run of the port's evolve and analysis phases.

Importing the JAX science_run sets JAX's persistent compilation-cache
directory (.jax_cache/ at the repository root) and its minimum compile
time, as that script does for itself. The cache is set up at the first
compile, so this module puts both settings back right after the import:
otherwise every later test in the process would compile into that
directory (tests/test_capabilities.py checks where the engine's cache
goes)."""

import json
import math

import numpy as np
import pytest
import torch

from _torch_parity import tt

import jax

from lambda_cdm_tpu.core.config import SimulationConfig as JConfig
from lambda_cdm_tpu_torch import science_run as tsr
from lambda_cdm_tpu_torch.core import engine as teng
from lambda_cdm_tpu_torch.core.config import SimulationConfig as TConfig
from lambda_cdm_tpu_torch.physics.initial_conditions import generate_state

_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")
_saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
import science_run as jsr  # noqa: E402  (sets the two settings)
for _k, _v in _saved.items():
    jax.config.update(_k, _v)


class _Stub:
    """An engine with a state whose scale factor the test sets."""

    def __init__(self, cfg, a):
        self.config = cfg
        n = 8
        self.state = type("S", (), dict(
            scale_factor=a, positions=np.zeros((n, 3), np.float32),
            velocities=np.zeros((n, 3), np.float32),
            masses=np.ones(n, np.float32)))()


def test_ledger_matches_jax(monkeypatch):
    """Both ledgers fed the same (a, T, U) sequence -- the energies
    stubbed, forced samples and dlna-gated ones mixed -- give the same
    samples, integral and worst residual to 1e-12."""
    import lambda_cdm_tpu.forces.direct as jdirect
    seq = [(0.04, 1.2e9, -9.6e12), (0.043, 1.3e9, -9.1e12),
           (0.05, 1.6e9, -8.0e12), (0.09, 3.3e9, -4.4e12),
           (0.2, 7.6e9, -2.0e12), (0.21, 8.0e9, -1.9e12),
           (0.45, 1.9e10, -1.0e12), (1.0, 4.4e10, -4.6e11)]
    cur = {}
    monkeypatch.setattr(jdirect, "kinetic_energy", lambda *a: cur["T"])
    monkeypatch.setattr(jdirect, "potential_energy",
                        lambda *a, **k: cur["U"])
    monkeypatch.setattr(tsr, "kinetic_energy", lambda *a: cur["T"])
    monkeypatch.setattr(tsr, "potential_energy", lambda *a, **k: cur["U"])
    jcfg, tcfg = JConfig(), TConfig()
    jeng, teng_ = _Stub(jcfg, 0.0), _Stub(tcfg, 0.0)
    jli = jsr.LayzerIrvineLedger(jeng, dlna_sample=0.15)
    tli = tsr.LayzerIrvineLedger(teng_, dlna_sample=0.15)
    for i, (a, ke, pe) in enumerate(seq):
        jeng.state.scale_factor = teng_.state.scale_factor = a
        cur.update(T=ke, U=pe)
        force = i in (0, len(seq) - 1)
        jli.sample(force=force)
        tli.sample(force=force)
    assert len(tli.samples) == len(jli.samples) == 6
    for s_t, s_j in zip(tli.samples, jli.samples):
        for k in ("a", "T", "U", "residual"):
            assert s_t[k] == pytest.approx(s_j[k], rel=1e-12, abs=0.0)
    assert tli.worst == pytest.approx(jli.worst, rel=1e-12)
    assert tli._li == pytest.approx(jli._li, rel=1e-12)


def _record(n_side=12, small=True, seed=0, n_snap=2):
    rng = np.random.default_rng(seed)
    n = n_side ** 3
    g = tsr.geometry(small)
    pos = rng.uniform(0, g["box"], (n, 3)).astype(np.float32)
    return {
        "small": small, "geometry": g, "n": n, "m_p": 0.5, "a_i": 0.04,
        "a_f": 0.5, "z_final": 1.0, "steps": 17, "t_ic": 0.1,
        "t_evolve": 2.5, "ic_cached": False, "overflow": 0, "dropped": 0,
        "platform": "cpu", "engine_stats": {"total_steps": 17},
        "li_samples": [{"a": 0.04, "T": 1.0, "U": -2.0, "residual": 0.0}],
        "li_worst": 0.01, "li_wall_s": 0.2, "breakdown": {},
        "pk_i": {"k": rng.uniform(0, 1, 32).astype(np.float32),
                 "power": rng.uniform(1, 2, 32).astype(np.float32),
                 "counts": rng.integers(0, 99, 32).astype(np.float32)},
        "pk_snapshots": [{"scale_factor": 0.1 * (i + 1), "step": 5 * i,
                          "power": rng.uniform(1, 2, 32).astype(np.float32)}
                         for i in range(n_snap)],
        "pos_f": pos, "vel_f": rng.standard_normal((n, 3)).astype(
            np.float32), "masses": np.full(n, 0.5, np.float32)}


def _same_record(a, b):
    for k in ("pos_f", "vel_f", "masses"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("k", "power", "counts"):
        np.testing.assert_array_equal(a["pk_i"][k], b["pk_i"][k])
    assert len(a["pk_snapshots"]) == len(b["pk_snapshots"])
    for s, t in zip(a["pk_snapshots"], b["pk_snapshots"]):
        assert (s["scale_factor"], s["step"]) == (t["scale_factor"],
                                                  t["step"])
        np.testing.assert_array_equal(s["power"], t["power"])
    meta = [k for k in b if k not in ("pos_f", "vel_f", "masses", "pk_i",
                                      "pk_snapshots")]
    assert json.dumps({k: a[k] for k in meta}, sort_keys=True) == \
        json.dumps({k: b[k] for k in meta}, sort_keys=True)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_load_across_packages(tmp_path, writer):
    rec = _record(seed=1 if writer == "port" else 2)
    path = str(tmp_path / "science_record.npz")
    if writer == "port":
        tsr.save_record(path, rec)
        got = jsr.load_record(path)
    else:
        jsr._save_record(path, rec)
        got = tsr.load_record(path)
    _same_record(got, rec)
    _same_record(tsr.load_record(path), jsr.load_record(path))


def _clumpy_record():
    """8,192 particles in the small geometry's 62.5 Mpc/h box: 110 clumps
    of 25-70 particles over a uniform rest, numpy seed 5, at a = 1."""
    rng = np.random.default_rng(5)
    g = tsr.geometry(True)
    box, n = g["box"], 8192
    pos = rng.uniform(0, box, (n, 3))
    start = 0
    for size in rng.integers(25, 70, 110):
        pos[start:start + size] = rng.uniform(0, box, 3) \
            + 0.1 * rng.standard_normal((size, 3))
        start += size
    pos = np.mod(pos, box).astype(np.float32)
    rec = _record(small=True, n_snap=0)
    m_p = 27.7536 * 0.31 * box ** 3 / n
    lattice = (np.stack(np.meshgrid(*[np.arange(32)] * 3, indexing="ij"),
                        -1).reshape(-1, 3)[:n] + 0.5) * (box / 32)
    lattice = np.mod(lattice + 0.3 * rng.standard_normal(lattice.shape),
                     box).astype(np.float32)
    from lambda_cdm_tpu_torch.analysis.power_spectrum import \
        measure_power_spectrum
    pk = measure_power_spectrum(tt(lattice), box, ng=g["pk_grid"],
                                num_bins=32, subtract_shot_noise=False)
    rec.update(n=n, m_p=m_p, a_f=1.0, z_final=0.0, pos_f=pos,
               vel_f=rng.standard_normal((n, 3)).astype(np.float32),
               masses=np.full(n, m_p, np.float32),
               pk_i={"k": pk.k.numpy(), "power": pk.power.numpy(),
                     "counts": pk.counts.numpy()})
    return rec


def _close(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return (math.isnan(a) and math.isnan(b)) or \
            abs(a - b) <= 1e-4 * max(abs(b), 1e-30)
    return a == b


def test_analyze_phase_matches_jax():
    """Both packages' analyze_phase on one clumpy record at z = 0: every
    check present in both with the same pass flag, the same halo count,
    and every value within 1e-4 (float32 P(k), theory and lensing sums in
    another order)."""
    rec = _clumpy_record()
    cj = jsr.analyze_phase(dict(rec))
    ct = tsr.analyze_phase(dict(rec), device="cpu")
    assert set(ct["checks"]) == set(cj["checks"])
    assert "fof_stage_ok" not in ct["checks"]
    assert ct["checks"]["num_halos"]["value"] == \
        cj["checks"]["num_halos"]["value"] >= 10
    for name, c in ct["checks"].items():
        assert c["pass"] == cj["checks"][name]["pass"], name
        assert _close(c["value"], cj["checks"][name]["value"]), name
    assert ct["passed"] == cj["passed"]
    assert _close(ct["hmf"]["ratio_vs_st"], cj["hmf"]["ratio_vs_st"])
    assert ct["hmf"]["counts"] == cj["hmf"]["counts"]
    assert _close(ct["growth_factor_sq"], cj["growth_factor_sq"])
    assert ct["fof"]["overflow"] == 0 and ct["fof"]["rounds"] >= 1


def _fast_config(rebucket_every):
    cfg = TConfig.from_dict({
        "particles": {"num_particles": 12 ** 3, "box_size": 37.5},
        "forces": {"type": "treepm_fast", "pm_grid_size": 24,
                   "softening_length": 0.1,
                   "rebucket_every": rebucket_every},
        "cosmology": {"initial_redshift": 9.0},
        "time": {"initial_timestep": 2e-5},
        "simulation": {"output_frequency": 4, "checkpoint_frequency": 0},
        "profiling": {"output_file": ""},
        "logging": {"performance_logging": False}})
    ic = cfg.particles.initial_conditions
    ic.type, ic.grid_size, ic.random_seed = "2lpt", 12, 31
    return cfg


def test_release_force_state_then_continue():
    """6 steps in one run equal 2 steps, a release, 2 steps through run(),
    a release and 2 through step(): each resumes by rebuilding the
    buckets. The unbroken run rebuckets at the same steps (every 2), but
    may order a cell's slots otherwise, so the sums agree to float32
    rounding, not bit for bit. A second release is a no-op. The step
    breakdown times the card, so on CPU tensors it raises."""
    cfg = _fast_config(2)
    cfg.simulation.output_frequency = 2
    st0 = generate_state(cfg, device="cpu")
    ref = teng.SimulationEngine(cfg, device="cpu")
    ref.initialize(state=st0)
    ref.run(num_steps=6)
    eng = teng.SimulationEngine(cfg, device="cpu")
    eng.initialize(state=st0)
    eng.run(num_steps=2)
    eng.release_force_state()
    assert eng._fstate is None and eng._acc is None
    eng.release_force_state()
    eng.run(num_steps=2)
    assert eng._fstate is not None
    eng.release_force_state()
    eng.step(2)
    assert eng._fstate is not None and eng.statistics.total_steps == 6
    box = cfg.particles.box_size
    d = torch.remainder(eng.state.positions - ref.state.positions
                        + box / 2, box) - box / 2
    assert float(d.abs().max()) <= 1e-5 * box
    v_ref = ref.state.velocities
    assert float((eng.state.velocities - v_ref).abs().max()) \
        <= 1e-4 * float(v_ref.abs().max())
    assert float(eng.state.scale_factor) == float(ref.state.scale_factor)
    with pytest.raises(RuntimeError, match="card"):
        tsr.step_breakdown(eng)


def test_plumbing_run_16(tmp_path, capsys, monkeypatch):
    """The port's evolve and analysis phases on the CPU in a 16^3
    geometry (a 24^3 PM mesh: the CPU plan is 4^3 cells of capacity 128)
    to LCDM_SCIENCE_ZFINAL = 20 in chunks of 8 steps, then main
    --analyze-only on the record."""
    g = dict(n_side=16, ng_ic=32, box=40.0, pm_grid=24, pk_grid=32,
             softening=0.3, chunk=8, bucket_capacity=2048)
    monkeypatch.setattr(tsr, "geometry", lambda small: dict(g))
    monkeypatch.setenv("LCDM_SCIENCE_ZFINAL", "20")
    path = str(tmp_path / "science_record_small.npz")
    rec = tsr.evolve_phase(True, path, "cpu")
    assert rec["n"] == 4096 and rec["overflow"] == rec["dropped"] == 0
    assert rec["a_f"] >= 0.97 / 21.0 and rec["steps"] > 0
    assert len(rec["li_samples"]) >= 2 and rec["li_worst"] < 0.05
    assert len(rec["pk_snapshots"]) >= 1 and rec["breakdown"] == {}
    cert = tsr.analyze_phase(tsr.load_record(path), device="cpu")
    assert cert["passed"] and cert["steps"] == rec["steps"]
    assert cert["checks"]["num_halos"]["pass"] is None     # early stop
    rc = tsr.main(["--analyze-only", path, "--device", "cpu", "--out",
                   str(tmp_path), "--small"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["passed"] and line["steps"] == rec["steps"]
    with open(tmp_path / "SCIENCE_small.json") as f:
        assert json.load(f)["kind"] == \
            "lambda_cdm_tpu_torch science certificate"
