"""The stateless PM force's kernel wrappers (ops/pm_cic.py) on the CPU:
their plain versions equal forces/pm.py's plain chain bit for bit, they
refuse what the kernels do not take, and the engine's stateless `pm`
step on a 16^3 mesh agrees with the benchmark's float64 reference
(nbody_bench/reference.py, the `pm` law); the counter `pm_forces` and
the spans `pm.deposit`, `pm.solve`, `pm.gather` inside `fast.accel`.
The kernels themselves are compared with these plain versions on the
card in tests/test_torch_cuda.py."""

import os
import sys

import numpy as np
import pytest
import torch

import lambda_cdm_tpu_torch as tlc
from lambda_cdm_tpu_torch.analysis.power_spectrum import cic_deposit
from lambda_cdm_tpu_torch.forces import pm
from lambda_cdm_tpu_torch.ops import pm_cic
from lambda_cdm_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

N1, BOX, NG, DT, A0 = 12, 24.0, 16, 2e-4, 0.02
OMEGA_M, OMEGA_L = 0.31, 0.69


def _particles(n=4096, box=20.0, seed=3):
    gen = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 3), generator=gen) * box
    return pos, torch.rand(n, generator=gen) + 0.5


def _parent_chain(positions, masses, ng, box, g_const, split_scale):
    """forces/pm.pm_accelerations's plain chain as it was written before
    ops/pm_cic carried it, step by step."""
    cv = float((torch.tensor(box, dtype=torch.float32) / ng) ** 3)
    grid = cic_deposit(positions, ng, box, weights=masses)
    rho_k = torch.fft.rfftn(grid / cv)
    green, kx, ky, kz = pm._spectral(ng, box, split_scale, True, "cpu")
    phi_k = green * rho_k
    acc = [pm.cic_gather(torch.fft.irfftn(-1j * k * phi_k, s=(ng,) * 3),
                         positions, ng, box) for k in (kx, ky, kz)]
    return g_const * torch.stack(acc, dim=-1)


@pytest.mark.parametrize("split_scale", [0.0, 1.5])
def test_plain_pm_forces_equal_the_plain_chain(split_scale):
    pos, m = _particles()
    green, kx, ky, kz = pm._spectral(16, 20.0, split_scale, True, "cpu")
    got = pm_cic.pm_forces(pos, m, 16, 20.0, 43.007, green, (kx, ky, kz))
    want = _parent_chain(pos, m, 16, 20.0, 43.007, split_scale)
    assert torch.equal(got, want)
    assert torch.equal(pm.pm_accelerations(pos, m, 16, 20.0, 43.007,
                                           split_scale=split_scale), want)


def test_the_factor_is_the_plain_chains_last_product():
    """Modified gravity's factor (the `pm` solver's 1 + mg) multiplies
    the plain chain's result, as the solver did before the kernels; the
    `plain` route on CPU tensors is the CPU route."""
    pos, m = _particles(seed=6)
    base = pm.pm_accelerations(pos, m, 16, 20.0, 43.007)
    assert torch.equal(pm.pm_accelerations(pos, m, 16, 20.0, 43.007,
                                           factor=1.3), 1.3 * base)
    assert torch.equal(pm.pm_accelerations(pos, m, 16, 20.0, 43.007,
                                           plain=True), base)


def test_plain_versions_are_the_chains_steps():
    pos, m = _particles(seed=4)
    assert torch.equal(pm_cic.cic_scatter(pos, m, 16, 20.0),
                       cic_deposit(pos, 16, 20.0, weights=m))
    green, kx, ky, kz = pm._spectral(16, 20.0, 0.0, True, "cpu")
    rho_k = torch.fft.rfftn(cic_deposit(pos, 16, 20.0, weights=m))
    fields = []
    for axis, k in enumerate((kx, ky, kz)):
        spec = pm_cic.green_gradient(rho_k, green, k, axis)
        assert torch.equal(spec, -1j * k * (green * rho_k))
        fields.append(torch.fft.irfftn(spec, s=(16,) * 3))
    acc = pm_cic.cic_gather3(fields, pos, 16, 20.0, 2.5)
    for d in range(3):
        assert torch.equal(acc[:, d],
                           2.5 * pm.cic_gather(fields[d], pos, 16, 20.0))


def test_the_cuda_routes_folded_scales_match_the_plain_chain():
    """The kernel route's arithmetic, emulated with the plain versions:
    the unscaled deposit, unnormalised c2r and one scale g / (cell
    volume ng^3) at the gather read within float32's rounding of the
    plain chain."""
    pos, m = _particles(seed=5)
    green, kx, ky, kz = pm._spectral(16, 20.0, 0.0, True, "cpu")
    rho_k = torch.fft.rfftn(pm_cic.cic_scatter(pos, m, 16, 20.0))
    fields = [torch.fft.irfftn(pm_cic.green_gradient(rho_k, green, k, a),
                               s=(16,) * 3, norm="forward")
              for a, k in enumerate((kx, ky, kz))]
    scale = 43.007 / (pm_cic.cell_volume(16, 20.0) * 16 ** 3)
    got = pm_cic.cic_gather3(fields, pos, 16, 20.0, scale)
    want = _parent_chain(pos, m, 16, 20.0, 43.007, 0.0)
    assert float((got - want).abs().max() / want.abs().max()) < 2e-6


@pytest.mark.parametrize("case", ["dtype", "shape", "strided", "fields",
                                  "axis", "spectrum", "layout"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    pos, m = _particles(n=64)
    green, kx, _, _ = pm._spectral(16, 20.0, 0.0, True, "cpu")
    rho_k = torch.zeros((16, 16, 9), dtype=torch.complex64)
    field = torch.zeros((16, 16, 16))
    calls = {
        "dtype": lambda: pm_cic.cic_scatter(pos.double(), m, 16, 20.0),
        "shape": lambda: pm_cic.cic_scatter(pos, m[:-1], 16, 20.0),
        "strided": lambda: pm_cic.cic_gather3(
            [field] * 3, torch.zeros((64, 6))[:, ::2], 16, 20.0),
        "fields": lambda: pm_cic.cic_gather3([field, field, field[:8]], pos,
                                             16, 20.0),
        "axis": lambda: pm_cic.green_gradient(rho_k, green, kx, 3),
        "spectrum": lambda: pm_cic.green_gradient(rho_k[:, :, :8], green,
                                                  kx, 0),
        # dense, but not in green's layout
        "layout": lambda: pm_cic.green_gradient(
            rho_k.permute(2, 1, 0).contiguous().permute(2, 1, 0), green,
            kx, 0)}
    with pytest.raises(ValueError):
        calls[case]()


# -- the engine's stateless pm step ------------------------------------------

def _config(output_frequency=5):
    return tlc.SimulationConfig.from_dict({
        "particles": {"num_particles": N1 ** 3, "box_size": BOX},
        "forces": {"type": "pm", "pm_grid_size": NG},
        "cosmology": {"omega_m": OMEGA_M, "omega_lambda": OMEGA_L,
                      "initial_redshift": 49.0, "final_redshift": 0.0},
        "integration": {"adaptive_timestep": False, "max_dloga": 0.0,
                        "kick_mode": "comoving"},
        "time": {"initial_timestep": DT, "final_time": 1e9},
        "simulation": {"output_frequency": output_frequency,
                       "checkpoint_frequency": 0},
        "profiling": {"output_file": ""},
        "logging": {"performance_logging": False}})


def _state(rest=False):
    """A perturbed 12^3 lattice at z = 49 with the mean density of
    Omega_m (G = 43.007, H0 = 100 internal units), seeded."""
    rng = np.random.default_rng(22)
    q = (np.stack(np.meshgrid(*[np.arange(N1)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) * BOX / N1
    pos = np.mod(q + rng.normal(0.0, 0.3, q.shape), BOX).astype(np.float32)
    vel = rng.normal(0.0, 5.0, q.shape).astype(np.float32)
    if rest:
        vel[:] = 0.0
    mass = np.full(N1 ** 3, 27.754 * OMEGA_M * BOX ** 3 / N1 ** 3,
                   np.float32)
    return tlc.make_state(pos, vel, mass, scale_factor=A0)


def _engine(rest=False, **kw):
    return (tlc.SimulationBuilder(device="cpu").with_config(_config(**kw))
            .with_initial_state(_state(rest)).build())


def _gap(v, w):
    scale = torch.sqrt(torch.mean(torch.sum(w * w, dim=1)))
    return float(torch.max(torch.linalg.norm(v - w, dim=1)) / scale)


@pytest.mark.parametrize("rest", [False, True], ids=["moving", "rest"])
def test_engine_pm_step_matches_the_float64_reference(rest):
    from nbody_bench import reference
    eng = _engine(rest)
    st0 = eng.state
    st1 = eng.step(1)
    geometry = {"law": "pm", "box": BOX, "ng": NG, "rs": 1.0, "r_cut": 1.0,
                "softening": 0.0, "g_const": float(eng.config.units.G),
                "omega_m": OMEGA_M, "omega_lambda": OMEGA_L}
    targets = torch.arange(N1 ** 3)
    acc0, acc1 = (reference.forces(st.positions, st.masses, targets,
                                   geometry=geometry) for st in (st0, st1))
    v0 = st0.velocities.double()
    dv, drift = reference.kdk(acc0, acc1, v0, a0=float(st0.scale_factor),
                              dt=DT, omega_m=OMEGA_M, omega_lambda=OMEGA_L)
    got_drift = st1.positions.double() - st0.positions.double()
    got_drift -= BOX * torch.round(got_drift / BOX)
    # float32 against float64: the mesh sums' and the scale factor's
    # rounding read 6e-6 to 8e-6 here; the TF32 control reads 2.5e-3
    assert _gap(st1.velocities.double() - v0, dv) < 1e-4
    assert _gap(got_drift, drift) < 1e-4


def test_pm_forces_counts_steps_plus_a_reset():
    profiling.reset_trace()
    eng = _engine()
    start = eng.state
    with profiling.tracing():
        for _ in range(2):
            eng.state = start
            eng.run(num_steps=10)
        counters = profiling.trace_totals()["counters"]
    profiling.reset_trace()
    # a segment: the reset drops the force, the run's first step
    # evaluates it again, then one evaluation a step
    assert counters["pm_forces"] == 2 * (10 + 1)


def test_pm_spans_open_inside_fast_accel():
    profiling.reset_trace()
    eng = _engine()
    with profiling.tracing():
        eng.run(num_steps=5)
        spans = profiling.trace_totals()["spans"]
    profiling.reset_trace()
    for name in ("pm.deposit", "pm.solve", "pm.gather"):
        assert spans[name]["parents"] == ["fast.accel"]
        assert spans[name]["count"] == spans["fast.accel"]["count"] == 6


def test_factors_computed_ahead_leave_the_run_bit_for_bit():
    """Chunks whose scale factors the previous chunk computed ahead give
    the states that kdk_step_fused computing its own gives."""
    from lambda_cdm_tpu_torch.physics.integrators import kdk_step_fused
    eng = _engine()
    st, acc = eng.state, None
    got = eng.run(num_steps=15)          # three chunks of 5
    assert eng._ahead is not None
    force = eng.accel_fn
    acc = force(st)
    cfg = eng.config
    for _ in range(15):
        st, acc = kdk_step_fused(st, acc, force, cfg.cosmology_params(),
                                 eng._dt, BOX, kick_mode="comoving")
    for name in ("positions", "velocities", "scale_factor", "time"):
        assert torch.equal(getattr(got, name), getattr(st, name)), name


@pytest.mark.parametrize("dt_rule", ["fixed", "max_dloga"])
def test_each_steps_factors_are_computed_once(monkeypatch, dt_rule):
    """A run of three chunks computes each step's scale factors once:
    with a fixed dt a chunk computes the next chunk's ahead and the last
    chunk none; where dt changes between chunks, none ahead."""
    from lambda_cdm_tpu_torch.physics import integrators
    real, calls = integrators.kdk_factors, []

    def counted(*args, **kw):
        calls.append(float(args[1]))
        return real(*args, **kw)

    monkeypatch.setattr(integrators, "kdk_factors", counted)
    cfg = _config()
    # steps short enough that the run's exact-stop clamp at z = 0 keeps
    # every chunk at 5 steps
    cfg.time.initial_timestep = DT / 20
    cfg.integration.max_dloga = 1e-3 if dt_rule == "max_dloga" else 0.0
    eng = (tlc.SimulationBuilder(device="cpu").with_config(cfg)
           .with_initial_state(_state()).build())
    got = eng.run(num_steps=15)
    assert len(calls) == 15
    assert len(set(calls)) == 15
    assert calls[-1] < float(got.scale_factor)


@pytest.mark.parametrize("periodic", [True, False])
def test_flat_kdk_plain_is_the_steps_chain(periodic):
    """ops/kdk_update's flat forms on CPU tensors are the chain of
    operations kdk_step_fused wrote before them, with its 0-d host
    scalars, bit for bit; strided rows are taken as they are."""
    from lambda_cdm_tpu_torch.ops import kdk_update
    from lambda_cdm_tpu_torch.physics.integrators import kdk_factors, \
        wrap_positions
    gen = torch.Generator().manual_seed(9)
    p = torch.rand((3000, 3), generator=gen) * BOX
    v = torch.randn((6, 3000), generator=gen).t()[:, :3]   # strided
    acc, acc1 = torch.randn((2, 3000, 3), generator=gen) * 1e3
    dt = torch.tensor(2e-4)
    f = kdk_factors(pm_cic_params(), torch.tensor(A0), dt,
                    kick_mode="comoving")
    vel = v + acc * (0.5 * dt) * f.kf0
    pos = p + vel * dt * f.df
    if periodic:
        pos = wrap_positions(pos, BOX)
    got_pos, got_vel = kdk_update.kdk_open_flat(
        p, v, acc, half_dt=f.half_dt, kf=f.kf0, dt=dt, df=f.df,
        box=BOX if periodic else None)
    assert torch.equal(got_pos, pos) and torch.equal(got_vel, vel)
    assert torch.equal(
        kdk_update.kdk_kick_flat(vel, acc1, s1=f.half_dt, s2=f.kf1),
        vel + acc1 * (0.5 * dt) * f.kf1)


def pm_cic_params():
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    return CosmologyParams(omega_m=OMEGA_M, omega_lambda=OMEGA_L)
