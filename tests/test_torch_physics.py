"""Background cosmology, linear power spectra and integrator helpers of the
PyTorch port against the JAX package, on a grid of scale factors and
wavenumbers (float32 on both sides)."""

import numpy as np
import pytest
import torch

from _torch_parity import max_rel, nn, tt

import jax.numpy as jnp

import lambda_cdm_tpu.physics.cosmology as jcos
import lambda_cdm_tpu.physics.integrators as jint
import lambda_cdm_tpu.physics.power_spectra as jps
import lambda_cdm_tpu_torch.physics.cosmology as tcos
import lambda_cdm_tpu_torch.physics.integrators as tint
import lambda_cdm_tpu_torch.physics.power_spectra as tps

# float32 round-off: the same formulas in the same order, but pow, exp and
# log are different library calls in XLA and PyTorch (measured <= 5e-7,
# four ulps; the bound allows sixteen)
RTOL = 2e-6

A_GRID = np.geomspace(0.01, 1.0, 64).astype(np.float32)
K_GRID = np.geomspace(1e-3, 30.0, 200).astype(np.float32)

PARAMS = [dict(), dict(omega_m=0.3, omega_lambda=0.7, h=0.7, sigma8=0.8),
          dict(w0=-0.9, wa=0.1)]


def _pair(kw):
    return jcos.CosmologyParams(**kw), tcos.CosmologyParams(**kw)


@pytest.mark.parametrize("kw", PARAMS)
@pytest.mark.parametrize("fn", ["e_function", "hubble", "omega_m_a",
                                "growth_factor", "growth_rate"])
def test_background(fn, kw):
    jp, tp = _pair(kw)
    ref = getattr(jcos, fn)(jp, jnp.asarray(A_GRID))
    got = getattr(tcos, fn)(tp, tt(A_GRID))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nn(got), nn(ref), rtol=RTOL)


@pytest.mark.parametrize("kw", PARAMS[:2])
@pytest.mark.parametrize("name", ["bbks", "eisenstein_hu", "eh98_nowiggle"])
def test_transfer_functions(name, kw):
    jp, tp = _pair(kw)
    ref = jps.TRANSFERS[name](jp, jnp.asarray(K_GRID))
    got = tps.TRANSFERS[name](tp, tt(K_GRID))
    np.testing.assert_allclose(nn(got), nn(ref), rtol=RTOL)


@pytest.mark.parametrize("kw", PARAMS[:2])
def test_sigma8_normalization_and_linear_power(kw):
    """The 128-point quadrature is summed in another order, and P(k)
    multiplies four rounded factors (measured <= 1e-6): 4e-6."""
    jp, tp = _pair(kw)
    for name in ("bbks", "eisenstein_hu"):
        ref = jps.sigma8_normalization(jp, jps.TRANSFERS[name])
        got = tps.sigma8_normalization(tp, tps.TRANSFERS[name])
        assert abs(float(got) / float(ref) - 1.0) < 4e-6
    for z in (0.0, 9.0, 49.0):
        ref = jps.linear_power(jp, jnp.asarray(K_GRID), z=z)
        got = tps.linear_power(tp, tt(K_GRID), z=z)
        assert max_rel(got, ref) < 4e-6


@pytest.mark.parametrize("method", ["rk4", "euler"])
@pytest.mark.parametrize("dt", [1e-6, 1e-4, 2e-3])
def test_update_scale_factor(method, dt):
    jp, tp = _pair({})
    for a in (0.02, 0.1, 0.5, 1.0):
        ref = jint.update_scale_factor(jp, jnp.float32(a), jnp.float32(dt),
                                       100.0, method)
        got = tint.update_scale_factor(tp, torch.tensor(a), dt, 100.0,
                                       method)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref), rtol=2e-7)


@pytest.mark.parametrize("mode", ["reference", "comoving", "newtonian"])
def test_kick_and_drift_factors(mode):
    a = A_GRID
    np.testing.assert_allclose(nn(tint.kick_factor(tt(a), mode)),
                               nn(jint.kick_factor(jnp.asarray(a), mode)),
                               rtol=1e-7)
    np.testing.assert_allclose(nn(tint.drift_factor(tt(a), mode)),
                               nn(jint.drift_factor(jnp.asarray(a), mode)),
                               rtol=1e-7)
    with pytest.raises(ValueError):
        tint.kick_factor(tt(a), "bogus")


def test_wrap_positions_is_bitwise():
    rng = np.random.default_rng(1)
    box = 37.5
    x = np.concatenate([
        rng.uniform(-box, 2 * box, 4000),
        [-1e-7, -0.0, 0.0, box, box - 1e-6, 2 * box, -box, 1e-30]
    ]).astype(np.float32)
    ref = np.asarray(jint.wrap_positions(jnp.asarray(x), box))
    got = nn(tint.wrap_positions(tt(x), box))
    np.testing.assert_array_equal(got, ref)


def test_adaptive_dt():
    rng = np.random.default_rng(2)
    jp, tp = _pair({})
    acc = rng.normal(size=(500, 3)).astype(np.float32) * 50.0
    for hub, dloga in ((None, 0.0), (100.0 * 7.5, 0.01)):
        ref = jint.adaptive_dt(jnp.asarray(acc), 0.05, 1e-3, 1e-7, 1e-2,
                               hubble=None if hub is None
                               else jnp.float32(hub), max_dloga=dloga)
        got = tint.adaptive_dt(tt(acc), 0.05, 1e-3, 1e-7, 1e-2,
                               hubble=None if hub is None
                               else torch.tensor(hub), max_dloga=dloga)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cosmological", [True, False])
def test_kdk_steps(fused, cosmological):
    """Three KDK steps of 300 particles under the direct sum from one
    state in both packages (kdk_step: two force evaluations a step;
    kdk_step_fused: one, the closing force carried): positions to 1e-6 of
    the box, velocities to 1e-5 of the largest (float32 forces summed in
    another order), the scale factor to 2e-7 (the RK4 step's bar)."""
    from lambda_cdm_tpu.core.state import make_state as jmake_state
    from lambda_cdm_tpu.forces import direct as jdirect
    from lambda_cdm_tpu_torch.core.state import make_state as tmake_state
    from lambda_cdm_tpu_torch.forces import direct as tdirect
    box, soft, dt = 20.0, 0.2, 2e-3
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.0, box, (300, 3)).astype(np.float32)
    vel = rng.normal(0.0, 0.5, (300, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, 300).astype(np.float32)
    jp, tp = _pair({})
    kw = dict(h0_internal=100.0, cosmological=cosmological,
              kick_mode="reference" if cosmological else "newtonian")

    def jacc(s):
        return jdirect.direct_accelerations(s.positions, s.masses, box, soft)

    def tacc(s):
        return tdirect.direct_accelerations(s.positions, s.masses, box, soft)

    js = jmake_state(pos, vel, m, scale_factor=0.1)
    ts = tmake_state(pos, vel, m, scale_factor=0.1)
    ja, ta = jacc(js), tacc(ts)
    for _ in range(3):
        if fused:
            js, ja = jint.kdk_step_fused(js, ja, jacc, jp, dt, box, **kw)
            ts, ta = tint.kdk_step_fused(ts, ta, tacc, tp, dt, box, **kw)
        else:
            js = jint.kdk_step(js, jacc, jp, dt, box, **kw)
            ts = tint.kdk_step(ts, tacc, tp, dt, box, **kw)
    d = (nn(ts.positions) - nn(js.positions) + box / 2) % box - box / 2
    assert np.abs(d).max() < 1e-6 * box
    assert max_rel(ts.velocities, js.velocities) < 1e-5
    np.testing.assert_allclose(float(ts.scale_factor),
                               float(js.scale_factor), rtol=2e-7)
    assert int(ts.step) == int(js.step) == 3
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-6)
    if fused:
        assert max_rel(ta, ja) < 1e-5


Z_GRID = np.concatenate([[0.0], np.geomspace(1e-3, 20.0, 63)]) \
    .astype(np.float32)


@pytest.mark.parametrize("kw", PARAMS + [dict(omega_m=0.3, omega_lambda=0.6,
                                              omega_k=0.1),
                                         dict(omega_m=0.3, omega_lambda=0.8,
                                              omega_k=-0.1)])
@pytest.mark.parametrize("fn", ["comoving_distance",
                                "transverse_comoving_distance",
                                "angular_diameter_distance",
                                "luminosity_distance"])
def test_distances(fn, kw):
    """The 128-point Gauss-Legendre distance integrals, vectorized over z
    (open and closed geometries too): the quadrature is summed in another
    order (measured <= 3e-7), the RTOL of the background functions."""
    jp, tp = _pair(kw)
    ref = getattr(jcos, fn)(jp, jnp.asarray(Z_GRID))
    got = getattr(tcos, fn)(tp, tt(Z_GRID))
    assert got.dtype == torch.float32 and got.shape == Z_GRID.shape
    np.testing.assert_allclose(nn(got), nn(ref), rtol=RTOL)


def test_distance_scalars_and_times():
    """Scalar z gives a 0-d result, as in the JAX package; the times are
    integrals over ln a of one scale factor (the JAX functions take no
    arrays there)."""
    jp, tp = _pair({})
    for z in (0.5, [1.0], np.float32(3.0)):
        got = tcos.comoving_distance(tp, z)
        ref = jcos.comoving_distance(jp, jnp.asarray(z, jnp.float32))
        assert got.shape == np.shape(ref) == ()
        np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    for a in (0.02, 0.3, 1.0):
        for fn in ("conformal_time", "cosmic_time"):
            np.testing.assert_allclose(float(getattr(tcos, fn)(tp, a)),
                                       float(getattr(jcos, fn)(jp, a)),
                                       rtol=RTOL)
    np.testing.assert_allclose(float(tcos.age_of_universe(tp)),
                               float(jcos.age_of_universe(jp)), rtol=RTOL)
    for z in (0.0, 0.7, 9.0):
        np.testing.assert_allclose(float(tcos.lookback_time(tp, z)),
                                   float(jcos.lookback_time(jp, z)),
                                   rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        nn(tcos.scale_factor_to_redshift(tt(A_GRID))),
        nn(jcos.scale_factor_to_redshift(jnp.asarray(A_GRID))), rtol=1e-7)
    np.testing.assert_allclose(
        nn(tcos.redshift_to_scale_factor(tt(Z_GRID))),
        nn(jcos.redshift_to_scale_factor(jnp.asarray(Z_GRID))), rtol=1e-7)


@pytest.mark.parametrize("kw", PARAMS)
def test_scale_factor_at_chi(kw):
    """a(chi) through the port's interp (searchsorted and a lerp, clamped
    at both ends as jnp.interp clamps), on chi inside, at the ends of and
    beyond the table."""
    jp, tp = _pair(kw)
    chi_max = float(jcos.comoving_distance(jp, 20.0))
    chi = np.concatenate([np.linspace(0.0, chi_max, 301),
                          [-5.0, chi_max * 1.5, 1e-3]]).astype(np.float32)
    ref = jcos.scale_factor_at_chi(jp, jnp.asarray(chi))
    got = tcos.scale_factor_at_chi(tp, tt(chi))
    np.testing.assert_allclose(nn(got), nn(ref), rtol=RTOL)
    assert float(got[-3]) == 1.0 and float(got[-2]) == pytest.approx(
        1.0 / 21.0, rel=1e-6)
