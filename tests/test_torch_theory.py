"""analysis/theory.py and physics/power_spectra.sigma_r of the PyTorch port
against the JAX package on the same inputs: sigma(R), sigma(M), the
finite-difference slope d ln sigma / d ln M, the Press-Schechter and
Sheth-Tormen mass functions, linear bias, the NFW functions, the Duffy08
concentration and its fit, the HOD occupations and the galaxy number
density.

Both packages integrate sigma^2 in float32 with 128 Gauss-Legendre nodes,
summed in another order: sigma agrees to ~6e-7, and the slope, a
difference of two sigmas 0.1 apart in ln M, amplifies that to ~9e-5; the
sigma integrals and everything built on the slope are held at 1e-4, the
rest at 1e-5."""

import numpy as np
import pytest
import torch

from _torch_parity import max_rel, tt

import jax.numpy as jnp

from lambda_cdm_tpu.analysis import theory as jth
from lambda_cdm_tpu.physics import cosmology as jcos, power_spectra as jps
from lambda_cdm_tpu.physics.cosmology import CosmologyParams as JParams
from lambda_cdm_tpu_torch.analysis import theory as tth
from lambda_cdm_tpu_torch.physics import cosmology as tcos, \
    power_spectra as tps
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams as TParams

TOL = 1e-5
TOL_SIGMA = 1e-4
PARAMS = [dict(), dict(omega_m=0.3, omega_lambda=0.7, h=0.7, sigma8=0.8)]
MASSES = np.logspace(0.5, 5.0, 9).astype(np.float32)   # 3e10..1e15 Msun/h


def _pp(kw):
    return JParams(**kw), TParams(**kw)


def _rel(got, ref):
    """Largest elementwise relative difference."""
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


@pytest.mark.parametrize("kw", PARAMS)
@pytest.mark.parametrize("transfer", ["eh98", "bbks"])
def test_sigma_r(kw, transfer):
    jp, tp = _pp(kw)
    r = np.array([0.5, 1.0, 3.0, 8.0, 20.0, 60.0], np.float32)
    ref = jps.sigma_r(jp, jnp.asarray(r), transfer=jps.TRANSFERS[transfer])
    got = tps.sigma_r(tp, tt(r), transfer=tps.TRANSFERS[transfer])
    assert got.shape == (6,) and got.dtype == torch.float32
    assert _rel(got, ref) < TOL_SIGMA
    one = tps.sigma_r(tp, 8.0, transfer=tps.TRANSFERS[transfer])
    assert one.shape == () and abs(float(one) - jp.sigma8) < TOL_SIGMA


@pytest.mark.parametrize("kw", PARAMS)
@pytest.mark.parametrize("z", [0.0, 1.0])
def test_sigma_m_and_slope(kw, z):
    jp, tp = _pp(kw)
    m = jnp.asarray(MASSES)
    assert _rel(tth.mass_to_radius(tp, tt(MASSES)),
                jth.mass_to_radius(jp, m)) < TOL
    assert _rel(tth.sigma_m(tp, tt(MASSES), z), jth.sigma_m(jp, m, z)) \
        < TOL_SIGMA
    assert _rel(tth._dlnsigma_dlnm(tp, tt(MASSES), z),
                jth._dlnsigma_dlnm(jp, m, z)) < TOL_SIGMA


@pytest.mark.parametrize("kw", PARAMS)
@pytest.mark.parametrize("z", [0.0, 0.5])
@pytest.mark.parametrize("kind", ["sheth_tormen", "press_schechter"])
def test_mass_function(kw, z, kind):
    jp, tp = _pp(kw)
    ref = jth.mass_function(jp, jnp.asarray(MASSES), z, kind=kind)
    got = tth.mass_function(tp, tt(MASSES), z, kind=kind)
    assert _rel(got, ref) < TOL_SIGMA


@pytest.mark.parametrize("z", [0.0, 1.0])
def test_linear_bias(z):
    jp, tp = _pp({})
    assert _rel(tth.linear_bias(tp, tt(MASSES), z),
                jth.linear_bias(jp, jnp.asarray(MASSES), z)) < TOL_SIGMA


def test_multiplicities():
    nu = np.linspace(0.2, 5.0, 25).astype(np.float32)
    assert _rel(tth.sheth_tormen_multiplicity(tt(nu)),
                jth.sheth_tormen_multiplicity(jnp.asarray(nu))) < TOL
    assert _rel(tth.press_schechter_multiplicity(tt(nu)),
                jth.press_schechter_multiplicity(jnp.asarray(nu))) < TOL


def test_nfw_functions():
    r = np.linspace(0.01, 1.5, 30).astype(np.float32)
    rho_j, rs_j = jth.nfw_params_from_m_c(100.0, 0.8, 7.0)
    rho_t, rs_t = tth.nfw_params_from_m_c(100.0, 0.8, 7.0)
    assert abs(rho_t - float(rho_j)) <= TOL * abs(float(rho_j))
    assert abs(rs_t - float(rs_j)) <= TOL * abs(float(rs_j))
    assert _rel(tth.nfw_density(tt(r), rho_t, rs_t),
                jth.nfw_density(jnp.asarray(r), rho_j, rs_j)) < TOL
    assert _rel(tth.nfw_enclosed_mass(tt(r), rho_t, rs_t),
                jth.nfw_enclosed_mass(jnp.asarray(r), rho_j, rs_j)) < TOL
    m = np.logspace(0, 5, 11).astype(np.float32)
    assert _rel(tth.concentration_duffy08(tt(m), 0.5),
                jth.concentration_duffy08(jnp.asarray(m), 0.5)) < TOL


@pytest.mark.parametrize("c_true,noise", [(7.0, 0.0), (4.0, 0.05),
                                          (15.0, 0.1)])
def test_fit_nfw_concentration(c_true, noise):
    """A profile drawn at c_true with multiplicative noise (numpy seed):
    both packages pick the same grid point."""
    r = np.linspace(0.01, 1.0, 40).astype(np.float32)
    rho_s, r_s = jth.nfw_params_from_m_c(100.0, 0.8, c_true)
    m_enc = np.asarray(jth.nfw_enclosed_mass(jnp.asarray(r), rho_s, r_s))
    m_enc = (m_enc * (1.0 + noise * np.random.default_rng(3).standard_normal(
        r.shape))).astype(np.float32)
    ref = float(jth.fit_nfw_concentration(jnp.asarray(r),
                                          jnp.asarray(m_enc), 0.8, 100.0))
    got = tth.fit_nfw_concentration(tt(r), tt(m_enc), 0.8, 100.0)
    assert got.shape == () and float(got) == ref
    if noise == 0.0:
        assert abs(ref - c_true) <= 0.25 + 1e-6   # the grid's spacing


def test_hod():
    m = np.logspace(-0.5, 5, 23).astype(np.float32)
    assert max_rel(tth.hod_central(tt(m)), jth.hod_central(jnp.asarray(m))) \
        < TOL
    kw = dict(log_m0=1.2, log_m1=2.3, alpha=0.9, log_m_min=1.1,
              sigma_logm=0.3)
    assert max_rel(tth.hod_satellites(tt(m), **kw),
                   jth.hod_satellites(jnp.asarray(m), **kw)) < TOL


@pytest.mark.parametrize("z,hod", [(0.0, None),
                                   (0.5, dict(log_m_min=1.3,
                                              sigma_logm=0.25, alpha=1.1))])
def test_galaxy_number_density(z, hod):
    jp, tp = _pp({})
    ref = float(jth.galaxy_number_density(jp, z, hod_kwargs=hod))
    got = tth.galaxy_number_density(tp, z, hod_kwargs=hod, device="cpu")
    assert got.shape == () and abs(float(got) - ref) <= TOL_SIGMA * ref


@pytest.mark.parametrize("kw", PARAMS + [dict(w0=-0.9, wa=0.1)])
def test_growth_factor_exact(kw):
    """The ODE growth factor (the science run's growth^2 bars): the same
    float32 RK4, to 1e-6 at single scale factors and over an array whose
    largest a sets the grid."""
    jp, tp = _pp(kw)
    a = np.array([0.04, 0.1, 0.4291849, 0.75, 1.0003], np.float32)
    assert _rel(tcos.growth_factor_exact(tp, tt(a)),
                jcos.growth_factor_exact(jp, jnp.asarray(a))) < 1e-6
    for x in (0.04, 1.0):
        assert abs(float(tcos.growth_factor_exact(tp, x))
                   - float(jcos.growth_factor_exact(jp, x))) \
            <= 1e-6 * float(jcos.growth_factor_exact(jp, x))


def test_explicit_device():
    """Number inputs go to `device`; tensor inputs keep theirs."""
    tp = TParams()
    got = tth.mass_function(tp, 100.0, device="cpu")
    assert got.device.type == "cpu" and got.shape == ()
    assert tth.hod_central(torch.tensor([10.0])).shape == (1,)
