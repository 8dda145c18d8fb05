"""The port's flat-sky angular spectra (angular_power_spectrum,
shear_eb_spectra in lambda_cdm_tpu_torch.analysis.power_spectrum) against
the JAX package's on the same numpy maps.

Tolerances: whole modes may change log (or linear) bins under float32
rounding of |l| between the frameworks, as with P(k), so the binned
spectra are held by the assignment-invariant rule of the P(k) tests
(`assert_binned_match`: equal-count bins within 1e-4 relative in power
and mean ell, runs of bins whose counts differ conserving their count
with count-weighted power within 1e-3). The bins sum in float64 in the
port and in float32 in the JAX package (measured <= 1e-6).
"""

import numpy as np
import pytest

from _torch_parity import assert_binned_match, nn, tt

import jax.numpy as jnp

from lambda_cdm_tpu.analysis import power_spectrum as jps
from lambda_cdm_tpu.raytracing import lensing as jl
from lambda_cdm_tpu_torch.analysis import power_spectrum as tps
from lambda_cdm_tpu_torch.raytracing import lensing as tl


def _map(n, seed, smooth=0.0):
    """A zero-mean [n, n] float32 map: white noise, optionally smoothed by
    a Gaussian of `smooth` pixels (red spectrum)."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    if smooth:
        k = np.fft.fftfreq(n)
        g = np.exp(-0.5 * (2 * np.pi * smooth) ** 2
                   * (k[:, None] ** 2 + k[None, :] ** 2))
        m = np.fft.ifft2(np.fft.fft2(m) * g).real
    return (m - m.mean()).astype(np.float32)


@pytest.mark.parametrize("n,fov,num_bins,log_bins,ell_range", [
    (64, 0.1, 16, True, None),
    (128, 0.05, 12, True, (200.0, 5000.0)),
    (64, 0.2, 24, False, None),
    (63, 0.1, 10, True, None),
])
def test_angular_power_spectrum_matches(n, fov, num_bins, log_bins,
                                        ell_range):
    m = _map(n, seed=n + num_bins, smooth=2.0)
    kw = dict(num_bins=num_bins, log_bins=log_bins)
    if ell_range:
        kw.update(ell_min=ell_range[0], ell_max=ell_range[1])
    lj, cj, nj = jps.angular_power_spectrum(jnp.asarray(m), fov, **kw)
    lt, ct, nt = tps.angular_power_spectrum(tt(m), fov, **kw)
    assert ct.shape == (num_bins,) and str(ct.dtype) == "torch.float32"
    assert_binned_match(nt, nj, ct, cj, lt, lj)
    # Parseval over the default range: sum C counts / fov^2 = <m^2>
    if ell_range is None:
        total = float((ct.double() * nt.double()).sum()) / fov ** 2
        assert np.isclose(total, float(np.mean(m.astype(np.float64) ** 2)),
                          rtol=1e-4)


def test_cross_spectrum_matches():
    n, fov = 64, 0.1
    a = _map(n, seed=2, smooth=1.5)
    b = a + 0.5 * _map(n, seed=3)
    for x, y in ((a, b), (b, a), (a, a)):
        lj, cj, nj = jps.angular_power_spectrum(jnp.asarray(x), fov,
                                                jnp.asarray(y), num_bins=10)
        lt, ct, nt = tps.angular_power_spectrum(tt(x), fov, tt(y),
                                                num_bins=10)
        assert_binned_match(nt, nj, ct, cj, lt, lj)
    _, c_aa, _ = tps.angular_power_spectrum(tt(a), fov, num_bins=10)
    _, c_aa2, _ = tps.angular_power_spectrum(tt(a), fov, tt(a), num_bins=10)
    np.testing.assert_allclose(nn(c_aa), nn(c_aa2), rtol=1e-6)


@pytest.mark.parametrize("ell_cut", [0.95, None])
def test_shear_eb_spectra_matches(ell_cut):
    """The E/B spectra of the shear of one kappa map: the port against the
    JAX package channel by channel, and the port's own null test (C_EE =
    C_kappakappa to 1e-4, C_BB < 1e-8 C_EE, |C_EB| < 1e-4 C_EE below the
    axis Nyquist, the JAX package's bars)."""
    n, fov = 128, 0.1
    kappa = _map(n, seed=5, smooth=1.0)
    gj = jl.shear_from_kappa(jnp.asarray(kappa), fov, ng=n)
    gt = tl.shear_from_kappa(tt(kappa), fov, ng=n)
    np.testing.assert_allclose(nn(gt), np.asarray(gj), rtol=0,
                               atol=1e-5 * float(np.abs(gj).max()))
    kw = dict(num_bins=12)
    if ell_cut:
        kw["ell_max"] = ell_cut * np.pi * n / fov
    rj = jps.shear_eb_spectra(gj[0], gj[1], fov, **kw)
    rt = tps.shear_eb_spectra(gt[0], gt[1], fov, **kw)
    assert len(rt) == 5
    assert_binned_match(rt[4], rj[4], rt[1], rj[1], rt[0], rj[0])
    # C_BB and C_EB are round-off (~1e-14 of C_EE) below the axis Nyquist
    # and differ between frameworks there: held per bin within 1e-4 of
    # C_EE (the Nyquist rows' E-to-B leak included)
    same = nn(rt[4]) == np.asarray(rj[4])
    cee_j = np.asarray(rj[1])[same]
    for c in (2, 3):
        d = np.abs(nn(rt[c])[same] - np.asarray(rj[c])[same])
        assert np.all(d <= 1e-4 * cee_j)
    if not ell_cut:
        return
    _, ckk, _ = tps.angular_power_spectrum(tt(kappa), fov, **kw)
    ok = nn(rt[4]) > 0
    cee, cbb, ceb = (nn(rt[c])[ok] for c in (1, 2, 3))
    np.testing.assert_allclose(cee, nn(ckk)[ok], rtol=1e-4)
    assert np.all(cbb < 1e-8 * cee)
    assert np.all(np.abs(ceb) < 1e-4 * cee)
