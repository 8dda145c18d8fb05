"""The port's P(k) analysis (lambda_cdm_tpu_torch.analysis.power_spectrum)
against the JAX package's on the same numpy particles.

Tolerances: deposits within 1e-5 of the largest cell (float32 scatter-adds
summed in another order). Binned spectra by the assignment-invariant rule
of bench.py: a mode whose |k| sits on a bin edge may fall on either side
under float32 rounding, so bins whose mode counts agree must agree exactly
in counts and within 1e-4 relative in power (relative to the larger of
the bin's |P| and 1% of the largest bin's: the Legendre weights of the
multipoles cancel to near zero in some bins) and in mean k; over each run
of adjacent bins whose counts differ, the mode count is conserved and the
count-weighted power agrees within 1e-3.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_binned_match, max_rel, nn, tt

import jax.numpy as jnp

from lambda_cdm_tpu.analysis import power_spectrum as jps
from lambda_cdm_tpu_torch.analysis import power_spectrum as tps
from lambda_cdm_tpu_torch.interop import power_spectrum_to_arrays

BOX = 100.0


def _particles(n=20000, seed=1):
    """Clustered particles: a uniform background and Gaussian clumps, with
    velocities and masses."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(0, BOX, (30, 3))
    nc = n // 3
    pos = np.concatenate([rng.uniform(0, BOX, (n - nc, 3)),
                          cent[rng.integers(0, 30, nc)]
                          + 2.0 * rng.standard_normal((nc, 3))]) % BOX
    vel = rng.normal(0, 300.0, (n, 3))
    m = rng.uniform(0.5, 1.5, n)
    return (pos.astype(np.float32), vel.astype(np.float32),
            m.astype(np.float32))


@pytest.mark.parametrize("kind", ["ngp", "cic", "tsc"])
def test_deposits_match(kind):
    pos, _, m = _particles(5000)
    for w in (None, m):
        gj = jps.DEPOSITS[kind](jnp.asarray(pos), 16, BOX,
                                None if w is None else jnp.asarray(w))
        gt = tps.DEPOSITS[kind](tt(pos), 16, BOX,
                                None if w is None else tt(w))
        assert gt.shape == (16, 16, 16)
        assert max_rel(gt, gj) <= 1e-5
        ref = float(len(pos) if w is None else w.sum())
        assert abs(float(gt.double().sum()) - ref) <= 1e-5 * ref


def test_window_and_multiplicity_match():
    for ng in (8, 9, 16):
        np.testing.assert_array_equal(
            nn(tps._hermitian_multiplicity(ng)),
            np.asarray(jps._hermitian_multiplicity(ng)))
        for kind in ("ngp", "cic", "tsc"):
            assert max_rel(tps.assignment_window(ng, BOX, kind),
                           jps.assignment_window(ng, BOX, kind)) <= 1e-6


def test_bin_index_matches():
    k = np.random.default_rng(0).uniform(0, 3.0, 20000).astype(np.float32)
    k[:10] = 0.0
    for log_bins in (True, False):
        bj = jps._bin_index(jnp.asarray(k), 0.06, 2.0, 32, log_bins=log_bins)
        bt = tps._bin_index(tt(k), 0.06, 2.0, 32, log_bins=log_bins)
        # a k within one ulp of an edge may fall on either side
        d = np.abs(nn(bt) - np.asarray(bj))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("assignment,ng,kw", [
    ("cic", 32, {}),
    ("tsc", 32, {"num_bins": 20}),
    ("ngp", 24, {"subtract_shot_noise": False}),
    ("cic", 32, {"deconvolve": False, "k_min": 0.1, "k_max": 0.8}),
])
def test_measure_power_spectrum_matches(assignment, ng, kw):
    pos, _, m = _particles()
    weights = m if assignment == "tsc" else None
    dj = jps.measure_power_spectrum(
        jnp.asarray(pos), BOX, ng=ng, assignment=assignment,
        weights=None if weights is None else jnp.asarray(weights), **kw)
    dt = tps.measure_power_spectrum(
        tt(pos), BOX, ng=ng, assignment=assignment,
        weights=None if weights is None else tt(weights), **kw)
    at = power_spectrum_to_arrays(dt)
    assert_binned_match(at["counts"], dj.counts, at["power"], dj.power,
                        at["k"], dj.k)
    assert_binned_match(at["counts"], dj.counts, at["power_raw"],
                        dj.power_raw)
    for f in ("shot_noise", "box_size", "num_particles"):
        np.testing.assert_allclose(at[f], np.asarray(getattr(dj, f)),
                                   rtol=1e-6)


def test_power_from_delta_linear_bins():
    rng = np.random.default_rng(4)
    delta = rng.standard_normal((16, 16, 16)).astype(np.float32)
    kw = dict(ng=16, box_size=BOX, num_particles=4096, num_bins=12,
              log_bins=False)
    dj = jps.power_from_delta(jnp.asarray(delta), **kw)
    dt = tps.power_from_delta(tt(delta), **kw)
    assert_binned_match(dt.counts, dj.counts, dt.power, dj.power, dt.k,
                        dj.k)


def test_cross_power_matches():
    pos, _, _ = _particles()
    pos_b = ((pos + np.random.default_rng(7).normal(0, 1.0, pos.shape))
             % BOX).astype(np.float32)
    kj, pj, cj = jps.cross_power_spectrum(jnp.asarray(pos),
                                          jnp.asarray(pos_b), BOX, ng=32)
    kt, pt, ct = tps.cross_power_spectrum(tt(pos), tt(pos_b), BOX, ng=32)
    assert_binned_match(ct, cj, pt, pj, kt, kj)


def test_redshift_space_multipoles_match():
    pos, vel, _ = _particles()
    a, hub = 0.5, 0.2
    sj = jps.redshift_space_positions(jnp.asarray(pos), jnp.asarray(vel),
                                      BOX, scale_factor=a,
                                      hubble_internal_rate=hub)
    st = tps.redshift_space_positions(tt(pos), tt(vel), BOX, scale_factor=a,
                                      hubble_internal_rate=hub)
    d = nn(st) - np.asarray(sj)
    assert np.abs(d - BOX * np.round(d / BOX)).max() <= 1e-5 * BOX
    s_np = np.asarray(sj)
    kj, plj, cj = jps.power_spectrum_multipoles(jnp.asarray(s_np), BOX,
                                                ng=32, num_bins=16)
    kt, plt, ct = tps.power_spectrum_multipoles(tt(s_np), BOX, ng=32,
                                                num_bins=16)
    for ell in range(3):
        assert_binned_match(ct, cj, plt[ell], np.asarray(plj)[ell], kt, kj)
    # the distortions leave a quadrupole
    assert float(plt[1].abs().max()) > 1e-2 * float(plt[0].abs().max())


def test_sigma8_and_save_match(tmp_path):
    pos, _, _ = _particles()
    dj = jps.measure_power_spectrum(jnp.asarray(pos), BOX, ng=32)
    dt = tps.measure_power_spectrum(tt(pos), BOX, ng=32)
    s8j = float(jps.sigma8_from_power(dj))
    s8t = float(tps.sigma8_from_power(dt))
    assert s8t > 0 and max_rel(s8t, s8j) <= 1e-3
    fj, ft = tmp_path / "j.txt", tmp_path / "t.txt"
    jps.save_power_spectrum(str(fj), dj)
    tps.save_power_spectrum(str(ft), dt)
    tj, tt_ = np.loadtxt(fj), np.loadtxt(ft)
    assert fj.read_text().splitlines()[:2] == ft.read_text().splitlines()[:2]
    assert_binned_match(tt_[:, 2], tj[:, 2], tt_[:, 1], tj[:, 1])


def test_on_device_of_input():
    """Every result lies on the input's device."""
    pos, _, _ = _particles(2000)
    d = tps.measure_power_spectrum(tt(pos), BOX, ng=16, num_bins=8)
    for v in power_spectrum_to_arrays(d).values():
        assert np.all(np.isfinite(v))
    assert d.k.device == torch.device("cpu")
