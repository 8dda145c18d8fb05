"""The port's lensing raytracer (lambda_cdm_tpu_torch.raytracing.lensing,
with the plain versions of its sampler kernel K6/K7 in ops/lens_sample.py)
against the JAX package's on the same numpy inputs, and LensingObserver in
an engine run against the JAX observer.

Tolerances, each with its reason:
- samplers: 2e-4 absolute on unit-normal fields, the JAX package's own bar
  for its Pallas samplers (bf16x3 GEMMs); the port's gather agrees with
  JAX's gather to float32 round-off (read ~1e-7) and with the one-hot
  contractions to ~1e-6;
- planes, fields, traces, maps and the Limber C_ell: 1e-5 of the largest
  value, float32 scatter sums and FFTs taken in another order (read
  <= 3e-7); the engine run's maps 1e-3 of the largest |kappa|, the maps
  bar (the two engines' states differ by float32 round-off after steps);
- the Jacobian's products (gamma, kappa_jac, omega: differences of the
  distortion matrix's O(1) entries): 1e-6 absolute, eight ulps of 1, and
  mu = 1/det(A) within 1e-6 relative.
The JAX samplers run as its own tests run them on the CPU (interpret mode).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from _torch_parity import max_rel, nn, tt

import jax.numpy as jnp

import lambda_cdm_tpu as jlc
from lambda_cdm_tpu.core import analysis_observers as jao
from lambda_cdm_tpu.core.state import make_state as jmake_state
from lambda_cdm_tpu.ops import pallas_lens_sample as jpls
from lambda_cdm_tpu.physics.cosmology import CosmologyParams as JParams
from lambda_cdm_tpu.raytracing import lensing as jl
import lambda_cdm_tpu_torch as tlc
from lambda_cdm_tpu_torch import interop
from lambda_cdm_tpu_torch.core import analysis_observers as tao
from lambda_cdm_tpu_torch.core.state import make_state as tmake_state
from lambda_cdm_tpu_torch.ops import lens_sample
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams as TParams
from lambda_cdm_tpu_torch.raytracing import lensing as tl

JP, TP = JParams(), TParams()
TOL = 1e-5          # of the largest value: float32 sums/FFTs reordered
SAMPLE_ATOL = 2e-4  # the JAX package's sampler bar on unit-normal fields
JAC_ATOL = 1e-6     # eight ulps of the O(1) distortion-matrix entries


def _assert_jacobian(got: dict, ref: dict):
    """gamma, kappa_jac and omega within JAC_ATOL, mu within 1e-6."""
    for f in ("gamma", "gamma1", "gamma2", "kappa_jac", "omega"):
        if f in ref:
            assert np.abs(nn(got[f]) - np.asarray(ref[f])).max() \
                <= JAC_ATOL, f
    assert max_rel(got["mu"], ref["mu"]) <= 1e-6


def _particles(n, box, seed):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([
        rng.uniform(0, box, (n - n // 4, 3)),
        0.3 * box + 0.05 * box * rng.standard_normal((n // 4, 3))]) % box
    m = rng.uniform(0.5, 2.0, n)
    return pos.astype(np.float32), m.astype(np.float32)


def _planes(L, ng, amp, seed):
    rng = np.random.default_rng(seed)
    d = amp * rng.standard_normal((L, ng, ng))
    return (d - d.mean(axis=(1, 2), keepdims=True)).astype(np.float32)


def _grid_rays(side, span):
    ang = ((np.arange(side) + 0.5) * span / side).astype(np.float32)
    return np.stack(np.meshgrid(ang, ang, indexing="ij"), -1).reshape(-1, 2)


# -- lens planes ---------------------------------------------------------

@pytest.mark.parametrize("axis,z_range", [(2, (0.0, None)),
                                          (0, (12.5, 61.0)),
                                          (1, (99.0, 140.0))])
def test_surface_density_plane(axis, z_range):
    pos, m = _particles(6000, 100.0, 1)
    kw = dict(ng=32, axis=axis, z_min=z_range[0], z_max=z_range[1])
    sj = jl.surface_density_plane(jnp.asarray(pos), jnp.asarray(m), 100.0,
                                  **kw)
    st = tl.surface_density_plane(tt(pos), tt(m), 100.0, **kw)
    assert st.shape == (32, 32) and max_rel(st, sj) <= TOL
    np.testing.assert_allclose(nn(tl.overdensity_plane(st)),
                               np.asarray(jl.overdensity_plane(sj)),
                               rtol=0, atol=TOL * float(np.abs(
                                   jl.overdensity_plane(sj)).max()))


@pytest.mark.parametrize("n_planes,axis", [(4, 2), (5, 2), (8, 0)])
def test_snapshot_lightcone_planes(n_planes, axis):
    """Both branches: one 3D CIC deposit summed per slab (ng % n_planes
    == 0) and the hard-cut 2D CIC per slab."""
    pos, m = _particles(5000, 100.0, 2)
    pj, dj = jl.snapshot_lightcone_planes(jnp.asarray(pos), jnp.asarray(m),
                                          100.0, ng=32, n_planes=n_planes,
                                          axis=axis)
    pt, dt = tl.snapshot_lightcone_planes(tt(pos), tt(m), 100.0, ng=32,
                                          n_planes=n_planes, axis=axis)
    assert dt == dj and pt.shape == (n_planes, 32, 32)
    assert max_rel(pt, pj) <= TOL


def test_efficiency_and_born_convergence():
    delta = _planes(4, 32, 0.1, 3)
    chis = np.linspace(800.0, 1100.0, 4).astype(np.float32)
    a_l = np.linspace(0.7, 0.6, 4).astype(np.float32)
    assert max_rel(tl.lensing_efficiency(TP, tt(chis), 2500.0, tt(a_l)),
                   jl.lensing_efficiency(JP, jnp.asarray(chis), 2500.0,
                                         jnp.asarray(a_l))) <= 1e-6
    kj = jl.born_convergence(JP, jnp.asarray(delta), jnp.asarray(chis),
                             25.0, 2500.0, jnp.asarray(a_l))
    kt = tl.born_convergence(TP, tt(delta), tt(chis), 25.0, 2500.0,
                             tt(a_l))
    assert kt.shape == (32, 32) and max_rel(kt, kj) <= TOL


# -- potential, deflection, shear ------------------------------------------

@pytest.mark.parametrize("fn", ["lensing_potential", "deflection_from_kappa",
                                "second_derivs_from_kappa",
                                "shear_from_kappa"])
def test_fft_fields(fn):
    """Each on one map, and on a batch of two maps (the port's form of the
    JAX package's vmap) against the JAX function map by map."""
    ng, extent = 64, 10.0
    x = (np.arange(ng) + 0.5) * (extent / ng) - extent / 2
    blob = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 2.0)
    maps = np.stack([blob - blob.mean(), _planes(1, ng, 0.3, 4)[0]]) \
        .astype(np.float32)
    ref = [np.asarray(getattr(jl, fn)(jnp.asarray(k), extent, ng=ng))
           for k in maps]
    got = getattr(tl, fn)(tt(maps[0]), extent, ng=ng)
    assert got.shape == ref[0].shape and max_rel(got, ref[0]) <= TOL
    batch = getattr(tl, fn)(tt(maps), extent, ng=ng)
    assert max_rel(batch, np.stack(ref)) <= TOL


# -- the samplers (plain versions of K6/K7) --------------------------------

def _edge_points(ext, n, seed):
    rng = np.random.default_rng(seed)
    edge = np.array([[0.0, 0.0], [ext - 1e-3, ext - 1e-3],
                     [0.01, ext - 0.01], [ext / 2, 0.0], [ext, ext / 3]])
    return np.concatenate([edge, rng.uniform(0, ext, (n - len(edge), 2))]) \
        .astype(np.float32)


def test_plain_sampler_matches_jax_gathers():
    """bilinear_sample ([ng, ng] and [C, ng, ng]), bilinear_sample_matmul
    and the K6/K7 plain version against the JAX package's gather and
    one-hot forms, on ragged R with points on the periodic edges; CPU
    tensors launch nothing."""
    ng, ext = 48, 37.5
    fields = np.random.default_rng(5).standard_normal((3, ng, ng)) \
        .astype(np.float32)
    xy = _edge_points(ext, 700, 6)
    ref = np.asarray(jl.bilinear_sample(jnp.asarray(fields), jnp.asarray(xy),
                                        ext))
    before = dict(lens_sample.launches)
    for got in (tl.bilinear_sample(tt(fields), tt(xy), ext),
                lens_sample.bilinear_sample_fields_plain(tt(fields), tt(xy),
                                                         ext),
                lens_sample.bilinear_sample_fields(tt(fields), tt(xy), ext,
                                                   fast_channels=2)):
        assert got.shape == (3, 700)
        np.testing.assert_allclose(nn(got), ref, rtol=0, atol=1e-6)
    one = tl.bilinear_sample(tt(fields[1]), tt(xy), ext)
    np.testing.assert_allclose(nn(one), ref[1], rtol=0, atol=1e-6)
    mm = jl.bilinear_sample_matmul(jnp.asarray(fields), jnp.asarray(xy), ext)
    np.testing.assert_allclose(
        nn(tl.bilinear_sample_matmul(tt(fields), tt(xy), ext)),
        np.asarray(mm), rtol=0, atol=SAMPLE_ATOL)
    assert lens_sample.launches == before


def test_plain_sampler_matches_pallas_interpret():
    """The K6 and K7 plain versions against pallas_bilinear_sample and
    pallas_bilinear_sample_xwin in interpret mode: K6 on ragged R with
    edge points, F = 6 with the TPU's fast Hessian channels (the port
    samples them in float32, so they are held at the faithful bar too,
    against the JAX gather); K7 on a grid-coherent bundle whose x runs
    unwrapped from -0.25 to 0.35 of the box."""
    ng, ext = 128, 37.5
    rng = np.random.default_rng(7)
    fields = rng.standard_normal((6, ng, ng)).astype(np.float32)
    xy = _edge_points(ext, 700, 8)
    got = lens_sample.bilinear_sample_fields(tt(fields), tt(xy), ext,
                                             fast_channels=3)
    pk = jpls.pallas_bilinear_sample(jnp.asarray(fields[:3]),
                                     jnp.asarray(xy), ext, interpret=True)
    np.testing.assert_allclose(nn(got[:3]), np.asarray(pk), rtol=0,
                               atol=SAMPLE_ATOL)
    ref = jl.bilinear_sample(jnp.asarray(fields), jnp.asarray(xy), ext)
    np.testing.assert_allclose(nn(got), np.asarray(ref), rtol=0,
                               atol=SAMPLE_ATOL)

    n = jpls._RT + 700                 # an edge-padded last tile
    x = (-0.25 + 0.6 * np.arange(n) / n) * ext \
        + rng.uniform(0, 0.01 * ext, n)
    xy = np.stack([x, rng.uniform(0, ext, n)], 1).astype(np.float32)
    got = lens_sample.bilinear_sample_fields_xwin(tt(fields[:3]), tt(xy),
                                                  ext, window=80)
    pk = jpls.pallas_bilinear_sample_xwin(jnp.asarray(fields[:3]),
                                          jnp.asarray(xy), ext, window=80,
                                          interpret=True)
    np.testing.assert_allclose(nn(got), np.asarray(pk), rtol=0,
                               atol=SAMPLE_ATOL)
    # the JAX package's own check wraps first; the port's plain version
    # takes x unwrapped and wraps the cell index
    wrapped = jl.bilinear_sample(jnp.asarray(fields[:3]),
                                 jnp.mod(jnp.asarray(xy), ext), ext)
    np.testing.assert_allclose(nn(got), np.asarray(wrapped), rtol=0,
                               atol=SAMPLE_ATOL)


@pytest.mark.parametrize("window,raises", [(120, False), (121, True),
                                           (200, True)])
def test_xwin_window_contract(window, raises):
    """ValueError exactly where the JAX entry raises it: the window
    rounded up to 8 reaching ng."""
    fields = np.zeros((1, 128, 128), np.float32)
    xy = np.zeros((8, 2), np.float32)
    if raises:
        with pytest.raises(ValueError, match="window"):
            jpls.pallas_bilinear_sample_xwin(
                jnp.asarray(fields), jnp.asarray(xy), 10.0, window=window,
                interpret=True)
        with pytest.raises(ValueError, match="window"):
            lens_sample.bilinear_sample_fields_xwin(tt(fields), tt(xy),
                                                    10.0, window=window)
    else:
        out = lens_sample.bilinear_sample_fields_xwin(tt(fields), tt(xy),
                                                      10.0, window=window)
        assert out.shape == (1, 8)
    with pytest.raises(ValueError, match="xy"):
        lens_sample.bilinear_sample_fields(tt(fields), tt(xy[:, :1]), 10.0)


# -- plane fields, the window bound, the tracer ----------------------------

@pytest.mark.parametrize("jacobian", [False, True])
def test_lens_plane_fields(jacobian):
    delta = _planes(4, 32, 0.1, 9)
    chis = np.linspace(800.0, 1100.0, 4).astype(np.float32)
    a_l = np.full(4, 0.6, np.float32)
    fj = jl.lens_plane_fields(JP, jnp.asarray(delta), jnp.asarray(chis),
                              jnp.asarray(a_l), 25.0, 100.0, 2500.0, ng=32,
                              jacobian=jacobian)
    ft = tl.lens_plane_fields(TP, tt(delta), tt(chis), tt(a_l), 25.0, 100.0,
                              2500.0, ng=32, jacobian=jacobian)
    assert ft.shape == (4, 6 if jacobian else 3, 32, 32)
    for c in range(ft.shape[1]):
        assert max_rel(ft[:, c], fj[:, c]) <= TOL


@pytest.mark.parametrize("rt,shuffle", [(2048, False), (256, False),
                                        (2048, True)])
def test_auto_sample_window(rt, shuffle):
    """The same integer as the JAX function, from the same fields (its
    test geometry: ng 128, 4 planes of 0.3 normal, box 400, 64^2 rays);
    shuffled rays give no useful bound (0) on both sides."""
    ng, L, box = 128, 4, 400.0
    deltas = _planes(L, ng, 0.3, 10)
    chis = (900.0 + np.arange(L) * 100.0).astype(np.float32)
    fl = jl.lens_plane_fields(JP, jnp.asarray(deltas), jnp.asarray(chis),
                              jnp.full((L,), 0.7), box / L, box, 1500.0,
                              ng=ng)
    theta0 = _grid_rays(64, box / chis[0])
    if shuffle:
        theta0 = theta0[np.random.default_rng(11).permutation(len(theta0))]
    wj = jl.auto_sample_window(fl, jnp.asarray(chis), jnp.asarray(theta0),
                               box, ng=ng, rt=rt)
    wt = tl.auto_sample_window(tt(np.asarray(fl)), tt(chis), tt(theta0),
                               box, ng=ng, rt=rt)
    assert isinstance(wt, int) and wt == wj
    assert (wt == 0) == shuffle


@pytest.mark.parametrize("jacobian", [False, True])
def test_trace_rays(jacobian):
    """The multi-plane trace (Jacobian recursion included) against the JAX
    package's CPU route; the window is ignored on the CPU, as there."""
    ng, box, L = 32, 100.0, 6
    delta = _planes(L, ng, 0.1, 12)
    chis = np.linspace(700.0, 1700.0, L).astype(np.float32)
    a_l = np.linspace(0.75, 0.55, L).astype(np.float32)
    theta0 = _grid_rays(16, box / chis[0])
    args = (jnp.asarray(delta), jnp.asarray(chis), jnp.asarray(a_l), 40.0,
            box, jnp.asarray(theta0), 2800.0)
    bj = jl.trace_rays(JP, *args, ng=ng, jacobian=jacobian)
    targs = (tt(delta), tt(chis), tt(a_l), 40.0, box, tt(theta0), 2800.0)
    bt = tl.trace_rays(TP, *targs, ng=ng, jacobian=jacobian)
    for f in ("theta", "beta", "kappa"):
        assert max_rel(getattr(bt, f), getattr(bj, f)) <= TOL, f
    bw = tl.trace_rays(TP, *targs, ng=ng, jacobian=jacobian, window=24)
    assert torch.equal(bw.kappa, bt.kappa)
    if not jacobian:
        assert bt.gamma is None and bt.mu is None
        return
    jac = ("gamma", "mu", "omega", "kappa_jac")
    _assert_jacobian({f: getattr(bt, f) for f in jac},
                     {f: getattr(bj, f) for f in jac})
    arrays = interop.ray_bundle_to_arrays(bt)
    assert set(arrays) == {f.name for f in dataclasses.fields(bj)}
    np.testing.assert_array_equal(arrays["mu"], nn(bt.mu))
    assert interop.ray_bundle_to_arrays(
        tl.trace_rays(TP, *targs, ng=ng))["gamma"] is None


def _loop_body_before(fields, theta, kap, amat, chi_l, chi_source, a_l,
                      d_chi, box, wrap):
    """trace_rays's plane loop body as it stood before the plane step moved
    into ops/lens_sample (the CPU route: the samplers' plain versions;
    wrap False is the windowed route's unwrapped impact positions)."""
    if wrap:
        sampled = lens_sample.bilinear_sample_fields(
            fields, torch.remainder(theta * chi_l, box), box)
    else:
        sampled = lens_sample.bilinear_sample_fields_xwin(
            fields, theta * chi_l, box, window=8)
    ax, ay, dl = sampled[0], sampled[1], sampled[2]
    theta = theta + (-torch.stack([ax, ay], dim=-1) / chi_l)
    w = tl.lensing_efficiency(TP, chi_l, chi_source, a_l)
    kap = kap + dl * w * d_chi
    if amat is not None:
        uxx, uxy, uyy = sampled[3], sampled[4], sampled[5]
        a00, a01, a10, a11 = amat
        amat = (a00 - (uxx * a00 + uxy * a10),
                a01 - (uxx * a01 + uxy * a11),
                a10 - (uxy * a00 + uyy * a10),
                a11 - (uxy * a01 + uyy * a11))
    return theta, kap, amat


def _trace_inputs(L=5, ng=32, box=100.0, side=12, span=1.6):
    """Planes, their fields (Jacobian channels included), distances, scale
    factors, and a bundle whose impact positions leave the box on both
    sides (span x the box at the first plane, centred on its edge)."""
    delta = _planes(L, ng, 0.1, 21)
    chis = np.linspace(700.0, 1700.0, L).astype(np.float32)
    a_l = np.linspace(0.75, 0.55, L).astype(np.float32)
    theta0 = _grid_rays(side, span * box / chis[0]) - 0.5 * span * box \
        / chis[0]
    fl = tl.lens_plane_fields(TP, tt(delta), tt(chis), tt(a_l), 40.0, box,
                              2800.0, ng=ng, jacobian=True)
    return delta, fl, tt(chis), tt(a_l), tt(theta0)


@pytest.mark.parametrize("jacobian", [False, True])
@pytest.mark.parametrize("wrap", [True, False])
def test_plane_step_plain_is_the_loop_body(jacobian, wrap):
    """The plane step's plain version, plane by plane and as the whole
    trace_planes_plain, equals the loop body as trace_rays wrote it bit
    for bit on the CPU (the weights one vector over the planes)."""
    _, fl, chis, a_l, theta0 = _trace_inputs()
    chi_s, box = torch.tensor(2800.0), torch.tensor(100.0)
    weights = tl.lensing_efficiency(TP, chis, chi_s, a_l)
    n = theta0.shape[0]
    amat0 = (torch.ones(n), torch.zeros(n), torch.zeros(n),
             torch.ones(n)) if jacobian else None
    old = (theta0, torch.zeros(n), amat0)
    new = old
    for idx in range(fl.shape[0]):
        old = _loop_body_before(fl[idx], *old, chis[idx], chi_s, a_l[idx],
                                40.0, box, wrap)
        new = lens_sample.plane_step_plain(fl[idx], *new, chis[idx],
                                           weights[idx], 40.0, box,
                                           wrap=wrap)
        for a, b in zip(old[:2] + (old[2] or ()), new[:2] + (new[2] or ())):
            assert torch.equal(a, b), idx
    got = lens_sample.trace_planes(fl, theta0, chis, weights, 40.0, 100.0,
                                   chi_s, jacobian=jacobian,
                                   window=0 if wrap else 8)
    ref = lens_sample.finish_plain(*old, chi_s)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("chi_source", [2800.0, "tensor"])
def test_lensing_efficiency_vector_bits(chi_source):
    """The weights of all planes at once equal the per-plane calls bit for
    bit (the function is elementwise)."""
    chis = tt(np.linspace(300.0, 2700.0, 37))
    a_l = tt(np.linspace(0.95, 0.4, 37))
    chi_s = torch.tensor(2800.0) if chi_source == "tensor" else chi_source
    vec = tl.lensing_efficiency(TP, chis, torch.as_tensor(
        chi_s, dtype=torch.float32), a_l)
    for i in range(37):
        one = tl.lensing_efficiency(TP, chis[i], torch.as_tensor(
            chi_s, dtype=torch.float32), a_l[i])
        assert torch.equal(vec[i], one), i


@pytest.mark.parametrize("jacobian", [False, True])
def test_trace_rays_wrapping_bundle(jacobian):
    """A bundle whose impact positions leave the box on both sides (the
    wrap of every plane in use), twelve planes: the port's trace against
    the JAX package's CPU route at test_trace_rays' bars."""
    ng, box, L = 32, 100.0, 12
    delta, _, chis, a_l, theta0 = _trace_inputs(L=L, side=14)
    bj = jl.trace_rays(JP, jnp.asarray(delta), jnp.asarray(nn(chis)),
                       jnp.asarray(nn(a_l)), 40.0, box,
                       jnp.asarray(nn(theta0)), 2800.0, ng=ng,
                       jacobian=jacobian)
    bt = tl.trace_rays(TP, tt(delta), chis, a_l, 40.0, box, theta0, 2800.0,
                       ng=ng, jacobian=jacobian)
    assert float(theta0.min()) < 0 and float(
        (theta0 * chis[-1]).max()) > box
    for f in ("theta", "beta", "kappa"):
        assert max_rel(getattr(bt, f), getattr(bj, f)) <= TOL, f
    if jacobian:
        jac = ("gamma", "mu", "omega", "kappa_jac")
        _assert_jacobian({f: getattr(bt, f) for f in jac},
                         {f: getattr(bj, f) for f in jac})


def test_trace_planes_offset_and_contract():
    """x_offset 0 is the plain trace; half a cell moves kappa past the
    maps bar (the planted fault the card's accuracy check must see); a
    window reaching ng raises on the windowed route, as the sampler's."""
    _, fl, chis, a_l, theta0 = _trace_inputs()
    chi_s = torch.tensor(2800.0)
    w = tl.lensing_efficiency(TP, chis, chi_s, a_l)
    kw = dict(jacobian=False, window=0)
    base = lens_sample.trace_planes(fl, theta0, chis, w, 40.0, 100.0, chi_s,
                                    **kw)
    same = lens_sample.trace_planes(fl, theta0, chis, w, 40.0, 100.0, chi_s,
                                    x_offset=0.0, **kw)
    assert torch.equal(base["kappa"], same["kappa"])
    moved = lens_sample.trace_planes(fl, theta0, chis, w, 40.0, 100.0,
                                     chi_s, x_offset=0.5 * 100.0 / 32, **kw)
    assert max_rel(moved["kappa"], base["kappa"]) > 1e-3
    with pytest.raises(ValueError, match="window"):
        lens_sample.trace_planes(fl, theta0, chis, w, 40.0, 100.0, chi_s,
                                 jacobian=False, window=32)


# -- whole pipelines -------------------------------------------------------

def test_build_lightcone():
    """Unrandomised: planes, distances, scale factors and thickness equal
    the JAX package's. Randomised (a torch.Generator: jax.random bits are
    not reproduced): reproducible from the seed, and one shift a tile."""
    pos, m = _particles(4096, 200.0, 13)
    snaps_j = [(jnp.asarray(pos), jnp.asarray(m), 1.0 / (1.0 + z))
               for z in (0.0, 0.3, 0.7)]
    snaps_t = [(tt(pos), tt(m), 1.0 / (1.0 + z)) for z in (0.0, 0.3, 0.7)]
    kw = dict(ng=32, z_source=0.8, planes_per_box=4)
    pj, cj, aj, dj = jl.build_lightcone(snaps_j, JP, 200.0, **kw)
    pt, ct, at, dt = tl.build_lightcone(snaps_t, TP, 200.0, **kw)
    assert dt == dj and pt.shape == pj.shape
    assert max_rel(ct, cj) <= 1e-7 and max_rel(at, aj) <= 1e-6
    assert max_rel(pt, pj) <= TOL
    runs = [tl.build_lightcone(snaps_t, TP, 200.0, **kw,
                               randomize_key=torch.Generator()
                               .manual_seed(3))[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], pt)
    assert bool(torch.all(torch.isfinite(runs[0])))


def test_maps_from_state():
    """convergence_map_from_state and raytraced_maps_from_state (the CPU
    route: no window) against the JAX package's, and the weak-field
    checks of its own test on its uniform box."""
    rng = np.random.default_rng(14)
    pos = rng.uniform(0, 100.0, (4096, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, 4096).astype(np.float32)
    vel = np.zeros_like(pos)
    sj = jmake_state(pos, vel, m, scale_factor=0.7)
    st = tmake_state(pos, vel, m, scale_factor=0.7)
    kw = dict(ng=32, n_planes=4, z_source=1.0)
    kj = jl.convergence_map_from_state(sj, JP, 100.0, **kw)
    kt = tl.convergence_map_from_state(st, TP, 100.0, **kw)
    assert kt.shape == (32, 32) and max_rel(kt, kj) <= TOL
    mj = jl.raytraced_maps_from_state(sj, JP, 100.0, n_rays_side=16, **kw)
    mt = tl.raytraced_maps_from_state(st, TP, 100.0, n_rays_side=16, **kw)
    ks = float(torch.std(mt["kappa"], correction=0)) + 1e-12
    assert all(v.shape == (16, 16) for v in mt.values())
    assert max_rel(mt["kappa"], mj["kappa"]) <= TOL
    _assert_jacobian(mt, {k: v for k, v in mj.items() if k != "kappa"})
    assert float((mt["kappa_jac"] - mt["kappa"]).abs().max()) \
        < 0.05 * ks + 1e-7
    assert float((mt["mu"] - (1 + 2 * mt["kappa_jac"])).abs().max()) \
        < 0.05 * ks + 1e-7
    assert float(mt["omega"].abs().max()) < 0.1 * ks


@pytest.mark.parametrize("transfer", ["eisenstein_hu", "bbks"])
def test_limber_convergence_cl(transfer):
    ells = np.array([50.0, 100.0, 200.0, 400.0, 800.0], np.float32)
    for zs in (1.0, 2.0):
        cj = jl.limber_convergence_cl(JP, jnp.asarray(ells), zs,
                                      transfer=transfer)
        ct = tl.limber_convergence_cl(TP, tt(ells), zs, transfer=transfer)
        assert max_rel(ct, cj) <= TOL


# -- LensingObserver -------------------------------------------------------

def test_lensing_observer_engine_run(tmp_path):
    """One 2LPT state through both engines for 8 treepm_fast steps with a
    LensingObserver at cadence 4: the same records, kappa maps and their
    population rms (torch.std with correction=0, as jnp.std) within the
    maps bar; the observer's timer is the engine's analysis.lensing."""
    from lambda_cdm_tpu.physics.initial_conditions import generate_state
    from _torch_parity import fields
    out = str(tmp_path / "out")
    d = {"simulation": {"output_directory": out, "output_frequency": 4,
                        "checkpoint_frequency": 0},
         "cosmology": {"initial_redshift": 9.0},
         "forces": {"type": "treepm_fast", "pm_grid_size": 32,
                    "softening_length": 0.1, "rebucket_every": 4},
         "particles": {"num_particles": 4096, "box_size": 50.0},
         "time": {"initial_timestep": 2e-5, "max_steps": 8},
         "profiling": {"output_file": os.path.join(out, "prof.json")},
         "logging": {"performance_logging": False}}
    jcfg = jlc.SimulationConfig.from_dict(d)
    st0 = generate_state(jcfg)
    kw = dict(frequency=4, grid_size=32, n_planes=4, z_source=1.0)
    assert tlc.LensingObserver is tao.LensingObserver
    jobs, tobs = jao.LensingObserver(**kw), tlc.LensingObserver(**kw)
    jlc.SimulationBuilder().with_config(jcfg).with_initial_state(st0) \
        .with_observer(jobs).build().run()
    teng = tlc.SimulationBuilder(device="cpu").with_config(
        tlc.SimulationConfig.from_dict(d)).with_initial_state(
        interop.sim_state_from_arrays(fields(st0), device="cpu")).with_observer(
        tobs).build()
    teng.run()
    assert [r["step"] for r in tobs.maps] == [r["step"] for r in jobs.maps] \
        == [4, 8]
    for rt_, rj in zip(tobs.maps, jobs.maps):
        assert isinstance(rt_["kappa"], np.ndarray)
        scale = np.abs(rj["kappa"]).max()
        assert np.abs(rt_["kappa"] - rj["kappa"]).max() <= 1e-3 * scale
        assert rt_["kappa_rms"] == pytest.approx(rj["kappa_rms"], rel=1e-3)
        assert "png" not in rt_
    assert teng.profiler.summary()["analysis.lensing"]["count"] == 2
