"""K1 (CIC deposit) and K2 (fused CIC x fd4 gather) of the PyTorch port:
their plain versions against the JAX package's CPU reference
(ops/bucketed_pm) and the TPU kernels in Pallas interpret mode
(ops/pallas_pm_rods), plus the whole fd4 PM route."""

import numpy as np
import pytest

from _torch_parity import max_rel, nn, tt, uniform_particles

import jax.numpy as jnp

import lambda_cdm_tpu.forces.pm as jpm
import lambda_cdm_tpu.ops.bucketed_pm as jbpm
from lambda_cdm_tpu.forces.treepm import bucket_particles
from lambda_cdm_tpu.ops.pallas_pm_rods import (assemble_rods,
                                               pallas_deposit_rods,
                                               pallas_gather_fd4)
import lambda_cdm_tpu_torch.forces.pm as tpm
import lambda_cdm_tpu_torch.ops.bucketed_pm as tbpm
from lambda_cdm_tpu_torch.ops import pm_rods

N, BOX, NG, NC, CAP, MARGIN = 3000, 12.0, 16, 4, 128, 1
GEO = dict(ncell=NC, ng=NG, box_size=BOX, margin=MARGIN)

# Relative to the largest value. The CPU reference sums in another order
# and computes u = x / box * ng where the kernels (TPU and CUDA) use
# x * (ng / box): measured <= 1.3e-6 for the deposit and the whole fd4
# route. The TPU kernels in interpret mode run their GEMMs as three bf16
# passes ("bf16x3"): measured 4.7e-6 (deposit) and 6.2e-6 (gather).
DEPOSIT_TOL = 1e-5
GATHER_TOL = 2e-5


def _state(seed=0, push_frac=0.0):
    """SoA bucketed state [3, C, K] with live-first slots; `push_frac` of
    the live slots drift 2.5 PM cells along x and z (unwrapped), so some
    leave their home block window and some leave the box."""
    pos, m = uniform_particles(N, BOX, seed)
    bpos, bmass, _, ovf = bucket_particles(jnp.asarray(pos), jnp.asarray(m),
                                           BOX, ncell=NC, capacity=CAP)
    assert int(ovf) == 0
    bpos = np.moveaxis(np.array(bpos), -1, 0)
    bmass = np.array(bmass)
    if push_frac:
        rng = np.random.default_rng(seed + 1)
        push = (rng.random(bmass.shape) < push_frac) & (bmass > 0)
        step = 2.5 * BOX / NG
        bpos[0] += np.where(push, step, 0.0).astype(np.float32)
        bpos[2] -= np.where(push, step, 0.0).astype(np.float32)
    counts = (bmass > 0).sum(axis=1).astype(np.int32)
    return bpos.astype(np.float32), bmass, counts


@pytest.mark.parametrize("push_frac", [0.0, 0.05])
def test_deposit_plain_matches_jnp_reference(push_frac):
    bpos, bmass, counts = _state(1, push_frac)
    ref, rdrop = jbpm.deposit_from_buckets(
        jnp.asarray(np.moveaxis(bpos, 0, -1)), jnp.asarray(bmass), **GEO)
    grid, drop = pm_rods.cic_deposit(tt(bpos), tt(bmass), tt(counts, None),
                                     **GEO)
    assert grid.shape == (NG, NG, NG)
    assert max_rel(grid, ref) < DEPOSIT_TOL
    assert int(drop) == int(rdrop)
    assert (int(drop) > 0) == (push_frac > 0)
    # mass of the deposited particles is conserved exactly up to round-off
    kept = float(np.asarray(ref).sum())
    assert abs(float(grid.sum()) - kept) < 1e-5 * kept


def test_deposit_plain_matches_pallas_interpret():
    bpos, bmass, counts = _state(2, 0.05)
    blocks, rdrop = pallas_deposit_rods(
        jnp.asarray(bpos), jnp.asarray(bmass), counts=jnp.asarray(counts),
        interpret=True, **GEO)
    ref = assemble_rods(blocks, ncell=NC, ng=NG, margin=MARGIN)
    grid, drop = pm_rods.cic_deposit(tt(bpos), tt(bmass), tt(counts, None),
                                     **GEO)
    assert max_rel(grid, ref) < DEPOSIT_TOL
    assert int(drop) == int(rdrop) > 0


def _phi(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(NG, NG, NG)).astype(np.float32)


def _live(counts):
    return np.arange(CAP)[None, :] < counts[:, None]


def test_gather_plain_matches_pallas_interpret():
    """The TPU kernel's contract: -(fd4 grad phi) CIC-gathered at live
    slots, zero on dead and dropped ones."""
    bpos, bmass, counts = _state(3, 0.05)
    phi = _phi(4)
    ref = pallas_gather_fd4(jnp.asarray(phi), jnp.asarray(bpos),
                            counts=jnp.asarray(counts), interpret=True,
                            **GEO)
    got = pm_rods.fd4_gather(tt(phi), tt(bpos), tt(counts, None), **GEO)
    assert got.shape == (3, NC ** 3, CAP)
    live = _live(counts)
    assert max_rel(got, ref, live[None]) < GATHER_TOL
    assert np.all(nn(got)[:, ~live] == 0.0)


def test_gather_plain_zero_on_dropped_slots():
    bpos, bmass, counts = _state(5, 0.2)
    got = nn(pm_rods.fd4_gather(tt(_phi(6)), tt(bpos), tt(counts, None),
                                **GEO))
    _, _, ok = pm_rods._cic_corners(tt(bpos), **GEO)
    dropped = _live(counts) & ~nn(ok)
    assert dropped.sum() > 0
    assert np.all(got[:, dropped] == 0.0)
    assert np.all(np.abs(got[:, _live(counts) & nn(ok)]).max(axis=0) > 0)


@pytest.mark.parametrize("split", [0.0, 1.0])
def test_greens_function(split):
    ref = jpm.poisson_greens_function(NG, BOX, split_scale=split)
    got = tpm.poisson_greens_function(NG, BOX, split_scale=split)
    assert max_rel(got, ref) < 2e-6


def test_block_geometry_and_origins():
    assert tbpm.block_geometry(NG, NC, MARGIN) == \
        jbpm.block_geometry(NG, NC, MARGIN)
    np.testing.assert_array_equal(
        nn(tbpm._block_origins(NC, NG // NC, MARGIN)),
        np.asarray(jbpm._block_origins(NC, NG // NC, MARGIN)))
    with pytest.raises(ValueError, match="multiple"):
        tbpm.block_geometry(18, 4)


@pytest.mark.parametrize("split", [0.0, 1.0])
@pytest.mark.parametrize("push_frac", [0.0, 0.05])
def test_pm_route_fd4_matches_jnp_reference(split, push_frac):
    """deposit -> FFT Poisson -> fd4 gather, against
    pm_accelerations_bucketed(gradient="fd4", use_pallas=False)."""
    bpos, bmass, _ = _state(7, push_frac)
    g = 43.0071057317063
    ref, rdrop = jbpm.pm_accelerations_bucketed(
        jnp.asarray(bpos), jnp.asarray(bmass), g_const=g,
        split_scale=split, gradient="fd4", use_pallas=False, **GEO)
    got, drop = tbpm.pm_accelerations_bucketed(
        tt(bpos), tt(bmass), g_const=g, split_scale=split, gradient="fd4",
        **GEO)
    live = np.asarray(bmass) > 0
    assert max_rel(got, ref, live[None]) < GATHER_TOL
    assert int(drop) == int(rdrop)


def test_pm_route_refuses_unported_gradients():
    """Every gradient of the JAX package is ported: spectral and interp
    (which this test once saw refused) run and match the JAX package's
    XLA path on live slots at GATHER_TOL (the drop-rule and interp cases
    are tests/test_torch_fast_options.py's); any other name is refused."""
    bpos, bmass, _ = _state(8)
    live = (bmass > 0)[None]
    for gradient in ("spectral", "interp"):
        ref, _ = jbpm.pm_accelerations_bucketed(
            jnp.asarray(bpos), jnp.asarray(bmass), split_scale=1.0,
            gradient=gradient, use_pallas=False, **GEO)
        got, _ = tbpm.pm_accelerations_bucketed(
            tt(bpos), tt(bmass), split_scale=1.0, gradient=gradient, **GEO)
        assert max_rel(got, ref, live) < GATHER_TOL
    with pytest.raises(ValueError, match="gradient"):
        tbpm.pm_accelerations_bucketed(tt(bpos), tt(bmass),
                                       gradient="fd2", **GEO)
