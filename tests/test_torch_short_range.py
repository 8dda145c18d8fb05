"""K3 (short-range pairs over 27 neighbour cells) of the PyTorch port: its
plain version against the TPU kernel in Pallas interpret mode (vpu3, the
same even-polynomial split, and the vpu, vpu2 and mxu variants with their
split functions), against the exact-erfc JAX reference, and its `rows=`
form against the full evaluation -- on a uniform state and on a clustered
one whose capacity is several hundred."""

import numpy as np
import pytest

from _torch_parity import clustered_particles, max_rel, nn, tt, \
    uniform_particles

import jax.numpy as jnp

from lambda_cdm_tpu.forces.treepm import bucket_particles, \
    short_range_bucketed
from lambda_cdm_tpu.ops import pallas_short_range as jpsr
from lambda_cdm_tpu_torch.ops import short_range as tsr

RS, SOFT = 1.5, 0.1
# same function and float32 pair arithmetic as vpu3; the pair sums run in
# another order (measured 3.0e-7 of the max)
KERNEL_TOL = 1e-5
# the exact-erfc reference: the cutoff truncation (S(x_max) = 2.2e-5 per
# pair) plus the even-polynomial fit error (measured 4.6e-4) -- the bar of
# the JAX package's own test of its kernel (tests/test_fast_treepm.py)
ERFC_TOL = 1e-3


def _bucketed(pos, m, box, ncell, cap):
    bpos, bmass, _, ovf = bucket_particles(jnp.asarray(pos), jnp.asarray(m),
                                           box, ncell=ncell, capacity=cap)
    assert int(ovf) == 0
    bpos = np.moveaxis(np.array(bpos), -1, 0)
    bmass = np.array(bmass)
    counts = (bmass > 0).sum(axis=1).astype(np.int32)
    return bpos, bmass, counts


def _uniform():
    box, ncell, cap = 18.0, 3, 64
    pos, m = uniform_particles(1000, box, 0)
    return box, ncell, cap, _bucketed(pos, m, box, ncell, cap)


def _clustered():
    """A Gaussian clump of 300 in one cell of a 3^3 grid: capacity 384."""
    box, ncell, cap = 18.0, 3, 384
    pos, m = clustered_particles(700, box, 1, n_clump=300, sigma=0.8,
                                 centre=(9.0, 9.0, 9.0))
    return box, ncell, cap, _bucketed(pos, m, box, ncell, cap)


STATES = {"uniform": _uniform, "clustered": _clustered}


def _plain(state, **kw):
    box, ncell, cap, (bpos, bmass, counts) = state
    return tsr.short_range(tt(bpos), tt(bmass), tt(counts, None),
                           ncell=ncell, capacity=cap, box_size=box, rs=RS,
                           softening=SOFT, **kw)


def _live(state):
    _, _, cap, (_, _, counts) = state
    return np.arange(cap)[None, :] < counts[:, None]


def test_plain_matches_vpu3_interpret():
    """On the clustered state, whose other 26 cells are uniform (one
    interpret-mode compile: about 14 s on one core)."""
    state = _clustered()
    box, ncell, cap, (bpos, bmass, counts) = state
    assert counts.max() > 256 and np.median(counts) < 32
    ref = jpsr.pallas_short_range(jnp.asarray(bpos), jnp.asarray(bmass),
                                  ncell=ncell, capacity=cap, box_size=box,
                                  rs=RS, softening=SOFT, interpret=True,
                                  variant="vpu3")
    got = _plain(state)
    live = _live(state)
    assert max_rel(got, ref, live[None]) < KERNEL_TOL
    assert np.all(nn(got)[:, ~live] == 0.0)       # dead slots exactly 0


@pytest.mark.parametrize("name", list(STATES))
def test_plain_matches_exact_erfc_reference(name):
    state = STATES[name]()
    box, ncell, cap, (bpos, bmass, _) = state
    ref = short_range_bucketed(jnp.asarray(np.moveaxis(bpos, 0, -1)),
                               jnp.asarray(bmass), box, RS, SOFT,
                               ncell=ncell, capacity=cap, use_poly=False)
    ref = np.moveaxis(np.asarray(ref), -1, 0)
    got = _plain(state)
    assert max_rel(got, ref, _live(state)[None]) < ERFC_TOL


@pytest.mark.parametrize("name", list(STATES))
def test_rows_form_matches_full(name):
    state = STATES[name]()
    box, ncell, cap, (bpos, bmass, counts) = state
    full = nn(_plain(state)).reshape(3, -1)
    rng = np.random.default_rng(4)
    rows = rng.choice(ncell ** 3 * cap, 500, replace=False)
    got = nn(tsr.short_range_plain(
        tt(bpos), tt(bmass), tt(counts, None), ncell=ncell, capacity=cap,
        box_size=box, rs=RS, softening=SOFT, rows=tt(rows, None)))
    assert got.shape == (3, 500)
    assert max_rel(got, full[:, rows]) < 1e-6


def test_periodic_shift_from_cell_index():
    """Positions drift unwrapped between rebuckets: a particle just outside
    the box, still in its home cell's bucket, sees the same forces as its
    wrapped image would (periodicity comes from cell indices)."""
    state = _uniform()
    box, ncell, cap, (bpos, bmass, counts) = state
    base = nn(_plain(state))
    # a rigid translation by -0.3 along x moves the particles near x = 0
    # out of the box without re-bucketing; pair separations are unchanged
    # up to the rounding of the moved coordinates (measured 2.3e-7)
    moved = bpos.copy()
    moved[0] = np.where(bmass > 0, moved[0] - np.float32(0.3), 0.0)
    assert (moved[0][bmass > 0] < 0).any()
    got = nn(_plain((box, ncell, cap, (moved, bmass, counts))))
    assert max_rel(got, base, _live(state)[None]) < 1e-5


def test_poly_even_coeffs_identical():
    for rs in (RS, 0.652, 3.0):
        assert tsr._poly_even_coeffs(rs) == jpsr._poly_even_coeffs(rs)


# the variants that also take no counts (any slot order; mass 0 is dead)
FULL_VARIANTS = ("vpu", "vpu2", "mxu")
# the TPU mxu kernel sums w x_j - (sum w) x_i in centred coordinates as a
# GEMM: its float32 cancellation puts it 4.4e-5 of the max from vpu on the
# uniform state (measured), while the port's mxu is the vpu function, held
# against the JAX vpu kernel at KERNEL_TOL
MXU_GEMM_TOL = 1e-4


def _interpret(state, variant):
    box, ncell, cap, (bpos, bmass, _) = state
    return jpsr.pallas_short_range(jnp.asarray(bpos), jnp.asarray(bmass),
                                   ncell=ncell, capacity=cap, box_size=box,
                                   rs=RS, softening=SOFT, interpret=True,
                                   variant=variant)


@pytest.mark.parametrize("variant", FULL_VARIANTS)
def test_plain_variants_match_interpret(variant):
    """vpu, vpu2 and mxu on the uniform 3^3 / capacity-64 state (one
    interpret-mode compile each: about 5 s on one core); given no counts
    the port gives the same, and dead slots are exactly 0."""
    state = _uniform()
    got = _plain(state, variant=variant)
    live = _live(state)
    if variant == "mxu":
        assert max_rel(got, _interpret(state, "vpu"), live[None]) \
            < KERNEL_TOL
        assert max_rel(got, _interpret(state, "mxu"), live[None]) \
            < MXU_GEMM_TOL
    else:
        assert max_rel(got, _interpret(state, variant), live[None]) \
            < KERNEL_TOL
    assert np.all(nn(got)[:, ~live] == 0.0)
    box, ncell, cap, (bpos, bmass, _) = state
    no_counts = tsr.short_range(tt(bpos), tt(bmass), None, ncell=ncell,
                                capacity=cap, box_size=box, rs=RS,
                                softening=SOFT, variant=variant)
    np.testing.assert_array_equal(nn(no_counts), nn(got))


@pytest.mark.parametrize("variant", FULL_VARIANTS)
def test_full_capacity_variants_take_any_slot_order(variant):
    """The live slots of each cell scattered among its dead ones (not live
    first): each particle's acceleration is unchanged up to the order of
    its pair sum."""
    state = _uniform()
    box, ncell, cap, (bpos, bmass, counts) = state
    base = nn(_plain(state, variant=variant))
    rng = np.random.default_rng(11)
    perm = np.stack([rng.permutation(cap) for _ in range(ncell ** 3)])
    sb = np.take_along_axis(bpos, perm[None], axis=2)
    sm = np.take_along_axis(bmass, perm, axis=1)
    assert not np.array_equal(sm > 0, bmass > 0)
    got = nn(tsr.short_range(tt(sb), tt(sm), None, ncell=ncell,
                             capacity=cap, box_size=box, rs=RS,
                             softening=SOFT, variant=variant))
    back = np.empty_like(got)
    np.put_along_axis(back, perm[None], got, axis=2)
    assert max_rel(back, base, _live(state)[None]) < 1e-6


def test_vpu2_close_to_vpu3():
    """Two fits of one split function: the JAX package's bar between its
    vpu2 and vpu3 kernels (tests/test_fast_treepm.py)."""
    state = _uniform()
    live = _live(state)
    assert max_rel(_plain(state, variant="vpu3"),
                   _plain(state, variant="vpu2"), live[None]) < 5e-4


def test_split_coefficients_identical():
    for rs in (RS, 0.652, 3.0):
        assert tsr._poly_r_coeffs(rs) == jpsr._poly_r_coeffs(rs)
    assert tsr._x_coeffs() == jpsr._COEFFS_F
    assert tsr._X_MAX == jpsr._X_MAX


def test_variant_names():
    state = _uniform()
    with pytest.raises(ValueError, match="variant"):
        _plain(state, variant="vpu9")
    with pytest.raises(ValueError, match="counts"):
        box, ncell, cap, (bpos, bmass, _) = state
        tsr.short_range(tt(bpos), tt(bmass), None, ncell=ncell,
                        capacity=cap, box_size=box, rs=RS, softening=SOFT)
    assert {tsr.counter(v) for v in tsr.VARIANTS} == set(tsr.launches)
