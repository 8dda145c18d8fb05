"""K3 (short-range pairs over 27 neighbour cells) of the PyTorch port: its
plain version against the TPU kernel in Pallas interpret mode (vpu3, the
same even-polynomial split), against the exact-erfc JAX reference, and
its `rows=` form against the full evaluation -- on a uniform state and on
a clustered one whose capacity is several hundred."""

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
