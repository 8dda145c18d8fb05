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


# -- K3's plan of units -------------------------------------------------------

import torch  # noqa: E402


def _plan_counts(kind, ncell=8, seed=0):
    """Occupancies of ncell^3 cells: near 30 (Poisson), with one cell of
    5000 rows, one live cell alone, or all empty."""
    rng = np.random.default_rng(seed)
    cc = ncell ** 3
    counts = rng.poisson(30.5, cc)
    if kind == "heavy":
        counts[137] = 5000
    elif kind == "one_cell":
        counts = np.zeros(cc)
        counts[5] = 70
    elif kind == "empty":
        counts = np.zeros(cc)
    return torch.from_numpy(counts.astype(np.int32))


@pytest.mark.parametrize("kind", ["uniform", "heavy", "one_cell", "empty"])
def test_unit_plan_covers_live_rows_once(kind):
    """Every live row of every cell lies in exactly one unit; a unit holds
    1..UNIT_ROWS rows of one cell; the header counts the non-empty cells
    and the units; empty cells have class -1 and no unit."""
    ncell = 8
    counts = _plan_counts(kind, ncell)
    plan = tsr.unit_plan(counts, ncell)
    assert plan.dtype == torch.int32
    assert plan.numel() == tsr.PLAN_HEADER + 3 * ncell ** 3
    units = tsr.plan_units(plan, counts, ncell)
    assert int(plan[1]) == int((counts > 0).sum())
    assert int(plan[2]) == units.shape[0] == int(
        ((counts.long() + tsr.UNIT_ROWS - 1) // tsr.UNIT_ROWS).sum())
    if units.shape[0]:
        assert int(units[:, 2].min()) >= 1
        assert int(units[:, 2].max()) <= tsr.UNIT_ROWS
    cls = plan[tsr.PLAN_HEADER:tsr.PLAN_HEADER + ncell ** 3]
    assert bool(torch.all((cls == -1) == (counts == 0)))
    cap = int(counts.max()) if int(counts.max()) else 1
    seen = torch.zeros(ncell ** 3 * cap, dtype=torch.int64)
    for cell, row0, rows in units.tolist():
        seen[cell * cap + row0:cell * cap + row0 + rows] += 1
    live = (torch.arange(cap)[None] < counts[:, None].long()).reshape(-1)
    assert bool(torch.all(seen == live.long()))


@pytest.mark.parametrize("kind", ["uniform", "heavy"])
def test_unit_plan_heaviest_first(kind):
    """Units come in classes of neighbour load (floor(log2) of the live
    slots of the 27 neighbours: a unit's work is its rows times that
    load), heavy to light, cells by id within a class, each cell's units
    together: with one cell of 5000 rows the first units are the 157 of
    that cell and those of its 26 neighbours, whose rows each see it."""
    ncell = 8
    counts = _plan_counts(kind, ncell)
    plan = tsr.unit_plan(counts, ncell)
    units = tsr.plan_units(plan, counts, ncell)
    load = tsr.neighbour_load(counts, ncell)
    cls = torch.floor(torch.log2(load[units[:, 0]].double()))
    assert bool(torch.all(cls[1:] <= cls[:-1]))
    same = cls[1:] == cls[:-1]
    assert bool(torch.all(units[1:, 0][same] >= units[:-1, 0][same]))
    cells = torch.unique_consecutive(units[:, 0])
    assert cells.numel() == int((counts > 0).sum())
    if kind == "heavy":
        one = torch.zeros(ncell ** 3, dtype=torch.int32)
        one[137] = 1
        near = torch.nonzero(tsr.neighbour_load(one, ncell))[:, 0]
        n_top = int(((counts[near].long() + tsr.UNIT_ROWS - 1)
                     // tsr.UNIT_ROWS).sum())
        assert n_top >= 157 + 26
        assert bool(torch.all(units[:n_top, 0].unique() == near))
        assert float(cls[n_top - 1]) > float(cls[n_top])


# -- K3's cull ----------------------------------------------------------------

# the tests' split scale and the benchmark plans' (1.25 x 100 / 192)
CULL_RS = (RS, 1.25 * 100.0 / 192)
CULL_FORMS = ("vpu3", "vpu2", "vpu")


@pytest.mark.parametrize("rs", CULL_RS)
@pytest.mark.parametrize("variant", CULL_FORMS)
def test_keep_radius2_is_where_the_weight_ends(variant, rs):
    """From keep_radius2 on, every float32 r^2 weighs exactly 0 in each
    split form (each of the 16,384 floats from it, and a dense sweep to 16
    times it), and the cut is tight: at most (1 + 1e-3) r_max^2."""
    r2_keep = tsr.keep_radius2(variant, rs)
    r_max = 2.0 * rs * float(tsr._X_MAX)
    assert r_max ** 2 <= r2_keep <= (1.0 + 1e-3) * r_max ** 2
    bits = torch.tensor([r2_keep], dtype=torch.float32).view(torch.int32)
    near = (bits + torch.arange(1 << 14, dtype=torch.int32)).view(
        torch.float32)
    far = torch.linspace(r2_keep, 16.0 * r2_keep, 1 << 20,
                         dtype=torch.float64).to(torch.float32)
    for r2 in (near, far):
        assert bool(torch.all(tsr.pair_weight(r2, variant, rs) == 0))


@pytest.mark.parametrize("rs", [0.5, RS])
@pytest.mark.parametrize("variant", CULL_FORMS)
def test_cull_drops_only_zero_weights(variant, rs):
    """cull_counts_plain on the clustered state (rs 0.5: r_max 3 in cells
    of 6): each unit tests its cell's neighbour load and keeps at most
    that, and the cull engages; each candidate j a unit culls weighs
    exactly 0 (float32, the kernel's order of r^2) against every live row
    of the unit, and the kept count is the box rule's, j by j."""
    box, ncell, cap, (bpos, _, counts) = _clustered()
    bpos, counts = tt(bpos), tt(counts, torch.int32)
    soft2 = SOFT ** 2
    r2_keep = tsr.keep_radius2(variant, rs)
    tested, kept = tsr.cull_counts_plain(
        bpos, counts, ncell=ncell, capacity=cap, box_size=box,
        softening=SOFT, r2_keep=r2_keep)
    units = tsr.plan_units(tsr.unit_plan_plain(counts, ncell), counts, ncell)
    assert torch.equal(tested, tsr.neighbour_load(counts, ncell)[units[:, 0]])
    assert bool(torch.all(kept <= tested))
    assert int(kept.sum()) < int(tested.sum())
    for (cell, row0, rows), k in zip(units.tolist(), kept.tolist()):
        xi = bpos[:, cell, row0:row0 + rows]                     # [3, R]
        ncid, shift = tsr._neighbours(torch.tensor([cell]), ncell, box)
        live = torch.arange(cap)[None] < counts[ncid[0]][:, None]
        pj = (bpos[:, ncid[0]] + shift[:, 0, :, None])[:, live]  # [3, J]
        g = torch.clamp(torch.maximum(xi.amin(1, keepdim=True) - pj,
                                      pj - xi.amax(1, keepdim=True)),
                        min=0.0)
        keep = g[0] * g[0] + (g[1] * g[1] + (g[2] * g[2] + soft2)) < r2_keep
        assert int(keep.sum()) == k
        d = pj[:, None, ~keep] - xi[:, :, None]                 # [3, R, J']
        r2 = d[0] * d[0] + (d[1] * d[1] + (d[2] * d[2] + soft2))
        assert bool(torch.all(tsr.pair_weight(r2, variant, rs) == 0))
