"""The direct O(N^2) sums of the PyTorch port against the JAX package: the
broadcast and row-blocked accelerations (the CPU path and the oracle of
the `direct` solver), the plain versions of the K4/K4s kernels
(variants v1, v2, sym, sym2) against pallas_direct_accelerations run in
interpret mode, as the JAX package's own tests run it, and the pairwise
potential energy (K9's plain version) against the JAX package's."""

import numpy as np
import pytest
import torch

from _torch_parity import half_box_lattice, max_rel, tt, uniform_particles

import jax
import jax.numpy as jnp

from lambda_cdm_tpu.forces import direct as jdirect
from lambda_cdm_tpu.ops.pallas_direct import pallas_direct_accelerations
from lambda_cdm_tpu_torch.forces import direct as tdirect
from lambda_cdm_tpu_torch.ops import direct as tops

# float32 sums over N pairs taken in another order: measured <= 3.4e-7 of
# the largest |a|; 1e-5 is the JAX package's own bar for the Pallas kernel
# against its jnp oracle (tests/test_solvers.py)
TOL = 1e-5


def _jx(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("n", [300, 777])
@pytest.mark.parametrize("mg", [0.0, 0.3])
def test_direct_accelerations(n, mg):
    box, soft, g = 20.0, 0.05, 43.0071
    pos, m = uniform_particles(n, box, seed=n)
    ref = jdirect.direct_accelerations(*_jx(pos, m), box, soft, g, mg)
    got = tdirect.direct_accelerations(tt(pos), tt(m), box, soft, g, mg)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    assert max_rel(got, ref) < TOL


@pytest.mark.parametrize("n,chunk", [(777, 256), (1000, 300)])
def test_direct_accelerations_chunked(n, chunk):
    """A chunk that divides N and one that does not, with modified
    gravity."""
    box, soft = 20.0, 0.05
    pos, m = uniform_particles(n, box, seed=3)
    ref = jdirect.direct_accelerations_chunked(*_jx(pos, m), box, soft, 1.0,
                                               0.2, chunk_size=chunk)
    got = tdirect.direct_accelerations_chunked(tt(pos), tt(m), box, soft,
                                               1.0, 0.2, chunk_size=chunk)
    assert max_rel(got, ref) < TOL
    full = tdirect.direct_accelerations(tt(pos), tt(m), box, soft, 1.0, 0.2)
    assert max_rel(got, full) < TOL


def test_direct_bfloat16_precision():
    """forces.precision "bfloat16": the contraction's operands in bf16,
    float32 accumulation. Against the JAX package's float32 oracle (the
    CPU computes its einsum at float32 whatever the precision): a few
    parts in a thousand, as the JAX package documents (~0.4%); against
    the port's own float32 result the same, and never bit-equal."""
    box, soft = 20.0, 0.05
    pos, m = uniform_particles(300, box, seed=5)
    ref = jdirect.direct_accelerations(
        *_jx(pos, m), box, soft, 1.0, precision=jax.lax.Precision.HIGHEST)
    got = tdirect.direct_accelerations(tt(pos), tt(m), box, soft, 1.0,
                                       precision="bfloat16")
    err = max_rel(got, ref)
    assert 1e-5 < err < 1e-2
    chunked = tdirect.direct_accelerations_chunked(
        tt(pos), tt(m), box, soft, 1.0, chunk_size=128,
        precision="bfloat16")
    assert max_rel(chunked, got) < TOL


def test_pair_accel():
    """The single-pair term: G m_j (|d|^2 + eps^2)^(-3/2) d for a batch of
    displacements, the zero displacement included."""
    rng = np.random.default_rng(4)
    dx = rng.normal(size=(50, 3)).astype(np.float32)
    dx[0] = 0.0
    mj = rng.uniform(0.5, 2.0, 50).astype(np.float32)
    ref = jdirect._pair_accel(*_jx(dx, mj), 0.01, 2.0)
    got = tdirect._pair_accel(tt(dx), tt(mj), 0.01, 2.0)
    assert max_rel(got, ref) < 1e-6
    assert torch.all(got[0] == 0)


VARIANT_CASES = [(100, "v1"), (100, "sym"), (777, "v1"), (777, "v2"),
                 (777, "sym"), (777, "sym2"), (1100, "sym"), (1100, "sym2")]


@pytest.mark.parametrize("n,variant", VARIANT_CASES)
def test_kernel_plain_matches_pallas(n, variant):
    """N = 100 (sym: one tile), 777 (a ragged tile) and 1100 (sym: three
    TPU tiles and five K4s tiles, the half-matrix wrap); unit and random
    masses. The box-unit variants (v2, sym2) are held to the same bar:
    both packages round the same box-unit intermediates."""
    box, soft = 20.0, 0.05
    pos, m = uniform_particles(n, box, seed=n + 1)
    if n == 100:
        m = np.ones(n, np.float32)
    ref = pallas_direct_accelerations(*_jx(pos, m), box, soft, 2.0,
                                      interpret=True, variant=variant)
    got = tops.pairwise_accelerations(tt(pos), tt(m), box, soft, 2.0,
                                      variant=variant)
    assert got.shape == (n, 3)
    assert max_rel(got, ref) < TOL
    # every variant computes the one function
    oracle = tdirect.direct_accelerations(tt(pos), tt(m), box, soft, 2.0)
    assert max_rel(got, oracle) < (TOL if variant in ("v1", "sym")
                                   else 1e-3)


@pytest.mark.parametrize("variant", ["v1", "sym"])
def test_kernel_plain_nonperiodic(variant):
    pos, m = uniform_particles(300, 10.0, seed=7)
    ref = pallas_direct_accelerations(*_jx(pos, m), 10.0, 0.05,
                                      periodic=False, interpret=True,
                                      variant=variant)
    got = tops.pairwise_accelerations(tt(pos), tt(m), 10.0, 0.05,
                                      periodic=False, variant=variant)
    assert max_rel(got, ref) < TOL
    far = tdirect.direct_accelerations(tt(pos), tt(m), 1e9, 0.05)
    assert max_rel(got, far) < TOL


@pytest.mark.parametrize("variant", ["v1", "sym"])
def test_kernel_plain_half_box_image(variant):
    """Pairs one ulp past half a box apart: the plain versions take the
    image of the true quotient d / box, as the solver's min_image does,
    and agree with direct_accelerations; the TPU kernel's d * (1/box)
    picks the other image there, so it lands beyond the bar."""
    box = 50.0
    pos, m, flips = half_box_lattice(box, seed=3)
    assert flips > 0
    oracle = tdirect.direct_accelerations(tt(pos), tt(m), box, 0.1)
    got = tops.pairwise_accelerations(tt(pos), tt(m), box, 0.1,
                                      variant=variant)
    assert max_rel(got, oracle) < TOL
    tpu = pallas_direct_accelerations(*_jx(pos, m), box, 0.1,
                                      interpret=True, variant=variant)
    assert max_rel(tpu, oracle) > 100 * TOL


def test_kernel_g_const_and_zero_mass():
    """G scales the result; a zero-mass particle feels no force in sym (its
    force is divided by its mass: 0, not NaN) and exerts none."""
    box = 20.0
    pos, m = uniform_particles(200, box, seed=9)
    a1 = tops.pairwise_accelerations(tt(pos), tt(m), box, 0.05, 1.0)
    a2 = tops.pairwise_accelerations(tt(pos), tt(m), box, 0.05, 43.0071)
    assert max_rel(a2, 43.0071 * a1) < 1e-6
    m[5] = 0.0
    sym = tops.pairwise_accelerations(tt(pos), tt(m), box, 0.05,
                                      variant="sym")
    assert torch.all(sym[5] == 0)
    v1 = tops.pairwise_accelerations(tt(pos), tt(m), box, 0.05)
    keep = np.arange(200) != 5
    assert max_rel(sym[keep], v1[keep]) < TOL
    ref = pallas_direct_accelerations(*_jx(pos, m), box, 0.05,
                                      interpret=True, variant="sym")
    assert max_rel(sym, ref) < TOL


def test_zero_softening_rejected():
    pos, m = uniform_particles(64, 10.0, seed=1)
    with pytest.raises(ValueError):
        pallas_direct_accelerations(*_jx(pos, m), 10.0, 0.0, interpret=True)
    for variant in tops.VARIANTS:
        with pytest.raises(ValueError, match="softening"):
            tops.pairwise_accelerations(tt(pos), tt(m), 10.0, 0.0,
                                        variant=variant)
    with pytest.raises(ValueError, match="variant"):
        tops.pairwise_accelerations(tt(pos), tt(m), 10.0, 0.1,
                                    variant="v3")


def test_sym_tiles_odd():
    assert [tops.sym_tiles(n) for n in (1, 256, 257, 600, 1100)] == \
        [1, 1, 3, 3, 5]


@pytest.mark.parametrize("variant", ["v1", "sym"])
def test_kernel_wrapper_never_falls_back(variant):
    """A tensor neither on the CPU nor on a card raises (the plain version
    is taken only for CPU tensors); CPU calls count no launch."""
    before = dict(tops.launches)
    meta = torch.zeros((64, 3), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        tops.pairwise_accelerations(meta, torch.ones(64, device="meta"),
                                    10.0, 0.1, variant=variant)
    pos, m = uniform_particles(64, 10.0, seed=2)
    tops.pairwise_accelerations(tt(pos), tt(m), 10.0, 0.1, variant=variant)
    assert tops.launches == before


# -- the pairwise potential energy (K9's plain version) -----------------------

@pytest.mark.parametrize("box,soft", [(20.0, 0.05), (50.0, 0.05),
                                      (50.0, 0.5)])
def test_potential_energy_half_box_lattice(box, soft):
    """N = 4096 on a jittered lattice: at box 50 its middle layer sits one
    ulp past half a box from layer 0 (131,072 pairs whose image depends on
    the rounding of the quotient); both packages take the true quotient.
    Float32 pair terms summed in another order (the JAX package in
    float32, the port in float64): measured <= 1.9e-7."""
    pos, m, flips = half_box_lattice(box, seed=3, side=16)
    assert len(pos) == 4096 and (flips > 0) == (box == 50.0)
    ref = float(jdirect.potential_energy(*_jx(pos, m), box, soft, 43.0071))
    got = tdirect.potential_energy(tt(pos), tt(m), box, soft, 43.0071)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - ref) <= TOL * abs(ref)


def test_potential_energy_uniform_and_chunks():
    """Uniform masses in (0.5, 2): the JAX value at 1e-5 for two row
    blockings; K9's plain version returns the float64 sum that
    potential_energy rounds, and counts no launch on the CPU."""
    pos, m = uniform_particles(4096, 20.0, seed=7)
    ref = float(jdirect.potential_energy(*_jx(pos, m), 20.0, 0.05, 1.0))
    before = dict(tops.launches)
    for chunk in (2048, 300):
        got = tops.pair_potential(tt(pos), tt(m), 20.0, 0.05, 1.0,
                                  chunk_size=chunk)
        assert got.dtype == torch.float64 and got.shape == ()
        assert abs(float(got) - ref) <= TOL * abs(ref)
        assert float(tdirect.potential_energy(
            tt(pos), tt(m), 20.0, 0.05, 1.0, chunk_size=chunk)) == \
            float(got.to(torch.float32))
    assert tops.launches == before


def test_pair_potential_wrapper_never_falls_back():
    """A tensor neither on the CPU nor on a card raises."""
    meta = torch.zeros((64, 3), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        tops.pair_potential(meta, torch.ones(64, device="meta"), 10.0, 0.1)


# -- K9's symmetric tile schedule, emulated ----------------------------------

def _schedule_pairs(n):
    """[P, 2] (i, j) index pairs K9's blocks visit, in block order: tile p's
    rows against tile q's columns, j > i on the diagonal block."""
    t = tops.PAIR_TILE
    out = []
    for p, q in zip(*tops.pair_schedule(n)):
        if max(int(p), int(q)) * t >= n:    # the odd count's empty tile
            continue
        rows = torch.arange(int(p) * t, min(n, int(p) * t + t))
        cols = torch.arange(int(q) * t, min(n, int(q) * t + t))
        i, j = torch.meshgrid(rows, cols, indexing="ij")
        keep = j > i if p == q else torch.ones_like(i, dtype=torch.bool)
        out.append(torch.stack([i[keep], j[keep]], dim=1))
    return torch.cat(out)


def _tiled_potential(pos, m, box, soft, g):
    """U = -G sum_{i<j} m_i m_j / r over K9's schedule, with the kernel's
    arithmetic: the image rint(d * fl(1/box)) of the unrounded product (an
    FMA into the magic constant, exact here in float64), d - box r rounded
    once (an FMA), r^2 rounded as the plain version, the exclusion r^2 <=
    eps^2 + 1e-30; each block's terms summed in float64."""
    soft2 = torch.tensor(soft, dtype=torch.float32) ** 2
    thr = soft2 + 1e-30
    inv_box = (1.0 / torch.tensor(box, dtype=torch.float32)).double()
    total = torch.zeros((), dtype=torch.float64)
    t = tops.PAIR_TILE
    n = pos.shape[0]
    for p, q in zip(*tops.pair_schedule(n)):
        if max(int(p), int(q)) * t >= n:
            continue
        pi, pj = pos[p * t:p * t + t], pos[q * t:q * t + t]
        d = (pj[None, :, :] - pi[:, None, :]).double()
        img = torch.round(d * inv_box)
        d = (d - float(np.float32(box)) * img).to(torch.float32)
        r2 = torch.sum(d * d, dim=-1) + soft2
        inv_r = torch.where(r2 <= thr, 0.0, torch.rsqrt(r2))
        term = (m[p * t:p * t + t, None] * m[None, q * t:q * t + t]) * inv_r
        if p == q:
            term = torch.triu(term, diagonal=1)
        total = total + torch.sum(term, dtype=torch.float64)
    return -float(g) * total


@pytest.mark.parametrize("n", [1, 2, tops.PAIR_TILE - 1, tops.PAIR_TILE + 1,
                               4096])
def test_pair_schedule_visits_each_unordered_pair_once(n):
    """K9's blocks (pair_schedule, decoded as the kernel decodes blockIdx)
    visit every unordered pair i < j exactly once and no self pair; the
    tile count is odd, so the half-matrix wrap closes."""
    assert tops.pair_tiles(n) % 2 == 1
    pairs = _schedule_pairs(n)
    assert bool(torch.all(pairs[:, 0] != pairs[:, 1]))
    key = torch.minimum(pairs[:, 0], pairs[:, 1]) * n + torch.maximum(
        pairs[:, 0], pairs[:, 1])
    seen = torch.bincount(key, minlength=n * n).reshape(n, n)
    assert bool(torch.all(torch.triu(seen, 1) == torch.triu(
        torch.ones_like(seen), 1)))
    assert int(seen.sum()) == n * (n - 1) // 2


@pytest.mark.parametrize("n", [1, 2, tops.PAIR_TILE - 1, tops.PAIR_TILE + 1,
                               4096])
def test_pair_schedule_sum_matches_plain_and_jax(n):
    """The schedule's sum with the kernel's arithmetic equals
    pair_potential_plain and the JAX potential_energy at 1e-5 (float32
    terms summed in another order; one fewer rounding of the image)."""
    pos, m = uniform_particles(n, 20.0, seed=n)
    got = float(_tiled_potential(tt(pos), tt(m), 20.0, 0.05, 43.0071))
    ref = float(tops.pair_potential_plain(tt(pos), tt(m), 20.0, 0.05,
                                          43.0071))
    assert abs(got - ref) <= TOL * abs(ref) or n == 1 and got == ref == 0.0
    if n > 1:
        jref = float(jdirect.potential_energy(*_jx(pos, m), 20.0, 0.05,
                                              43.0071))
        assert abs(got - jref) <= TOL * abs(jref)


@pytest.mark.parametrize("box", [20.0, 50.0])
def test_pair_schedule_sum_half_box_lattice(box):
    """On the lattice whose middle layer sits one ulp past half a box
    (box 50: pairs whose image the product d * (1/box) and the quotient
    d / box round apart), the schedule's sum holds plain and JAX at
    1e-5: at the tie both images give |d| to an ulp."""
    pos, m, flips = half_box_lattice(box, seed=3, side=16)
    assert (flips > 0) == (box == 50.0)
    got = float(_tiled_potential(tt(pos), tt(m), box, 0.05, 43.0071))
    ref = float(tops.pair_potential_plain(tt(pos), tt(m), box, 0.05,
                                          43.0071))
    jref = float(jdirect.potential_energy(*_jx(pos, m), box, 0.05, 43.0071))
    assert abs(got - ref) <= TOL * abs(ref)
    assert abs(got - jref) <= TOL * abs(jref)


# -- the cross forms of the multi-rank ring ----------------------------------

@pytest.mark.parametrize("n, m", [(100, 333), (333, 100)])
def test_cross_forms_plain_match_the_jax_ring_step(n, m):
    """K4's and K9's cross forms (plain versions) against the JAX ring's
    step bodies: parallel/sharded._partial_direct at K4's bar, and the
    sharded_energy step's sum over ordered pairs with its guard at 1e-6;
    a zero-mass source adds nothing."""
    from lambda_cdm_tpu.parallel.sharded import _partial_direct
    box, soft = 20.0, 0.05
    t, tm = uniform_particles(n, box, seed=n)
    s, sm = uniform_particles(m, box, seed=m + 1)
    sm[::7] = 0.0
    ref = _partial_direct(*_jx(t, s, sm), box, soft * soft)
    got = tops.pairwise_accelerations_cross(tt(t), tt(s), tt(sm), box, soft,
                                            1.0)
    assert max_rel(got, ref) <= TOL
    d = jdirect.min_image(jnp.asarray(s)[None] - jnp.asarray(t)[:, None],
                          box)
    r2 = jnp.sum(d * d, -1) + soft * soft
    inv_r = jnp.where(r2 <= soft * soft + 1e-30, 0.0, jax.lax.rsqrt(r2))
    ref_u = -0.5 * 1.3 * float(jnp.sum(jnp.asarray(tm)[:, None]
                                       * jnp.asarray(sm)[None] * inv_r))
    got_u = tops.pair_potential_cross(tt(t), tt(tm), tt(s), tt(sm), box,
                                      soft, 1.3)
    assert got_u.dtype == torch.float64
    assert abs(float(got_u) - ref_u) <= 1e-6 * abs(ref_u)


def test_cross_forms_on_one_set():
    """With one set as both arguments the cross forms are the symmetric
    functions: K4's plain cross form is the solver's plain sum byte for
    byte, K9's cross form is pair_potential to 1e-6 (the self pair left
    out by the guard); the sym variants take no separate sources."""
    box, soft = 20.0, 0.05
    p, m = uniform_particles(500, box, seed=3)
    for variant in ("v1", "v2"):
        assert torch.equal(
            tops.pairwise_accelerations_cross(tt(p), tt(p), tt(m), box, soft,
                                              2.0, variant=variant),
            tops.pairwise_accelerations_plain(tt(p), tt(m), box, soft, 2.0,
                                              variant=variant))
    sym = float(tops.pair_potential(tt(p), tt(m), box, soft, 2.0))
    cross = float(tops.pair_potential_cross(tt(p), tt(m), tt(p), tt(m), box,
                                            soft, 2.0))
    assert abs(cross - sym) <= 1e-6 * abs(sym)
    with pytest.raises(ValueError, match="v1 or v2"):
        tops.pairwise_accelerations_cross(tt(p), tt(p), tt(m), box, soft,
                                          variant="sym")
