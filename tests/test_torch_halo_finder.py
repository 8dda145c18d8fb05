"""The port's FoF + SO halo finder (lambda_cdm_tpu_torch.analysis.
halo_finder, with the K5 hook's plain version on the CPU) against the JAX
package's on the same numpy inputs.

Tolerances: FoF labels, overflow counts, plans and group sizes are
integers and must be equal. Catalogue floats: mass, centre and velocity
within 1e-5 relative (float64 segment sums in the port against the JAX
package's float32 segmented scan); radius, v_max and spin within 1e-4
(radial histograms summed in another order, a float64-built bin-edge
table against jnp.linspace in float32).
"""

import numpy as np
import pytest
import torch

from _torch_parity import max_rel, nn, tt

import jax.numpy as jnp

from lambda_cdm_tpu.analysis import halo_finder as jhf
from lambda_cdm_tpu_torch.analysis import halo_finder as thf
from lambda_cdm_tpu_torch.interop import halo_catalog_to_arrays
from lambda_cdm_tpu_torch.ops import fof_hook


def _clumpy(n, box, seed, n_clumps=8, frac=0.3, sigma=0.2):
    """Uniform background plus Gaussian clumps around random centres."""
    rng = np.random.default_rng(seed)
    nu = int((1 - frac) * n)
    cent = rng.uniform(0, box, (n_clumps, 3))
    pos = np.concatenate([
        rng.uniform(0, box, (nu, 3)),
        cent[rng.integers(0, n_clumps, n - nu)]
        + sigma * rng.standard_normal((n - nu, 3))])
    return (pos % box).astype(np.float32)


def _overflow_dead():
    """A dense core centred in a cell (it overflows capacity 128 at
    ncell=8), background, and 24 dead rows at the origin."""
    rng = np.random.default_rng(5)
    box = 20.0
    pos = np.concatenate([11.25 + 0.15 * rng.standard_normal((900, 3)),
                          rng.uniform(0, box, (600, 3)),
                          np.zeros((24, 3))]) % box
    live = np.concatenate([np.ones(1500, bool), np.zeros(24, bool)])
    return pos.astype(np.float32), live, box


def _chains():
    """Two periodic chains of step 0.18 < b = 0.2 (along x and along y), a
    clump and background: many hook rounds."""
    box = 40.0
    rng = np.random.default_rng(11)
    step = 0.18
    npts = int(box / step)
    ca = np.stack([np.arange(npts) * step, np.full(npts, 5.3),
                   np.full(npts, 5.3)], 1)
    cb = np.stack([np.full(npts, 25.1), np.arange(npts) * step,
                   np.full(npts, 25.1)], 1)
    pos = np.concatenate([ca, cb, rng.normal(15.0, 0.1, (80, 3)),
                          rng.uniform(0, box, (300, 3))]) % box
    return pos.astype(np.float32), box, npts


def _union_find(pos, box, b):
    """Brute-force FoF oracle: each particle labelled with the least index
    of its component (r^2 < b^2, minimum image)."""
    n = len(pos)
    d = pos[:, None, :].astype(np.float64) - pos[None, :, :]
    d -= box * np.round(d / box)
    adj = (d ** 2).sum(-1) < b * b
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x
    for i, j in zip(*np.nonzero(adj)):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    return np.array([find(i) for i in range(n)])


def _both_labels(pos, box, b, live=None, jhook="jnp", **kw):
    lj, oj = jhf.fof_labels(jnp.asarray(pos), box, b, hook=jhook,
                            live=None if live is None else jnp.asarray(live),
                            **kw)
    lt, ot = thf.fof_labels(tt(pos), box, b,
                            live=None if live is None else torch.tensor(live),
                            **kw)
    assert lt.dtype == torch.int32
    return np.asarray(lj), int(oj), nn(lt), int(ot)


class TestFofLabels:
    def test_clustered_matches_jnp(self):
        n, box = 3000, 20.0
        pos = _clumpy(n, box, 0)
        lj, oj, lt, ot = _both_labels(pos, box, 0.25 * box / n ** (1 / 3),
                                      ncell=8, capacity=128)
        np.testing.assert_array_equal(lt, lj)
        assert ot == oj == 0
        assert 100 < len(np.unique(lt)) < n

    def test_overflow_and_dead_rows_match_jnp(self):
        pos, live, box = _overflow_dead()
        lj, oj, lt, ot = _both_labels(pos, box, 0.5, live=live, ncell=8,
                                      capacity=128)
        np.testing.assert_array_equal(lt, lj)
        assert ot == oj > 0
        # dead rows stay field singletons
        np.testing.assert_array_equal(lt[-24:], np.arange(1500, 1524))

    def test_long_chains_match_jnp_and_union_find(self):
        """Percolation chains need many rounds; the per-cell active mask
        must not starve the propagation."""
        pos, box, npts = _chains()
        lj, oj, lt, ot = _both_labels(pos, box, 0.2, ncell=8, capacity=128,
                                      max_rounds=256)
        oracle = _union_find(pos, box, 0.2)
        np.testing.assert_array_equal(lj, oracle)
        np.testing.assert_array_equal(lt, oracle)
        assert ot == oj == 0
        assert np.unique(lt[:npts]).size == 1
        assert np.unique(lt[npts:2 * npts]).size == 1

    def test_matches_pallas_interpret(self):
        """The TPU kernel under the Pallas interpreter (a Gauss-Seidel
        sweep) and the port's Jacobi sweep reach the same labels."""
        rng = np.random.default_rng(0)
        n, box = 300, 6.0
        pos = (np.concatenate([rng.uniform(0, box, (200, 3)),
                               3.0 + 0.15 * rng.standard_normal((100, 3))])
               % box).astype(np.float32)
        lj, oj, lt, ot = _both_labels(pos, box, 0.3 * box / n ** (1 / 3),
                                      jhook="pallas_interpret", ncell=3,
                                      capacity=128)
        np.testing.assert_array_equal(lt, lj)
        assert ot == oj == 0

    def test_hook_names(self):
        """"jnp" runs the plain version, "pallas" / "auto" the wrapper (its
        plain version on CPU tensors): one labelling either way."""
        n, box = 800, 10.0
        pos = tt(_clumpy(n, box, 3))
        b = 0.3 * box / n ** (1 / 3)
        out = [nn(thf.fof_labels(pos, box, b, ncell=4, capacity=128,
                                 hook=h)[0])
               for h in ("jnp", "pallas", "auto")]
        for o in out[1:]:
            np.testing.assert_array_equal(o, out[0])
        for bad in ("x", "pallas_interpret"):
            with pytest.raises(ValueError, match="unknown hook"):
                thf.fof_labels(pos, box, b, ncell=4, capacity=128, hook=bad)


def test_fof_hook_plain_rows_and_inactive_cells():
    """fof_hook_plain on sampled rows equals its full sweep on those rows;
    inactive cells and dead slots keep their labels."""
    box, ncell, cap = 10.0, 4, 128
    pos = tt(_clumpy(1500, box, 4))
    n = pos.shape[0]
    bxyz, _, counts, pslot, _, _ = thf._fof_setup(
        pos, torch.ones(n, dtype=torch.bool), box, ncell, cap)
    nslots = ncell ** 3 * cap
    lab = torch.full((nslots + 1,), n, dtype=torch.int32)
    perm = torch.tensor(np.random.default_rng(1).permutation(n)
                        .astype(np.int32))
    lab[torch.where(pslot >= 0, pslot, nslots)] = perm
    lab = lab[:nslots].reshape(ncell ** 3, cap)
    active = torch.tensor(np.arange(ncell ** 3) % 3 != 0, dtype=torch.int32)
    kw = dict(ncell=ncell, capacity=cap, n_sentinel=n, box_size=box,
              linking_length=0.3)
    full = fof_hook.fof_hook(*bxyz, lab, counts, active, **kw)
    assert int((full != lab).sum()) > 0
    off = (active == 0)[:, None] | (torch.arange(cap)[None] >= counts[:, None])
    assert torch.equal(full[off], lab[off])
    rows = torch.nonzero(~off.reshape(-1))[:, 0][::7]
    part = fof_hook.fof_hook_plain(*bxyz, lab, counts, active, rows=rows,
                                   chunk=5, **kw)
    assert torch.equal(part, full.reshape(-1)[rows])


class TestPlans:
    @pytest.mark.parametrize("case", ["uniform", "clumpy", "dead_rows",
                                      "tight_budget", "chain"])
    def test_fof_plan_matches(self, case):
        box = 20.0
        live = None
        budget = 2 << 30
        if case == "uniform":
            pos = np.random.default_rng(2).uniform(0, box, (4000, 3)) \
                .astype(np.float32)
        elif case == "clumpy":
            pos = _clumpy(4000, box, 6, n_clumps=4, frac=0.5, sigma=0.1)
        elif case == "dead_rows":
            pos, live, box = _overflow_dead()
        elif case == "chain":
            # a dense periodic chain along x through a uniform box: one
            # row of cells far above the mean occupancy
            pos = np.random.default_rng(3).uniform(0, box, (4000, 3))
            pos[:1500] = np.stack([np.arange(1500) * box / 1500,
                                   np.full(1500, 7.3), np.full(1500, 11.1)],
                                  1)
            pos = pos.astype(np.float32)
        else:
            # the budget rules out the unconstrained plan (8, 16)
            pos = np.random.default_rng(2).uniform(0, box, (4000, 3)) \
                .astype(np.float32)
            budget = 16 * 8 ** 3 * 16 - 1
        n = len(pos)
        b = 0.2 * box / n ** (1 / 3)
        pj = jhf.fof_plan(n, box, b, positions=jnp.asarray(pos),
                          memory_budget_bytes=budget,
                          live=None if live is None else jnp.asarray(live))
        pt = thf.fof_plan(n, box, b, positions=tt(pos),
                          memory_budget_bytes=budget,
                          live=None if live is None else torch.tensor(live))
        assert pt == pj

    def test_fof_plan_without_positions(self):
        for n, box, b in ((4096, 50.0, 0.6), (10 ** 6, 100.0, 0.2),
                          (100, 1.0, 0.6)):
            assert thf.fof_plan(n, box, b) == jhf.fof_plan(n, box, b)
            assert thf.fof_plan(n, box, b, capacity=96) == \
                jhf.fof_plan(n, box, b, capacity=96)

    def test_catalog_window_plan_matches(self):
        box = 100.0
        plans = []
        for pos in (_clumpy(60000, box, 8, n_clumps=40, sigma=0.5),
                    np.random.default_rng(9).uniform(0, box, (20000, 3))
                    .astype(np.float32),
                    np.random.default_rng(9).uniform(0, box, (3000, 3))
                    .astype(np.float32)):
            plans.append(thf.catalog_window_plan(tt(pos), box))
            assert plans[-1] == jhf.catalog_window_plan(jnp.asarray(pos),
                                                        box)
        assert plans[0] is not None and plans[1] is not None
        assert plans[2] is None          # no cheaper than the exact scan


def test_fof_labels_slabwise_matches():
    rng = np.random.default_rng(3)
    box, ll = 40.0, 0.2
    chain = np.stack([29.0 + np.arange(12) * 0.18, np.full(12, 7.0),
                      np.full(12, 7.0)], 1)
    pos = np.concatenate([rng.normal(10.0, 0.15, (300, 3)),
                          rng.normal(20.0, 0.15, (300, 3)), chain,
                          rng.uniform(0, box, (2000, 3))]) % box
    pos = np.concatenate([pos, np.zeros((40, 3))]).astype(np.float32)
    live = np.ones(len(pos), bool)
    live[-40:] = False
    kw = dict(ncell=16, capacity=128)
    lg, og = thf.fof_labels(tt(pos), box, ll, live=torch.tensor(live), **kw)
    lj, oj = jhf.fof_labels_slabwise(jnp.asarray(pos), box, ll, n_slabs=2,
                                     live=jnp.asarray(live), **kw)
    for n_slabs in (2, 4):
        lt, ot = thf.fof_labels_slabwise(tt(pos), box, ll, n_slabs=n_slabs,
                                         live=torch.tensor(live), **kw)
        np.testing.assert_array_equal(nn(lt), np.asarray(lj))
        np.testing.assert_array_equal(nn(lt), nn(lg))
        assert int(ot) == int(oj) == int(og) == 0
    assert np.unique(nn(lt)[600:612]).size == 1
    with pytest.raises(ValueError, match="slab width"):
        thf.fof_labels_slabwise(tt(pos), box, ll, n_slabs=256, **kw)


def _halo_box(seed=12):
    """Clumps of equal sizes (ties in the ranking) and of other sizes, a
    background and random velocities, in a 100 Mpc/h box."""
    rng = np.random.default_rng(seed)
    box = 100.0
    centres = rng.uniform(15, 85, (10, 3))
    sizes = [60, 60, 60, 45, 45, 120, 30, 25, 80, 60]
    parts = [c + r * rng.standard_normal((s, 3))
             for c, s, r in zip(centres, sizes,
                                rng.uniform(0.4, 1.2, len(sizes)))]
    pos = np.concatenate(parts + [rng.uniform(0, box, (1500, 3))]) % box
    n = len(pos)
    vel = rng.normal(0, 1.0, (n, 3))
    mass = rng.uniform(0.5, 2.0, n)
    return (pos.astype(np.float32), vel.astype(np.float32),
            mass.astype(np.float32), box)


def _catalogs(window=None, **kw):
    pos, vel, mass, box = _halo_box()
    b = 0.3 * box / len(pos) ** (1 / 3)
    lab, _ = jhf.fof_labels(jnp.asarray(pos), box, b, ncell=16,
                            capacity=128)
    lab = np.asarray(lab)
    cj = jhf.catalog_from_labels(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(mass), jnp.asarray(lab), box,
                                 max_halos=16, min_particles=20,
                                 window=window, **kw)
    ct = thf.catalog_from_labels(tt(pos), tt(vel), tt(mass),
                                 torch.tensor(lab), box, max_halos=16,
                                 min_particles=20, window=window, **kw)
    return cj, ct, box


def _assert_catalogs_match(cj, ct, box):
    t = halo_catalog_to_arrays(ct)
    nh = int(cj.num_halos)
    assert int(t["num_halos"]) == nh >= 9
    for f in ("n_particles", "particle_label"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(cj, f)))
    assert int(t["profile_dropped"]) == int(cj.profile_dropped) == 0
    assert max_rel(t["mass"], cj.mass) <= 1e-5
    assert max_rel(t["velocity"], cj.velocity) <= 1e-5
    d = t["center"] - np.asarray(cj.center)
    d -= box * np.round(d / box)
    assert np.abs(d).max() / box <= 1e-5
    for f in ("radius", "v_max", "spin", "angular_momentum"):
        assert max_rel(t[f], getattr(cj, f)) <= 1e-4, f
    assert float(t["radius"][:nh].min()) > 0


class TestCatalog:
    def test_exact_matches(self):
        cj, ct, box = _catalogs()
        _assert_catalogs_match(cj, ct, box)

    def test_windowed_matches(self):
        cj, ct, box = _catalogs(window=(8, 256, 1))
        _assert_catalogs_match(cj, ct, box)

    def test_windowed_equals_exact(self):
        """The windowed profiles see every particle within r_max, so SO
        radius, M_Delta-derived v_max and everything from the group sums
        equal the exact path's (angular momentum differs: the windowed L
        is the one within r_max)."""
        pos, vel, mass, box = _halo_box()
        b = 0.3 * box / len(pos) ** (1 / 3)
        lab, _ = thf.fof_labels(tt(pos), box, b, ncell=16, capacity=128)
        cats = [thf.catalog_from_labels(tt(pos), tt(vel), tt(mass), lab,
                                        box, max_halos=16, window=w)
                for w in (None, (8, 256, 1), (16, 128, 2))]
        for c in cats[1:]:
            for f in ("num_halos", "n_particles", "particle_label"):
                assert torch.equal(getattr(c, f), getattr(cats[0], f))
            for f in ("mass", "center", "velocity", "radius", "v_max"):
                assert max_rel(getattr(c, f), getattr(cats[0], f)) <= 1e-5

    def test_mass_function_matches(self):
        cj, ct, box = _catalogs()
        for kw in ({}, {"num_bins": 5, "m_min": 10.0, "m_max": 300.0}):
            for a, b_ in zip(thf.mass_function(ct, box, **kw),
                             jhf.mass_function(cj, box, **kw)):
                assert max_rel(a, b_) <= 1e-5

    def test_group_sums_immune_to_global_prefix_magnitude(self):
        """A 20-particle halo sorted behind a group of mass 2^24 keeps its
        mass exact (a global float32 prefix sum would lose ~10%)."""
        n_big, n_small = 1024, 20
        n = n_big + n_small
        mass = np.concatenate([np.full(n_big, 16384.0), np.ones(n_small)])
        lab = np.concatenate([np.zeros(n_big), np.full(n_small, n_big)])
        rng = np.random.default_rng(0)
        pos = np.concatenate([20.0 + rng.uniform(0, 1, (n_big, 3)),
                              70.0 + rng.uniform(0, 1, (n_small, 3))])
        cat = thf.catalog_from_labels(tt(pos), torch.zeros(n, 3), tt(mass),
                                      torch.tensor(lab, dtype=torch.int32),
                                      100.0, max_halos=4)
        assert int(cat.num_halos) == 2
        masses = np.sort(nn(cat.mass)[:2])
        np.testing.assert_allclose(masses[0], 20.0, rtol=1e-6)
        np.testing.assert_allclose(masses[1], 1024 * 16384.0, rtol=1e-6)

    def test_window_overflow_counted(self):
        n = 300
        pos = tt(50.0 + 0.1 * np.random.default_rng(2).uniform(0, 1, (n, 3)))
        lab = torch.zeros(n, dtype=torch.int32)
        args = (pos, torch.zeros(n, 3), torch.ones(n), lab, 100.0)
        cat = thf.catalog_from_labels(*args, max_halos=4, window=(8, 128, 1))
        assert int(cat.profile_dropped) == n - 128
        assert int(thf.catalog_from_labels(*args, max_halos=4)
                   .profile_dropped) == 0


def test_find_halos_and_count_groups_match():
    pos, vel, mass, box = _halo_box(seed=13)
    kw = dict(linking_length_factor=0.3, min_particles=20)
    cj = jhf.find_halos(jnp.asarray(pos), jnp.asarray(vel),
                        jnp.asarray(mass), box, **kw)
    ct = thf.find_halos(tt(pos), tt(vel), tt(mass), box, **kw)
    assert ct.mass.shape == cj.mass.shape          # auto-sized alike
    _assert_catalogs_match(cj, ct, box)
    labels = np.asarray(cj.particle_label)
    for m in (1, 20, 61):
        raw = np.where(labels >= 0, labels, np.arange(len(labels)) + 10 ** 6)
        assert int(thf.count_groups(torch.tensor(raw), m)) == \
            int(jhf.count_groups(jnp.asarray(raw), m))
