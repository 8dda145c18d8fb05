"""The port's 1D-slab multi-rank path (lambda_cdm_tpu_torch/parallel) held
against the JAX package's parallel/ functions: 4 spawned gloo ranks (one
group for the whole module, tests/_torch_mesh_worker.py) against a
4-device mesh of the conftest's virtual CPU devices, at N = 1024 from one
numpy seed. Each rank returns its rows; the tests join them in rank order,
which is the JAX package's row order of a sharded array.

Bars: the ring's forces 1e-5 of the largest |a| (K4's bar), the energies
1e-6, the sharded PM 1e-5 of the largest |a| (the stateless pm test's
bar), the slab FFT 1e-5 of the largest value (float32 transforms of 16^3
points, summed in another order), migration row for row exactly
(overflowing cases included), bounds and imbalance exactly.
"""

import numpy as np
import pytest

from _torch_mesh_worker import run_ranks
from _torch_parity import max_rel

import jax
import jax.numpy as jnp

from lambda_cdm_tpu.parallel import exchange as jex, fft as jfft, \
    sharded as jsh
from lambda_cdm_tpu.parallel.mesh import make_mesh

N_RANKS = 4
N = 1024
BOX, SOFT, NG, G = 50.0, 0.5, 16, 1.3
NG_WHOLE = 18                     # 18 % N_RANKS != 0
CAP, CAP_SMALL = 96, 16


def _payload():
    rng = np.random.default_rng(11)
    f32 = np.float32
    pos = rng.uniform(0.0, BOX, (N, 3)).astype(f32)
    vel = rng.normal(size=(N, 3)).astype(f32)
    mass = rng.uniform(0.5, 1.5, N).astype(f32)
    mass[-24:] = 0.0                                 # zero-mass padding rows
    pos[-24:] = 0.0
    vel[-24:] = 0.0
    grid = rng.normal(size=(NG,) * 3).astype(f32)
    other = rng.normal(size=(NG,) * 3).astype(f32)
    spectrum_t = np.asarray(jfft.distributed_rfftn(
        jnp.asarray(other), mesh=make_mesh(N_RANKS)))
    # a migration input nobody has homed: uniform rows, 40% dead
    mig_pos = rng.uniform(0.0, BOX, (N, 3)).astype(f32)
    mig_vel = rng.normal(size=(N, 3)).astype(f32)
    mig_mass = rng.uniform(0.5, 1.5, N).astype(f32)
    dead = rng.random(N) < 0.4
    mig_mass[dead] = 0.0
    mig_pos[dead] = 0.0
    mig_vel[dead] = 0.0
    # a cluster, so the pair-cost weights and bounds differ from counts
    mig_pos[:60] = (BOX * 0.3 + rng.normal(size=(60, 3)) * 1.5).astype(f32)
    return dict(box=BOX, soft=SOFT, ng=NG, ng_whole=NG_WHOLE, g=G, pos=pos,
                vel=vel, mass=mass, grid=grid, spectrum_t=spectrum_t,
                mig_pos=mig_pos, mig_vel=mig_vel, mig_mass=mig_mass,
                bounds=np.array([0.0, 12.0, 25.0, 38.0, BOX], f32),
                cap=CAP, cap_small=CAP_SMALL)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(payload, per-rank results): one spawned group for the module."""
    p = _payload()
    return p, run_ranks("functions", N_RANKS, tmp_path_factory.mktemp("pg"),
                        p)


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(N_RANKS)


def joined(res, key):
    return np.concatenate([r[key] for r in res])


def ri(x):
    """A complex array as its (re, im) float pairs."""
    x = np.asarray(x)
    return np.stack([x.real, x.imag], -1)


def test_ring_direct_accelerations(ranks, jmesh):
    p, res = ranks
    ref = jsh.ring_direct_accelerations(
        jnp.asarray(p["pos"]), jnp.asarray(p["mass"]), box_size=BOX,
        softening=SOFT, g_const=G, mesh=jmesh)
    got = joined(res, "ring")
    assert max_rel(got, ref) <= 1e-5
    assert np.all(got[-24:] == 0.0)          # zero-mass rows: no force


def test_sharded_energy(ranks, jmesh):
    p, res = ranks
    ref = jsh.sharded_energy(jnp.asarray(p["pos"]), jnp.asarray(p["vel"]),
                             jnp.asarray(p["mass"]), box_size=BOX,
                             softening=SOFT, g_const=G, mesh=jmesh)
    for k in ("kinetic", "potential", "total"):
        vals = {float(r[f"energy_{k}"]) for r in res}
        assert len(vals) == 1                # equal on every rank
        assert abs(vals.pop() - float(ref[k])) <= 1e-6 * abs(float(ref[k]))


@pytest.mark.parametrize("key, ng, split", [
    ("pm", NG, 0.0), ("pm_split", NG, 1.5),
    ("pm_whole", NG_WHOLE, 0.0), ("pm_whole_split", NG_WHOLE, 1.5)])
def test_sharded_pm_accelerations(ranks, jmesh, key, ng, split):
    """The slab PM, and at a grid that does not divide by the ranks the
    whole-grid solve on every rank, against JAX's GSPMD PM."""
    p, res = ranks
    ref = jsh.sharded_pm_accelerations(
        jnp.asarray(p["pos"]), jnp.asarray(p["mass"]), ng, BOX, G,
        split_scale=split, mesh=jmesh)
    assert max_rel(joined(res, key), ref) <= 1e-5


def test_slab_fft(ranks, jmesh):
    """The transposed [ky, kx, kz] half spectrum, its inverse, the round
    trip and the Poisson solve (with and without the split)."""
    p, res = ranks
    grid = jnp.asarray(p["grid"])
    assert max_rel(ri(joined(res, "rfftn")),
                   ri(jfft.distributed_rfftn(grid, mesh=jmesh))) <= 1e-5
    assert max_rel(joined(res, "irfftn"), jfft.distributed_irfftn(
        jnp.asarray(p["spectrum_t"]), ng=NG, mesh=jmesh)) <= 1e-5
    kx = jfft.k_vectors_transposed(NG, BOX)[0]
    assert max_rel(joined(res, "irfftn_grad"), jfft.distributed_irfftn(
        -1j * kx * jnp.asarray(p["spectrum_t"]), ng=NG, mesh=jmesh)) <= 1e-5
    assert max_rel(joined(res, "roundtrip"), p["grid"]) <= 1e-5
    for key, split in (("poisson", 0.0), ("poisson_split", 2.0)):
        ref = jfft.distributed_poisson_solve(grid, ng=NG, box_size=BOX,
                                             mesh=jmesh, split_scale=split)
        assert max_rel(joined(res, key), ref) <= 1e-5
    kx, ky, kz, k2 = jfft.k_vectors_transposed(NG, BOX)
    from lambda_cdm_tpu_torch.parallel import fft as tfft
    for a, b in zip(tfft.k_vectors_transposed(NG, BOX, device="cpu"),
                    (kx, ky, kz, k2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["emig", "emig_bounds", "emig_ovf", "full",
                                  "full_ovf"])
def test_migration_row_for_row(ranks, jmesh, name):
    """Both migrations against the JAX functions row for row, and the
    overflow count; the overflowing cases (a bucket of 16) too."""
    p, res = ranks
    fn = (jex.migrate_particles if name.startswith("full")
          else jex.migrate_particles_emigrant)
    cap = {"emig": CAP, "emig_bounds": CAP, "emig_ovf": CAP_SMALL,
           "full": N // N_RANKS, "full_ovf": CAP_SMALL}[name]
    kw = {"bounds": jnp.asarray(p["bounds"])} if name == "emig_bounds" \
        else {}
    rp, rv, rm, ovf = fn(jnp.asarray(p["mig_pos"]), jnp.asarray(p["mig_vel"]),
                         jnp.asarray(p["mig_mass"]), box_size=BOX,
                         capacity=cap, mesh=jmesh, **kw)
    assert all(r[f"{name}_ovf"] == int(ovf) for r in res)
    assert (int(ovf) > 0) == name.endswith("ovf")
    for key, ref in (("pos", rp), ("vel", rv), ("mass", rm)):
        np.testing.assert_array_equal(joined(res, f"{name}_{key}"),
                                      np.asarray(ref))
    if int(ovf) == 0:            # a valid result keeps every particle
        got = joined(res, f"{name}_mass")
        np.testing.assert_array_equal(np.sort(got[got > 0]),
                                      np.sort(p["mig_mass"][
                                          p["mig_mass"] > 0]))


def test_bounds_and_imbalance(ranks, jmesh):
    p, res = ranks
    pos, mass = jnp.asarray(p["mig_pos"]), jnp.asarray(p["mig_mass"])
    w = jex.pair_cost_weights(pos, mass, BOX)
    np.testing.assert_array_equal(joined(res, "pair_cost"), np.asarray(w))
    for r in res:
        np.testing.assert_array_equal(r["slab_bounds"], np.asarray(
            jex.adaptive_slab_bounds(pos, mass, N_RANKS, BOX)))
        np.testing.assert_array_equal(r["slab_bounds_w"], np.asarray(
            jex.adaptive_slab_bounds(pos, mass, N_RANKS, BOX, weights=w)))
        for got, ref in zip((r["bounds_nd_x"], r["bounds_nd_y"],
                             r["bounds_nd_z"]),
                            jex.adaptive_bounds_nd(pos, mass, (2, 2, 1),
                                                   BOX)):
            np.testing.assert_array_equal(got, np.asarray(ref))
        assert r["imbalance"] == float(jex.load_imbalance(mass, mesh=jmesh))
        assert r["imbalance_w"] == float(
            jex.load_imbalance(mass, mesh=jmesh, weights=w))


def test_owners_and_padding():
    """find_owner (uniform and with bounds), find_owner_3d (uniform and
    with adaptive bricks) and pad_particles on whole arrays."""
    import torch
    from lambda_cdm_tpu_torch.parallel import exchange as tex
    p = _payload()
    pos, mass = p["mig_pos"], p["mig_mass"]
    tp, tm = torch.as_tensor(pos), torch.as_tensor(mass)
    b = p["bounds"]
    np.testing.assert_array_equal(tex.find_owner(tp, BOX, 4).numpy(),
                                  np.asarray(jex.find_owner(pos, BOX, 4)))
    np.testing.assert_array_equal(
        tex.find_owner(tp, BOX, 4, bounds=torch.as_tensor(b)).numpy(),
        np.asarray(jex.find_owner(pos, BOX, 4, bounds=jnp.asarray(b))))
    np.testing.assert_array_equal(
        tex.find_owner_3d(tp, BOX, (2, 3, 2)).numpy(),
        np.asarray(jex.find_owner_3d(pos, BOX, (2, 3, 2))))
    jb = jex.adaptive_bounds_nd(jnp.asarray(pos), jnp.asarray(mass),
                                (2, 2, 2), BOX)
    tb = tex.adaptive_bounds_nd(tp, tm, (2, 2, 2), BOX)
    for a, c in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    np.testing.assert_array_equal(
        tex.find_owner_3d(tp, BOX, (2, 2, 2), bounds=tb).numpy(),
        np.asarray(jex.find_owner_3d(pos, BOX, (2, 2, 2), bounds=jb)))
    for n_dev in (3, 8):
        got = tex.pad_particles(tp, tp, tm, n_dev=n_dev, factor=1.5)
        ref = jex.pad_particles(jnp.asarray(pos), jnp.asarray(pos),
                                jnp.asarray(mass), n_dev=n_dev, factor=1.5)
        for a, c in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_helpers_default_to_the_card():
    """Public helpers that build tensors from numbers place them on the
    card unless a device is named (the JAX arrays' default device): on
    this CPU-only host the default raises, device="cpu" works."""
    import torch
    from lambda_cdm_tpu_torch.analysis import theory
    from lambda_cdm_tpu_torch.forces import pm
    from lambda_cdm_tpu_torch.parallel import fft as tfft
    from lambda_cdm_tpu_torch.physics import initial_conditions as ic
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    calls = [lambda **kw: ic.fourier_grid(8, BOX, **kw),
             lambda **kw: ic.lattice_positions(4, BOX, **kw),
             lambda **kw: pm.assignment_window(8, BOX, **kw),
             lambda **kw: pm.poisson_greens_function(8, BOX, **kw),
             lambda **kw: tfft.k_vectors_transposed(8, BOX, **kw),
             lambda **kw: theory.mass_function(CosmologyParams(), 100.0,
                                               **kw)]
    for call in calls:
        assert call(device="cpu") is not None
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                call()
