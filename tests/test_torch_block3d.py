"""The port's 3D block decomposition held against the JAX package's: 8
spawned gloo ranks (one group for the module, tests/_torch_mesh_worker.py)
on the (2, 2, 2) grid, and on the (2, 4, 1) pencil grid (the engine's
{shx, shy} mesh), against the conftest's virtual CPU devices at
tests/test_block3d.py's and test_mesh2d_generic.py's geometry (2048
particles in a 100 box, padded by 1.5) from one numpy seed. Each rank
returns its rows; the tests join them in rank order (row-major ranks,
the JAX device order).

Bars: the 3D migrations row for row and their overflow exactly (brick
bounds and an overflowing case included); the block halo pass, the full
sharded TreePM and the pencil ring direct sum and TreePM 1e-5 of the
largest |a|, the halo passes' overflow counts exactly.
"""

import numpy as np
import pytest

from _torch_mesh_worker import run_ranks
from _torch_parity import max_rel

import jax.numpy as jnp

from lambda_cdm_tpu.parallel import exchange as jex, sharded as jsh, \
    sharded_treepm as jstp
from lambda_cdm_tpu.parallel.mesh import make_mesh3d

N_RANKS = 8
AX = ("shx", "shy", "shz")
N, BOX, NG, SOFT, G = 2048, 100.0, 64, 0.1, 43.007
NG2, SOFT2 = 32, 0.5                      # the pencil tests' geometry
RS = 1.25 * BOX / NG
CAP_MIG, CAP_SMALL = 96, 8


@pytest.fixture(scope="module")
def meshes(cpu_devices):
    return {"block": make_mesh3d((2, 2, 2)), "pencil": make_mesh3d((2, 4, 1))}


def _homed(pos, vel, mass, mesh):
    n_loc = pos.shape[0] // N_RANKS
    pos, _, mass, ovf = jex.migrate_particles(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), box_size=BOX,
        capacity=n_loc, mesh=mesh, axis_name=AX)
    assert int(ovf) == 0
    return np.asarray(pos), np.asarray(mass)


@pytest.fixture(scope="module")
def ranks(meshes, tmp_path_factory):
    """(payload, per-rank results): one spawned group for the module."""
    rng = np.random.default_rng(1)
    pos = rng.uniform(0.0, BOX, (N, 3)).astype(np.float32)
    vel = rng.normal(size=(N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, N).astype(np.float32)
    pos, vel, mass = (np.asarray(a) for a in jex.pad_particles(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), n_dev=N_RANKS,
        factor=1.5))
    n_alloc = pos.shape[0]
    bricks = jex.adaptive_bounds_nd(jnp.asarray(pos), jnp.asarray(mass),
                                    (2, 2, 2), BOX)
    pos3, mass3 = _homed(pos, vel, mass, meshes["block"])
    pos2, mass2 = _homed(pos, vel, mass, meshes["pencil"])
    plan = jstp.sharded_treepm_plan_3d(n_alloc, BOX, NG, (2, 2, 2))
    p = dict(box=BOX, soft=SOFT, g=G, rs=RS, ng=NG, mig_pos=pos,
             mig_vel=vel, mig_mass=mass,
             bricks=[np.asarray(b) for b in bricks], cap_mig=CAP_MIG,
             cap_small=CAP_SMALL, pos3=pos3, mass3=mass3, nc3=plan["nc"],
             cap3=plan["capacity"], pos2=pos2, mass2=mass2, ng2=NG2,
             soft2=SOFT2)
    return p, run_ranks("block3d", N_RANKS, tmp_path_factory.mktemp("pg"),
                        p)


def joined(res, key):
    return np.concatenate([r[key] for r in res])


def test_rank_grid(ranks):
    """Ranks are row-major over (shx, shy, shz), JAX's device order; the
    default shapes are JAX make_mesh3d's and make_mesh2d's; axis_size of
    a tuple is the product; a shift along one axis of the (2, 4) grid
    receives from the rank at coordinate -+1 there (mod the axis)."""
    _, res = ranks
    assert [r["coords"] for r in res] == [
        (x, y, z) for x in range(2) for y in range(2) for z in range(2)]
    assert all(r["shape"] == {"shx": 2, "shy": 2, "shz": 2} for r in res)
    assert all(r["default3"] == (2, 2, 2) for r in res)
    assert all(r["grid2"] == {"shx": 2, "shy": 4} for r in res)
    assert all(r["axis_size"] == [4, 8, 2] for r in res)
    for rank, r in enumerate(res):
        x, y = divmod(rank, 4)
        assert r["grid2_from"] == [
            ((x - 1) % 2) * 4 + y, ((x + 1) % 2) * 4 + y,
            x * 4 + (y - 1) % 4, x * 4 + (y + 1) % 4]


@pytest.mark.parametrize("name", ["full", "emig", "emig_bounds",
                                  "emig_ovf"])
def test_migration_3d_row_for_row(ranks, meshes, name):
    p, res = ranks
    fn = jex.migrate_particles if name == "full" \
        else jex.migrate_particles_emigrant
    cap = {"full": p["mig_pos"].shape[0] // N_RANKS, "emig": CAP_MIG,
           "emig_bounds": CAP_MIG, "emig_ovf": CAP_SMALL}[name]
    kw = ({"bounds": tuple(jnp.asarray(b) for b in p["bricks"])}
          if name == "emig_bounds" else {})
    rp, rv, rm, ovf = fn(jnp.asarray(p["mig_pos"]),
                         jnp.asarray(p["mig_vel"]),
                         jnp.asarray(p["mig_mass"]), box_size=BOX,
                         capacity=cap, mesh=meshes["block"], axis_name=AX,
                         **kw)
    assert all(r[f"{name}_overflow"] == int(ovf) for r in res)
    assert (int(ovf) > 0) == name.endswith("ovf")
    for key, ref in (("pos", rp), ("vel", rv), ("mass", rm)):
        np.testing.assert_array_equal(joined(res, f"{name}_{key}"),
                                      np.asarray(ref))
    if int(ovf) == 0:
        got = joined(res, f"{name}_mass")
        assert np.sum(got > 0) == N


@pytest.mark.parametrize("name", ["halo", "halo_ovf"])
def test_halo_3d(ranks, meshes, name):
    p, res = ranks
    cap = p["cap3"] if name == "halo" else CAP_SMALL
    acc, ovf = jstp.halo_short_range_accelerations_3d(
        jnp.asarray(p["pos3"]), jnp.asarray(p["mass3"]), box_size=BOX,
        nc=p["nc3"], capacity=cap, rs=RS, softening=SOFT,
        mesh=meshes["block"])
    assert all(r[f"{name}_overflow"] == int(ovf) for r in res)
    assert (int(ovf) > 0) == (name == "halo_ovf")
    got = joined(res, name)
    assert max_rel(got, acc) <= 1e-5
    assert np.all(got[p["mass3"] == 0] == 0.0)


def test_full_treepm_3d(ranks, meshes):
    p, res = ranks
    acc, diag = jstp.sharded_treepm_accelerations(
        jnp.asarray(p["pos3"]), jnp.asarray(p["mass3"]), box_size=BOX,
        pm_grid=NG, softening=SOFT, g_const=G, mesh=meshes["block"],
        axis_name=AX, return_diagnostics=True)
    assert all(r["full3_overflow"] == int(diag["overflow"]) == 0
               for r in res)
    assert max_rel(joined(res, "full3"), acc) <= 1e-5


def test_pencil_ring_direct(ranks, meshes):
    """The ring over the flattened (2, 4, 1) order."""
    p, res = ranks
    ref = jsh.ring_direct_accelerations(
        jnp.asarray(p["pos2"]), jnp.asarray(p["mass2"]), box_size=BOX,
        softening=SOFT2, g_const=G, mesh=meshes["pencil"], axis_name=AX)
    got = joined(res, "pencil_ring")
    assert max_rel(got, ref) <= 1e-5
    assert np.all(got[p["mass2"] == 0] == 0.0)


def test_pencil_treepm(ranks, meshes):
    """The sharded TreePM on the z = 1 grid (its z shifts return their
    input)."""
    p, res = ranks
    acc, diag = jstp.sharded_treepm_accelerations(
        jnp.asarray(p["pos2"]), jnp.asarray(p["mass2"]), box_size=BOX,
        pm_grid=NG2, softening=SOFT2, g_const=G, mesh=meshes["pencil"],
        axis_name=AX, return_diagnostics=True)
    assert all(r["pencil_overflow"] == int(diag["overflow"]) == 0
               for r in res)
    assert max_rel(joined(res, "pencil_treepm"), acc) <= 1e-5
