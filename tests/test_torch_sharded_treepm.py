"""The port's sharded TreePM on the 1D slab mesh
(lambda_cdm_tpu_torch/parallel/sharded_treepm.py and
exchange.exchange_ghosts) held against the JAX package's: 8 spawned gloo
ranks (one group for the module, tests/_torch_mesh_worker.py) against the
conftest's 8 virtual CPU devices, at tests/test_sharded_treepm.py's
geometry (2048 particles in a 100 box, PM 64, padded by 1.5 and homed on
their slabs by the JAX migration) from one numpy seed. Each rank returns
its rows; the tests join them in rank order.

Bars: the plans, the ghost buffers and every overflow count exactly; the
halo pass, the ring and the full sharded TreePM 1e-5 of the largest |a|
(float32 pair sums in another order); zero-mass rows get no force.
"""

import numpy as np
import pytest

from _torch_mesh_worker import run_ranks
from _torch_parity import max_rel

import jax.numpy as jnp

from lambda_cdm_tpu.parallel import exchange as jex, \
    sharded_treepm as jstp
from lambda_cdm_tpu.parallel.mesh import make_mesh
from lambda_cdm_tpu_torch.parallel import sharded_treepm as tstp

N_RANKS = 8
N, BOX, NG, SOFT, G = 2048, 100.0, 64, 0.1, 43.0
RS = 1.25 * BOX / NG
CAP_SMALL = 8
GHOSTS = {"ghosts": (3.0, 128), "ghosts_ovf": (6.0, 16)}
FB_N, FB_NG, FB_SOFT = 512, 32, 0.5        # nc_max 5 < 8: the ring


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(N_RANKS)


@pytest.fixture(scope="module")
def ranks(jmesh, tmp_path_factory):
    """(payload, per-rank results): the homed cloud, one spawned group."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, BOX, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, N).astype(np.float32)
    pos, vel, mass = jex.pad_particles(jnp.asarray(pos), jnp.zeros((N, 3)),
                                       jnp.asarray(mass), n_dev=N_RANKS,
                                       factor=1.5)
    n_loc = pos.shape[0] // N_RANKS
    pos, _, mass, ovf = jex.migrate_particles(pos, vel, mass, box_size=BOX,
                                              capacity=n_loc, mesh=jmesh)
    assert int(ovf) == 0
    pos, mass = np.asarray(pos), np.asarray(mass)
    plan = jstp.sharded_treepm_plan(pos.shape[0], BOX, NG, N_RANKS)
    mass_dead = mass.copy()
    mass_dead[::4] = 0.0
    p = dict(box=BOX, soft=SOFT, g=G, rs=RS, ng=NG, pos=pos, mass=mass,
             mass_dead=mass_dead, nc=plan["nc"], cap=plan["capacity"],
             cap_small=CAP_SMALL, ghosts=GHOSTS,
             fb_pos=rng.uniform(0.0, BOX, (FB_N, 3)).astype(np.float32),
             fb_mass=np.ones(FB_N, np.float32), fb_ng=FB_NG,
             fb_soft=FB_SOFT)
    return p, run_ranks("treepm", N_RANKS, tmp_path_factory.mktemp("pg"), p)


def joined(res, key):
    return np.concatenate([r[key] for r in res])


@pytest.mark.parametrize("args, kw", [
    ((4096, 100.0, 64, 8), {}),
    ((3072, 100.0, 64, 8), {"capacity": 20}),
    ((3072, 100.0, 64, 4), {"split_factor": 1.0, "cut_factor": 3.0,
                             "occupancy_headroom": 2.0}),
    ((512, 10.0, 16, 8), {}),                     # too small: None
    ((512, 100.0, 32, 8), {})])                   # the fallback geometry
def test_plan(args, kw):
    assert tstp.sharded_treepm_plan(*args, **kw) == \
        jstp.sharded_treepm_plan(*args, **kw)


@pytest.mark.parametrize("args", [
    (4096, 100.0, 64, (2, 2, 2)), (4096, 100.0, 64, (4, 2, 1)),
    (3072, 100.0, 32, (2, 4, 1)), (512, 10.0, 16, (2, 2, 2))])
def test_plan_3d(args):
    got = tstp.sharded_treepm_plan_3d(*args)
    assert got == jstp.sharded_treepm_plan_3d(*args)
    assert (got is None) == (args[1] == 10.0)


@pytest.mark.parametrize("name", sorted(GHOSTS))
def test_exchange_ghosts(ranks, jmesh, name):
    """The ghost buffers row for row and the overflow (16 rows a face of
    width 6 overflow)."""
    p, res = ranks
    width, cap = GHOSTS[name]
    gp, gm, ovf = jex.exchange_ghosts(
        jnp.asarray(p["pos"]), jnp.asarray(p["mass"]), box_size=BOX,
        ghost_width=width, capacity=cap, mesh=jmesh)
    assert all(r[f"{name}_overflow"] == int(ovf) for r in res)
    assert (int(ovf) > 0) == name.endswith("ovf")
    np.testing.assert_array_equal(joined(res, f"{name}_pos"), np.asarray(gp))
    np.testing.assert_array_equal(joined(res, f"{name}_mass"),
                                  np.asarray(gm))


@pytest.mark.parametrize("name", ["halo", "halo_ovf", "halo_dead"])
def test_halo_short_range(ranks, jmesh, name):
    """The halo pass against JAX's (the same rows overflow at a capacity of
    8); zero-mass rows get no force."""
    p, res = ranks
    cap = CAP_SMALL if name == "halo_ovf" else p["cap"]
    mass = p["mass_dead"] if name == "halo_dead" else p["mass"]
    acc, ovf = jstp.halo_short_range_accelerations(
        jnp.asarray(p["pos"]), jnp.asarray(mass), box_size=BOX, nc=p["nc"],
        capacity=cap, rs=RS, softening=SOFT, mesh=jmesh)
    assert all(r[f"{name}_overflow"] == int(ovf) for r in res)
    assert (int(ovf) > 0) == (name == "halo_ovf")
    got = joined(res, name)
    assert max_rel(got, acc) <= 1e-5
    assert np.all(got[mass == 0] == 0.0)
    assert np.all(np.isfinite(got))


def test_ring_short_range(ranks, jmesh):
    p, res = ranks
    ref = jstp.ring_short_range_accelerations(
        jnp.asarray(p["pos"]), jnp.asarray(p["mass"]), box_size=BOX, rs=RS,
        softening=SOFT, mesh=jmesh)
    got = joined(res, "ring")
    assert max_rel(got, ref) <= 1e-5
    assert np.all(got[p["mass"] == 0] == 0.0)


@pytest.mark.parametrize("name", ["full", "fallback"])
def test_sharded_treepm_accelerations(ranks, jmesh, name):
    """The full sharded TreePM against JAX's: the halo geometry, and the
    ring-fallback one (plan None)."""
    p, res = ranks
    if name == "full":
        pos, mass, soft, ng = p["pos"], p["mass"], SOFT, NG
    else:
        pos, mass, soft, ng = p["fb_pos"], p["fb_mass"], FB_SOFT, FB_NG
    acc, diag = jstp.sharded_treepm_accelerations(
        jnp.asarray(pos), jnp.asarray(mass), box_size=BOX, pm_grid=ng,
        softening=soft, g_const=G, mesh=jmesh, return_diagnostics=True)
    assert all(r[f"{name}_plan"] == diag["plan"] for r in res)
    assert (diag["plan"] is None) == (name == "fallback")
    assert all(r[f"{name}_overflow"] == int(diag["overflow"]) == 0
               for r in res)
    assert max_rel(joined(res, name), acc) <= 1e-5
