"""The port's pencil fast stepper (lambda_cdm_tpu_torch/parallel/
fast_mesh2d.py) and the engine's treepm_fast on {shx, shy}, held against
the JAX package's parallel/fast_mesh2d and engine on the conftest's
virtual CPU devices: spawned gloo ranks (tests/_torch_mesh_worker.py) in
two groups started once for the module, the (2, 4) grid on 8 ranks (the
plan's nc 4: one cell row a rank along y) and (2, 2) on 4 (nc 6, 3 x 3
rods), at tests/test_fast_mesh2d.py's geometry. The cases and bars are
tests/_torch_fast_mesh_nd.py's.
"""

import numpy as np
import pytest

from _torch_fast_mesh_nd import (BOX, N, NG, check_accel, check_engine,
                                 check_initialize, check_overflow,
                                 check_plan_none, check_rebucket, check_run,
                                 run_groups)

from lambda_cdm_tpu.parallel import fast_mesh2d as jfm2
from lambda_cdm_tpu_torch.parallel import fast_mesh2d as tfm2

# {mesh shape: run the engines there}
GROUPS = {(2, 4): True, (2, 2): False}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return run_groups(tmp_path_factory, GROUPS)


@pytest.mark.parametrize("args, kw", [
    ((N, BOX, NG, (2, 4)), {}), ((N, BOX, NG, (2, 2)), {}),
    ((N, BOX, 64, (2, 4)), {}), ((100_000, 100.0, 96, (2, 4)), {}),
    ((1_000_000, 100.0, 192, (2, 2)), {}),
    ((N, BOX, NG, (2, 2)), {"capacity": 200}),
    ((N, BOX, 50, (2, 4)), {}),                    # pm_grid % dy: None
    ((N, BOX, 16, (2, 2)), {})])                   # r_cut: None
def test_plan(args, kw):
    got = tfm2.mesh_fast_plan2d(*args, **kw)
    assert got == jfm2.mesh_fast_plan2d(*args, **kw)
    assert (got is None) == (args[2] in (50, 16))


@pytest.mark.parametrize("nc, dx, dy", [(8, 2, 4), (6, 2, 2), (24, 2, 2),
                                        (4, 1, 4)])
def test_cell_order(nc, dx, dy):
    """Block-major ids: the JAX package's permutation and its inverse."""
    p = tfm2.cell_order2d(nc, dx, dy).numpy()
    q = tfm2.cell_order2d_inv(nc, dx, dy).numpy()
    np.testing.assert_array_equal(p, np.asarray(jfm2.cell_order2d(nc, dx,
                                                                  dy)))
    np.testing.assert_array_equal(q, np.asarray(jfm2.cell_order2d_inv(
        nc, dx, dy)))
    assert np.array_equal(p[q], np.arange(nc ** 3))


@pytest.mark.parametrize("dims", list(GROUPS))
@pytest.mark.parametrize("name", ["accel", "dead", "dropping", "seam"])
def test_mesh_fast_accel2d(groups, dims, name):
    """The sharded forces on JAX's global block-major buckets. "seam":
    the first cell plane of x and of y moved -0.3 PM cells, wrapped as
    the stepper wraps positions: the port's periodic window keeps their
    deposit, and its forces are JAX's on the same slots unwrapped."""
    check_accel(groups[dims], name)


@pytest.mark.parametrize("dims", list(GROUPS))
@pytest.mark.parametrize("name", ["rebucket", "rebucket_default",
                                  "rebucket_small"])
def test_mesh_rebucket2d(groups, dims, name):
    """The JAX test's drift (+0.9 cells along every axis: diagonal movers
    hop in x, then y) at an emigrant capacity of 2048 rows (lossless,
    every row in its cell's bucket), at the default and at 16 rows
    (lossy): every slot and the lost count are JAX's."""
    check_rebucket(groups[dims], name)


@pytest.mark.parametrize("dims", list(GROUPS))
def test_initialize_mesh_fast2d(groups, dims):
    """The plan dict, the rank's block-major slots of the global
    bucketing (ids exactly) and the primed accelerations."""
    check_initialize(groups[dims])


@pytest.mark.parametrize("dims", list(GROUPS))
def test_mesh_fast_run2d(groups, dims):
    """8 steps, a rebucket every 4, by id against JAX's run."""
    check_run(groups[dims])


@pytest.mark.parametrize("dims", list(GROUPS))
def test_overflowing_rebucket_raises_with_the_state(groups, dims):
    check_overflow(groups[dims])


def test_engine_pencils_match_jax(groups):
    """compute.mesh {shx: 2, shy: 4} with treepm_fast on 8 ranks takes the
    pencil stepper and tracks the JAX engine's on 8 devices."""
    check_engine(groups[(2, 4)], (True, False))


def test_engine_plan_none_takes_the_stateless_treepm(groups):
    check_plan_none(groups[(2, 4)])
