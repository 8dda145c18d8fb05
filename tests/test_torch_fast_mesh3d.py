"""The port's block fast stepper (lambda_cdm_tpu_torch/parallel/
fast_mesh3d.py) and the engine's treepm_fast on {shx, shy, shz}, held
against the JAX package's parallel/fast_mesh3d and engine on the
conftest's virtual CPU devices: spawned gloo ranks
(tests/_torch_mesh_worker.py) in two groups started once for the module,
the (2, 2, 2) grid on 8 ranks and (1, 2, 2) on 4 (an axis of one rank:
its spills and halos are the rank's own planes), both at the plan's nc 6,
at tests/test_fast_mesh3d.py's geometry. The Poisson solve runs the
pencil FFT over the (shy, shz) tuple axis, whose first-major order the
forces check slot for slot. The cases and bars are
tests/_torch_fast_mesh_nd.py's.
"""

import numpy as np
import pytest

from _torch_fast_mesh_nd import (BOX, N, NG, check_accel, check_engine,
                                 check_initialize, check_overflow,
                                 check_plan_none, check_rebucket, check_run,
                                 run_groups)

from lambda_cdm_tpu.parallel import fast_mesh3d as jfm3
from lambda_cdm_tpu_torch.parallel import fast_mesh3d as tfm3

GROUPS = {(2, 2, 2): True, (1, 2, 2): False}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return run_groups(tmp_path_factory, GROUPS)


@pytest.mark.parametrize("args, kw", [
    ((N, BOX, NG, (2, 2, 2)), {}), ((N, BOX, NG, (1, 2, 2)), {}),
    ((100_000, 100.0, 96, (2, 2, 2)), {}),
    ((1_000_000, 100.0, 192, (1, 2, 2)), {}),
    ((N, BOX, NG, (2, 2, 2)), {"capacity": 300}),
    ((1000, 100.0, 50, (2, 2, 2)), {}),            # pm_grid % (dy dz)
    ((N, BOX, 16, (2, 2, 2)), {})])                # r_cut: None
def test_plan(args, kw):
    got = tfm3.mesh_fast_plan3d(*args, **kw)
    assert got == jfm3.mesh_fast_plan3d(*args, **kw)
    assert (got is None) == (args[2] in (50, 16))


@pytest.mark.parametrize("nc, dims", [(8, (2, 2, 2)), (6, (1, 2, 2)),
                                      (24, (1, 2, 2)), (12, (2, 3, 4))])
def test_cell_order(nc, dims):
    p = tfm3.cell_order3d(nc, *dims).numpy()
    q = tfm3.cell_order3d_inv(nc, *dims).numpy()
    np.testing.assert_array_equal(p, np.asarray(jfm3.cell_order3d(nc,
                                                                  *dims)))
    np.testing.assert_array_equal(q, np.asarray(jfm3.cell_order3d_inv(
        nc, *dims)))
    assert np.array_equal(p[q], np.arange(nc ** 3))


@pytest.mark.parametrize("dims", list(GROUPS))
@pytest.mark.parametrize("name", ["accel", "dead", "dropping", "seam"])
def test_mesh_fast_accel3d(groups, dims, name):
    """The sharded forces on JAX's global block-major buckets ("seam":
    the first cell plane of each axis moved -0.3 PM cells and wrapped)."""
    check_accel(groups[dims], name)


@pytest.mark.parametrize("dims", list(GROUPS))
@pytest.mark.parametrize("name", ["rebucket", "rebucket_default",
                                  "rebucket_small"])
def test_mesh_rebucket3d(groups, dims, name):
    """The JAX test's drift (+0.9 cells along every axis: corner movers
    hop in x, y and z) at 4096 emigrant rows (lossless), at the default
    and at 16 rows: every slot and the lost count are JAX's."""
    check_rebucket(groups[dims], name)


@pytest.mark.parametrize("dims", list(GROUPS))
def test_initialize_mesh_fast3d(groups, dims):
    check_initialize(groups[dims])


@pytest.mark.parametrize("dims", list(GROUPS))
def test_mesh_fast_run3d(groups, dims):
    """8 steps, a rebucket every 4, by id against JAX's run."""
    check_run(groups[dims])


@pytest.mark.parametrize("dims", list(GROUPS))
def test_overflowing_rebucket_raises_with_the_state(groups, dims):
    """JAX test_fast_mesh3d.py's blob: raised before any step with the
    intact state, regrown losslessly into JAX's slots."""
    check_overflow(groups[dims])


def test_engine_blocks_match_jax(groups):
    """compute.mesh {shx: 2, shy: 2, shz: 2} with treepm_fast on 8 ranks
    takes the block stepper and tracks the JAX engine's on 8 devices."""
    check_engine(groups[(2, 2, 2)], (False, True))


def test_engine_plan_none_takes_the_stateless_treepm(groups):
    check_plan_none(groups[(2, 2, 2)])
