"""The treepm_fast stepper's options in the PyTorch port against the JAX
package: the short-range `variant` (vpu, vpu2, mxu) and `pm_only` through
initialize_fast + fast_run with re-bucketing inside the run (compared by
persistent id), and the `spectral` and `interp` PM gradients of
pm_accelerations_bucketed against the JAX package's XLA path
(use_pallas=False)."""

import numpy as np
import pytest

from _torch_parity import max_rel, nn, tt

import jax.numpy as jnp

import lambda_cdm_tpu.ops.bucketed_pm as jbp
import lambda_cdm_tpu.ops.fast_treepm as jft
from lambda_cdm_tpu.core.config import SimulationConfig as JConfig
from lambda_cdm_tpu.physics.cosmology import CosmologyParams as JParams
from lambda_cdm_tpu.physics.initial_conditions import generate_state
import lambda_cdm_tpu_torch.ops.bucketed_pm as tbp
import lambda_cdm_tpu_torch.ops.fast_treepm as tft
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams as TParams

BOX, NG, N_SIDE = 37.5, 24, 12
DT, N_STEPS, REBUCKET = 2e-5, 8, 3     # 2 rebuckets inside the run


@pytest.fixture(scope="module")
def ics():
    cfg = JConfig()
    cfg.particles.num_particles = N_SIDE ** 3
    cfg.particles.box_size = BOX
    ic = cfg.particles.initial_conditions
    ic.type, ic.grid_size, ic.random_seed = "2lpt", N_SIDE, 21
    cfg.cosmology.initial_redshift = 9.0
    st = generate_state(cfg)
    return (np.asarray(st.positions), np.asarray(st.velocities),
            np.asarray(st.masses), float(st.scale_factor))


def _by_id(fs, n):
    ids = nn(fs.ids).reshape(-1)
    live = ids >= 0
    assert np.array_equal(np.sort(ids[live]), np.arange(n))
    out = {}
    for name in ("bpos", "bvel"):
        arr = np.zeros((n, 3))
        arr[ids[live]] = nn(getattr(fs, name)).reshape(3, -1).T[live]
        out[name] = arr
    return out


def _runs(ics, option):
    """Both packages' initialize_fast -> fast_run for one option; the port
    runs from the JAX initialize_fast dict."""
    pos, vel, m, a0 = ics
    kw = dict(box_size=BOX, pm_grid=NG, softening=0.05, kick_mode="comoving",
              pm_only=option == "pm_only")
    jfs, jkw = jft.initialize_fast(pos, vel, m, a0, **kw)
    tfs, tkw = tft.initialize_fast(tt(pos), tt(vel), tt(m), a0, **kw)
    assert tkw == jkw
    if option != "pm_only":
        jkw = dict(jkw, variant=option)
    jfs = jft.fast_run(jfs, JParams(), DT, n_steps=N_STEPS,
                       rebucket_every=REBUCKET, **jkw)
    tfs = tft.fast_run(tfs, TParams(), DT, n_steps=N_STEPS,
                       rebucket_every=REBUCKET, **jkw)
    return jfs, tfs


@pytest.mark.parametrize("option", ["vpu", "vpu2", "mxu", "pm_only"])
def test_fast_run_option_matches(ics, option):
    """8 KDK steps and 2 rebuckets on a 12^3 2LPT start at z=9 (plan 3^3
    cells of capacity 128). The JAX package's CPU path evaluates its
    x-space split polynomial for every variant (the vpu/mxu function), so
    vpu2's fit differs from it by ~5e-5 of a pair weight. Bounds as
    tests/test_torch_fast_treepm.py: positions 1e-5 of the box,
    velocities 1e-3 of the largest, counters equal."""
    jfs, tfs = _runs(ics, option)
    n = N_SIDE ** 3
    j, t = _by_id(jfs, n), _by_id(tfs, n)
    d = (t["bpos"] - j["bpos"] + BOX / 2) % BOX - BOX / 2
    assert np.abs(d).max() < 1e-5 * BOX
    vscale = np.abs(j["bvel"]).max()
    assert np.abs(t["bvel"] - j["bvel"]).max() / vscale < 1e-3
    assert int(tfs.step) == int(jfs.step) == N_STEPS
    assert int(tfs.overflow) == int(jfs.overflow) == 0
    assert int(tfs.dropped) == int(jfs.dropped)
    np.testing.assert_array_equal(nn(tfs.bmass).sum(), np.asarray(
        jfs.bmass).sum())


@pytest.fixture(scope="module")
def bucketed():
    """1200 uniform particles in a 24 Mpc/h box on 4^3 cells of capacity
    64 (live-first), with a tenth of the slots pushed 2.5 PM cells along x
    so that some leave their block window (dropped)."""
    box, ncell, cap = 24.0, 4, 64
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.0, box, (1200, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, 1200).astype(np.float32)
    plan = {"ncell": ncell, "capacity": cap, "margin": 1, "rs": 1.0}
    fs = jft.build_fast_state(jnp.asarray(pos), jnp.zeros((1200, 3)),
                              jnp.asarray(m), 1.0, box_size=box, plan=plan)
    assert int(fs.overflow) == 0
    bpos = np.asarray(fs.bpos).copy()
    bmass = np.asarray(fs.bmass)
    push = (rng.random(bmass.shape) < 0.1) & (bmass > 0)
    bpos[0] += np.where(push, np.float32(2.5 * box / 32), 0.0) \
        .astype(np.float32)
    return dict(bpos=bpos, bmass=bmass, box=box, ncell=ncell, ng=32)


@pytest.mark.parametrize("split", [0.0, 1.2])
@pytest.mark.parametrize("gradient", ["spectral", "interp"])
def test_pm_gradients_match(bucketed, gradient, split):
    """The port's plain gathers against the JAX package's XLA einsums on
    live slots inside their block window (the JAX interp gradient leaves
    the z component of a dropped slot nonzero; the port zeroes every
    component there), with the split and unsplit (pm_fast) Green's
    function; the drop counts are equal."""
    b = bucketed
    kw = dict(ncell=b["ncell"], ng=b["ng"], box_size=b["box"], g_const=2.0,
              split_scale=split, gradient=gradient)
    ref, jdrop = jbp.pm_accelerations_bucketed(
        jnp.asarray(b["bpos"]), jnp.asarray(b["bmass"]), use_pallas=False,
        **kw)
    got, tdrop = tbp.pm_accelerations_bucketed(tt(b["bpos"]),
                                               tt(b["bmass"]), **kw)
    assert int(tdrop) == int(jdrop) > 0
    ok = nn(tbp._cic_corners(tt(b["bpos"]), ncell=b["ncell"], ng=b["ng"],
                             box_size=b["box"], margin=1)[2])
    inside = (b["bmass"] > 0) & ok
    assert max_rel(got, ref, inside[None]) < 1e-5
    assert np.all(nn(got)[:, ~inside] == 0.0)


def test_pm_gradients_agree(bucketed):
    """The three gradients of one potential: fd4 against spectral at the
    JAX package's bar (tests/test_fast_treepm.py: 5% of the max; measured
    2.9e-3); interp's derivative of the CIC weights is constant inside a
    PM cell (measured 0.18 of the max against spectral at rs = 1.6 PM
    cells, 0.09 at 4)."""
    b = bucketed
    kw = dict(ncell=b["ncell"], ng=b["ng"], box_size=b["box"],
              split_scale=1.2)
    acc = {g: nn(tbp.pm_accelerations_bucketed(
        tt(b["bpos"]), tt(b["bmass"]), gradient=g, **kw)[0])
        for g in tbp.GRADIENTS}
    assert max_rel(acc["spectral"], acc["fd4"]) < 0.05
    assert max_rel(acc["spectral"], acc["interp"]) < 0.25
    with pytest.raises(ValueError, match="gradient"):
        tbp.pm_accelerations_bucketed(tt(b["bpos"]), tt(b["bmass"]),
                                      gradient="fd2", **kw)
