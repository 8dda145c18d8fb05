"""The treepm_fast slice at stepper level: JAX 2LPT initial conditions run
through the JAX package's initialize_fast + fast_run and through the
port's, with re-bucketing inside the run, compared particle by particle
(sorted by persistent id)."""

import numpy as np
import pytest
import torch

from _torch_parity import nn, tt

import lambda_cdm_tpu.ops.fast_treepm as jft
from lambda_cdm_tpu.core.config import SimulationConfig as JConfig
from lambda_cdm_tpu.physics.cosmology import CosmologyParams as JParams
from lambda_cdm_tpu.physics.initial_conditions import generate_state
import lambda_cdm_tpu_torch.ops.fast_treepm as tft
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams as TParams

BOX, NG, N_SIDE = 50.0, 32, 16
DT, N_STEPS, REBUCKET = 2e-5, 8, 3     # a from 0.1 to ~0.13; 2 rebuckets


@pytest.fixture(scope="module")
def runs():
    cfg = JConfig()
    cfg.particles.num_particles = N_SIDE ** 3
    cfg.particles.box_size = BOX
    ic = cfg.particles.initial_conditions
    ic.type, ic.grid_size, ic.random_seed = "2lpt", N_SIDE, 21
    cfg.cosmology.initial_redshift = 9.0
    st = generate_state(cfg)
    pos, vel, m = (np.asarray(st.positions), np.asarray(st.velocities),
                   np.asarray(st.masses))
    a0 = float(st.scale_factor)
    kw = dict(box_size=BOX, pm_grid=NG, softening=0.05, kick_mode="comoving")

    jfs, jkw = jft.initialize_fast(pos, vel, m, a0, **kw)
    tfs, tkw = tft.initialize_fast(tt(pos), tt(vel), tt(m), a0, **kw)
    out = {"init": (jfs, tfs)}
    jfs = jft.fast_run(jfs, JParams(), DT, n_steps=N_STEPS,
                       rebucket_every=REBUCKET, **jkw)
    tfs = tft.fast_run(tfs, TParams(), DT, n_steps=N_STEPS,
                       rebucket_every=REBUCKET, **tkw)
    out["run"] = (jfs, tfs)
    out["kw"] = (jkw, tkw)
    out["n"] = pos.shape[0]
    return out


def _by_id(fs, n):
    """Flat per-particle arrays in id order (ids -1 are padding)."""
    ids = nn(fs.ids).reshape(-1)
    live = ids >= 0
    assert np.array_equal(np.sort(ids[live]), np.arange(n))
    out = {}
    for name in ("bpos", "bvel", "acc"):
        x = nn(getattr(fs, name)).reshape(3, -1).T
        arr = np.zeros((n, 3), np.float64)
        arr[ids[live]] = x[live]
        out[name] = arr
    mass = np.zeros(n)
    mass[ids[live]] = nn(fs.bmass).reshape(-1)[live]
    out["mass"] = mass
    return out


def test_plans_agree(runs):
    jkw, tkw = runs["kw"]
    # every key of the JAX dict, pm_only, variant and n_rows included
    assert jkw == tkw
    assert (tkw["ncell"], tkw["capacity"], tkw["variant"]) == (4, 128,
                                                               "vpu3")
    assert tkw["n_rows"] == runs["n"] and tkw["pm_only"] is False


def test_initial_accelerations(runs):
    """The x-space erfc polynomial of the JAX CPU path against vpu3's even
    one, plus the PM route: measured 3.8e-4 of the largest acceleration."""
    jfs, tfs = runs["init"]
    n = runs["n"]
    j, t = _by_id(jfs, n), _by_id(tfs, n)
    scale = np.abs(j["acc"]).max()
    assert np.abs(t["acc"] - j["acc"]).max() / scale < 1e-3
    assert np.array_equal(nn(tfs.ids), np.asarray(jfs.ids))


def test_run_matches(runs):
    """After 8 KDK steps and 2 rebuckets, measured: positions 6.9e-7 of
    the box, velocities 1.3e-4 of the largest, kinetic energy 1.7e-4,
    scale factor identical. Bounds: 1e-5 of the box, 1e-3 and 1e-3 (the
    force difference above), counters equal."""
    jfs, tfs = runs["run"]
    n = runs["n"]
    j, t = _by_id(jfs, n), _by_id(tfs, n)
    d = (t["bpos"] - j["bpos"] + BOX / 2) % BOX - BOX / 2
    assert np.abs(d).max() < 1e-5 * BOX
    vscale = np.abs(j["bvel"]).max()
    assert np.abs(t["bvel"] - j["bvel"]).max() / vscale < 1e-3
    ke_j = float(np.sum(j["mass"][:, None] * j["bvel"] ** 2))
    ke_t = float(np.sum(t["mass"][:, None] * t["bvel"] ** 2))
    assert ke_t == pytest.approx(ke_j, rel=1e-3)
    np.testing.assert_array_equal(t["mass"], j["mass"])
    assert float(tfs.scale_factor) == pytest.approx(
        float(jfs.scale_factor), rel=1e-6)
    assert float(tfs.time) == pytest.approx(float(jfs.time), rel=1e-6)
    assert int(tfs.step) == int(jfs.step) == N_STEPS
    assert int(tfs.overflow) == int(jfs.overflow)
    assert int(tfs.dropped) == int(jfs.dropped)
    assert tfs.scale_factor.dtype == torch.float32
    assert tfs.step.dtype == torch.int32


def test_overflow_raises_with_intact_state():
    """on_overflow="raise": a rebucket that would drop particles raises
    and carries the pre-rebucket state and the steps done, as in JAX."""
    n, box = 400, 30.0
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.0, box, (n, 3)).astype(np.float32)
    vel = ((box / 2 - pos) * 0.118).astype(np.float32)
    m = np.full(n, 1e-6, np.float32)
    kw = dict(box_size=box, pm_grid=24, softening=1.0, g_const=1e-8,
              kick_mode="newtonian", cosmological=False)
    out = []
    for mod, params, arr in ((jft, JParams(), np.asarray),
                             (tft, TParams(), tt)):
        fs, fkw = mod.initialize_fast(arr(pos), arr(vel), arr(m), 1.0, **kw)
        with pytest.raises(mod.BucketOverflowError) as exc:
            mod.fast_run(fs, params, 1.0, n_steps=16, rebucket_every=4,
                         on_overflow="raise", **fkw)
        out.append(exc.value)
    jexc, texc = out
    assert texc.steps_done == jexc.steps_done > 0
    assert int(texc.fstate.step) == int(jexc.fstate.step)
    assert int(texc.fstate.overflow) == int(jexc.fstate.overflow) == 0
