"""The port's random streams (lambda_cdm_tpu_torch.utils.prng) against
jax.random, and every draw site switched to them against the JAX
package's: generate_state for each IC kind, random_state and the light
cone's tile shifts, from the same seeds and keys."""

import numpy as np
import pytest
import torch

from _torch_parity import max_rel, nn, tt

import jax
import jax.numpy as jnp

import lambda_cdm_tpu as jlc
import lambda_cdm_tpu.physics.initial_conditions as jic
from lambda_cdm_tpu.core.config import SimulationConfig as JConfig
from lambda_cdm_tpu.physics.cosmology import CosmologyParams as JParams
from lambda_cdm_tpu.raytracing import lensing as jl
import lambda_cdm_tpu_torch as tlc
import lambda_cdm_tpu_torch.physics.initial_conditions as tic
from lambda_cdm_tpu_torch.core.config import SimulationConfig as TConfig
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams as TParams
from lambda_cdm_tpu_torch.raytracing import lensing as tl
from lambda_cdm_tpu_torch.utils import prng

# jax.random.normal's erf_inv takes XLA's float32 log1p, the port a
# log1p rounded once from float64: measured <= 3 ulp over 1M draws
NORMAL_ULP = 4


def _bits(x) -> np.ndarray:
    return np.asarray(nn(x), np.float32).view(np.int32).astype(np.int64)


def _ulp(got, ref) -> int:
    """The largest distance in units in the last place (same signs)."""
    g, r = _bits(got), _bits(ref)
    assert np.array_equal(g < 0, r < 0)
    return int(np.abs(g - r).max())


@pytest.mark.parametrize("seed", [0, 3, 7, 2026, 12345, -1, 2 ** 33 + 5])
def test_prng_key(seed):
    key = prng.PRNGKey(seed)
    assert key.dtype == torch.uint32 and prng.is_key(key)
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 2026])
def test_split(seed, num):
    got = prng.split(prng.PRNGKey(seed), num)
    ref = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    assert got.shape == (num, 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    # a JAX key handed over as numpy is a key too
    np.testing.assert_array_equal(
        prng.split(np.asarray(jax.random.PRNGKey(seed)), num).numpy(), ref)


@pytest.mark.parametrize("data", [0, 1, 5, 12345, 2 ** 32 - 1])
def test_fold_in(data):
    key = jax.random.PRNGKey(8)
    np.testing.assert_array_equal(
        prng.fold_in(prng.PRNGKey(8), data).numpy(),
        np.asarray(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("shape,lo,hi", [
    ((1,), 0.0, 1.0), ((7,), 0.0, 1.0), ((1001, 3), 0.0, 100.0),
    ((33,), 3.7, 11.3), ((4, 5, 6), -2.5, 1e-3), ((3,), 0.0, 200.0)])
def test_uniform_bit_equal(shape, lo, hi):
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
    got = prng.uniform(prng.PRNGKey(11), shape, lo, hi, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape", [(1 << 18,), (48, 48, 48), (1001, 3)])
def test_normal_within_ulps(shape):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(2026), shape))
    got = prng.normal(prng.PRNGKey(2026), shape, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _ulp(got, ref) <= NORMAL_ULP


@pytest.mark.parametrize("draw", ["random_bits", "uniform", "normal"])
def test_draws_default_to_the_card(draw):
    """A draw with no device names the card: on a host without one it
    raises instead of drawing on the CPU; with device="cpu" it draws
    there."""
    fn = getattr(prng, draw)
    key = prng.PRNGKey(3)
    assert fn(key, (5,), device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert fn(key, (5,)).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            fn(key, (5,))


def test_erf_inv_edges():
    """+-1 give +-inf; zero gives zero; odd in x."""
    x = torch.tensor([-1.0, 1.0, 0.0, 0.25, -0.25], dtype=torch.float32)
    out = prng.erf_inv(x)
    assert out[0] == -np.inf and out[1] == np.inf and out[2] == 0.0
    assert out[3] == -out[4]
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(nn(x[2:]))))
    assert _ulp(out[2:], ref) <= NORMAL_ULP


def _configs(kind, n, grid):
    """Both packages' configs for one IC kind (the IC block set on the
    objects: both loaders drop a native particles.initial_conditions
    block)."""
    d = {"particles": {"num_particles": n, "box_size": 64.0},
         "cosmology": {"initial_redshift": 9.0}}
    out = []
    for cls in (JConfig, TConfig):
        cfg = cls.from_dict(d)
        ic = cfg.particles.initial_conditions
        ic.type, ic.grid_size, ic.random_seed = kind, grid, 4
        out.append(cfg)
    return tuple(out)


@pytest.mark.parametrize("kind,n,grid", [
    ("zeldovich", 16 ** 3, 16), ("2lpt", 16 ** 3, 32), ("2lpt", 32 ** 3, 32),
    ("uniform_random", 20 ** 3, 8), ("glass", 12 ** 3, 8)])
def test_generate_state_matches_jax(kind, n, grid):
    """The same config gives the JAX package's particles: positions within
    1e-5 of the box (wrap-aware) and velocities within 1e-4 of their
    largest value (float32 FFTs and direct sums reordered); the uniform
    load bit for bit."""
    jc, tc = _configs(kind, n, grid)
    js = jic.generate_state(jc)
    ts = tic.generate_state(tc, device="cpu")
    box = 64.0
    np.testing.assert_array_equal(nn(ts.masses), np.asarray(js.masses))
    if kind == "uniform_random":
        np.testing.assert_array_equal(_bits(ts.positions),
                                      _bits(js.positions))
    d = nn(ts.positions) - np.asarray(js.positions)
    d = (d + box / 2) % box - box / 2
    assert np.abs(d).max() < 1e-5 * box
    if kind in ("zeldovich", "2lpt"):
        assert max_rel(ts.velocities, js.velocities) < 1e-4
    else:
        assert bool(torch.all(ts.velocities == 0))


def test_random_state_matches_jax():
    ref = jlc.random_state(jax.random.PRNGKey(5), 777, 50.0,
                           velocity_scale=3.0, mass=2.0, scale_factor=0.25)
    got = tlc.random_state(prng.PRNGKey(5), 777, 50.0, velocity_scale=3.0,
                           mass=2.0, scale_factor=0.25, device="cpu")
    np.testing.assert_array_equal(_bits(got.positions),
                                  _bits(ref.positions))
    assert _ulp(got.velocities, ref.velocities) <= NORMAL_ULP
    np.testing.assert_array_equal(nn(got.masses), np.asarray(ref.masses))
    assert float(got.scale_factor) == float(ref.scale_factor)


def test_build_lightcone_shifts_match_jax():
    """With a key, each tile's shift is the JAX package's
    uniform(fold_in(key, tile), (3,), 0, box): the randomised planes agree
    at the unrandomised bar of test_torch_lensing (1e-5 of the largest
    value), and differ from the unrandomised ones."""
    rng = np.random.default_rng(13)
    pos = rng.uniform(0, 200.0, (4096, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, 4096).astype(np.float32)
    zs = (0.0, 0.3, 0.7)
    kw = dict(ng=32, z_source=0.8, planes_per_box=4)
    pj, _, _, _ = jl.build_lightcone(
        [(jnp.asarray(pos), jnp.asarray(m), 1.0 / (1.0 + z)) for z in zs],
        JParams(), 200.0, randomize_key=jax.random.PRNGKey(8), **kw)
    snaps_t = [(tt(pos), tt(m), 1.0 / (1.0 + z)) for z in zs]
    pt, _, _, _ = tl.build_lightcone(snaps_t, TParams(), 200.0,
                                     randomize_key=prng.PRNGKey(8), **kw)
    plain, _, _, _ = tl.build_lightcone(snaps_t, TParams(), 200.0, **kw)
    assert pt.shape == pj.shape
    assert max_rel(pt, pj) <= 1e-5
    assert not torch.allclose(pt, plain)
    for tile in (0, 1, 2):
        np.testing.assert_array_equal(
            _bits(prng.uniform(prng.fold_in(prng.PRNGKey(8), tile), (3,),
                               0.0, 200.0, device="cpu")),
            _bits(jax.random.uniform(
                jax.random.fold_in(jax.random.PRNGKey(8), tile), (3,),
                maxval=200.0)))
