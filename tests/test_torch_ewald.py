"""The port's float64 Ewald and min-image oracles
(lambda_cdm_tpu_torch.forces.ewald) against the JAX package's, run with
jax_enable_x64 switched on around each call as tests/test_ewald.py runs
them, and the oracle's own alpha-independence check on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambda_cdm_tpu.forces import ewald as jew
from lambda_cdm_tpu_torch.forces import ewald as tew

BOX = 10.0
# both oracles are float64; they sum in other orders (the structure
# factor's chunks, the k-space and shell sums)
REL = 1e-10


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _random_set(n=48, seed=0, zero_mass=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    mass = rng.uniform(0.5, 2.0, (n,))
    mass[n - zero_mass:] = 0.0
    return pos, mass


def _rel(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("kw", [
    dict(softening=0.05, nmax=8, nreal=0, source_chunk=16, target_chunk=16),
    dict(softening=0.05, alpha=3.0 / BOX, nmax=6, nreal=1, source_chunk=7,
         target_chunk=5),
    dict(softening=0.0, nmax=4, nreal=0, g_const=43.007, source_chunk=64,
         target_chunk=64)])
def test_ewald_matches_jax(x64, kw):
    pos, mass = _random_set(n=48, seed=1, zero_mass=4)
    tgt = np.array([0, 3, 7, 11, 20, 44, 46, 47])
    ref = jew.ewald_accelerations(jnp.asarray(pos), jnp.asarray(mass),
                                  jnp.asarray(tgt), BOX, **kw)
    assert ref.dtype == jnp.float64
    got = tew.ewald_accelerations(torch.from_numpy(pos),
                                  torch.from_numpy(mass),
                                  torch.from_numpy(tgt), BOX, **kw)
    assert got.dtype == torch.float64 and got.shape == (8, 3)
    assert _rel(got, ref) < REL


@pytest.mark.parametrize("softening", [0.0, 0.05])
def test_min_image_matches_jax(x64, softening):
    pos, mass = _random_set(n=40, seed=2, zero_mass=3)
    tgt = np.arange(0, 40, 3)
    ref = jew.min_image_accelerations(jnp.asarray(pos), jnp.asarray(mass),
                                      jnp.asarray(tgt), BOX,
                                      softening=softening, g_const=2.0)
    got = tew.min_image_accelerations(torch.from_numpy(pos),
                                      torch.from_numpy(mass),
                                      torch.from_numpy(tgt), BOX,
                                      softening=softening, g_const=2.0)
    assert got.dtype == torch.float64
    assert _rel(got, ref) < REL


def test_alpha_independence():
    """tests/test_ewald.py::test_alpha_independence on the port: the
    real/k split moves weight between the sums, so agreement at two alphas
    (real-space shells sized for the smaller) pins the 4 pi / L^3
    coefficient."""
    pos, mass = _random_set()
    pos, mass = torch.from_numpy(pos), torch.from_numpy(mass)
    tgt = torch.arange(pos.shape[0])
    a1 = tew.ewald_accelerations(pos, mass, tgt, BOX, softening=0.05,
                                 alpha=3.0 / BOX, nreal=1, nmax=8,
                                 source_chunk=16, target_chunk=16)
    a2 = tew.ewald_accelerations(pos, mass, tgt, BOX, softening=0.05,
                                 alpha=6.0 / BOX, nreal=0, nmax=8,
                                 source_chunk=16, target_chunk=16)
    scale = float(torch.sqrt(torch.mean(torch.sum(a1 * a1, dim=-1))))
    dev = float(torch.max(torch.linalg.norm(a1 - a2, dim=-1))) / scale
    assert dev < 3e-5, f"alpha split disagreement {dev:.2e}"


def test_half_box_symmetry_point():
    """A target half a box from a lone source: zero periodic force, the
    min-image force G m / (L/2)^2 (tests/test_ewald.py's check)."""
    pos = torch.tensor([[0.0, 0.0, 0.0], [BOX / 2, 0.0, 0.0]],
                       dtype=torch.float64)
    mass = torch.tensor([1.0, 0.0], dtype=torch.float64)
    tgt = torch.tensor([1])
    a_ew = tew.ewald_accelerations(pos, mass, tgt, BOX, nmax=8)
    a_mi = tew.min_image_accelerations(pos, mass, tgt, BOX)
    mi_mag = float(torch.linalg.norm(a_mi))
    assert mi_mag > 0.03
    assert float(torch.linalg.norm(a_ew)) < 1e-3 * mi_mag
