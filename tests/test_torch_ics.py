"""Initial conditions of the PyTorch port against the JAX package: the same
white noise (drawn with jax.random in the test and handed over as numpy)
through delta_k, the first- and second-order displacements and the 2LPT
particle load, plus the config-driven generator."""

import numpy as np
import pytest
import torch

from _torch_parity import max_rel, nn, tt

import jax
import jax.numpy as jnp

import lambda_cdm_tpu.physics.initial_conditions as jic
from lambda_cdm_tpu.core.config import SimulationConfig as JConfig
from lambda_cdm_tpu.physics.cosmology import CosmologyParams as JParams
import lambda_cdm_tpu_torch.physics.initial_conditions as tic
from lambda_cdm_tpu_torch.core.config import SimulationConfig as TConfig
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams as TParams

NG = 16
BOX = 64.0

# float32 FFTs in two libraries (XLA's and PyTorch's) round in another
# order: measured <= 1.3e-6 of the largest mode, displacement or velocity
# (the fixed-amplitude draw divides by |delta_k|, the largest case)
FFT_TOL = 5e-6


def _noise(seed, ng=NG):
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.normal(key, (ng,) * 3, jnp.float32))


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("transfer", ["eisenstein_hu", "bbks"])
def test_gaussian_delta_k(transfer, fixed):
    key, white = _noise(3)
    ref = jic.gaussian_delta_k(key, NG, BOX, JParams(), transfer, fixed)
    got = tic.gaussian_delta_k(white, NG, BOX, TParams(), transfer, fixed)
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    assert max_rel(got.real, ref.real) < FFT_TOL
    assert max_rel(got.imag, ref.imag) < FFT_TOL


def test_gaussian_delta_k_from_generator():
    """A torch.Generator draw is reproducible by seed."""
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = tic.gaussian_delta_k(g1, NG, BOX, TParams())
    b = tic.gaussian_delta_k(g2, NG, BOX, TParams())
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="white noise"):
        tic.gaussian_delta_k(np.zeros((NG, NG, NG - 1)), NG, BOX,
                             TParams())


def test_first_and_second_order_displacements():
    key, _ = _noise(7)
    dk = jic.gaussian_delta_k(key, NG, BOX, JParams())
    dk_t = torch.as_tensor(np.array(dk))
    psi1 = tic.displacement_from_delta(dk_t, NG, BOX)
    assert max_rel(psi1, jic.displacement_from_delta(dk, NG, BOX)) < FFT_TOL
    psi2 = tic.second_order_displacement(dk_t, NG, BOX)
    assert max_rel(psi2, jic.second_order_displacement(dk, NG, BOX)) \
        < FFT_TOL


def test_lattice_and_sampling():
    np.testing.assert_array_equal(nn(tic.lattice_positions(4, BOX)),
                                  np.asarray(jic.lattice_positions(4, BOX)))
    field = np.random.default_rng(0).normal(size=(3, 8, 8, 8)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        nn(tic._sample_field_at_lattice(tt(field), 4, 8)),
        np.asarray(jic._sample_field_at_lattice(jnp.asarray(field), 4, 8)))
    with pytest.raises(ValueError, match="multiple"):
        tic._sample_field_at_lattice(tt(field), 3, 8)


@pytest.mark.parametrize("kick_mode", ["reference", "comoving"])
def test_ic_velocity_prefactor(kick_mode):
    for a in (0.02, 0.1, 0.5):
        ref = jic.ic_velocity_prefactor(JParams(), jnp.float32(a), 100.0,
                                        kick_mode)
        got = tic.ic_velocity_prefactor(TParams(), a, 100.0, kick_mode)
        np.testing.assert_allclose(float(got), float(ref), rtol=2e-6)


@pytest.mark.parametrize("use_2lpt", [False, True])
@pytest.mark.parametrize("ng,n_side", [(16, 16), (32, 16)])
def test_lpt_displacements(ng, n_side, use_2lpt):
    """Positions to 1e-6 of the box (measured 6e-8: displacements differ
    at FFT round-off, the lattice is exact); velocities to FFT_TOL."""
    key, white = _noise(11, ng)
    kw = dict(ng=ng, n_side=n_side, box_size=BOX, a_init=0.1,
              use_2lpt=use_2lpt, kick_mode="comoving")
    jpos, jvel = jic.lpt_displacements(key, JParams(), **kw)
    tpos, tvel = tic.lpt_displacements(white, TParams(), **kw)
    d = nn(tpos) - np.asarray(jpos)
    d = (d + BOX / 2) % BOX - BOX / 2           # a wrap may differ
    assert np.abs(d).max() < 1e-6 * BOX
    assert max_rel(tvel, jvel) < FFT_TOL


def _configs(kind, n=512):
    """Both packages' configs for one IC kind. The IC block is set on the
    objects: both loaders drop a native particles.initial_conditions
    block (they read only the reference layout's generator block)."""
    d = {"particles": {"num_particles": n, "box_size": BOX},
         "cosmology": {"initial_redshift": 9.0}}
    out = []
    for cls in (JConfig, TConfig):
        cfg = cls.from_dict(d)
        ic = cfg.particles.initial_conditions
        ic.type, ic.grid_size, ic.random_seed = kind, 8, 4
        out.append(cfg)
    return tuple(out)


def test_generate_state_grid_matches():
    jc, tc = _configs("grid")
    js = jic.generate_state(jc)
    ts = tic.generate_state(tc, device="cpu")
    np.testing.assert_array_equal(nn(ts.positions), np.asarray(js.positions))
    np.testing.assert_array_equal(nn(ts.masses), np.asarray(js.masses))
    assert float(ts.scale_factor) == float(js.scale_factor)
    assert ts.scale_factor.dtype == torch.float32
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0


@pytest.mark.parametrize("kind", ["2lpt", "zeldovich", "random"])
def test_generate_state_kinds(kind):
    """The port's generator draws from the JAX package's keys
    (utils/prng; particle parity in tests/test_torch_prng.py): same
    masses, scale factor and shapes as the JAX package, positions in the
    box, reproducible by seed; the 2LPT load moves the lattice about as
    much."""
    jc, tc = _configs(kind)
    js = jic.generate_state(jc)
    ts = tic.generate_state(tc, device="cpu")
    again = tic.generate_state(tc, device="cpu")
    assert torch.equal(ts.positions, again.positions)
    assert ts.positions.shape == (512, 3) and ts.positions.dtype \
        == torch.float32
    assert bool(torch.all((ts.positions >= 0) & (ts.positions < BOX)))
    np.testing.assert_array_equal(nn(ts.masses), np.asarray(js.masses))
    assert float(ts.scale_factor) == float(js.scale_factor)
    if kind != "random":
        q = nn(tic.lattice_positions(8, BOX))
        disp = lambda p: np.sqrt(np.mean(((p - q + BOX / 2) % BOX  # noqa
                                          - BOX / 2) ** 2))
        rt, rj = disp(nn(ts.positions)), disp(np.asarray(js.positions))
        assert 0.5 < rt / rj < 2.0


def test_generate_state_refuses():
    """Non-cubic LPT loads and unknown kinds raise; glass, refused before
    the direct solver was ported, now generates: a relaxed load in the
    box, reproducible by seed, with the JAX package's masses and scale
    factor (the relaxation itself is held against the JAX package in
    tests/test_torch_solvers.py)."""
    jc, tc = _configs("glass", n=216)
    ts = tic.generate_state(tc, device="cpu")
    js = jic.generate_state(jc)
    assert torch.equal(ts.positions,
                       tic.generate_state(tc, device="cpu").positions)
    assert ts.positions.shape == (216, 3)
    assert bool(torch.all((ts.positions >= 0) & (ts.positions < BOX)))
    assert bool(torch.all(ts.velocities == 0))
    np.testing.assert_array_equal(nn(ts.masses), np.asarray(js.masses))
    assert float(ts.scale_factor) == float(js.scale_factor)
    _, tc = _configs("2lpt", n=500)
    with pytest.raises(ValueError, match="cubic"):
        tic.generate_state(tc, device="cpu")
    _, tc = _configs("bogus")
    with pytest.raises(ValueError, match="unknown"):
        tic.generate_state(tc, device="cpu")
