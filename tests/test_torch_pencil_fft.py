"""The port's pencil FFT (lambda_cdm_tpu_torch/parallel/fft.py:
pencil_rfftn, pencil_irfftn, pencil_poisson_solve) and the rank mesh's
axis collectives (Mesh.all_to_all along an axis or a tuple of axes,
Mesh.axis_index), held against the JAX package's on the conftest's 8
virtual CPU devices: 8 spawned gloo ranks (tests/_torch_mesh_worker.py),
started once for the module, on tests/test_pencil_fft.py's (2, 4) mesh
and 32^3 grid from one numpy seed.

Bars: tests/test_pencil_fft.py's, the port against JAX on the same
input: the forward transform 2e-3 (of values ~180), the round trip 1e-5,
Poisson 1e-5 of the largest |phi|; the inverse of a non-Hermitian
spectrum 1e-5 of the largest value; the collectives and indices
exactly.
"""

import numpy as np
import pytest

from _torch_mesh_worker import start_ranks

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from lambda_cdm_tpu.parallel import fft as jfft
from lambda_cdm_tpu.parallel.mesh import make_mesh2d, make_mesh3d

NG, BOX, DIMS = 32, 50.0, (2, 4)
GRIDS3 = {"g222": (2, 2, 2), "g241": (2, 4, 1)}
# one axis, the (shy, shz) tuple the block stepper's pencil solve uses,
# the other tuples, the whole grid; shz of g241 is an axis of one rank
A2A_AXES = ("shx", "shy", "shz", ("shy", "shz"), ("shx", "shy"),
            ("shx", "shz"), ("shx", "shy", "shz"))
AXES3 = ("shx", "shy", "shz")


def _payload():
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(NG, NG, NG)).astype(np.float32)
    rho = grid - grid.mean()
    zp = -(-(NG // 2 + 1) // DIMS[1]) * DIMS[1]
    spectrum = (rng.normal(size=(NG, NG, zp))
                + 1j * rng.normal(size=(NG, NG, zp))).astype(np.complex64)
    a2a = rng.normal(size=(8, 8, 5)).astype(np.float32)
    return {"dims": DIMS, "ng": NG, "box": BOX, "grid": grid, "rho": rho,
            "spectrum": spectrum, "grids3": GRIDS3, "a2a_axes": A2A_AXES,
            "a2a": a2a}


def _key(axis):
    return "_".join(axis) if isinstance(axis, tuple) else axis


def _jax_collectives(p):
    """JAX's untiled all_to_all over dim 0 and axis_index on each 3D grid
    and axis: {name: [8 devices, ...]} in the flattened device order."""
    out = {}
    for name, dims in p["grids3"].items():
        mesh = make_mesh3d(dims)
        for axis in p["a2a_axes"]:
            names = axis if isinstance(axis, tuple) else (axis,)
            n = int(np.prod([mesh.shape[a] for a in names]))

            def local(x, axis=axis):
                y = jax.lax.all_to_all(x[0], axis, 0, 0)
                return y[None], jax.lax.axis_index(axis)[None]

            fn = jax.jit(jax.shard_map(local, mesh=mesh,
                                       in_specs=P(AXES3),
                                       out_specs=(P(AXES3), P(AXES3))))
            y, idx = fn(jnp.asarray(p["a2a"][:, :n]))
            out[f"{name}_a2a_{_key(axis)}"] = np.asarray(y)
            out[f"{name}_index_{_key(axis)}"] = np.asarray(idx)
    return out


@pytest.fixture(scope="module")
def pencils(tmp_path_factory):
    """(payload, JAX's results, each rank's results)."""
    p = _payload()
    finish = start_ranks("pencil_fft", 8, tmp_path_factory.mktemp("pfft"), p)
    mesh = make_mesh2d(DIMS)
    spec = NamedSharding(mesh, P("shx", "shy", None))
    grid = jax.device_put(jnp.asarray(p["grid"]), spec)
    rho = jax.device_put(jnp.asarray(p["rho"]), spec)
    gk = jfft.pencil_rfftn(grid, mesh=mesh)
    ref = {"rfftn": np.asarray(gk),
           "roundtrip": np.asarray(jfft.pencil_irfftn(gk, ng=NG, mesh=mesh)),
           "poisson": np.asarray(jfft.pencil_poisson_solve(
               rho, ng=NG, box_size=BOX, mesh=mesh)),
           "poisson_split": np.asarray(jfft.pencil_poisson_solve(
               rho, ng=NG, box_size=BOX, mesh=mesh, split_scale=2.0)),
           "irfftn_nonherm": np.asarray(jfft.pencil_irfftn(
               jax.device_put(jnp.asarray(p["spectrum"]),
                              NamedSharding(mesh, P(None, "shx", "shy"))),
               ng=NG, mesh=mesh)),
           "numpy_rfftn": np.fft.rfftn(p["grid"].astype(np.float64))}
    ref.update(_jax_collectives(p))
    return p, ref, finish()


def _spectrum_block(res, key):
    """The global [ng, ng, zp] half spectrum from each rank's block (ky by
    its shx coordinate, kz by its shy one)."""
    dx, dy = DIMS
    blk = res[0][key].shape
    out = np.zeros((NG, dx * blk[1], dy * blk[2]), res[0][key].dtype)
    for r in res:
        ix, iy = r["coords"]
        out[:, ix * blk[1]:(ix + 1) * blk[1],
            iy * blk[2]:(iy + 1) * blk[2]] = r[key]
    return out


def _pencils(res, key):
    """The global [ng, ng, ng] grid from each rank's z-pencil."""
    dx, dy = DIMS
    xl, yl = NG // dx, NG // dy
    out = np.zeros((NG, NG, NG), np.float32)
    for r in res:
        ix, iy = r["coords"]
        out[ix * xl:(ix + 1) * xl, iy * yl:(iy + 1) * yl] = r[key]
    return out


def test_forward_matches_jax_and_rfftn(pencils):
    p, ref, res = pencils
    got = _spectrum_block(res, "rfftn")
    assert got.shape == ref["rfftn"].shape
    np.testing.assert_allclose(got, ref["rfftn"], atol=2e-3)
    nzr = NG // 2 + 1
    np.testing.assert_allclose(got[:, :, :nzr], ref["numpy_rfftn"],
                               atol=2e-3)
    assert np.all(got[:, :, nzr:] == 0)


def test_roundtrip(pencils):
    p, ref, res = pencils
    got = _pencils(res, "roundtrip")
    np.testing.assert_allclose(got, p["grid"], atol=1e-5)
    np.testing.assert_allclose(got, ref["roundtrip"], atol=1e-5)


def test_sharding_layout(pencils):
    """A rank's block [ng, ng / dx, zp / dy]: kx whole, ky split over
    shx, kz over shy, padded to zp = ceil((ng / 2 + 1) / dy) dy."""
    _, _, res = pencils
    zp = -(-(NG // 2 + 1) // DIMS[1]) * DIMS[1]
    for r in res:
        assert r["rfftn"].shape == (NG, NG // DIMS[0], zp // DIMS[1])
        assert r["roundtrip"].shape == (NG // DIMS[0], NG // DIMS[1], NG)


@pytest.mark.parametrize("key", ["poisson", "poisson_split"])
def test_poisson_matches_jax(pencils, key):
    _, ref, res = pencils
    got = _pencils(res, key)
    scale = np.abs(ref[key]).max()
    np.testing.assert_allclose(got, ref[key], atol=1e-5 * scale)


def test_inverse_of_a_non_hermitian_spectrum(pencils):
    """A spectrum with arbitrary imaginary parts on the kz = 0 and Nyquist
    bins (as a gradient's i k makes them): the last 1D irfft reads their
    real parts, as JAX's does."""
    _, ref, res = pencils
    got = _pencils(res, "irfftn_nonherm")
    scale = np.abs(ref["irfftn_nonherm"]).max()
    np.testing.assert_allclose(got, ref["irfftn_nonherm"], atol=1e-5 * scale)


@pytest.mark.parametrize("grid", list(GRIDS3))
@pytest.mark.parametrize("axis", A2A_AXES, ids=_key)
def test_axis_collectives_match_jax(pencils, grid, axis):
    """all_to_all along one axis, a tuple of axes (first-major, the
    (shy, shz) order of the block stepper's pencil solve) and an axis of
    one rank (shz of (2, 4, 1): the input itself), and axis_index, each
    rank's equal to JAX's device at the same coordinates."""
    _, ref, res = pencils
    key = _key(axis)
    for r, rank_res in enumerate(res):
        np.testing.assert_array_equal(rank_res[f"{grid}_a2a_{key}"],
                                      ref[f"{grid}_a2a_{key}"][r])
        assert rank_res[f"{grid}_index_{key}"] == \
            ref[f"{grid}_index_{key}"][r]
