"""K10's plain version (ops/alias_probe.py) against the TPU alias probe of
benchmarks/probe_alias.py, built here as the same pallas_call and run in
interpret mode (the script itself runs on the device when imported, so its
kernel body is copied below). pltpu.InterpretParams() interprets the grid
in order with the alias live (Gauss-Seidel: 1..8 in column 0), plain
interpret=True reads a snapshot of the input (all ones): the port's
sequential mode and its snapshot must give the same buffers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lambda_cdm_tpu_torch.ops import alias_probe as tprobe


def _kern(x_hbm, o_ref):
    i = pl.program_id(0)

    def body(buf, sem):
        src = jnp.where(i > 0, i - 1, 0)
        cp = pltpu.make_async_copy(x_hbm.at[pl.ds(src, 1)], buf, sem)
        cp.start()
        cp.wait()
        buf[...] = buf[...] + 1.0
        wb = pltpu.make_async_copy(buf, o_ref.at[pl.ds(i, 1)], sem)
        wb.start()
        wb.wait()

    pl.run_scoped(body, buf=pltpu.VMEM((1, 128), jnp.float32),
                  sem=pltpu.SemaphoreType.DMA)


def _tpu_probe(x, interpret):
    return np.asarray(pl.pallas_call(
        _kern, grid=(x.shape[0],),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        input_output_aliases={0: 0},
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",)),
        interpret=interpret)(jnp.asarray(x)))


@pytest.mark.parametrize("start", ["zeros", "random"])
def test_sequential_matches_ordered_interpreter(start):
    x = np.zeros((8, 128), np.float32) if start == "zeros" else \
        np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    ref = _tpu_probe(x, pltpu.InterpretParams())
    got = tprobe.alias_probe(torch.tensor(x), "sequential")
    np.testing.assert_array_equal(got.numpy(), ref)
    if start == "zeros":
        np.testing.assert_array_equal(ref[:, 0], np.arange(1, 9))


@pytest.mark.parametrize("start", ["zeros", "random"])
def test_snapshot_matches_plain_interpreter(start):
    x = np.zeros((8, 128), np.float32) if start == "zeros" else \
        np.random.default_rng(1).standard_normal((8, 128)).astype(np.float32)
    ref = _tpu_probe(x, True)
    got = tprobe.alias_probe(torch.tensor(x), "blocks")
    np.testing.assert_array_equal(got.numpy(), ref)
    if start == "zeros":
        np.testing.assert_array_equal(ref[:, 0], np.ones(8))


def test_in_place_and_checks():
    x = torch.zeros((8, 128))
    assert tprobe.alias_probe(x, "sequential") is x
    with pytest.raises(ValueError):
        tprobe.alias_probe(x, "diagonal")
    with pytest.raises(ValueError):
        tprobe.alias_probe(torch.zeros((8, 128), dtype=torch.float64))


def test_entry_point(capsys):
    assert tprobe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["cpu blocks: [1. 1. 1. 1. 1. 1. 1. 1.]",
                   "cpu sequential: [1. 2. 3. 4. 5. 6. 7. 8.]"]


@pytest.mark.parametrize("shape", [(8, 128), (5, 300), (1, 7)])
def test_sequential_register_chain(shape):
    """The card's sequential kernel carries row 0 of a column in a
    register and writes v + 1, (v + 1) + 1, ... to rows 0, 1, ...: those
    float32 additions, emulated in numpy, equal the plain version bit for
    bit (and, at the probe's shape, the TPU kernel run in order)."""
    x = np.random.default_rng(shape[1]).standard_normal(shape).astype(
        np.float32) * np.float32(1e3)
    v = x[0].copy()
    chain = np.empty_like(x)
    for i in range(shape[0]):
        v = v + np.float32(1.0)
        chain[i] = v
    got = tprobe.alias_probe(torch.tensor(x), "sequential")
    np.testing.assert_array_equal(got.numpy(), chain)
    if shape == (8, 128):
        np.testing.assert_array_equal(chain,
                                      _tpu_probe(x, pltpu.InterpretParams()))


def test_launch_floor_needs_the_card():
    """The floor kernel is timed on the card only: a CPU buffer raises."""
    with pytest.raises(ValueError, match="cuda"):
        tprobe.launch_floor(8, 128, torch.zeros(8 * 128))
