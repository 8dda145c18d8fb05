"""The port's native host runtime (lambda_cdm_tpu_torch/native) against
the JAX package's: the source is the same file byte for byte, each case
of tests/test_native.py runs on the port's bindings (registry order and
cycles, the arena, the .lcdm codec with corruption detection, the async
writer), and a .lcdm file written by either package reads in the other
bit for bit."""

import filecmp
import os

import numpy as np
import pytest
import torch

from lambda_cdm_tpu import native as jnative
import lambda_cdm_tpu_torch.native as native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_source_is_the_jax_copy():
    assert filecmp.cmp(os.path.join(ROOT, "lambda_cdm_tpu_torch", "native",
                                    "lcdm_runtime.cpp"),
                       os.path.join(ROOT, "lambda_cdm_tpu", "native",
                                    "lcdm_runtime.cpp"), shallow=False)


def test_builds_into_the_port():
    assert native.native_available(), native.build_error()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "lambda_cdm_tpu_torch",
                                                 "_build")


class TestRegistry:
    def test_topological_order(self):
        reg = native.ComponentRegistry()
        for name in ("engine", "forces", "cosmology", "integrator"):
            reg.add(name)
        reg.add_dependency("engine", "forces")
        reg.add_dependency("engine", "integrator")
        reg.add_dependency("forces", "cosmology")
        reg.add_dependency("integrator", "cosmology")
        order = reg.initialization_order()
        assert order.index("cosmology") < order.index("forces")
        assert order.index("forces") < order.index("engine")
        assert order.index("integrator") < order.index("engine")

    def test_cycle_detection(self):
        reg = native.ComponentRegistry()
        reg.add("a")
        reg.add("b")
        reg.add_dependency("a", "b")
        assert not reg.has_cycle()
        reg.add_dependency("b", "a")
        assert reg.has_cycle()
        with pytest.raises(ValueError):
            reg.initialization_order()

    def test_unknown_dependency_raises(self):
        reg = native.ComponentRegistry()
        reg.add("a")
        with pytest.raises(KeyError):
            reg.add_dependency("a", "ghost")

    def test_duplicate_add_is_idempotent(self):
        reg = native.ComponentRegistry()
        assert reg.add("x") == reg.add("x")


class TestArena:
    def test_alloc_and_stats(self):
        arena = native.HostArena(1 << 20)
        p1 = arena.alloc(1000)
        p2 = arena.alloc(1000)
        assert p2 != p1
        assert arena.used >= 2000
        assert arena.peak >= arena.used
        assert arena.alloc_count == 2
        arena.reset()
        assert arena.used == 0
        assert arena.peak >= 2000   # peak survives reset

    def test_alignment(self):
        arena = native.HostArena(1 << 16)
        p = arena.alloc(10, align=256)
        assert p % 256 == 0

    def test_exhaustion(self):
        arena = native.HostArena(1024)
        with pytest.raises(MemoryError):
            arena.alloc(4096)


def _data(n=1000):
    rng = np.random.RandomState(0)
    return (rng.rand(n, 3).astype(np.float32),
            rng.rand(n, 3).astype(np.float32),
            rng.rand(n).astype(np.float32))


class TestSnapshotCodec:
    def test_roundtrip_bit_exact(self, tmp_path):
        pos, vel, mass = _data()
        path = str(tmp_path / "snap.lcdm")
        native.write_snapshot_native(path, pos, vel, mass, 0.5, 1.25, 42)
        p2, v2, m2, a, t, s = native.read_snapshot_native(path)
        np.testing.assert_array_equal(p2, pos)
        np.testing.assert_array_equal(v2, vel)
        np.testing.assert_array_equal(m2, mass)
        assert (a, t, s) == (0.5, 1.25, 42)

    def test_tensors_roundtrip(self, tmp_path):
        """Tensors (copied to the host by the binding) write the same
        bytes as their numpy arrays."""
        pos, vel, mass = _data()
        pa, pb = str(tmp_path / "a.lcdm"), str(tmp_path / "b.lcdm")
        native.write_snapshot_native(pa, pos, vel, mass, 0.5, 1.25, 42)
        native.write_snapshot_native(pb, torch.from_numpy(pos),
                                     torch.from_numpy(vel),
                                     torch.from_numpy(mass), 0.5, 1.25, 42)
        assert filecmp.cmp(pa, pb, shallow=False)

    def test_corruption_detected(self, tmp_path):
        pos, vel, mass = _data()
        path = str(tmp_path / "corrupt.lcdm")
        native.write_snapshot_native(path, pos, vel, mass, 0.5, 0.0, 1)
        raw = bytearray(open(path, "rb").read())
        raw[200] ^= 0xFF   # flip a payload byte
        open(path, "wb").write(bytes(raw))
        with pytest.raises(OSError, match="checksum"):
            native.read_snapshot_native(path)

    def test_bad_file_rejected(self, tmp_path):
        path = str(tmp_path / "junk.lcdm")
        open(path, "wb").write(b"not a snapshot")
        with pytest.raises(OSError):
            native.read_snapshot_native(path)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_cross_package(self, tmp_path, writer):
        """A .lcdm written by one package reads in the other bit for bit,
        and the two packages write the same bytes."""
        pos, vel, mass = _data(777)
        args = (pos, vel, mass, 0.125, 3.5, 17)
        mine, theirs = (native, jnative) if writer == "port" \
            else (jnative, native)
        path = str(tmp_path / f"{writer}.lcdm")
        mine.write_snapshot_native(path, *args)
        p2, v2, m2, a, t, s = theirs.read_snapshot_native(path)
        np.testing.assert_array_equal(p2, pos)
        np.testing.assert_array_equal(v2, vel)
        np.testing.assert_array_equal(m2, mass)
        assert (a, t, s) == (0.125, 3.5, 17)
        other = str(tmp_path / "other.lcdm")
        theirs.write_snapshot_native(other, *args)
        assert filecmp.cmp(path, other, shallow=False)


class TestAsyncWriter:
    def test_writes_complete(self, tmp_path):
        pos, vel, mass = (np.zeros((100, 3), np.float32),
                          np.zeros((100, 3), np.float32),
                          np.ones(100, np.float32))
        writer = native.AsyncSnapshotWriter()
        paths = [str(tmp_path / f"s{i}.lcdm") for i in range(12)]
        for i, p in enumerate(paths):
            writer.submit(p, pos, vel, mass, 0.1 * i, 0.0, i)
        writer.wait()
        assert writer.errors == 0
        assert writer.pending == 0
        writer.close()
        for i, p in enumerate(paths):
            _, _, m2, a, _, s = native.read_snapshot_native(p)
            assert s == i
            np.testing.assert_array_equal(m2, mass)
