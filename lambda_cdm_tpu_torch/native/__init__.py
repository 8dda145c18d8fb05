"""ctypes bindings for the native C++ host runtime (counterpart of
lambda_cdm_tpu/native/__init__.py): the component registry's dependency
order, a host bump arena, the checksummed `.lcdm` snapshot codec and the
background snapshot writer.

`lcdm_runtime.cpp` here is the JAX package's source byte for byte (a CPU
test compares the two files), so a `.lcdm` file written by either package
reads in the other. It builds at first use with one `g++` into the
git-ignored lambda_cdm_tpu_torch/_build/, under a name keyed by a hash of
the source and flags (as ops/cuda_build builds the CUDA kernels), and is
bound with ctypes. Nothing builds at import.

This is host I/O, not a device kernel. The snapshot functions take
tensors (on any device: card tensors are copied to the host here) or
numpy arrays. As in the JAX package, every class and function raises
RuntimeError when the library cannot be built (no compiler).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "lcdm_runtime.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-fvisibility=hidden"]

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"liblcdm_runtime_{h.hexdigest()[:16]}.so")


def _build(out: str) -> str | None:
    """Compile the library to `out` (through a per-process temporary, so
    concurrent builders never load a half-written file); an error string
    or None."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++"] + GXX_FLAGS + ["-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"g++ unavailable: {exc}"
    if proc.returncode != 0:
        return f"g++ failed: {proc.stderr[-2000:]}"
    os.replace(tmp, out)
    return None


def load_library():
    """The loaded native library (built on first use), or None."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        path = library_path()
        if not os.path.exists(path):
            _build_error = _build(path)
            if _build_error:
                return None
        lib = ctypes.CDLL(path)
        _configure(lib)
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


def build_error() -> str | None:
    load_library()
    return _build_error


def _require():
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {build_error()}")
    return lib


def _configure(lib) -> None:
    c = ctypes
    lib.lcdm_registry_create.restype = c.c_void_p
    lib.lcdm_registry_destroy.argtypes = [c.c_void_p]
    lib.lcdm_registry_add.argtypes = [c.c_void_p, c.c_char_p]
    lib.lcdm_registry_add.restype = c.c_int
    lib.lcdm_registry_count.argtypes = [c.c_void_p]
    lib.lcdm_registry_count.restype = c.c_int
    lib.lcdm_registry_add_dependency.argtypes = [c.c_void_p, c.c_char_p,
                                                 c.c_char_p]
    lib.lcdm_registry_add_dependency.restype = c.c_int
    lib.lcdm_registry_topo_sort.argtypes = [c.c_void_p,
                                            c.POINTER(c.c_int), c.c_int]
    lib.lcdm_registry_topo_sort.restype = c.c_int
    lib.lcdm_registry_has_cycle.argtypes = [c.c_void_p]
    lib.lcdm_registry_has_cycle.restype = c.c_int
    lib.lcdm_registry_name.argtypes = [c.c_void_p, c.c_int]
    lib.lcdm_registry_name.restype = c.c_char_p

    lib.lcdm_pool_create.argtypes = [c.c_size_t]
    lib.lcdm_pool_create.restype = c.c_void_p
    lib.lcdm_pool_destroy.argtypes = [c.c_void_p]
    lib.lcdm_pool_alloc.argtypes = [c.c_void_p, c.c_size_t, c.c_size_t]
    lib.lcdm_pool_alloc.restype = c.c_void_p
    lib.lcdm_pool_reset.argtypes = [c.c_void_p]
    for fn in ("lcdm_pool_used", "lcdm_pool_capacity", "lcdm_pool_peak",
               "lcdm_pool_alloc_count"):
        getattr(lib, fn).argtypes = [c.c_void_p]
        getattr(lib, fn).restype = c.c_size_t

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.lcdm_snapshot_write.argtypes = [
        c.c_char_p, c.c_int64, f32p, f32p, f32p, c.c_double, c.c_double,
        c.c_int64]
    lib.lcdm_snapshot_write.restype = c.c_int
    lib.lcdm_snapshot_read_n.argtypes = [c.c_char_p]
    lib.lcdm_snapshot_read_n.restype = c.c_int64
    lib.lcdm_snapshot_read.argtypes = [
        c.c_char_p, c.c_int64, f32p, f32p, f32p,
        c.POINTER(c.c_double), c.POINTER(c.c_double), c.POINTER(c.c_int64)]
    lib.lcdm_snapshot_read.restype = c.c_int

    lib.lcdm_writer_create.restype = c.c_void_p
    lib.lcdm_writer_submit.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64, f32p, f32p, f32p,
        c.c_double, c.c_double, c.c_int64]
    lib.lcdm_writer_submit.restype = c.c_int
    lib.lcdm_writer_pending.argtypes = [c.c_void_p]
    lib.lcdm_writer_pending.restype = c.c_int
    lib.lcdm_writer_errors.argtypes = [c.c_void_p]
    lib.lcdm_writer_errors.restype = c.c_int
    lib.lcdm_writer_wait.argtypes = [c.c_void_p]
    lib.lcdm_writer_destroy.argtypes = [c.c_void_p]
    lib.lcdm_runtime_version.restype = c.c_char_p


def _host_f32(x, shape_tail: tuple) -> np.ndarray:
    """A C-contiguous float32 host array of a tensor (copied from its
    device) or an array-like."""
    if hasattr(x, "detach"):
        x = x.detach().to("cpu").numpy()
    out = np.ascontiguousarray(x, np.float32)
    if out.shape[1:] != shape_tail:
        want = ", ".join(["N", *map(str, shape_tail)])
        raise ValueError(f"expected [{want}] rows, got shape {out.shape}")
    return out


def _particles(positions, velocities, masses):
    pos = _host_f32(positions, (3,))
    vel = _host_f32(velocities, (3,))
    mass = _host_f32(masses, ())
    if not pos.shape[0] == vel.shape[0] == mass.shape[0]:
        raise ValueError(f"row counts differ: {pos.shape[0]}, "
                         f"{vel.shape[0]}, {mass.shape[0]}")
    return pos, vel, mass


# ---------------------------------------------------------------------------
# High-level wrappers
# ---------------------------------------------------------------------------

class ComponentRegistry:
    """Dependency-resolving registry: Kahn topological order and cycle
    detection in the native library."""

    def __init__(self):
        self._lib = _require()
        self._h = self._lib.lcdm_registry_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lcdm_registry_destroy(self._h)
            self._h = None

    def add(self, name: str) -> int:
        return self._lib.lcdm_registry_add(self._h, name.encode())

    def add_dependency(self, name: str, depends_on: str) -> None:
        rc = self._lib.lcdm_registry_add_dependency(
            self._h, name.encode(), depends_on.encode())
        if rc != 0:
            raise KeyError(f"unknown component in ({name}, {depends_on})")

    def initialization_order(self) -> list[str]:
        n = self._lib.lcdm_registry_count(self._h)
        out = (ctypes.c_int * max(n, 1))()
        rc = self._lib.lcdm_registry_topo_sort(self._h, out, n)
        if rc == -1:
            raise ValueError("circular component dependency detected")
        return [self._lib.lcdm_registry_name(self._h, out[i]).decode()
                for i in range(rc)]

    def has_cycle(self) -> bool:
        return bool(self._lib.lcdm_registry_has_cycle(self._h))


class HostArena:
    """Native host bump allocator with statistics (used, capacity, peak,
    allocation count)."""

    def __init__(self, capacity_bytes: int):
        self._lib = _require()
        self._h = self._lib.lcdm_pool_create(capacity_bytes)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lcdm_pool_destroy(self._h)
            self._h = None

    def alloc(self, size: int, align: int = 64) -> int:
        ptr = self._lib.lcdm_pool_alloc(self._h, size, align)
        if not ptr:
            raise MemoryError(f"arena exhausted ({self.used}/"
                              f"{self.capacity} bytes)")
        return ptr

    def reset(self) -> None:
        self._lib.lcdm_pool_reset(self._h)

    @property
    def used(self) -> int:
        return self._lib.lcdm_pool_used(self._h)

    @property
    def capacity(self) -> int:
        return self._lib.lcdm_pool_capacity(self._h)

    @property
    def peak(self) -> int:
        return self._lib.lcdm_pool_peak(self._h)

    @property
    def alloc_count(self) -> int:
        return self._lib.lcdm_pool_alloc_count(self._h)


def write_snapshot_native(path: str, positions, velocities, masses,
                          scale_factor: float, time: float,
                          step: int) -> None:
    """Synchronous `.lcdm` binary snapshot (FNV-1a checksummed)."""
    lib = _require()
    pos, vel, mass = _particles(positions, velocities, masses)
    rc = lib.lcdm_snapshot_write(path.encode(), mass.shape[0], pos, vel,
                                 mass, float(scale_factor), float(time),
                                 int(step))
    if rc != 0:
        raise OSError(f"native snapshot write failed (rc={rc}): {path}")


def read_snapshot_native(path: str):
    """-> (positions, velocities, masses, scale_factor, time, step) as
    numpy arrays and Python numbers; raises OSError on a checksum mismatch
    (corruption) or a file that is not a `.lcdm` snapshot."""
    lib = _require()
    n = lib.lcdm_snapshot_read_n(path.encode())
    if n < 0:
        raise OSError(f"not a .lcdm snapshot: {path}")
    pos = np.empty((n, 3), np.float32)
    vel = np.empty((n, 3), np.float32)
    mass = np.empty((n,), np.float32)
    a = ctypes.c_double()
    t = ctypes.c_double()
    s = ctypes.c_int64()
    rc = lib.lcdm_snapshot_read(path.encode(), n, pos, vel, mass,
                                ctypes.byref(a), ctypes.byref(t),
                                ctypes.byref(s))
    if rc == -3:
        raise OSError(f"snapshot checksum mismatch (corrupt): {path}")
    if rc != 0:
        raise OSError(f"native snapshot read failed (rc={rc}): {path}")
    return pos, vel, mass, a.value, t.value, s.value


class AsyncSnapshotWriter:
    """Background-thread `.lcdm` writer: `submit` copies the arrays (card
    tensors to the host first, then into the native queue) and returns;
    the simulation continues while the files are written."""

    def __init__(self):
        self._lib = _require()
        self._h = self._lib.lcdm_writer_create()

    def submit(self, path: str, positions, velocities, masses,
               scale_factor: float, time: float, step: int) -> None:
        pos, vel, mass = _particles(positions, velocities, masses)
        while True:
            rc = self._lib.lcdm_writer_submit(
                self._h, path.encode(), mass.shape[0], pos, vel, mass,
                float(scale_factor), float(time), int(step))
            if rc == 0:
                return
            self.wait()    # bounded queue full: drain

    @property
    def pending(self) -> int:
        return self._lib.lcdm_writer_pending(self._h)

    @property
    def errors(self) -> int:
        return self._lib.lcdm_writer_errors(self._h)

    def wait(self) -> None:
        self._lib.lcdm_writer_wait(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self.wait()
            self._lib.lcdm_writer_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
