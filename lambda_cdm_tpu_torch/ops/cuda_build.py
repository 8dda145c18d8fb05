"""Build and load the port's hand-written CUDA kernels.

Each source under lambda_cdm_tpu_torch/csrc/*.cu compiles with its own
plain `nvcc` process (sm_90a, no PyTorch headers: seconds, not minutes),
all started together; one more `nvcc` links the objects into one shared
library with a C interface, cached in lambda_cdm_tpu_torch/_build/ under
a name keyed by a hash of the sources and flags. The library is
loaded with ctypes; wrappers pass raw pointers (tensor.data_ptr()) and
PyTorch's current stream, and every C entry point returns
cudaGetLastError() so a refused launch raises at once.

Nothing here runs at import: the library builds at the first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc/ptxas output of the build this process made

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signatures: (name, argtypes); every entry returns an int error code
_SIGNATURES = {
    "lcdm_cic_deposit": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                         _P],
    "lcdm_fd4_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I,
                        _P],
    "lcdm_short_range_plan": [_P, _P, _I, _P],
    "lcdm_short_range": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                         _F, _F, _P],
    "lcdm_short_range_rd_plan": [_P, _P, _I, _I, _I, _P],
    "lcdm_short_range_rd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                            _P],
    "lcdm_fof_hook": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    "lcdm_direct": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                    _P],
    "lcdm_direct_sym": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                        _P],
    "lcdm_lens_sample": [_P, _P, _P, _F, _P, _I, _I, _I, _I, _P],
    "lcdm_lens_trace": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _P, _P, _P, _F, _P, _F, _P, _F, _F, _I, _I, _P],
    "lcdm_pair_potential": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _P],
    "lcdm_alias_probe": [_P, _I, _I, _I, _P],
    "lcdm_launch_floor": [_P, _I, _I, _P],
    "lcdm_kdk_open": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P],
    "lcdm_kdk_kick": [_P, _P, _P, _I, _I, _F, _F, _P],
    "lcdm_kdk_open_flat": [_P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _I,
                           _P],
    "lcdm_kdk_kick_flat": [_P, _P, _P, _L, _F, _F, _P],
    "lcdm_pm_cic_scatter": [_P, _P, _P, _L, _I, _F, _P],
    "lcdm_pm_green_gradient": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P],
    "lcdm_pm_cic_gather3": [_P, _P, _P, _P, _P, _L, _I, _F, _F, _P],
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"liblcdm_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> None:
    """Start every command at once, wait for all; append their output to
    build_log and raise if any failed."""
    global build_log
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        build_log += out
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode})")
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed)
                           + f"\n{build_log}")


def build() -> str:
    """Compile the kernels unless a library for these sources exists;
    returns its path."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{out}.{os.getpid()}"
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(s)}.o" for s in srcs]
    build_log = ""
    _run_all([[nvcc] + COMPILE_FLAGS + ["-c", "-o", o, s]
              for s, o in zip(srcs, objs)])
    _run_all([[nvcc] + LINK_FLAGS + ["-o", f"{tag}.tmp"] + objs])
    for o in objs:
        os.remove(o)
    os.replace(f"{tag}.tmp", out)
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry `name` (the last argument, the stream, is appended
    here) and raise on a CUDA error."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds a call of fn() on the current stream
    (CUDA events around `reps` calls, after `warmup` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require_cuda(name: str, *tensors, dtypes=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (with the given dtypes)."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} must be on {dev} "
                             f"(cuda), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} must be contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise ValueError(f"{name}: argument {i} must be {dtypes[i]}, "
                             f"got {t.dtype}")
