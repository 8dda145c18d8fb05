"""The KDK updates of the fast stepper over live slots and of the
stateless solvers over [N, 3] rows: CUDA kernels (csrc/kdk_update.cu)
with their plain PyTorch versions.

    open   vel = bvel + acc * half_dt * kf     the opening half kick
           pos = bpos + vel * dt * df          and the drift
    kick   x = x + y * s1 * s2                 the closing half kick
                                               (vel, acc, half_dt, kf) and
                                               the force's combine
                                               acc_long + g acc_short
                                               (acc_long, acc_short, g, 1)

on SoA [3, C, K] float32 buckets of a live-first layout with live-slot
counts [C] int32. The scalars are numbers or 0-d host tensors (the
stepper's), taken as Python floats; each rounds to float32 as PyTorch
rounds a scalar operand, and every product and sum rounds on its own in
the order written, so a kernel equals its plain version bit for bit on
live slots (the combine's g * acc_short rounds as acc_short * g, and the
product by 1 is exact). Dead slots hold 0 in every input and output.

The stateless solvers' step (physics/integrators.kdk_step_fused) has
flat forms over [N, 3] rows, where every value is live, both into new
tensors and in the same rounding order (torch.remainder's wrap too):

    open_flat   vel = v + acc * half_dt * kf,
                pos = remainder(p + vel * dt * df, box)   (box None: no
                                                           wrap)
    kick_flat   out = x + y * s1 * s2

Each wrapper checks its tensors (float32 vectors of one [3, C, K] shape,
int32 counts [C], contiguous, on one device; the flat forms float32
[N, 3] rows of any strides, made contiguous on the card), runs the plain
version for
CPU tensors, launches its kernel for CUDA tensors and raises on any other
device. On the card the kernels touch live slots only: `kdk_open` writes
zeroed new buffers, or with `owned` writes into bpos and bvel
themselves; `kdk_kick` writes into x, which its caller owns. The plain
versions return new tensors. Callers use the returned tensors. Each
launch counts in `launches` and in the program counter `fused_kdk`
(utils/profiling.count), both in `_launch`.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count
from . import cuda_build

# launches of each kernel since the last reset
launches = {"kdk_open": 0, "kdk_kick": 0, "kdk_open_flat": 0,
            "kdk_kick_flat": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _launch(kernel: str, *args) -> None:
    """Start `kernel` (the one place a launch is counted)."""
    launches[kernel] += 1
    count("fused_kdk")
    cuda_build.launch(f"lcdm_{kernel}", *args)


def _check(name, vectors, counts) -> None:
    """Raise unless `vectors` are float32 [3, C, K] tensors of one shape
    and `counts` an int32 [C] tensor, all contiguous and on one CPU or
    CUDA device."""
    shape = tuple(vectors[0].shape)
    if len(shape) != 3 or shape[0] != 3:
        raise ValueError(f"{name}: vectors must be SoA [3, C, K], got "
                         f"{shape}")
    dev = vectors[0].device
    for i, t in enumerate(vectors + (counts,)):
        want = (torch.float32, shape) if i < len(vectors) else \
            (torch.int32, shape[1:2])
        if (t.dtype, tuple(t.shape)) != want:
            raise ValueError(f"{name}: argument {i} must be {want[0]} "
                             f"{list(want[1])}, got {t.dtype} "
                             f"{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: argument {i} must be on {dev}, got "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev}: the plain version "
                         "takes CPU tensors, the kernel CUDA tensors")


def kdk_open_plain(bpos, bvel, acc, counts, half_dt: float, kf: float,
                   dt: float, df: float):
    """The half kick and the drift over every slot -> (pos, vel), pos 0
    on dead slots."""
    vel = bvel + acc * half_dt * kf
    live = torch.arange(bpos.shape[2], device=counts.device) \
        < counts[:, None]
    pos = torch.where(live[None], bpos + vel * dt * df, 0.0)
    return pos, vel


def kdk_kick_plain(x, y, s1: float, s2: float):
    """x + y * s1 * s2 over every slot."""
    return x + y * s1 * s2


def kdk_open(bpos, bvel, acc, counts, *, half_dt: float, kf: float,
             dt: float, df: float, owned: bool = False):
    """The opening half kick and the drift -> (pos, vel). CUDA tensors
    launch the open kernel on live slots: into zeroed new buffers, or with
    `owned` (the caller owns bpos and bvel and gives them up) into bpos
    and bvel; CPU tensors take kdk_open_plain."""
    _check("kdk_open", (bpos, bvel, acc), counts)
    half_dt, kf, dt, df = float(half_dt), float(kf), float(dt), float(df)
    if bpos.device.type == "cpu":
        return kdk_open_plain(bpos, bvel, acc, counts, half_dt, kf, dt, df)
    pos, vel = (bpos, bvel) if owned else (torch.zeros_like(bpos),
                                           torch.zeros_like(bvel))
    _launch("kdk_open", bpos.data_ptr(), bvel.data_ptr(), acc.data_ptr(),
            counts.data_ptr(), pos.data_ptr(), vel.data_ptr(),
            bpos.shape[1], bpos.shape[2], half_dt, kf, dt, df)
    return pos, vel


def kdk_kick(x, y, counts, *, s1: float, s2: float):
    """x + y * s1 * s2 -> x: the closing half kick (vel, acc, half_dt,
    kf) or the force's combine (acc_long, acc_short, g, 1). CUDA tensors
    launch the kick kernel on live slots, writing into x (the caller's
    own buffer); CPU tensors take kdk_kick_plain."""
    _check("kdk_kick", (x, y), counts)
    s1, s2 = float(s1), float(s2)
    if x.device.type == "cpu":
        return kdk_kick_plain(x, y, s1, s2)
    _launch("kdk_kick", x.data_ptr(), y.data_ptr(), counts.data_ptr(),
            x.shape[1], x.shape[2], s1, s2)
    return x


def _check_flat(name, vectors) -> tuple:
    """Raise unless `vectors` are float32 tensors of one [N, 3] shape on
    one CPU or CUDA device; returns them, contiguous on CUDA (a copy
    where one is strided, as a state's initial rows may be)."""
    shape = tuple(vectors[0].shape)
    if len(shape) != 2 or shape[1] != 3:
        raise ValueError(f"{name}: vectors must be [N, 3], got {shape}")
    dev = vectors[0].device
    for i, t in enumerate(vectors):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: argument {i} must be float32 "
                             f"{list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: argument {i} must be on {dev}, got "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev}: the plain version "
                         "takes CPU tensors, the kernel CUDA tensors")
    return vectors if dev.type == "cpu" else tuple(t.contiguous()
                                                   for t in vectors)


def kdk_open_flat_plain(p, v, acc, half_dt: float, kf: float, dt: float,
                        df: float, box):
    vel = v + acc * half_dt * kf
    pos = p + vel * dt * df
    if box is not None:
        pos = torch.remainder(pos, box)
    return pos, vel


def kdk_open_flat(p, v, acc, *, half_dt: float, kf: float, dt: float,
                  df: float, box=None):
    """The stateless step's opening half kick and drift, wrapped into
    [0, box) unless box is None -> new (pos, vel): one launch on CUDA
    tensors, kdk_open_flat_plain on CPU tensors."""
    p, v, acc = _check_flat("kdk_open_flat", (p, v, acc))
    half_dt, kf, dt, df = float(half_dt), float(kf), float(dt), float(df)
    if p.device.type == "cpu":
        return kdk_open_flat_plain(p, v, acc, half_dt, kf, dt, df, box)
    pos, vel = torch.empty_like(p), torch.empty_like(v)
    _launch("kdk_open_flat", p.data_ptr(), v.data_ptr(), acc.data_ptr(),
            pos.data_ptr(), vel.data_ptr(), p.numel(), half_dt, kf, dt, df,
            float(box or 0.0), box is not None)
    return pos, vel


def kdk_kick_flat(x, y, *, s1: float, s2: float):
    """x + y * s1 * s2 -> a new tensor (the stateless step's closing half
    kick): one launch on CUDA tensors, kdk_kick_plain on CPU tensors."""
    x, y = _check_flat("kdk_kick_flat", (x, y))
    s1, s2 = float(s1), float(s2)
    if x.device.type == "cpu":
        return kdk_kick_plain(x, y, s1, s2)
    out = torch.empty_like(x)
    _launch("kdk_kick_flat", x.data_ptr(), y.data_ptr(), out.data_ptr(),
            x.numel(), s1, s2)
    return out
