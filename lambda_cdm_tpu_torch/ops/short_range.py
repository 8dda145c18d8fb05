"""K3: TreePM short-range pair accelerations on cell buckets -- the CUDA
kernel csrc/short_range.cu with its plain PyTorch version (counterpart
of lambda_cdm_tpu/ops/pallas_short_range.py, whose vpu3/vpu4b/vpu5
variants are one function that this kernel computes at any capacity).

Per live slot i of cell c:
    acc_i = sum over the 27 periodic neighbour cells n of c, over the
            live j of n, of (m_j c1) max(r^-3 + Q(v), 0) dx,
    dx = x_j + shift_n - x_i, r^2 = |dx|^2 + eps^2,
    v = min(r^2 v_scale - 1, 1),
with Q the even split polynomial of `_poly_even_coeffs`. The shift is
+-box where the neighbour's cell index wraps: positions drift unwrapped
between rebuckets, so periodicity comes from cell indices, not from
min-image. Dead slots get exactly 0.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import cuda_build
from ..forces.treepm import _fit_short_poly

_X_MAX = _fit_short_poly()[1]

launches = {"short_range": 0}


def reset_launch_counts() -> None:
    launches["short_range"] = 0


@functools.lru_cache(maxsize=None)
def _poly_even_coeffs(rs: float, degree: int = 10):
    """Even-polynomial split in r^2, computed with numpy exactly as the
    JAX package does: (Q coefficients highest first, with c8/c1 folded in;
    v_scale; c1). Per pair w = (m c1) max(r^-3 + Q(min(r^2 v_scale - 1,
    1)), 0)."""
    x_max = _X_MAX
    u_max = x_max * x_max
    u = np.linspace(1e-8, u_max, 8001)
    x = np.sqrt(u)
    s = np.array([math.erfc(t) + (2.0 * t / math.sqrt(math.pi))
                  * math.exp(-t * t) for t in x])
    qt = (s - 1.0) / x ** 3
    v = 2.0 * u / u_max - 1.0
    c = np.polyfit(v, qt, degree)
    got = np.polyval(c.astype(np.float32), v.astype(np.float32))
    err = float(np.max(np.abs((got - qt) * x ** 3)))
    assert err < 2e-4, f"even split poly fit error {err}"
    s_end = (math.erfc(x_max) + (2.0 * x_max / math.sqrt(math.pi))
             * math.exp(-x_max * x_max))
    c1 = 1.0 - s_end
    c8 = 1.0 / (8.0 * rs ** 3)
    v_scale = 2.0 / (u_max * 4.0 * rs * rs)
    return ([float(cc * c8 / c1) for cc in c], float(v_scale), float(c1))


def _validate(bpos, bmass, counts, ncell, capacity, softening):
    if ncell < 3:
        raise ValueError("short_range needs ncell >= 3")
    if softening <= 0:
        raise ValueError("softening must be > 0")
    cc = ncell ** 3
    if tuple(bpos.shape) != (3, cc, capacity):
        raise ValueError(f"bpos must be SoA [3, {cc}, {capacity}], got "
                         f"{tuple(bpos.shape)}")
    if tuple(bmass.shape) != (cc, capacity):
        raise ValueError(f"bmass must be [{cc}, {capacity}]")
    if tuple(counts.shape) != (cc,):
        raise ValueError(f"counts must be [{cc}]")


def _neighbours(cells, ncell, box_size):
    """[T] cell ids -> ([T, 27] neighbour cell ids, [3, T, 27] shifts)."""
    nc = ncell
    offs = torch.tensor([(ox, oy, oz) for ox in (-1, 0, 1)
                         for oy in (-1, 0, 1) for oz in (-1, 0, 1)],
                        device=cells.device)
    cxyz = torch.stack([cells // (nc * nc), (cells // nc) % nc, cells % nc])
    raw = cxyz[:, :, None] + offs.T[:, None, :]               # [3, T, 27]
    shift = torch.where(raw < 0, -box_size,
                        torch.where(raw >= nc, box_size, 0.0))
    n = torch.remainder(raw, nc)
    return (n[0] * nc + n[1]) * nc + n[2], shift.to(torch.float32)


def short_range_plain(bpos, bmass, counts, *, ncell: int, capacity: int,
                      box_size: float, rs: float, softening: float,
                      rows=None, chunk: int = 0):
    """Plain PyTorch K3. Without `rows`: [3, C, K] for every slot (0 on
    dead slots; only the live rows are evaluated). With `rows` ([T] flat
    slot indices into C*K): [3, T] for those slots only, O(T * 27 * K) --
    the affordable comparison at full size (the counterpart of
    forces/treepm.short_range_targets, with the vpu3 split function).
    Evaluated in row chunks of `chunk` (default: about 8M pair slots per
    chunk)."""
    _validate(bpos, bmass, counts, ncell, capacity, softening)
    chq, v_scale, c1 = _poly_even_coeffs(float(rs))
    soft2 = float(softening) ** 2
    cc, k = ncell ** 3, capacity
    chunk = chunk or max(16, (1 << 23) // (27 * k))
    flat_pos = bpos.reshape(3, cc * k)
    live_slot = (torch.arange(k, device=bpos.device)[None, :]
                 < counts[:, None])                           # [C, K]
    all_rows = rows is None
    if all_rows:
        rows = torch.nonzero(live_slot.reshape(-1))[:, 0]
    rows = torch.as_tensor(rows, device=bpos.device).to(torch.int64)
    jmass = torch.where(live_slot, bmass, 0.0) * c1
    out = torch.zeros((3, rows.numel()), dtype=torch.float32,
                      device=bpos.device)
    for r0 in range(0, rows.numel(), chunk):
        r = rows[r0:r0 + chunk]
        cells = r // k
        ncid, shift = _neighbours(cells, ncell, box_size)       # [T, 27]
        pi = flat_pos[:, r]                                     # [3, T]
        pj = bpos[:, ncid] + shift[..., None]                   # [3,T,27,K]
        d = pj - pi[:, :, None, None]
        r2 = d[0] * d[0] + (d[1] * d[1] + (d[2] * d[2] + soft2))
        inv_r = torch.rsqrt(r2)
        v = torch.clamp(r2 * v_scale - 1.0, max=1.0)
        q = torch.full_like(v, chq[0])
        for cq in chq[1:]:
            q = q * v + cq
        w = jmass[ncid] * torch.clamp((inv_r * inv_r) * inv_r + q, min=0.0)
        acc = torch.sum(w[None] * d, dim=(2, 3))                # [3, T]
        live_i = live_slot.reshape(-1)[r]
        out[:, r0:r0 + chunk] = torch.where(live_i[None], acc, 0.0)
    if all_rows:
        full = torch.zeros((3, cc * k), dtype=torch.float32,
                           device=bpos.device)
        full[:, rows] = out
        return full.reshape(3, cc, k)
    return out


def _threads(capacity: int) -> int:
    """Block size: one warp multiple near the capacity, at most 256."""
    return min(256, max(32, 32 * ((capacity + 31) // 32)))


@functools.lru_cache(maxsize=None)
def _device_coeffs(rs: float, device: str):
    return torch.tensor(_poly_even_coeffs(rs)[0], dtype=torch.float32,
                        device=device)


def short_range(bpos, bmass, counts, *, ncell: int, capacity: int,
                box_size: float, rs: float, softening: float):
    """Short-range accelerations (unit G) for every bucket slot -> SoA
    [3, C, K], 0 on dead slots. CUDA tensors launch K3
    (csrc/short_range.cu, replacing pallas_short_range's vpu3/vpu4b/vpu5
    kernels); CPU tensors take short_range_plain."""
    _validate(bpos, bmass, counts, ncell, capacity, softening)
    if bpos.device.type == "cpu":
        return short_range_plain(bpos, bmass, counts, ncell=ncell,
                                 capacity=capacity, box_size=box_size,
                                 rs=rs, softening=softening)
    cuda_build.require_cuda("short_range", bpos, bmass, counts,
                            dtypes=(torch.float32, torch.float32,
                                    torch.int32))
    _, v_scale, c1 = _poly_even_coeffs(float(rs))
    chq = _device_coeffs(float(rs), str(bpos.device))
    out = torch.zeros_like(bpos)
    launches["short_range"] += 1
    cuda_build.launch("lcdm_short_range", bpos.data_ptr(), bmass.data_ptr(),
                      counts.data_ptr(), chq.data_ptr(), out.data_ptr(),
                      ncell, capacity, _threads(capacity), float(box_size),
                      float(softening) ** 2, v_scale, c1)
    return out
