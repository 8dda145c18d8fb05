"""K5: the friends-of-friends hook sweep on cell buckets -- the CUDA kernel
csrc/fof_hook.cu with its plain PyTorch version (counterpart of
lambda_cdm_tpu/ops/pallas_fof.py).

One sweep, for every live slot i of an active cell c:
    out[i] = min(lab[i], min over the live j of the 27 periodic neighbour
             cells of c with r^2(i, j) < b^2 of lab[j]),
    d = (x_j + shift) - x_i, r^2 = (dx^2 + dy^2) + dz^2 in float32,
the shift box * floor((c + o) / ncell) per axis coming from the neighbour
cell's index (right for any ncell >= 1). Labels are int32; empty slots
carry the sentinel n; dead rows and inactive cells keep their incoming
labels.

This is a Jacobi sweep (reads `lab`, writes a copy), where the TPU kernel
is a Gauss-Seidel one (ordered grid through an aliased buffer): `reverse`
and `bidirectional`, which order the TPU sweep, have no meaning here and
are accepted only so that call sites read as in the JAX package. Both
sweeps reach the same fixpoint in the caller's hook-and-compress loop.

The kernel's work is K3's plan of units (ops/short_range.unit_plan) over
the live rows of the active cells: one warp a unit of at most UNIT_ROWS
rows, heaviest first, with no host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build
from .short_range import _neighbours, unit_plan

launches = {"fof_hook": 0}


def reset_launch_counts() -> None:
    launches["fof_hook"] = 0


def _b2(linking_length) -> float:
    """b^2 as the float32 the comparison uses (b*b in double, rounded
    once, as the JAX package's float32 comparison rounds it)."""
    return float(np.float32(float(linking_length) * float(linking_length)))


def _validate(bx, by, bz, lab, counts, active, ncell, capacity):
    cc = ncell ** 3
    for name, t in (("bx", bx), ("by", by), ("bz", bz), ("lab", lab)):
        if tuple(t.shape) != (cc, capacity):
            raise ValueError(f"{name} must be [{cc}, {capacity}], got "
                             f"{tuple(t.shape)}")
    if tuple(counts.shape) != (cc,):
        raise ValueError(f"counts must be [{cc}]")
    if active is not None and tuple(active.shape) != (cc,):
        raise ValueError(f"active must be [{cc}]")


def _live_rows(counts, active, capacity):
    """Flat slot indices of the live rows of active cells."""
    live = (torch.arange(capacity, device=counts.device)[None, :]
            < counts[:, None])
    if active is not None:
        live = live & (active != 0)[:, None]
    return torch.nonzero(live.reshape(-1))[:, 0]


def fof_hook_plain(bx, by, bz, lab, counts, active=None, *, ncell: int,
                   capacity: int, n_sentinel: int, box_size: float,
                   linking_length: float, reverse: bool = False,
                   bidirectional: bool = False, rows=None, chunk: int = 0):
    """Plain PyTorch K5 (`reverse` and `bidirectional` are ignored, see
    the module docstring). Without `rows`: the swept labels [C, K] int32.
    With `rows` ([T] flat slot indices of live rows): the swept labels of
    those rows only, O(T * 27 * K) -- the affordable comparison at full
    size. Evaluated in row chunks of `chunk` (default: about 4M pair
    slots per chunk). `n_sentinel` is the empty-slot label; it takes no
    part in the arithmetic."""
    _validate(bx, by, bz, lab, counts, active, ncell, capacity)
    k = capacity
    dev = bx.device
    b2 = torch.tensor(_b2(linking_length), dtype=torch.float32, device=dev)
    chunk = chunk or max(16, (1 << 22) // (27 * k))
    all_rows = rows is None
    if all_rows:
        rows = _live_rows(counts, active, k)
    rows = torch.as_tensor(rows, device=dev).to(torch.int64)
    flat = [t.reshape(-1) for t in (bx, by, bz)]
    flat_lab = lab.reshape(-1)
    slot = torch.arange(k, device=dev)
    out = torch.empty(rows.numel(), dtype=torch.int32, device=dev)
    for r0 in range(0, rows.numel(), chunk):
        r = rows[r0:r0 + chunk]
        ncid, shift = _neighbours(r // k, ncell, box_size)     # [T, 27]
        r2 = None
        for comp in range(3):
            pj = (bx, by, bz)[comp][ncid] + shift[comp][..., None]
            d = pj - flat[comp][r][:, None, None]             # [T, 27, K]
            r2 = d * d if r2 is None else r2 + d * d
        jlive = slot[None, None, :] < counts[ncid][..., None]
        cand = torch.where((r2 < b2) & jlive, lab[ncid],
                           torch.iinfo(torch.int32).max)
        best = cand.reshape(r.numel(), -1).min(dim=1).values
        out[r0:r0 + chunk] = torch.minimum(flat_lab[r], best)
    if not all_rows:
        return out
    full = lab.reshape(-1).clone()
    full[rows] = out
    return full.reshape(lab.shape)


def fof_hook(bx, by, bz, lab, counts, active=None, *, ncell: int,
             capacity: int, n_sentinel: int, box_size: float,
             linking_length: float, reverse: bool = False,
             bidirectional: bool = False):
    """One FoF min-label sweep -> new slot labels [C, K] int32. CUDA
    tensors launch K5 (csrc/fof_hook.cu, replacing pallas_fof's
    _fof_hook_kernel); CPU tensors take fof_hook_plain. `active` (int32
    [C], default all cells) marks the cells to sweep."""
    _validate(bx, by, bz, lab, counts, active, ncell, capacity)
    kw = dict(ncell=ncell, capacity=capacity, n_sentinel=n_sentinel,
              box_size=box_size, linking_length=linking_length)
    if bx.device.type == "cpu":
        return fof_hook_plain(bx, by, bz, lab, counts, active, **kw)
    if active is None:
        active = torch.ones_like(counts)
    cuda_build.require_cuda(
        "fof_hook", bx, by, bz, lab, counts, active,
        dtypes=(torch.float32,) * 3 + (torch.int32,) * 3)
    plan = unit_plan(torch.where(active != 0, counts, 0), ncell)
    out = lab.clone()
    launches["fof_hook"] += 1
    cuda_build.launch("lcdm_fof_hook", bx.data_ptr(), by.data_ptr(),
                      bz.data_ptr(), lab.data_ptr(), counts.data_ptr(),
                      plan.data_ptr(), out.data_ptr(), ncell, capacity,
                      float(box_size), _b2(linking_length))
    return out
