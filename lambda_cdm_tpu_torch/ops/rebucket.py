"""The fast stepper's rebucket pass on the card: csrc/rebucket.cu's three
kernels over live rows only, with PyTorch's cumsum and stable sort
between them.

    rebucket(bpos, bvel, acc, bmass, ids, *, box_size, ncell, n_rows)
        -> (pos, vel, acc, mass, ids, pass_overflow)

takes a live-first bucket state (SoA [3, C, K] float32 positions,
velocities and forces, [C, K] float32 masses and int32 ids, C = ncell^3)
and files its live rows into new buffers of the same shape: each cell's
rows in their old-slot order, positions wrapped into [0, box), dead slots
0 (ids -1), rows over a cell's capacity left out and counted in
`pass_overflow` (a 0-d int32 tensor, this pass's alone). With `n_rows`
> 0 only the first n_rows live rows in slot order are filed, as the
compact form's nonzero()[:n_rows] keeps them; 0 files them all. The
states equal fast_treepm's plain forms (the gather form, and the compact
form with the same n_rows), bit for bit in every field.

The plain forms are the CPU path (fast_treepm._rebucket sends CUDA
tensors here); this wrapper takes CUDA tensors only and raises on any
other. It waits on nothing: the caller reads `pass_overflow` when it
needs it. A pass launches each of the three kernels once and counts once
in `launches["rebucket"]`.
"""

from __future__ import annotations

import torch

from . import cuda_build

# passes since the last reset (each launches the three kernels once)
launches = {"rebucket": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _check(vectors, bmass, ids, ncell: int):
    """Raise unless the state is CUDA float32 vectors [3, C, K], float32
    masses and int32 ids [C, K] on one device with C = ncell^3; returns
    them contiguous."""
    shape = tuple(bmass.shape)
    if len(shape) != 2 or shape[0] != ncell ** 3:
        raise ValueError(f"rebucket: masses must be [ncell^3, K] = "
                         f"[{ncell ** 3}, K], got {list(shape)}")
    want = [(torch.float32, (3,) + shape)] * 3 + [(torch.float32, shape),
                                                  (torch.int32, shape)]
    dev = bmass.device
    out = []
    for i, (t, (dtype, shp)) in enumerate(zip(vectors + (bmass, ids), want)):
        if (t.dtype, tuple(t.shape)) != (dtype, shp):
            raise ValueError(f"rebucket: argument {i} must be {dtype} "
                             f"{list(shp)}, got {t.dtype} {list(t.shape)}")
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"rebucket: argument {i} must be on one CUDA "
                             f"device, got {t.device}")
        out.append(t.contiguous())
    if shape[0] * shape[1] > 2 ** 31 - 1:
        raise ValueError("rebucket: more than 2^31 - 1 slots")
    return out


def rebucket(bpos, bvel, acc, bmass, ids, *, box_size: float, ncell: int,
             n_rows: int = 0):
    """The rebucket pass on the card -> (pos, vel, acc, mass, ids,
    pass_overflow), new tensors (see the module's docstring)."""
    bpos, bvel, acc, bmass, ids = _check((bpos, bvel, acc), bmass, ids,
                                         ncell)
    cells, cap = bmass.shape
    slots = cells * cap
    n = min(int(n_rows), slots) if n_rows > 0 else slots
    box = float(box_size)
    dev = bmass.device
    launches["rebucket"] += 1
    counts, hist = torch.empty((2, cells + 1), dtype=torch.int32,
                               device=dev)
    grew = torch.empty((), dtype=torch.int32, device=dev)
    cuda_build.launch("lcdm_rebucket_counts", bmass.data_ptr(), ncell, cap,
                      counts.data_ptr(), hist.data_ptr(), grew.data_ptr())
    start = torch.cumsum(counts, 0, dtype=torch.int32)
    keys, vals = torch.empty((2, n), dtype=torch.int32, device=dev)
    cuda_build.launch("lcdm_rebucket_keys", bpos.data_ptr(),
                      start.data_ptr(), ncell, cap, n, box, keys.data_ptr(),
                      vals.data_ptr(), hist.data_ptr())
    keys, order = torch.sort(keys, stable=True)
    start = torch.cumsum(hist, 0, dtype=torch.int32)
    outs = [torch.zeros_like(t) for t in (bpos, bvel, acc, bmass)]
    outs.append(torch.full_like(ids, -1))
    cuda_build.launch("lcdm_rebucket_move",
                      *(t.data_ptr() for t in (bpos, bvel, acc, bmass, ids)),
                      *(t.data_ptr() for t in outs), keys.data_ptr(),
                      order.data_ptr(), vals.data_ptr(), start.data_ptr(),
                      ncell, cap, n, box, grew.data_ptr())
    return (*outs, grew)
