"""K6/K7: periodic bilinear sampling of a lens plane's field stack -- the
CUDA kernel csrc/lens_sample.cu with its plain PyTorch version
(counterpart of lambda_cdm_tpu/ops/pallas_lens_sample.py).

    out[f, r] = bilinear interpolation of fields[f] (periodic, cell-centred)
                at xy[r] in grid units g = xy / extent * ng

for a [F, ng, ng] float32 stack (y the fast axis) and R points -> [F, R].
`bilinear_sample_fields` (K6) takes points in [0, extent]; the windowed
entry `bilinear_sample_fields_xwin` (K7) takes x unwrapped (any sign and
magnitude), as trace_rays hands it on its windowed route. Both launch the
same kernel; the window only keeps the JAX contract (it bounded the TPU
kernel's GEMM depth and means nothing to a gather). `fast_channels` (the
TPU's single-bf16-pass Hessian channels) is accepted and ignored: every
channel is sampled in float32, tighter than the TPU's bf16 envelope.

CPU tensors take the plain version; CUDA tensors launch the kernel (or
raise).
"""

from __future__ import annotations

import torch

from . import cuda_build

# rays per tile of the TPU sampler: raytracing.lensing.auto_sample_window
# bounds each tile's x span with it, so the port picks the same window
RT = 2048

launches = {"lens_sample": 0, "lens_sample_xwin": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def grid_coords(xy, extent, ng: int):
    """xy / extent * ng in float32, dividing by a 0-d tensor (PyTorch's
    CUDA division by a Python scalar multiplies by the reciprocal, which
    can move a point across a cell edge)."""
    ext = torch.as_tensor(extent, dtype=torch.float32, device=xy.device)
    return xy.to(torch.float32) / ext * ng


def bilinear_sample_fields_plain(fields, xy, extent):
    """Plain PyTorch K6/K7: [F, ng, ng] sampled at xy [R, 2] -> [F, R]
    (x and y may lie anywhere: the cell indices wrap by an integer mod)."""
    ng = fields.shape[-1]
    u = grid_coords(xy, extent, ng) - 0.5
    i0 = torch.floor(u)
    f = u - i0
    i0 = i0.long()
    ix0, iy0 = torch.remainder(i0[:, 0], ng), torch.remainder(i0[:, 1], ng)
    ix1, iy1 = torch.remainder(i0[:, 0] + 1, ng), torch.remainder(
        i0[:, 1] + 1, ng)
    wx, wy = f[:, 0], f[:, 1]
    return (fields[:, ix0, iy0] * (1 - wx) * (1 - wy)
            + fields[:, ix1, iy0] * wx * (1 - wy)
            + fields[:, ix0, iy1] * (1 - wx) * wy
            + fields[:, ix1, iy1] * wx * wy)


def _validate(fields, xy):
    if fields.dim() != 3 or fields.shape[-1] != fields.shape[-2]:
        raise ValueError(f"fields must be [F, ng, ng], got "
                         f"{tuple(fields.shape)}")
    if xy.dim() != 2 or xy.shape[1] != 2:
        raise ValueError(f"xy must be [R, 2], got {tuple(xy.shape)}")


def _launch(name, fields, xy, extent, unwrapped: bool):
    ng = fields.shape[-1]
    g = grid_coords(xy, extent, ng).contiguous()
    cuda_build.require_cuda(name, fields, g,
                            dtypes=(torch.float32, torch.float32))
    n_rays = xy.shape[0]
    out = torch.empty((fields.shape[0], n_rays), dtype=torch.float32,
                      device=fields.device)
    launches[name] += 1
    cuda_build.launch("lcdm_lens_sample", fields.data_ptr(), g.data_ptr(),
                      out.data_ptr(), fields.shape[0], ng, n_rays,
                      int(unwrapped))
    return out


def bilinear_sample_fields(fields, xy, extent, *, fast_channels: int = 0):
    """Periodic bilinear sampling of fields [F, ng, ng] at xy [R, 2] in
    [0, extent]^2 -> [F, R] (replaces pallas_bilinear_sample; any ng).
    `fast_channels` is ignored: all channels are sampled in float32."""
    _validate(fields, xy)
    if fields.device.type == "cpu":
        return bilinear_sample_fields_plain(fields, xy, extent)
    return _launch("lens_sample", fields, xy, extent, unwrapped=False)


def bilinear_sample_fields_xwin(fields, xy, extent, *, window: int,
                                fast_channels: int = 0):
    """The windowed entry (replaces pallas_bilinear_sample_xwin): xy[:, 0]
    may be unwrapped. Raises ValueError, as the JAX function does, when
    the window rounded up to 8 reaches ng; the kernel needs no window.
    `fast_channels` is ignored: all channels are sampled in float32."""
    _validate(fields, xy)
    ng = fields.shape[-1]
    w = ((int(window) + 7) // 8) * 8
    if w >= ng:
        raise ValueError(f"window {window} >= ng {ng}: use "
                         f"bilinear_sample_fields")
    if fields.device.type == "cpu":
        return bilinear_sample_fields_plain(fields, xy, extent)
    return _launch("lens_sample_xwin", fields, xy, extent, unwrapped=True)
