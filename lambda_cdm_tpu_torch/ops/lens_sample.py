"""K6/K7: periodic bilinear sampling of a lens plane's field stack -- the
CUDA kernel csrc/lens_sample.cu with its plain PyTorch version
(counterpart of lambda_cdm_tpu/ops/pallas_lens_sample.py) -- and the ray
tracer's loop over the lens planes built on it.

    out[f, r] = bilinear interpolation of fields[f] (periodic, cell-centred)
                at xy[r] in grid units g = xy / extent * ng

for a [F, ng, ng] float32 stack (y the fast axis) and R points -> [F, R].
`bilinear_sample_fields` (K6) takes points in [0, extent]; the windowed
entry `bilinear_sample_fields_xwin` (K7) takes x unwrapped (any sign and
magnitude), as trace_rays hands it on its windowed route. Both launch the
same kernel, once a call (it forms g itself); the window only keeps the
JAX contract (it bounded the TPU kernel's GEMM depth and means nothing to
a gather). `fast_channels` (the TPU's single-bf16-pass Hessian channels)
is accepted and ignored: every channel is sampled in float32, tighter than
the TPU's bf16 envelope.

`trace_planes` runs raytracing.lensing.trace_rays's loop over the lens
planes: on the card one launch of the kernel's trace entry (every plane's
impact position, samples, deflection, kappa and Jacobian update for a ray
in one thread), on the CPU `trace_planes_plain`, the loop body as
trace_rays wrote it (`plane_step_plain`).

CPU tensors take the plain version; CUDA tensors launch the kernel (or
raise).
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

# rays per tile of the TPU sampler: raytracing.lensing.auto_sample_window
# bounds each tile's x span with it, so the port picks the same window
RT = 2048

# the public samplers (K6, K7), and the trace on each route: wrapped
# impact positions (K6's) and unwrapped (K7's); one launch a call each
launches = {"lens_sample": 0, "lens_sample_xwin": 0, "lens_trace": 0,
            "lens_trace_xwin": 0}


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


def _scalar(x, device):
    """A scalar argument as the kernel takes it: (pointer of a 0-d float32
    tensor on `device`, 0.0), or (0, its float32 value) for a number or a
    CPU tensor. The value divides and wraps as the 0-d tensor would."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        if x.device != device or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"scalar argument must be one float32 on "
                             f"{device}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        return x.data_ptr(), 0.0
    return 0, float(np.float32(float(x)))


def _launch(name, fields, xy, extent, unwrapped: bool):
    xy = xy.to(torch.float32).contiguous()
    cuda_build.require_cuda(name, fields, xy,
                            dtypes=(torch.float32, torch.float32))
    n_rays = xy.shape[0]
    out = torch.empty((fields.shape[0], n_rays), dtype=torch.float32,
                      device=fields.device)
    ext_p, ext_v = _scalar(extent, fields.device)
    launches[name] += 1
    cuda_build.launch("lcdm_lens_sample", fields.data_ptr(), xy.data_ptr(),
                      ext_p, ext_v, out.data_ptr(), fields.shape[0],
                      fields.shape[-1], n_rays, int(unwrapped))
    return out


def _check_window(window: int, ng: int) -> None:
    """The JAX contract: a window rounded up to 8 must stay below ng."""
    w = ((int(window) + 7) // 8) * 8
    if w >= ng:
        raise ValueError(f"window {window} >= ng {ng}: use "
                         f"bilinear_sample_fields")


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
    _check_window(window, fields.shape[-1])
    if fields.device.type == "cpu":
        return bilinear_sample_fields_plain(fields, xy, extent)
    return _launch("lens_sample_xwin", fields, xy, extent, unwrapped=True)


# -- the ray tracer's plane step ---------------------------------------------

def plane_step_plain(fields, theta, kap, amat, chi_l, w_l, d_chi, box, *,
                     wrap: bool, x_offset: float = 0.0):
    """One lens plane of trace_rays in plain PyTorch: the impact position
    theta * chi_l (+ x_offset on x; wrapped into the box when `wrap`),
    the samples of fields [F, ng, ng] there, then theta += -(ax, ay) /
    chi_l, kap += dl * w_l * d_chi and, when `amat` (a00, a01, a10, a11)
    is given, A <- (I - U) A. Returns the new (theta, kap, amat)."""
    xy = theta * chi_l
    if x_offset:
        xy = xy + torch.tensor([x_offset, 0.0], dtype=xy.dtype,
                               device=xy.device)
    if wrap:
        xy = torch.remainder(xy, box)
    sampled = bilinear_sample_fields_plain(fields, xy, box)
    ax, ay, dl = sampled[0], sampled[1], sampled[2]
    # the comoving potential u solves lap_x(u) = 2 kappa; the angular
    # deflection is grad_x(u) / chi_l
    theta = theta + (-torch.stack([ax, ay], dim=-1) / chi_l)
    kap = kap + dl * w_l * d_chi
    if amat is not None:
        # A <- (I - U) A, elementwise
        uxx, uxy, uyy = sampled[3], sampled[4], sampled[5]
        a00, a01, a10, a11 = amat
        amat = (a00 - (uxx * a00 + uxy * a10),
                a01 - (uxx * a01 + uxy * a11),
                a10 - (uxy * a00 + uyy * a10),
                a11 - (uxy * a01 + uyy * a11))
    return theta, kap, amat


def finish_plain(theta, kap, amat, chi_source) -> dict:
    """The bundle at the source plane: theta, beta = theta chi_s, kappa
    and, with the Jacobian, the shear, magnification, rotation and
    kappa_jac of A = [[1-k-g1, -g2+w], [-g2-w, 1-k+g1]]."""
    out = {"theta": theta, "beta": theta * chi_source, "kappa": kap}
    if amat is None:
        return out
    a00, a01, a10, a11 = amat
    g1 = 0.5 * (a11 - a00)
    g2 = -0.5 * (a01 + a10)
    det = a00 * a11 - a01 * a10
    out.update(gamma=torch.stack([g1, g2], dim=-1), mu=1.0 / det,
               omega=0.5 * (a10 - a01), kappa_jac=1.0 - 0.5 * (a00 + a11))
    return out


def trace_planes_plain(fields_l, theta0, chi_planes, weights, d_chi, box,
                       chi_source, *, jacobian: bool, window: int = 0,
                       x_offset: float = 0.0) -> dict:
    """Plain PyTorch trace_planes: plane_step_plain over the L planes of
    fields_l [L, F, ng, ng] (impact positions wrapped when window is 0),
    then finish_plain."""
    box = torch.as_tensor(box, dtype=torch.float32, device=theta0.device)
    n_rays = theta0.shape[0]
    theta = theta0
    kap = torch.zeros(n_rays, dtype=torch.float32, device=theta0.device)
    amat = None
    if jacobian:
        one = torch.ones_like(kap)
        amat = (one, torch.zeros_like(kap), torch.zeros_like(kap),
                one.clone())
    for idx in range(fields_l.shape[0]):
        theta, kap, amat = plane_step_plain(
            fields_l[idx], theta, kap, amat, chi_planes[idx], weights[idx],
            d_chi, box, wrap=window == 0, x_offset=x_offset)
    return finish_plain(theta, kap, amat, chi_source)


def trace_planes(fields_l, theta0, chi_planes, weights, d_chi, box,
                 chi_source, *, jacobian: bool, window: int = 0,
                 x_offset: float = 0.0) -> dict:
    """trace_rays's loop over the lens planes for a bundle of rays theta0
    [R, 2]: fields_l [L, F, ng, ng] (F >= 3, >= 6 with the Jacobian),
    chi_planes and weights (lensing_efficiency) [L], d_chi, box and
    chi_source scalars. Returns {theta, beta, kappa[, gamma, mu, omega,
    kappa_jac]} at the source plane (finish_plain's keys). Window 0 wraps
    the impact positions into the box (K6's route); a window > 0 samples
    them unwrapped (K7's, with the JAX contract on the window).
    `x_offset` moves every impact position along x (a diagnostic: a
    planted sampling fault); theta0 is never written.

    CPU tensors take trace_planes_plain. CUDA tensors launch
    csrc/lens_sample.cu's trace once (each ray's state in registers
    through the L planes, chi_l and w_l read on the card: no host sync)
    into buffers this call allocates."""
    if window:
        _check_window(window, fields_l.shape[-1])
    if theta0.device.type == "cpu":
        return trace_planes_plain(fields_l, theta0, chi_planes, weights,
                                  d_chi, box, chi_source, jacobian=jacobian,
                                  window=window, x_offset=x_offset)
    dev = theta0.device
    n_min = 6 if jacobian else 3
    if fields_l.dim() != 4 or fields_l.shape[1] < n_min \
            or fields_l.shape[2] != fields_l.shape[3]:
        raise ValueError(f"fields_l must be [L, F >= {n_min}, ng, ng], got "
                         f"{tuple(fields_l.shape)}")
    n_planes, n_f, ng = fields_l.shape[0], fields_l.shape[1], \
        fields_l.shape[-1]
    if theta0.dim() != 2 or theta0.shape[1] != 2:
        raise ValueError(f"theta0 must be [R, 2], got {tuple(theta0.shape)}")
    theta0 = theta0.to(torch.float32).contiguous()
    chi_planes = chi_planes.to(torch.float32).contiguous()
    weights = weights.to(torch.float32).contiguous()
    name = "lens_trace_xwin" if window else "lens_trace"
    cuda_build.require_cuda(name, fields_l, theta0, chi_planes, weights,
                            dtypes=(torch.float32,) * 4)
    if chi_planes.numel() != n_planes or weights.numel() != n_planes:
        raise ValueError("chi_planes and weights must hold one value a "
                         "plane")
    n_rays = theta0.shape[0]
    out = {"theta": torch.empty_like(theta0),
           "beta": torch.empty_like(theta0),
           "kappa": torch.empty(n_rays, dtype=torch.float32, device=dev)}
    jac = (0, 0, 0, 0)
    if jacobian:
        out.update(gamma=torch.empty_like(theta0),
                   mu=torch.empty_like(out["kappa"]),
                   omega=torch.empty_like(out["kappa"]),
                   kappa_jac=torch.empty_like(out["kappa"]))
        jac = tuple(out[k].data_ptr() for k in ("gamma", "mu", "omega",
                                                "kappa_jac"))
    launches[name] += 1
    cuda_build.launch("lcdm_lens_trace", fields_l.data_ptr(), n_planes, n_f,
                      ng, theta0.data_ptr(), out["theta"].data_ptr(),
                      out["kappa"].data_ptr(), out["beta"].data_ptr(), *jac,
                      n_rays, chi_planes.data_ptr(), weights.data_ptr(),
                      *_scalar(box, dev), *_scalar(d_chi, dev),
                      *_scalar(chi_source, dev), float(np.float32(x_offset)),
                      int(window > 0), int(jacobian))
    return out
