"""PM long-range accelerations on cell-bucketed particles (counterpart of
lambda_cdm_tpu/ops/bucketed_pm.py):

    K1 CIC deposit -> rfftn (cuFFT) -> Green's function, then by
    `gradient`:
      fd4       irfftn -> K2 fused CIC x fd4 gather;
      spectral  three irfftn of -i k phi_k -> CIC gather of each field;
      interp    irfftn -> -(gradient of the CIC weights) . phi.

The spectral and interp gathers are plain PyTorch, as the JAX package
computes them in XLA einsums outside any Pallas kernel; they use the
deposit's drop rule (pm_rods._cic_corners), so a dropped or dead slot
gathers 0 on all three axes.
"""

from __future__ import annotations

import functools

import torch

from .pm_rods import _cic_corners, _mesh_scale, cic_deposit, fd4_gather

GRADIENTS = ("fd4", "spectral", "interp")


def block_geometry(ng: int, ncell: int, margin: int = 1):
    """(ppc, L): PM cells per bucket cell and local block edge length."""
    if ng % ncell:
        raise ValueError(f"PM grid {ng} must be a multiple of ncell {ncell}")
    ppc = ng // ncell
    return ppc, ppc + 2 * margin + 2


def _block_origins(ncell: int, ppc: int, margin: int, device=None):
    """Block origin in global PM coords per cell -> [C, 3] int32, cell ids
    z-major: ((cx*c)+cy)*c+cz."""
    c = ncell
    cid = torch.arange(c ** 3, device=device)
    cx = cid // (c * c)
    cy = (cid // c) % c
    cz = cid % c
    return (torch.stack([cx, cy, cz], dim=-1) * ppc
            - (margin + 1)).to(torch.int32)


@functools.lru_cache(maxsize=16)
def _greens(ng: int, box_size: float, split_scale: float, device: str):
    from ..forces.pm import poisson_greens_function
    return poisson_greens_function(ng, box_size, split_scale=split_scale,
                                   device=device)


def live_counts(bmass) -> torch.Tensor:
    """Live slots per bucket ([C] int32) of a live-first layout."""
    return torch.sum(bmass > 0, dim=1, dtype=torch.int32)


def _corner_sum(fields, bpos, bmass, *, ncell, ng, box_size, margin,
                weights):
    """sum over the 8 CIC corners of weights(corner) * field at that
    corner, for live slots inside the drop rule's window (0 elsewhere).
    fields: [F, ng, ng, ng]; weights(dx, dy, dz, frac) -> [W, C, K]
    corner weights (W = F, or any W when F = 1). Returns [max(F, W), C,
    K]."""
    i0, frac, ok = _cic_corners(bpos, ncell=ncell, ng=ng, box_size=box_size,
                                margin=margin)
    mask = ((bmass > 0) & ok).to(torch.float32)
    flat = fields.reshape(fields.shape[0], -1)
    shape = (fields.shape[0],) + tuple(bpos.shape[1:])
    out = 0.0
    for dx in (0, 1):
        ix = torch.remainder(i0[0] + dx, ng)
        for dy in (0, 1):
            iy = torch.remainder(i0[1] + dy, ng)
            for dz in (0, 1):
                iz = torch.remainder(i0[2] + dz, ng)
                idx = ((ix * ng + iy) * ng + iz).reshape(-1)
                vals = flat[:, idx].reshape(shape)
                out = out + vals * weights(dx, dy, dz, frac)
    return out * mask


def cic_gather_fields(fields, bpos, bmass, *, ncell: int, ng: int,
                      box_size: float, margin: int = 1):
    """CIC interpolation of [F, ng, ng, ng] fields at every bucket slot ->
    [F, C, K] (the JAX gather_to_buckets; 0 on dead and dropped slots)."""
    def weights(dx, dy, dz, frac):
        wx = frac[0] if dx else 1.0 - frac[0]
        wy = frac[1] if dy else 1.0 - frac[1]
        wz = frac[2] if dz else 1.0 - frac[2]
        return ((wx * wy) * wz)[None]

    return _corner_sum(fields, bpos, bmass, ncell=ncell, ng=ng,
                       box_size=box_size, margin=margin, weights=weights)


def gather_gradient(phi, bpos, bmass, *, ncell: int, ng: int,
                    box_size: float, margin: int = 1):
    """Force = -gradient of the CIC-interpolated potential -> [3, C, K]
    (the JAX gather_gradient_to_buckets): each axis differentiates its
    own CIC weight (-+ ng/box at the two corners). 0 on dead and dropped
    slots."""
    scale = _mesh_scale(ng, box_size)

    def weights(dx, dy, dz, frac):
        w = [frac[a] if d else 1.0 - frac[a]
             for a, d in enumerate((dx, dy, dz))]
        dw = [scale if d else -scale for d in (dx, dy, dz)]
        return torch.stack([dw[0] * (w[1] * w[2]), w[0] * (dw[1] * w[2]),
                            (w[0] * w[1]) * dw[2]])

    return -_corner_sum(phi[None], bpos, bmass, ncell=ncell, ng=ng,
                        box_size=box_size, margin=margin, weights=weights)


def pm_accelerations_bucketed(bpos, bmass, *, ncell: int, ng: int,
                              box_size, g_const=1.0, split_scale=0.0,
                              margin: int = 1, gradient: str = "fd4",
                              counts=None):
    """Long-range PM accelerations for SoA bpos [3, C, K] -> ([3, C, K],
    dropped 0-d int32). `counts` ([C] int32 live slots) is derived from
    bmass when not given. gradient: "fd4" (K2), "spectral" or "interp"."""
    from ..physics.initial_conditions import fourier_grid
    if gradient not in GRADIENTS:
        raise ValueError(f"unknown gradient {gradient!r}")
    block_geometry(ng, ncell, margin)
    if counts is None:
        counts = live_counts(bmass)
    cell_volume = (box_size / ng) ** 3
    grid, dropped = cic_deposit(bpos, bmass, counts, ncell=ncell, ng=ng,
                                box_size=box_size, margin=margin)
    rho_k = torch.fft.rfftn(grid / cell_volume)
    green = _greens(ng, float(box_size), float(split_scale),
                    str(bpos.device))
    phi_k = green * rho_k
    geo = dict(ncell=ncell, ng=ng, box_size=box_size, margin=margin)
    if gradient == "spectral":
        kvecs = fourier_grid(ng, float(box_size), device=bpos.device)[:3]
        fields = torch.stack([torch.fft.irfftn(-1j * k * phi_k,
                                               s=(ng, ng, ng))
                              for k in kvecs])
        acc = cic_gather_fields(fields, bpos, bmass, **geo)
    else:
        phi = torch.fft.irfftn(phi_k, s=(ng, ng, ng))
        if gradient == "interp":
            acc = gather_gradient(phi, bpos, bmass, **geo)
        else:
            acc = fd4_gather(phi, bpos, counts, **geo)
    return g_const * acc, dropped
