"""PM long-range accelerations on cell-bucketed particles (counterpart of
lambda_cdm_tpu/ops/bucketed_pm.py, the gradient="fd4" route):

    K1 CIC deposit -> rfftn (cuFFT) -> Green's function -> irfftn
    -> K2 fused CIC x fd4 gather.

The `spectral` and `interp` gradients are not ported yet (ROADMAP).
"""

from __future__ import annotations

import functools

import torch

from .pm_rods import cic_deposit, fd4_gather


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


def pm_accelerations_bucketed(bpos, bmass, *, ncell: int, ng: int,
                              box_size, g_const=1.0, split_scale=0.0,
                              margin: int = 1, gradient: str = "fd4",
                              counts=None):
    """Long-range PM accelerations for SoA bpos [3, C, K] -> ([3, C, K],
    dropped 0-d int32). `counts` ([C] int32 live slots) is derived from
    bmass when not given."""
    if gradient != "fd4":
        raise NotImplementedError(
            f"gradient={gradient!r} is not ported yet (only fd4); see "
            f"ROADMAP.md")
    block_geometry(ng, ncell, margin)
    if counts is None:
        counts = live_counts(bmass)
    cell_volume = (box_size / ng) ** 3
    grid, dropped = cic_deposit(bpos, bmass, counts, ncell=ncell, ng=ng,
                                box_size=box_size, margin=margin)
    rho_k = torch.fft.rfftn(grid / cell_volume)
    green = _greens(ng, float(box_size), float(split_scale),
                    str(bpos.device))
    phi = torch.fft.irfftn(green * rho_k, s=(ng, ng, ng))
    acc = fd4_gather(phi, bpos, counts, ncell=ncell, ng=ng,
                     box_size=box_size, margin=margin)
    return g_const * acc, dropped
