"""Poisson Green's function for the PM solve (counterpart of
lambda_cdm_tpu/forces/pm.poisson_greens_function)."""

from __future__ import annotations

import math

import torch

from ..physics.initial_conditions import fourier_grid

_WINDOW_POWER = {"ngp": 1, "cic": 2, "tsc": 3}


def assignment_window(ng: int, box_size, assignment: str = "cic",
                      device=None):
    """Fourier-space mass-assignment window
    W = prod_i sinc(k_i dx / 2)^p (p = 1 NGP, 2 CIC, 3 TSC)."""
    kx, ky, kz, _ = fourier_grid(ng, box_size, device=device)
    half_dx = box_size / ng / 2.0

    def sinc(x):
        x = x * half_dx
        return torch.where(torch.abs(x) < 1e-12, 1.0, torch.sin(x) / x)

    p = _WINDOW_POWER[assignment]
    return (sinc(kx) * sinc(ky) * sinc(kz)) ** p


def poisson_greens_function(ng: int, box_size: float, *, split_scale=0.0,
                            deconvolve_cic: bool = True, device=None):
    """-4 pi / k^2 (unit G) times the optional Gaussian split
    exp(-k^2 rs^2) and CIC^-2 window -> [ng, ng, ng//2+1] float32."""
    kx, ky, kz, k2 = fourier_grid(ng, box_size, device=device)
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    green = -4.0 * math.pi * inv_k2
    if split_scale and split_scale > 0:
        green = green * torch.exp(-k2 * split_scale * split_scale)
    if deconvolve_cic:
        w = assignment_window(ng, box_size, "cic", device=device)
        green = green / (w * w)
    return green.to(torch.float32)
