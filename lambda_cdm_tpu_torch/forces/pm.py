"""Particle-mesh (PM) gravity in plain PyTorch (counterpart of
lambda_cdm_tpu/forces/pm.py): CIC deposit -> FFT Poisson solve (torch.fft)
-> spectral gradient -> CIC gather, with the optional Gaussian split of
the TreePM long-range force and CIC-window deconvolution.

    phi_k = -4 pi G rho_k / k^2 (DC mode zeroed),  acc_k = -i k phi_k.
"""

from __future__ import annotations

import functools
import math

import torch

from ..ops import pm_cic
from ..ops.pm_cic import cic_gather
from ..physics.initial_conditions import fourier_grid
from ..utils.profiling import count

_WINDOW_POWER = {"ngp": 1, "cic": 2, "tsc": 3}


def assignment_window(ng: int, box_size, assignment: str = "cic",
                      device="cuda"):
    """Fourier-space mass-assignment window
    W = prod_i sinc(k_i dx / 2)^p (p = 1 NGP, 2 CIC, 3 TSC), on `device`
    (the card unless named)."""
    kx, ky, kz, _ = fourier_grid(ng, box_size, device=device)
    half_dx = box_size / ng / 2.0

    def sinc(x):
        x = x * half_dx
        return torch.where(torch.abs(x) < 1e-12, 1.0, torch.sin(x) / x)

    p = _WINDOW_POWER[assignment]
    return (sinc(kx) * sinc(ky) * sinc(kz)) ** p


def poisson_greens_function(ng: int, box_size: float, *, split_scale=0.0,
                            deconvolve_cic: bool = True, device="cuda"):
    """-4 pi / k^2 (unit G) times the optional Gaussian split
    exp(-k^2 rs^2) and CIC^-2 window -> [ng, ng, ng//2+1] float32 on
    `device` (the card unless named)."""
    kx, ky, kz, k2 = fourier_grid(ng, box_size, device=device)
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    green = -4.0 * math.pi * inv_k2
    if split_scale and split_scale > 0:
        green = green * torch.exp(-k2 * split_scale * split_scale)
    if deconvolve_cic:
        w = assignment_window(ng, box_size, "cic", device=device)
        green = green / (w * w)
    return green.to(torch.float32)


@functools.lru_cache(maxsize=8)
def _spectral(ng: int, box_size: float, split_scale: float,
              deconvolve_cic: bool, device: str):
    """(Green's function, kx, ky, kz) of one mesh, kept between calls;
    the Green's function in the memory layout torch.fft.rfftn gives a
    half spectrum on `device` (ops/pm_cic.green_gradient walks both in
    one order)."""
    kx, ky, kz, _ = fourier_grid(ng, box_size, device=device)
    green = poisson_greens_function(ng, box_size, split_scale=split_scale,
                                    deconvolve_cic=deconvolve_cic,
                                    device=device)
    return pm_cic.like_rfftn(green), kx, ky, kz


def _density_k(positions, masses, ng: int, box_size):
    """rfftn of the CIC mass density (mass / cell volume)."""
    from ..analysis.power_spectrum import cic_deposit
    box = torch.tensor(float(box_size), dtype=torch.float32)
    cell_volume = float((box / ng) ** 3)
    grid = cic_deposit(positions, ng, box_size, weights=masses)
    return torch.fft.rfftn(grid / cell_volume)


def pm_accelerations(positions, masses, ng: int, box_size, g_const=1.0, *,
                     split_scale=0.0, deconvolve_cic: bool = True,
                     factor: float = 1.0, plain: bool = False):
    """PM accelerations [N, 3] for positions in [0, box): CIC deposit,
    FFT Poisson solve, spectral gradient, CIC gather, times g_const and
    then `factor` (modified gravity's 1 + mg). `split_scale` > 0 keeps
    only the long-range (Gaussian-filtered) force, for TreePM.
    ops/pm_cic.pm_forces computes it: on CUDA tensors through the
    kernels of csrc/pm_cic.cu unless `plain`, else in plain PyTorch.
    Counts `pm_forces` (utils/profiling), one an evaluation."""
    count("pm_forces")
    green, kx, ky, kz = _spectral(ng, float(box_size), float(split_scale),
                                  bool(deconvolve_cic),
                                  str(positions.device))
    return pm_cic.pm_forces(positions, masses, ng, float(box_size), g_const,
                            green, (kx, ky, kz), factor, plain=plain)


def potential_grid(positions, masses, ng: int, box_size, g_const=1.0, *,
                   deconvolve_cic: bool = True):
    """Peculiar-potential grid phi [ng, ng, ng]."""
    rho_k = _density_k(positions, masses, ng, box_size)
    green = _spectral(ng, float(box_size), 0.0, bool(deconvolve_cic),
                      str(rho_k.device))[0]
    return g_const * torch.fft.irfftn(green * rho_k, s=(ng, ng, ng))


def pm_potential(positions, masses, ng: int, box_size, g_const=1.0):
    """Gravitational potential at the particle positions (PM estimate)."""
    phi = potential_grid(positions, masses, ng, box_size, 1.0)
    return g_const * cic_gather(phi, positions, ng, box_size)
