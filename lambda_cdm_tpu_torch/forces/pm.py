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


def cic_gather(field, positions, ng: int, box_size):
    """Trilinear interpolation of a grid field at particle positions: the
    adjoint of cic_deposit (same cell-centred convention), so the PM force
    has no self-force."""
    from ..analysis.power_spectrum import _mesh_coords
    u = _mesh_coords(positions, ng, box_size)
    i0 = torch.floor(u - 0.5)
    frac = (u - 0.5) - i0
    i0 = i0.long()
    out = torch.zeros(positions.shape[:1], dtype=field.dtype,
                      device=field.device)
    flat = field.reshape(-1)
    for dx in (0, 1):
        wx = 1.0 - frac[:, 0] if dx == 0 else frac[:, 0]
        ix = torch.remainder(i0[:, 0] + dx, ng)
        for dy in (0, 1):
            wy = 1.0 - frac[:, 1] if dy == 0 else frac[:, 1]
            iy = torch.remainder(i0[:, 1] + dy, ng)
            for dz in (0, 1):
                wz = 1.0 - frac[:, 2] if dz == 0 else frac[:, 2]
                iz = torch.remainder(i0[:, 2] + dz, ng)
                idx = (ix * ng + iy) * ng + iz
                out = out + flat[idx] * (wx * wy * wz)
    return out


@functools.lru_cache(maxsize=8)
def _spectral(ng: int, box_size: float, split_scale: float,
              deconvolve_cic: bool, device: str):
    """(Green's function, kx, ky, kz) of one mesh, kept between calls."""
    kx, ky, kz, _ = fourier_grid(ng, box_size, device=device)
    green = poisson_greens_function(ng, box_size, split_scale=split_scale,
                                    deconvolve_cic=deconvolve_cic,
                                    device=device)
    return green, kx, ky, kz


def _density_k(positions, masses, ng: int, box_size):
    """rfftn of the CIC mass density (mass / cell volume)."""
    from ..analysis.power_spectrum import cic_deposit
    box = torch.tensor(float(box_size), dtype=torch.float32)
    cell_volume = float((box / ng) ** 3)
    grid = cic_deposit(positions, ng, box_size, weights=masses)
    return torch.fft.rfftn(grid / cell_volume)


def pm_accelerations(positions, masses, ng: int, box_size, g_const=1.0, *,
                     split_scale=0.0, deconvolve_cic: bool = True):
    """PM accelerations [N, 3] for positions in [0, box): CIC deposit,
    FFT Poisson solve, spectral gradient, CIC gather. `split_scale` > 0
    keeps only the long-range (Gaussian-filtered) force, for TreePM."""
    rho_k = _density_k(positions, masses, ng, box_size)
    green, kx, ky, kz = _spectral(ng, float(box_size), float(split_scale),
                                  bool(deconvolve_cic), str(rho_k.device))
    phi_k = green * rho_k
    acc = []
    for kvec in (kx, ky, kz):
        acc_grid = torch.fft.irfftn(-1j * kvec * phi_k, s=(ng, ng, ng))
        acc.append(cic_gather(acc_grid, positions, ng, box_size))
    return g_const * torch.stack(acc, dim=-1)


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
