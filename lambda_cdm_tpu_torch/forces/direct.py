"""The parts of the direct O(N^2) module that the diagnostics need
(counterpart of lambda_cdm_tpu/forces/direct.py): minimum-image
displacements and the kinetic and pairwise potential energies. The
direct accelerations wait for their kernel (ROADMAP, K4)."""

from __future__ import annotations

import torch


def min_image(dx, box_size):
    """Minimum-image displacement for periodic boxes. torch.round rounds
    half to even, as jnp.round does; the box is divided as a tensor, so
    the quotient rounds alike on every device."""
    box = torch.as_tensor(box_size, dtype=dx.dtype, device=dx.device)
    return dx - box * torch.round(dx / box)


def potential_energy(positions, masses, box_size, softening=0.01,
                     g_const=1.0, chunk_size=2048):
    """Total pairwise potential energy
    U = -G/2 sum_{i != j} m_i m_j / sqrt(r_ij^2 + eps^2), minimum image,
    in blocks of at most `chunk_size` rows (fewer where N is large, so a
    block stays about 8M pairs); block sums accumulate in float64. Pairs
    with r^2 <= eps^2 + 1e-30 (the self pair) are left out, as in the
    JAX package."""
    n = positions.shape[0]
    rows = max(1, min(chunk_size, (1 << 23) // max(n, 1)))
    soft2 = torch.tensor(softening, dtype=positions.dtype,
                         device=positions.device) ** 2
    total = torch.zeros((), dtype=torch.float64, device=positions.device)
    for i0 in range(0, n, rows):
        d = min_image(positions[None, :, :]
                      - positions[i0:i0 + rows, None, :], box_size)
        r2 = torch.sum(d * d, dim=-1) + soft2
        inv_r = torch.where(r2 <= soft2 + 1e-30, 0.0, torch.rsqrt(r2))
        pair = (masses[i0:i0 + rows, None] * masses[None, :]) * inv_r
        total = total + torch.sum(pair, dtype=torch.float64)
    return (-0.5 * g_const * total).to(positions.dtype)


def kinetic_energy(velocities, masses):
    """KE = sum 1/2 m v^2."""
    return 0.5 * torch.sum(masses * torch.sum(velocities * velocities,
                                              dim=-1))
