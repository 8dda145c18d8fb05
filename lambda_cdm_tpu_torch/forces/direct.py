"""Direct O(N^2) gravity in plain PyTorch (counterpart of
lambda_cdm_tpu/forces/direct.py): minimum-image displacements, the
broadcast and row-blocked accelerations (the CPU path of the `direct`
solver and the oracle of the tests and of validate_force_accuracy), and
the kinetic and pairwise potential energies. On the card the `direct`
solver runs the K4 kernel instead, and the potential energy K9
(ops/direct.py)."""

from __future__ import annotations

import torch


def min_image(dx, box_size):
    """Minimum-image displacement for periodic boxes. torch.round rounds
    half to even, as jnp.round does; the box is divided as a tensor, so
    the quotient rounds alike on every device."""
    box = torch.as_tensor(box_size, dtype=dx.dtype, device=dx.device)
    return dx - box * torch.round(dx / box)


def _pair_accel(dx, mass_j, softening2, g):
    """Acceleration contribution a_i from particle j at displacement dx."""
    r2 = torch.sum(dx * dx, dim=-1) + softening2
    inv_r3 = torch.rsqrt(r2) / r2             # (r^2)^(-3/2)
    return g * (mass_j * inv_r3)[..., None] * dx


def _contract(inv_r3, masses, dx, precision):
    """sum_j inv_r3[i, j] m_j dx[i, j, :] in float32. precision="bfloat16"
    rounds the two operands of the contraction, (inv_r3 m) and dx, to
    bf16 and accumulates in float32, as the JAX einsum does at
    Precision.DEFAULT on the TPU."""
    w = inv_r3 * masses[None, :]
    if precision == "bfloat16":
        w = w.to(torch.bfloat16).to(torch.float32)
        dx = dx.to(torch.bfloat16).to(torch.float32)
    return torch.einsum("ij,ijk->ik", w, dx)


def direct_accelerations(positions, masses, box_size, softening=0.01,
                         g_const=1.0, modified_gravity=0.0,
                         precision=None):
    """Softened pairwise accelerations, full [N, N] broadcast:
    a_i = G (1 + alpha) sum_{j != i} m_j d / (|d|^2 + eps^2)^(3/2),
    d = x_j - x_i with the minimum image."""
    dx = min_image(positions[None, :, :] - positions[:, None, :], box_size)
    r2 = torch.sum(dx * dx, dim=-1) + softening * softening
    inv_r3 = torch.rsqrt(r2) / r2
    n = positions.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=positions.device)
    inv_r3 = torch.where(eye, 0.0, inv_r3)
    acc = _contract(inv_r3, masses, dx, precision)
    return g_const * (1.0 + modified_gravity) * acc


def direct_accelerations_chunked(positions, masses, box_size, softening=0.01,
                                 g_const=1.0, modified_gravity=0.0,
                                 chunk_size=4096, precision=None,
                                 targets=None):
    """Row-blocked direct sum: O(N^2) operations, O(chunk_size * N)
    memory. Pairs with r^2 <= eps^2 + 1e-30 (the self pair) are left
    out. `targets` (indices) limits the rows to those particles, each
    summed over all sources, as validate_force_accuracy samples them."""
    rows = positions if targets is None else positions[targets]
    soft2 = softening * softening
    blocks = []
    for i0 in range(0, rows.shape[0], chunk_size):
        pos_i = rows[i0:i0 + chunk_size]
        dx = min_image(positions[None, :, :] - pos_i[:, None, :], box_size)
        r2 = torch.sum(dx * dx, dim=-1) + soft2
        inv_r3 = torch.rsqrt(r2) / r2
        inv_r3 = torch.where(r2 <= soft2 + 1e-30, 0.0, inv_r3)
        blocks.append(_contract(inv_r3, masses, dx, precision))
    acc = torch.cat(blocks) if blocks else positions.new_zeros((0, 3))
    return g_const * (1.0 + modified_gravity) * acc


def potential_energy(positions, masses, box_size, softening=0.01,
                     g_const=1.0, chunk_size=2048):
    """Total pairwise potential energy
    U = -G/2 sum_{i != j} m_i m_j / sqrt(r_ij^2 + eps^2), minimum image,
    pairs with r^2 <= eps^2 + 1e-30 (the self pair) left out, as in the
    JAX package; summed in float64 and returned in the positions' dtype.
    CUDA tensors launch K9 (ops/direct.pair_potential), CPU tensors take
    its plain version in row blocks of at most `chunk_size`."""
    from ..ops.direct import pair_potential
    return pair_potential(positions, masses, box_size, softening, g_const,
                          chunk_size).to(positions.dtype)


def kinetic_energy(velocities, masses):
    """KE = sum 1/2 m v^2."""
    return 0.5 * torch.sum(masses * torch.sum(velocities * velocities,
                                              dim=-1))
