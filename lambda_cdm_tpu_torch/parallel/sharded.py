"""Multi-rank force solvers and energy over the rank mesh (counterpart of
lambda_cdm_tpu/parallel/sharded.py). Each function takes this rank's
rows and returns its rows (or the global reduction), and is a collective:
every rank of the mesh calls it. On a 2D or 3D mesh each runs over the
flattened rank order (the JAX functions given a tuple of axes): the ring
passes blocks to flat rank + 1, and the sharded PM cuts its grid into
slabs over all D ranks, which needs ng divisible by D (a ValueError
says so; the JAX GSPMD version needs no such divisibility).

  * `ring_direct_accelerations`: the O(N^2) sum as a ring. A rank keeps
    its rows and passes the block it holds to rank + 1 at each of the D
    steps (the JAX ring's ppermute s -> s + 1); each step's partial sum is
    K4's cross form (ops/direct.pairwise_accelerations_cross: targets the
    rank's rows, sources the block), the plain version on the CPU.
  * `sharded_energy`: KE of the rank's rows plus the ring's PE, K9's cross
    form a step (ops/direct.pair_potential_cross, every ordered pair, the
    self pair left out by the guard r^2 <= eps^2 + 1e-30), summed over the
    ranks.
  * `sharded_pm_accelerations`: the PM force, equal to the single-device
    forces/pm.pm_accelerations (the JAX version is that function under
    GSPMD). Each rank deposits its rows onto the whole ng^3 grid; the
    grids are reduce-scattered into x-slabs; the potential comes from the
    slab FFT (parallel/fft, the CIC-deconvolved Green's function of
    forces/pm in the transposed layout); the three force slabs are
    all-gathered, and each rank gathers the forces at its rows. Bytes a
    call (4-byte floats): the deposit grid's reduce-scatter (ng^3 a rank
    in), two all_to_all transposes a transform of ng^3 / D complex values
    a rank (1 forward, 3 inverse), and the all-gather of 3 ng^3 floats
    to every rank. A halo-only form (each rank sends only the planes its
    neighbours' rows touch) is ROADMAP.md's.
"""

from __future__ import annotations


import torch

from .fft import check_slabs, distributed_irfftn, distributed_rfftn, \
    ky_slab
from .mesh import Mesh


def ring_direct_accelerations(positions, masses, *, box_size, softening,
                              g_const=1.0, mesh: Mesh):
    """Direct O(N^2) accelerations [n_loc, 3] on this rank's rows from
    every rank's rows (minimum image, softening > 0). Zero-mass rows are
    inert padding: they pull nothing and get zero force."""
    from ..ops.direct import pairwise_accelerations_cross
    acc = torch.zeros_like(positions)
    block = torch.cat([positions, masses[:, None]], dim=1)
    for k in range(mesh.size):
        acc = acc + pairwise_accelerations_cross(
            positions, block[:, :3], block[:, 3], box_size, softening, 1.0)
        if k + 1 < mesh.size:
            block = mesh.ring_shift(block)
    return g_const * torch.where((masses > 0)[:, None], acc, 0.0)


def sharded_energy(positions, velocities, masses, *, box_size, softening,
                   g_const, mesh: Mesh) -> dict:
    """{"kinetic", "potential", "total"}: KE over every rank's rows and
    the ring's pairwise PE (each ordered pair once from each side, halved),
    0-d float32 tensors equal on every rank."""
    from ..ops.direct import pair_potential_cross
    ke = 0.5 * torch.sum(masses * torch.sum(velocities * velocities,
                                            dim=-1))
    pe = torch.zeros((), dtype=torch.float64, device=positions.device)
    block = torch.cat([positions, masses[:, None]], dim=1)
    for k in range(mesh.size):
        pe = pe + pair_potential_cross(positions, masses, block[:, :3],
                                       block[:, 3], box_size, softening,
                                       g_const)
        if k + 1 < mesh.size:
            block = mesh.ring_shift(block)
    ke = mesh.all_reduce(ke.reshape(1))[0]
    pe = mesh.all_reduce(pe.reshape(1))[0].to(torch.float32)
    return {"kinetic": ke, "potential": pe, "total": ke + pe}


def sharded_pm_accelerations(positions, masses, ng: int, box_size,
                             g_const=1.0, *, split_scale=0.0,
                             mesh: Mesh):
    """PM accelerations [n_loc, 3] at this rank's rows, the forces
    forces/pm.pm_accelerations gives the global set (see the module
    docstring for the exchange). ng must divide by the number of ranks."""
    from ..analysis.power_spectrum import cic_deposit
    from ..forces.pm import cic_gather, poisson_greens_function
    from .fft import k_vectors_transposed
    check_slabs(ng, mesh)
    box = torch.tensor(float(box_size), dtype=torch.float32)
    cell_volume = float((box / ng) ** 3)
    grid = cic_deposit(positions, ng, box_size, weights=masses)
    slab = mesh.reduce_scatter(grid) / cell_volume      # [ng/D, ng, ng]
    rho_k = distributed_rfftn(slab, mesh=mesh)           # [ng/D, ng, nz]
    # the Green's function is symmetric in kx <-> ky, so its transposed
    # layout is its own [kx, ky, kz] array; this rank takes its ky rows
    green = ky_slab(poisson_greens_function(
        ng, float(box_size), split_scale=split_scale,
        device=positions.device), mesh)
    phi_k = green * rho_k
    kx, ky, kz, _ = k_vectors_transposed(ng, float(box_size),
                                         device=positions.device)
    forces = torch.stack([distributed_irfftn(-1j * ky_slab(kvec, mesh)
                                             * phi_k, ng=ng, mesh=mesh)
                          for kvec in (kx, ky, kz)])  # [3, ng/D, ng, ng]
    whole = mesh.all_gather(forces.movedim(1, 0).contiguous())
    whole = whole.movedim(1, 0)                          # [3, ng, ng, ng]
    acc = [cic_gather(whole[c], positions, ng, box_size) for c in range(3)]
    return g_const * torch.stack(acc, dim=-1)

