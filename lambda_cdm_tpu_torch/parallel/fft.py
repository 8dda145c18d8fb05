"""Slab-decomposed distributed 3D FFT over the rank mesh (counterpart of
the slab half of lambda_cdm_tpu/parallel/fft.py; the pencil half waits
for the 2D fast stepper, ROADMAP.md).

  forward:  x-slab [ng/D, ng, ng] a rank -> rfft over (y, z) -> one
            all_to_all transpose (x <-> y) -> fft over x (now whole) ->
            the half spectrum in ky slabs;
  inverse:  the exact reverse.

Layout contract (the JAX package's): the forward transform returns the
half spectrum TRANSPOSED, [ky (this rank's slab), kx, kz_r], i.e. array[b,
a, c] = F[a, b, c]; `k_vectors_transposed` gives the matching
wavevectors. Complex tensors cross the mesh as their float32 (re, im)
view. ng must divide by the number of ranks.
"""

from __future__ import annotations

import math

import torch

from .mesh import Mesh


def _check(ng: int, mesh: Mesh) -> None:
    if ng % mesh.size:
        raise ValueError(f"the slab FFT needs ng ({ng}) divisible by the "
                         f"{mesh.size} ranks")


def _exchange(chunks: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """all_to_all of a complex [D, ...] tensor over its real view."""
    return torch.view_as_complex(mesh.all_to_all(torch.view_as_real(
        chunks.contiguous())))


def distributed_rfftn(grid, *, mesh: Mesh):
    """Forward real FFT of the x-slab `grid` [ng/D, ng, ng] of this rank ->
    this rank's ky slab of the transposed half spectrum [ng/D, ng,
    ng//2+1] complex64."""
    nx_loc, ng, _ = grid.shape
    _check(ng, mesh)
    d = mesh.size
    gk = torch.fft.rfftn(grid, dim=(1, 2))           # local y, z transform
    nz = gk.shape[2]
    # chunk c = my x rows of y-chunk c -> rank c
    chunks = gk.reshape(nx_loc, d, ng // d, nz).movedim(1, 0)
    recv = _exchange(chunks, mesh)                   # [d, nx_loc, ny_loc, nz]
    full_x = recv.reshape(d * nx_loc, ng // d, nz)   # x-chunk c from rank c
    fx = torch.fft.fft(full_x, dim=0)
    return fx.movedim(0, 1).contiguous()             # [ny_loc, ng, nz]


def _hermitian_planes(gk, ng: int):
    """gk [nx, ng(ky), nz] after the x transform: its kz = 0 and (even ng)
    Nyquist planes replaced, for each x, by their Hermitian part in ky,
    (G(ky) + conj(G(-ky))) / 2. A spectrum from a real field is already
    Hermitian there (no change but rounding); a product with an odd
    factor such as the gradient's i k is not at the Nyquist index. numpy
    and PyTorch's CPU irfftn treat such input as this projection does,
    cuFFT's multi-dimensional c2r assumes Hermitian input, so the
    projection makes the slab inverse the same function on every
    device (and equal to the single-device irfftn of the whole
    spectrum)."""
    neg = (-torch.arange(ng, device=gk.device)) % ng
    planes = [0, ng // 2] if ng % 2 == 0 else [0]
    out = gk.clone()
    for c in planes:
        g = gk[:, :, c]
        out[:, :, c] = 0.5 * (g + torch.conj(g[:, neg]))
    return out


def distributed_irfftn(gk_t, *, ng: int, mesh: Mesh):
    """Inverse of distributed_rfftn: this rank's ky slab [ng/D, ng,
    ng//2+1] of the transposed half spectrum -> its real x-slab [ng/D, ng,
    ng] float32, numpy's irfftn of the whole spectrum (non-Hermitian
    kz = 0 and Nyquist planes taken by their Hermitian part, see
    _hermitian_planes)."""
    _check(ng, mesh)
    d = mesh.size
    ny_loc, _, nz = gk_t.shape
    fx = gk_t.movedim(1, 0)                          # [ng(x), ny_loc, nz]
    full_x = torch.fft.ifft(fx, dim=0)
    chunks = full_x.reshape(d, ng // d, ny_loc, nz)  # x-chunk c -> rank c
    recv = _exchange(chunks, mesh)                   # y-chunk c from rank c
    gk = recv.movedim(0, 1).reshape(ng // d, d * ny_loc, nz)
    return torch.fft.irfftn(_hermitian_planes(gk, ng), s=(ng, ng),
                            dim=(1, 2))


def k_vectors_transposed(ng: int, box_size, device="cuda"):
    """(kx, ky, kz, k2) float32, broadcasting over the TRANSPOSED half
    spectrum [ky, kx, kz] of distributed_rfftn (the whole ky range; a
    rank takes its slab of ky), on `device` (the card unless named)."""
    two_pi = 2.0 * math.pi
    kf = torch.fft.fftfreq(ng, d=1.0 / ng, device=device,
                           dtype=torch.float32) * (two_pi / box_size)
    kr = torch.fft.rfftfreq(ng, d=1.0 / ng, device=device,
                            dtype=torch.float32) * (two_pi / box_size)
    ky = kf[:, None, None]
    kx = kf[None, :, None]
    kz = kr[None, None, :]
    return kx, ky, kz, kx * kx + ky * ky + kz * kz


def ky_slab(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a [ng, ...] (or broadcast [1, ...]) spectrum
    factor in the transposed layout."""
    if x.shape[0] == 1:
        return x
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def distributed_poisson_solve(grid, *, ng: int, box_size, mesh: Mesh,
                              split_scale=0.0):
    """Sharded PM Poisson potential: this rank's density x-slab -> its
    potential x-slab through the slab FFT (lap phi = 4 pi rho, unit G,
    the DC mode zeroed; the optional Gaussian split exp(-k^2 rs^2))."""
    gk = distributed_rfftn(grid, mesh=mesh)
    _, _, _, k2 = k_vectors_transposed(ng, box_size, device=grid.device)
    k2 = ky_slab(k2, mesh)
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    green = -4.0 * math.pi * inv_k2
    if split_scale and split_scale > 0:
        green = green * torch.exp(-k2 * split_scale * split_scale)
    return distributed_irfftn(gk * green, ng=ng, mesh=mesh)
