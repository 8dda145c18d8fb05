"""Distributed 3D FFTs over the rank mesh (counterpart of
lambda_cdm_tpu/parallel/fft.py): the slab transform and the pencil one.

Slabs (the whole grid of D ranks in the flattened order):

  forward:  x-slab [ng/D, ng, ng] a rank -> rfft over (y, z) -> one
            all_to_all transpose (x <-> y) -> fft over x (now whole) ->
            the half spectrum in ky slabs;
  inverse:  the exact reverse.

  Layout contract (the JAX package's): the forward transform returns the
  half spectrum TRANSPOSED, [ky (this rank's slab), kx, kz_r], i.e.
  array[b, a, c] = F[a, b, c]; `k_vectors_transposed` gives the matching
  wavevectors. ng must divide by the number of ranks (on a 2D or 3D
  mesh, all of them: the slabs run over the flattened rank order).

Pencils (a 2D (dx, dy) grid of ranks; the second axis may be a tuple of
mesh axes, their ranks first-major, as the 3D block stepper runs it):

  forward:  z-pencil [ng/dx, ng/dy, ng] a rank -> rfft over z, padded to
            zp = ceil((ng/2+1)/dy) dy -> all_to_all over the y axis (y
            <-> z chunks) -> fft over y -> all_to_all over the x axis (x
            <-> y chunks) -> fft over x;
  inverse:  the exact reverse, ending in a 1D irfft over z.

  Layout contract (the JAX package's): the half spectrum with the global
  layout [kx (whole), ky (split over the x axis), kz (split over the y
  axis, padded to zp)], a rank's block [ng, ng/dx, zp/dy]; Green's
  functions must be zero on the padded kz rows (k_vectors_pencil).

Complex tensors cross the mesh as their float32 (re, im) view.
"""

from __future__ import annotations

import math

import torch

from .mesh import Mesh


def check_slabs(ng: int, mesh: Mesh) -> None:
    """ValueError unless ng divides into slabs over all the mesh's ranks
    (on a 2D or 3D mesh their product)."""
    if ng % mesh.size:
        raise ValueError(f"the slab FFT needs ng ({ng}) divisible by the "
                         f"{mesh.size} ranks of the mesh {mesh.shape}")


def _exchange(chunks: torch.Tensor, mesh: Mesh, axis=None) -> torch.Tensor:
    """all_to_all of a complex [d, ...] tensor over its real view, along
    `axis` (None: the whole grid)."""
    return torch.view_as_complex(mesh.all_to_all(torch.view_as_real(
        chunks.contiguous()), axis))


def distributed_rfftn(grid, *, mesh: Mesh):
    """Forward real FFT of the x-slab `grid` [ng/D, ng, ng] of this rank ->
    this rank's ky slab of the transposed half spectrum [ng/D, ng,
    ng//2+1] complex64."""
    nx_loc, ng, _ = grid.shape
    check_slabs(ng, mesh)
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
    check_slabs(ng, mesh)
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


# ---------------------------------------------------------------------------
# 2D pencil decomposition
# ---------------------------------------------------------------------------

def _pad_to_multiple(n: int, d: int) -> int:
    return ((n + d - 1) // d) * d


def _pencil_dims(mesh: Mesh, axes: tuple, ng: int) -> tuple:
    """(dx, dy) of the pencil grid, ValueError unless ng divides by both."""
    from .mesh import axis_size
    dx, dy = (axis_size(mesh, a) for a in axes)
    if ng % dx or ng % dy:
        raise ValueError(f"the pencil FFT needs ng ({ng}) divisible by the "
                         f"{dx} x {dy} ranks of the axes {axes}")
    return dx, dy


def pencil_rfftn(grid, *, mesh: Mesh, axes: tuple = ("shx", "shy")):
    """Forward real 3D FFT of this rank's z-pencil `grid` [ng/dx, ng/dy,
    ng] (x split over axes[0], y over axes[1]) -> its block [ng, ng/dx,
    zp/dy] complex64 of the padded half spectrum (module docstring)."""
    ax, ay = axes
    xl, yl, ng = grid.shape
    dx, dy = _pencil_dims(mesh, axes, ng)
    nzr = ng // 2 + 1
    zp = _pad_to_multiple(nzr, dy)
    zc = zp // dy
    gk = torch.nn.functional.pad(torch.fft.rfft(grid, dim=2),
                                 (0, zp - nzr))
    # y <-> z over the y axis: z-chunk c -> rank c
    ch = gk.reshape(xl, yl, dy, zc).movedim(2, 0)
    rec = _exchange(ch, mesh, ay)            # [dy, xl, yl, zc], y-block c
    gk = torch.fft.fft(rec.movedim(0, 1).reshape(xl, dy * yl, zc), dim=1)
    # x <-> y over the x axis: y-chunk c -> rank c
    ylc = ng // dx
    ch = gk.reshape(xl, dx, ylc, zc).movedim(1, 0)
    rec = _exchange(ch, mesh, ax)            # [dx, xl, ylc, zc], x-block c
    return torch.fft.fft(rec.reshape(dx * xl, ylc, zc), dim=0)


def _real_edges(g, ng: int):
    """g [..., ng//2+1] with the imaginary parts of its kz = 0 and (even
    ng) Nyquist bins zeroed: a 1D c2r reads only their real parts in
    numpy and PyTorch's CPU irfft; zeroing them makes the inverse the same
    function on the card."""
    g = g.clone()
    for c in ([0, ng // 2] if ng % 2 == 0 else [0]):
        g[..., c] = g[..., c].real.to(g.dtype)
    return g


def pencil_irfftn(gk, *, ng: int, mesh: Mesh, axes: tuple = ("shx", "shy")):
    """Inverse of pencil_rfftn: this rank's block [ng, ng/dx, zp/dy] of
    the padded half spectrum -> its real z-pencil [ng/dx, ng/dy, ng]
    float32 (the padded kz rows are dropped; the last step is a 1D irfft
    over z, whose kz = 0 and Nyquist bins give their real parts)."""
    ax, ay = axes
    dx, dy = _pencil_dims(mesh, axes, ng)
    _, ylc, zc = gk.shape
    xl, yl = ng // dx, ng // dy
    g = torch.fft.ifft(gk, dim=0)
    # x <-> y back over the x axis: x-chunk c -> rank c
    rec = _exchange(g.reshape(dx, xl, ylc, zc), mesh, ax)
    g = torch.fft.ifft(rec.movedim(0, 1).reshape(xl, dx * ylc, zc), dim=1)
    # y <-> z back over the y axis: y-chunk c -> rank c
    ch = g.reshape(xl, dy, yl, zc).movedim(1, 0)
    rec = _exchange(ch, mesh, ay)            # [dy, xl, yl, zc], z-chunk c
    g = rec.movedim(0, 2).reshape(xl, yl, dy * zc)[:, :, :ng // 2 + 1]
    return torch.fft.irfft(_real_edges(g, ng), n=ng, dim=2)


def k_vectors_pencil(ng: int, box_size, dy: int, device="cuda"):
    """(kx, ky, kz, k2) float32 broadcasting over pencil_rfftn's whole
    [kx, ky, kz padded to zp] layout (kz rows past ng//2 are padding,
    wavenumber 0; Green's functions must be zero there); a rank takes its
    block with `pencil_block`."""
    two_pi = 2.0 * math.pi
    kf = torch.fft.fftfreq(ng, d=1.0 / ng, device=device,
                           dtype=torch.float32) * (two_pi / box_size)
    kr = torch.fft.rfftfreq(ng, d=1.0 / ng, device=device,
                            dtype=torch.float32) * (two_pi / box_size)
    kz = torch.nn.functional.pad(kr, (0, _pad_to_multiple(ng // 2 + 1, dy)
                                      - kr.shape[0]))
    kx = kf[:, None, None]
    ky = kf[None, :, None]
    kz = kz[None, None, :]
    return kx, ky, kz, kx * kx + ky * ky + kz * kz


def pencil_block(x: torch.Tensor, mesh: Mesh, axes: tuple) -> torch.Tensor:
    """This rank's block of a spectrum factor x [ng or 1, ng, zp] in
    pencil_rfftn's layout: ky rows by its index along axes[0], kz rows by
    its index along axes[1]."""
    ax, ay = axes
    ng, zp = x.shape[1], x.shape[2]
    dx, dy = _pencil_dims(mesh, axes, ng)
    ylc, zc = ng // dx, zp // dy
    iy, iz = mesh.axis_index(ax), mesh.axis_index(ay)
    return x[:, iy * ylc:(iy + 1) * ylc, iz * zc:(iz + 1) * zc]


def pencil_poisson_solve(grid, *, ng: int, box_size, mesh: Mesh,
                         axes: tuple = ("shx", "shy"), split_scale=0.0):
    """Pencil-sharded PM Poisson potential (lap phi = 4 pi rho, unit G,
    the DC mode and the padded kz rows zeroed; the optional Gaussian split
    exp(-k^2 rs^2)), the pencil twin of distributed_poisson_solve."""
    gk = pencil_rfftn(grid, mesh=mesh, axes=axes)
    dy = _pencil_dims(mesh, axes, ng)[1]
    _, _, _, k2 = k_vectors_pencil(ng, box_size, dy, device=grid.device)
    valid = torch.arange(k2.shape[2], device=grid.device) < ng // 2 + 1
    inv_k2 = torch.where((k2 > 0) & valid,
                         1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    green = -4.0 * math.pi * inv_k2
    if split_scale and split_scale > 0:
        green = green * torch.exp(-k2 * split_scale * split_scale)
    return pencil_irfftn(gk * pencil_block(green, mesh, axes), ng=ng,
                         mesh=mesh, axes=axes)
