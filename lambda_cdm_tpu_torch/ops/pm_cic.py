"""The stateless PM force on unbucketed particles: CUDA kernels
(csrc/pm_cic.cu) with their plain PyTorch versions.

    cic_scatter     grid = sum over particles of m w_x w_y w_z at the 8
                    corners of each cell-centred CIC stencil (unscaled;
                    analysis/power_spectrum.cic_deposit with the masses)
    green_gradient  -i k_axis (G rho_k): one component of the potential's
                    spectral gradient
    cic_gather3     acc = scale * the three fields CIC-gathered at the
                    positions (cic_gather of each), [N, 3]
    pm_forces       the force: cic_scatter, rfftn, three green_gradient
                    and irfftn, cic_gather3

on positions [N, 3] and masses [N] float32 in [0, box), fields and grids
[ng, ng, ng] float32, half spectra [ng, ng, ng//2+1] complex64.

Each wrapper checks its tensors (dtypes, shapes, contiguous, one device),
runs the plain version for CPU tensors, launches its kernel for CUDA
tensors and raises on any other device. A kernel computes each term as
its plain version rounds it (see csrc/pm_cic.cu); the scatter's float
atomics sum a grid point's terms in another order. Each launch counts in
`launches`.

`pm_forces` on CPU tensors, or with `plain` on any device, is the plain
chain of forces/pm.py, bit for bit: the density divided by the cell
volume before the r2c, each c2r scaled by 1/ng^3, the gathered fields
times g, then times the modified-gravity factor. On CUDA tensors the
scatter adds the masses unscaled, the c2r are unnormalised
(norm="forward"), and 1/cell volume, 1/ng^3, g and the factor are one
scale that the gather applies as it writes; each field is made just
before its c2r, so one half spectrum of gradient lives at a time beside
rho_k. This module decides the route; its callers pass CPU or CUDA
tensors alike.
"""

from __future__ import annotations

import functools

import torch

from ..utils.profiling import span
from . import cuda_build

# launches of each kernel since the last reset
launches = {"pm_cic_scatter": 0, "pm_green_gradient": 0,
            "pm_cic_gather3": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _launch(kernel: str, *args) -> None:
    """Start `kernel` (the one place a launch is counted)."""
    launches[kernel] += 1
    cuda_build.launch(f"lcdm_{kernel}", *args)


def _check(name, tensors, specs, dense=0) -> torch.device:
    """Raise unless each tensor has its spec's (dtype, shape), is
    contiguous (the first `dense` ones: dense in any order of their
    dimensions) and lies with the others on one CPU or CUDA device."""
    dev = tensors[0].device
    for i, (t, (dtype, shape)) in enumerate(zip(tensors, specs)):
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: argument {i} must be {dtype} "
                             f"{list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
        if not (_dense(t) if i < dense else t.is_contiguous()):
            raise ValueError(f"{name}: argument {i} must be "
                             + ("dense" if i < dense else "contiguous"))
        if t.device != dev:
            raise ValueError(f"{name}: argument {i} must be on {dev}, got "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev}: the plain version "
                         "takes CPU tensors, the kernel CUDA tensors")
    return dev


def _particles(name, positions, masses=None):
    n = positions.shape[0] if positions.ndim == 2 else -1
    tensors = (positions,) if masses is None else (positions, masses)
    specs = [(torch.float32, (n, 3)), (torch.float32, (n,))]
    return _check(name, tensors, specs)


def cic_scatter_plain(positions, masses, ng: int, box_size: float):
    from ..analysis.power_spectrum import cic_deposit
    return cic_deposit(positions, ng, box_size, weights=masses)


def cic_scatter(positions, masses, ng: int, box_size: float):
    """The unscaled CIC mass grid [ng, ng, ng]: a zeroed grid and one
    launch on CUDA tensors, cic_scatter_plain on CPU tensors."""
    dev = _particles("cic_scatter", positions, masses)
    if dev.type == "cpu":
        return cic_scatter_plain(positions, masses, ng, box_size)
    grid = torch.zeros((ng, ng, ng), dtype=torch.float32, device=dev)
    _launch("pm_cic_scatter", positions.data_ptr(), masses.data_ptr(),
            grid.data_ptr(), positions.shape[0], ng, float(box_size))
    return grid


@functools.lru_cache(maxsize=8)
def _rfftn_strides(ng: int, device: str) -> tuple:
    return torch.fft.rfftn(torch.zeros((ng,) * 3, device=device)).stride()


def like_rfftn(x):
    """x [ng, ng, ng//2+1] in the layout torch.fft.rfftn gives the half
    spectrum of an [ng, ng, ng] grid on x's device (a permutation of the
    dimensions on the card, contiguous on the CPU): x itself where it has
    it, else a copy."""
    strides = _rfftn_strides(x.shape[0], str(x.device))
    if x.stride() == strides:
        return x
    out = torch.empty_strided(x.shape, strides, dtype=x.dtype,
                              device=x.device)
    return out.copy_(x)


def _dense(t) -> bool:
    """Whether t's elements fill its storage without gaps or overlaps
    (a permutation of a contiguous layout)."""
    expect = 1
    for size, stride in sorted(zip(t.shape, t.stride()),
                               key=lambda p: p[1]):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def green_gradient_plain(rho_k, green, k, axis: int):
    shape = [1, 1, 1]
    shape[axis] = -1
    return -1j * k.reshape(shape) * (green * rho_k)


def green_gradient(rho_k, green, k, axis: int):
    """-i k_axis G rho_k -> a new half spectrum in rho_k's layout; rho_k
    and green share one dense layout (rfftn's: like_rfftn); k is the
    axis's 1-D wavevector (fourier_grid's kx, ky or kz, any shape of its
    values)."""
    if axis not in (0, 1, 2):
        raise ValueError(f"green_gradient: axis {axis} not in 0, 1, 2")
    ng = rho_k.shape[0]
    nh = ng // 2 + 1
    k = k.reshape(-1)
    dev = _check("green_gradient", (rho_k, green, k),
                 [(torch.complex64, (ng, ng, nh)),
                  (torch.float32, (ng, ng, nh)),
                  (torch.float32, (nh if axis == 2 else ng,))],
                 dense=2)
    if green.stride() != rho_k.stride():
        raise ValueError(f"green_gradient: green's strides {green.stride()}"
                         f" differ from rho_k's {rho_k.stride()}")
    if dev.type == "cpu":
        return green_gradient_plain(rho_k, green, k, axis)
    out = torch.empty_strided(rho_k.shape, rho_k.stride(),
                              dtype=rho_k.dtype, device=dev)
    _launch("pm_green_gradient", rho_k.data_ptr(), green.data_ptr(),
            k.data_ptr(), out.data_ptr(), ng, nh, *rho_k.stride(), axis)
    return out


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


def cic_gather3_plain(fields, positions, ng: int, box_size: float,
                      scale: float):
    return scale * torch.stack([cic_gather(f, positions, ng, box_size)
                                for f in fields], dim=-1)


def cic_gather3(fields, positions, ng: int, box_size: float,
                scale: float = 1.0):
    """scale * the three fields [ng, ng, ng] CIC-gathered at the
    positions -> [N, 3]: one launch on CUDA tensors, cic_gather3_plain on
    CPU tensors."""
    if len(fields) != 3:
        raise ValueError(f"cic_gather3: 3 fields, got {len(fields)}")
    n = positions.shape[0] if positions.ndim == 2 else -1
    dev = _check("cic_gather3", (positions,) + tuple(fields),
                 [(torch.float32, (n, 3))]
                 + [(torch.float32, (ng, ng, ng))] * 3)
    if dev.type == "cpu":
        return cic_gather3_plain(fields, positions, ng, box_size, scale)
    acc = torch.empty_like(positions)
    _launch("pm_cic_gather3", positions.data_ptr(), fields[0].data_ptr(),
            fields[1].data_ptr(), fields[2].data_ptr(), acc.data_ptr(),
            positions.shape[0], ng, float(box_size), float(scale))
    return acc


@functools.lru_cache(maxsize=8)
def cell_volume(ng: int, box_size: float) -> float:
    """(box / ng)^3 rounded as the plain chain rounds it (float32)."""
    box = torch.tensor(float(box_size), dtype=torch.float32)
    return float((box / ng) ** 3)


def pm_forces(positions, masses, ng: int, box_size: float, g_const,
              green, kvecs, factor: float = 1.0, *, plain: bool = False):
    """PM accelerations [N, 3]: CIC density, rfftn, the Green's function
    `green` and the wavevectors `kvecs` (kx, ky, kz of fourier_grid), the
    three irfftn, CIC gather, times g_const and then `factor`. The
    kernels on CUDA tensors unless `plain` (the plain chain there: the
    kernels' reference on the card). Spans `pm.deposit`, `pm.solve`,
    `pm.gather` (utils/profiling)."""
    card = positions.is_cuda
    kernels = card and not plain
    positions, masses = positions.contiguous(), masses.contiguous()
    cv = cell_volume(ng, float(box_size))
    with span("pm.deposit", device=card):
        if kernels:
            grid = cic_scatter(positions, masses, ng, box_size)
        else:
            grid = cic_scatter_plain(positions, masses, ng, box_size) / cv
    with span("pm.solve", device=card):
        rho_k = torch.fft.rfftn(grid)
        del grid
        gradient = green_gradient if kernels else green_gradient_plain
        fields = [torch.fft.irfftn(gradient(rho_k, green, k, axis),
                                   s=(ng, ng, ng),
                                   norm="forward" if kernels else "backward")
                  for axis, k in enumerate(kvecs)]
    with span("pm.gather", device=card):
        if kernels:
            return cic_gather3(fields, positions, ng, box_size,
                               float(g_const) * float(factor)
                               / (cv * ng ** 3))
        return factor * cic_gather3_plain(fields, positions, ng, box_size,
                                          g_const)
