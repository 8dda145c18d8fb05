"""K1 (CIC deposit) and K2 (fused CIC x fd4 gather) on cell-bucketed
particles: CUDA kernels with their plain PyTorch versions (counterpart of
lambda_cdm_tpu/ops/pallas_pm_rods.py).

Kernel sources: csrc/cic_deposit.cu, csrc/fd4_gather.cu. Each wrapper
launches its kernel for CUDA tensors (raising on anything the kernel
does not take) and runs the plain version only for CPU tensors. Inputs:
SoA bpos [3, C, K] float32, bmass [C, K] float32 and live-slot counts
[C] int32 of a live-first bucket layout.

Mesh coordinates are u = x * scale with scale = ng / box rounded once to
float32, as the TPU kernels compute them, so a kernel and its plain
version locate every particle identically.

Drop rule (both kernels, as on the TPU and in the CPU reference): a
particle's lower CIC corner i0 = floor(u - 0.5) must stay
inside its home cell's block window, 0 <= i0 - (c*ppc - (margin+1))
<= ell - 2 on every axis, ell = ppc + 2 (margin + 1). A live particle
outside it deposits nothing (counted in `dropped`) and gathers zero.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

# launches of each kernel since the last reset (the wrappers count a
# launch where they start the kernel, and nowhere else)
launches = {"cic_deposit": 0, "fd4_gather": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _check(bpos, bmass, counts, ncell):
    cc = ncell ** 3
    if bpos.ndim != 3 or bpos.shape[0] != 3 or bpos.shape[1] != cc:
        raise ValueError(f"bpos must be SoA [3, {cc}, K], got "
                         f"{tuple(bpos.shape)}")
    cap = bpos.shape[2]
    if bmass is not None and tuple(bmass.shape) != (cc, cap):
        raise ValueError(f"bmass must be [{cc}, {cap}]")
    if tuple(counts.shape) != (cc,):
        raise ValueError(f"counts must be [{cc}]")
    return cap


def _mesh_scale(ng, box_size) -> float:
    """ng / box as the float32 the kernels take."""
    return float(np.float32(ng / box_size))


def _inv_12h(ng, box_size) -> float:
    """1 / (12 h), h = box / ng, the fd4 difference's denominator."""
    return float(np.float32(ng / (12.0 * box_size)))


def _cic_corners(bpos, *, ncell, ng, box_size, margin):
    """(i0 [3, C, K] int64, frac [3, C, K], ok [C, K]) of the drop rule."""
    ppc = ng // ncell
    ell = ppc + 2 * (margin + 1)
    u = bpos * _mesh_scale(ng, box_size)
    f0 = torch.floor(u - 0.5)
    frac = (u - 0.5) - f0
    i0 = f0.to(torch.int64)
    c = torch.arange(ncell ** 3, device=bpos.device)
    cell = torch.stack([c // (ncell * ncell), (c // ncell) % ncell,
                        c % ncell])
    origin = cell * ppc - (margin + 1)                       # [3, C]
    il = i0 - origin[:, :, None]
    ok = torch.all((il >= 0) & (il <= ell - 2), dim=0)
    return i0, frac, ok


def _live_mask(counts, cap):
    return (torch.arange(cap, device=counts.device)[None, :]
            < counts[:, None])


def cic_deposit_plain(bpos, bmass, counts, *, ncell: int, ng: int,
                      box_size: float, margin: int = 1):
    """Plain PyTorch K1: (grid [ng, ng, ng], dropped 0-d int32)."""
    cap = _check(bpos, bmass, counts, ncell)
    i0, frac, ok = _cic_corners(bpos, ncell=ncell, ng=ng,
                                box_size=box_size, margin=margin)
    live = _live_mask(counts, cap)
    dropped = torch.sum(live & ~ok).to(torch.int32)
    w = torch.where(live & ok, bmass, 0.0)
    grid = torch.zeros(ng * ng * ng, dtype=torch.float32,
                       device=bpos.device)
    for dx in (0, 1):
        wx = frac[0] if dx else 1.0 - frac[0]
        ix = torch.remainder(i0[0] + dx, ng)
        for dy in (0, 1):
            wy = frac[1] if dy else 1.0 - frac[1]
            iy = torch.remainder(i0[1] + dy, ng)
            for dz in (0, 1):
                wz = frac[2] if dz else 1.0 - frac[2]
                iz = torch.remainder(i0[2] + dz, ng)
                flat = (ix * ng + iy) * ng + iz
                grid.index_add_(0, flat.reshape(-1),
                                ((wx * wy) * (wz * w)).reshape(-1))
    return grid.reshape(ng, ng, ng), dropped


def cic_deposit(bpos, bmass, counts, *, ncell: int, ng: int,
                box_size: float, margin: int = 1):
    """CIC mass deposit of live bucketed particles -> (grid [ng,ng,ng]
    float32, dropped 0-d int32). CUDA tensors launch K1
    (csrc/cic_deposit.cu, replacing pallas_pm_rods._deposit_kernel_occ);
    CPU tensors take cic_deposit_plain."""
    if bpos.device.type == "cpu":
        return cic_deposit_plain(bpos, bmass, counts, ncell=ncell, ng=ng,
                                 box_size=box_size, margin=margin)
    cap = _check(bpos, bmass, counts, ncell)
    cuda_build.require_cuda("cic_deposit", bpos, bmass, counts,
                            dtypes=(torch.float32, torch.float32,
                                    torch.int32))
    if ng % ncell:
        raise ValueError(f"PM grid {ng} must be a multiple of ncell {ncell}")
    grid = torch.zeros((ng, ng, ng), dtype=torch.float32,
                       device=bpos.device)
    dropped = torch.zeros((), dtype=torch.int32, device=bpos.device)
    launches["cic_deposit"] += 1
    cuda_build.launch("lcdm_cic_deposit", bpos.data_ptr(),
                      bmass.data_ptr(), counts.data_ptr(), grid.data_ptr(),
                      dropped.data_ptr(), ncell, cap, ng, margin,
                      _mesh_scale(ng, box_size))
    return grid, dropped


def fd4_gather_plain(phi, bpos, counts, *, ncell: int, ng: int,
                     box_size: float, margin: int = 1):
    """Plain PyTorch K2: the three fd4 gradient grids by rolls, CIC
    gathered with the drop-rule mask -> accelerations [3, C, K] (unit
    g_const), zero on dead and dropped slots."""
    cap = _check(bpos, None, counts, ncell)
    inv_12h = _inv_12h(ng, box_size)
    fields = [-(8.0 * (torch.roll(phi, -1, ax) - torch.roll(phi, 1, ax))
                - (torch.roll(phi, -2, ax) - torch.roll(phi, 2, ax)))
              * inv_12h for ax in range(3)]
    flat = torch.stack(fields).reshape(3, -1)
    i0, frac, ok = _cic_corners(bpos, ncell=ncell, ng=ng,
                                box_size=box_size, margin=margin)
    mask = (_live_mask(counts, cap) & ok).to(torch.float32)
    acc = torch.zeros_like(bpos)
    for dx in (0, 1):
        wx = frac[0] if dx else 1.0 - frac[0]
        ix = torch.remainder(i0[0] + dx, ng)
        for dy in (0, 1):
            wy = frac[1] if dy else 1.0 - frac[1]
            iy = torch.remainder(i0[1] + dy, ng)
            for dz in (0, 1):
                wz = frac[2] if dz else 1.0 - frac[2]
                iz = torch.remainder(i0[2] + dz, ng)
                idx = ((ix * ng + iy) * ng + iz).reshape(-1)
                vals = flat[:, idx].reshape(3, *bpos.shape[1:])
                acc = acc + vals * ((wx * wy) * (wz * mask))
    return acc


def fd4_gather(phi, bpos, counts, *, ncell: int, ng: int, box_size: float,
               margin: int = 1):
    """-(fd4 gradient of phi) CIC-interpolated at every live slot ->
    [3, C, K] float32 (unit g_const). CUDA tensors launch K2
    (csrc/fd4_gather.cu, replacing pallas_pm_rods._gather_kernel_occ);
    CPU tensors take fd4_gather_plain."""
    if bpos.device.type == "cpu":
        return fd4_gather_plain(phi, bpos, counts, ncell=ncell, ng=ng,
                                box_size=box_size, margin=margin)
    cap = _check(bpos, None, counts, ncell)
    cuda_build.require_cuda("fd4_gather", phi, bpos, counts,
                            dtypes=(torch.float32, torch.float32,
                                    torch.int32))
    if tuple(phi.shape) != (ng, ng, ng):
        raise ValueError(f"phi must be [{ng}, {ng}, {ng}]")
    if ng % ncell:
        raise ValueError(f"PM grid {ng} must be a multiple of ncell {ncell}")
    out = torch.zeros_like(bpos)
    launches["fd4_gather"] += 1
    cuda_build.launch("lcdm_fd4_gather", phi.data_ptr(), bpos.data_ptr(),
                      counts.data_ptr(), out.data_ptr(), ncell, cap, ng,
                      margin, _mesh_scale(ng, box_size),
                      _inv_12h(ng, box_size))
    return out
