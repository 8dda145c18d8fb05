"""The Ewald-summed periodic force oracle in float64 PyTorch (counterpart
of lambda_cdm_tpu/forces/ewald.py), on the device its inputs lie on.

Min-image direct sums are not periodic gravity: they keep only each
source's nearest image. This oracle sums every image (tinfoil boundary,
uniform background subtracted):

    acc(x) = acc_real(x) + acc_k(x)
    acc_real = G sum_j m_j sum_n d_jn/r^3 [erfc(a r) + 2ar/sqrt(pi)
               e^{-a^2 r^2}],   d_jn = x_j + nL - x
    acc_k    = (4 pi G / L^3) sum_{k != 0} (k/k^2) e^{-k^2/4a^2}
               [S_s(k) cos(k.x) - S_c(k) sin(k.x)],
               S_c + i S_s = sum_j m_j e^{i k.x_j}

with the JAX module's choices: the k sphere 0 < |n| <= nmax (`_kvectors`),
the structure factor by per-axis phase powers over source chunks,
`(2 nreal + 1)^3` real-space image shells around the minimum image, the
Plummer softening as the exact near-field correction on the min-image
pass, and mass == 0 rows inert (r^2 > 1e-24 drops the self pair).

On the card it serves where the JAX oracle cannot run (a host without
JAX): 512 targets against 1M sources go in chunks of `target_chunk`
targets ([chunk, N, 3] float64 tensors) and `source_chunk` sources
([chunk, K] complex128 phases), both sized for the card's memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _kvectors(box: float, nmax: int):
    """Integer lattice k-vectors with 0 < |n|^2 <= nmax^2 (numpy, host).
    Returns (kvec [K,3] float, nvec [K,3] int)."""
    r = np.arange(-nmax, nmax + 1)
    n = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    n2 = np.sum(n * n, axis=1)
    keep = (n2 > 0) & (n2 <= nmax * nmax)
    n = n[keep]
    return (2.0 * np.pi / box) * n.astype(np.float64), n.astype(np.int32)


def _structure_factor(pos, mass, box: float, nvec, nmax: int,
                      source_chunk: int):
    """(S_c(k), S_s(k)): sum_j m_j e^{i k.x_j} over all sources, a chunk
    of sources at a time; e^{i k.x} is the product of the per-axis phase
    powers cx[|nx|] cy[|ny|] cz[|nz|], conjugated for negative n."""
    two_pi = 2.0 * math.pi / box
    nabs = nvec.abs().long()
    nneg = nvec < 0
    s = torch.zeros(nvec.shape[0], dtype=torch.complex128, device=pos.device)
    for i0 in range(0, pos.shape[0], source_chunk):
        p = pos[i0:i0 + source_chunk]
        m = mass[i0:i0 + source_chunk]
        base = torch.polar(torch.ones_like(p), two_pi * p)     # [C, 3]
        pows = [torch.ones_like(base)]
        for _ in range(nmax):
            pows.append(pows[-1] * base)
        pw = torch.stack(pows, dim=-1)                         # [C, 3, nmax+1]
        f = None
        for ax in range(3):
            fa = pw[:, ax][:, nabs[:, ax]]                     # [C, K]
            fa = torch.where(nneg[None, :, ax], fa.conj(), fa)
            f = fa if f is None else f * fa
        s += torch.sum(m.to(torch.complex128)[:, None] * f, dim=0)
    return s.real, s.imag


def ewald_accelerations(positions, masses, targets, box_size,
                        softening=0.0, g_const=1.0, *, alpha=None,
                        nmax: int = 8, nreal: int = 0,
                        source_chunk: int = 16384,
                        target_chunk: int = 64) -> torch.Tensor:
    """Periodic (Ewald-summed) accelerations at the `targets` rows,
    float64 [T, 3], on the device of `positions`.

    positions [N, 3], masses [N] (mass == 0 rows are inert padding),
    targets [T] int; alpha defaults to 6/L (erfc(3) at the min-image
    edge). The JAX oracle's parameters and units (G sum m d / r^3);
    `source_chunk` defaults smaller there for the card's memory."""
    box = float(box_size)
    a = 6.0 / box if alpha is None else float(alpha)
    soft2 = float(softening) ** 2
    pos = torch.as_tensor(positions).to(torch.float64)
    dev = pos.device
    mass = torch.as_tensor(masses).to(device=dev, dtype=torch.float64)
    tgt = torch.as_tensor(targets).to(device=dev, dtype=torch.int64)
    kv, nv = _kvectors(box, nmax)
    kvec = torch.as_tensor(kv, device=dev)                     # [K, 3]
    nvec = torch.as_tensor(nv, device=dev)
    k2 = torch.sum(kvec * kvec, dim=1)
    kcoef = (4.0 * math.pi / box ** 3) * torch.exp(-k2 / (4 * a * a)) / k2
    s_c, s_s = _structure_factor(pos, mass, box, nvec, nmax,
                                 int(source_chunk))
    r = np.arange(-nreal, nreal + 1)
    shells = torch.as_tensor(
        np.stack(np.meshgrid(r, r, r, indexing="ij"), -1)
        .reshape(-1, 3).astype(np.float64) * box, device=dev)  # [S, 3]
    # a 0-d divisor: the true quotient on every device
    box_t = torch.tensor(box, dtype=torch.float64, device=dev)
    two_a_sqrt_pi = 2.0 * a / math.sqrt(math.pi)
    out = []
    for t0 in range(0, tgt.shape[0], int(target_chunk)):
        pt = pos[tgt[t0:t0 + int(target_chunk)]]               # [T, 3]
        ph = pt @ kvec.T                                       # [T, K]
        acc = (kcoef * (s_s * torch.cos(ph) - s_c * torch.sin(ph))) @ kvec
        d0 = pos[None, :, :] - pt[:, None, :]                  # [T, N, 3]
        d0 = d0 - box_t * torch.round(d0 / box_t)
        for shift in shells:
            d = d0 + shift
            r2 = torch.sum(d * d, dim=-1)
            live = (mass > 0) & (r2 > 1e-24)
            rr = torch.sqrt(torch.where(live, r2, 1.0))
            screen = (torch.special.erfc(a * rr) / (rr * r2)
                      + two_a_sqrt_pi * torch.exp(-a * a * r2) / r2)
            w = torch.where(live, mass * screen, 0.0)
            acc = acc + torch.sum(w[..., None] * d, dim=1)
        r2 = torch.sum(d0 * d0, dim=-1)
        live = (mass > 0) & (r2 > 1e-24)
        rs2 = torch.where(live, r2, 1.0)
        corr = (rs2 + soft2) ** -1.5 - rs2 ** -1.5
        w = torch.where(live, mass * corr, 0.0)
        out.append(acc + torch.sum(w[..., None] * d0, dim=1))
    return float(g_const) * torch.cat(out)


def min_image_accelerations(positions, masses, targets, box_size,
                            softening=0.0, g_const=1.0, *,
                            target_chunk: int = 16) -> torch.Tensor:
    """The min-image float64 direct sum at the `targets` rows (the old
    oracle, kept so that its systematic against Ewald is a number):
    Plummer-softened, a row's own pair dropped by r^2 <= eps^2."""
    box = float(box_size)
    soft2 = float(softening) ** 2
    pos = torch.as_tensor(positions).to(torch.float64)
    dev = pos.device
    mass = torch.as_tensor(masses).to(device=dev, dtype=torch.float64)
    tgt = torch.as_tensor(targets).to(device=dev, dtype=torch.int64)
    box_t = torch.tensor(box, dtype=torch.float64, device=dev)
    out = []
    for t0 in range(0, tgt.shape[0], int(target_chunk)):
        pt = pos[tgt[t0:t0 + int(target_chunk)]]
        dx = pos[None, :, :] - pt[:, None, :]
        dx = dx - box_t * torch.round(dx / box_t)
        r2 = torch.sum(dx * dx, dim=-1) + soft2
        inv_r3 = torch.where(r2 <= soft2 + 1e-300, 0.0, r2 ** -1.5)
        out.append(torch.sum((mass * inv_r3)[..., None] * dx, dim=1))
    return float(g_const) * torch.cat(out)
