"""Power-spectrum analysis in PyTorch (counterpart of
lambda_cdm_tpu/analysis/power_spectrum.py): NGP/CIC/TSC mass assignment
with periodic wrap, torch.fft.rfftn, window deconvolution, spherical
binning with Hermitian multiplicity, shot noise, multipoles, cross
spectra and sigma8 from a measured P(k), and the flat-sky angular spectra
of lensing maps (C_ell, and the E/B spectra of a shear map).

The deposits are scatter-adds (index_add_), as the JAX package's are, and
the binned sums are segment sums in float64.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..forces.pm import assignment_window
from ..physics.initial_conditions import fourier_grid
from ..physics.power_spectra import _tophat_window


@dataclasses.dataclass
class PowerSpectrumData:
    """Binned P(k) (fields as in the JAX package)."""
    k: torch.Tensor            # [nbins] bin-averaged k [h/Mpc]
    power: torch.Tensor        # [nbins] P(k) [(Mpc/h)^3], shot noise off
    power_raw: torch.Tensor    # [nbins] before shot-noise subtraction
    counts: torch.Tensor       # [nbins] modes per bin
    shot_noise: torch.Tensor   # [] V/N
    box_size: torch.Tensor     # []
    num_particles: torch.Tensor  # []


def _mesh_coords(positions, ng: int, box_size):
    """u = x / box * ng, dividing by a tensor (exact on every device)."""
    box = torch.tensor(float(box_size), dtype=positions.dtype,
                       device=positions.device)
    return positions / box * ng


def _deposit(flat_ids, weights, ng: int, like):
    grid = torch.zeros(ng ** 3, dtype=like.dtype, device=like.device)
    for ids, w in zip(flat_ids, weights):
        grid.index_add_(0, ids, w)
    return grid.reshape(ng, ng, ng)


def _weights(positions, weights):
    return (torch.ones(positions.shape[0], dtype=positions.dtype,
                       device=positions.device)
            if weights is None else weights)


def ngp_deposit(positions, ng: int, box_size, weights=None):
    """Nearest-grid-point deposit."""
    w = _weights(positions, weights)
    cell = torch.remainder(torch.floor(_mesh_coords(positions, ng,
                                                    box_size)).long(), ng)
    flat = (cell[:, 0] * ng + cell[:, 1]) * ng + cell[:, 2]
    return _deposit([flat], [w], ng, positions)


def cic_deposit(positions, ng: int, box_size, weights=None):
    """Cloud-in-cell (trilinear) deposit with periodic wrap, cell-centred
    convention (8 corners)."""
    w = _weights(positions, weights)
    u = _mesh_coords(positions, ng, box_size)
    i0 = torch.floor(u - 0.5)
    frac = (u - 0.5) - i0
    i0 = i0.long()
    ids, ws = [], []
    for dx in (0, 1):
        wx = 1.0 - frac[:, 0] if dx == 0 else frac[:, 0]
        ix = torch.remainder(i0[:, 0] + dx, ng)
        for dy in (0, 1):
            wy = 1.0 - frac[:, 1] if dy == 0 else frac[:, 1]
            iy = torch.remainder(i0[:, 1] + dy, ng)
            for dz in (0, 1):
                wz = 1.0 - frac[:, 2] if dz == 0 else frac[:, 2]
                iz = torch.remainder(i0[:, 2] + dz, ng)
                ids.append((ix * ng + iy) * ng + iz)
                ws.append(w * wx * wy * wz)
    return _deposit(ids, ws, ng, positions)


def tsc_deposit(positions, ng: int, box_size, weights=None):
    """Triangular-shaped-cloud deposit (27 points)."""
    w = _weights(positions, weights)
    u = _mesh_coords(positions, ng, box_size)
    ic = torch.floor(u)
    d = u - (ic + 0.5)                     # offset from the cell centre
    ic = ic.long()

    def w1d(dist):
        ad = torch.abs(dist)
        return torch.where(ad < 0.5, 0.75 - ad * ad,
                           torch.where(ad < 1.5, 0.5 * (1.5 - ad) ** 2,
                                       0.0))

    ids, ws = [], []
    for dx in (-1, 0, 1):
        wx = w1d(d[:, 0] - dx)
        ix = torch.remainder(ic[:, 0] + dx, ng)
        for dy in (-1, 0, 1):
            wy = w1d(d[:, 1] - dy)
            iy = torch.remainder(ic[:, 1] + dy, ng)
            for dz in (-1, 0, 1):
                wz = w1d(d[:, 2] - dz)
                iz = torch.remainder(ic[:, 2] + dz, ng)
                ids.append((ix * ng + iy) * ng + iz)
                ws.append(w * wx * wy * wz)
    return _deposit(ids, ws, ng, positions)


DEPOSITS = {"ngp": ngp_deposit, "cic": cic_deposit, "tsc": tsc_deposit}
_WINDOW_POWER = {"ngp": 1, "cic": 2, "tsc": 3}


def density_contrast(grid):
    """delta = rho / rho_bar - 1."""
    return grid / torch.clamp(torch.mean(grid), min=1e-30) - 1.0


def _hermitian_multiplicity(ng: int, device=None, dims: int = 3):
    """An rfft keeps only the last axis' k >= 0: every mode with
    0 < k < ng/2 there stands for itself and its conjugate ->
    [ng, ..., ng//2+1] weights over `dims` axes."""
    nz = ng // 2 + 1
    mult = torch.full((nz,), 2.0, device=device)
    mult[0] = 1.0
    if ng % 2 == 0:
        mult[nz - 1] = 1.0
    return mult.expand((ng,) * (dims - 1) + (nz,))


def _bin_reduce(rows, bin_idx, num_bins: int):
    """Sum `rows` [F, M] into [F, num_bins] by `bin_idx` (index num_bins
    is discarded): a segment sum per row, accumulated in float64."""
    out = torch.zeros((rows.shape[0], num_bins + 1), dtype=torch.float64,
                      device=rows.device)
    out.index_add_(1, bin_idx, rows.double())
    return out[:, :num_bins].to(rows.dtype)


def _log32(x, device):
    return torch.log(torch.as_tensor(x, dtype=torch.float32, device=device))


def _bin_index(kmag_flat, k_lo, k_hi, num_bins: int, log_bins: bool = True):
    """Closed-form uniform bin index in k or log k (float32, as the JAX
    package computes it). Out-of-range values, k == 0 included, land
    outside [0, num_bins)."""
    dev = kmag_flat.device
    if log_bins:
        k_safe = torch.clamp(kmag_flat, min=1e-30)
        lo = _log32(k_lo, dev)
        t = (torch.log(k_safe) - lo) / (_log32(k_hi, dev) - lo)
    else:
        lo = torch.as_tensor(k_lo, dtype=torch.float32, device=dev)
        hi = torch.as_tensor(k_hi, dtype=torch.float32, device=dev)
        t = (kmag_flat - lo) / (hi - lo)
    return torch.floor(t * num_bins).to(torch.int64)


def _binned(kmag, channels, k_lo, k_hi, num_bins: int, ng: int,
            log_bins: bool = True):
    """Hermitian-weighted bin sums of each [ng, ..., nz] channel (the
    shape of kmag: a 3D or a 2D rfft), then of |k| and of the weights ->
    (sums..., ksum, counts)."""
    flat_k = kmag.reshape(-1)
    bin_idx = _bin_index(flat_k, k_lo, k_hi, num_bins, log_bins=log_bins)
    valid = (bin_idx >= 0) & (bin_idx < num_bins) & (flat_k > 0)
    bin_idx = torch.where(valid, bin_idx, num_bins)
    wts = torch.where(valid, _hermitian_multiplicity(
        ng, kmag.device, kmag.dim()).reshape(-1), 0.0)
    rows = torch.stack([wts * c.reshape(-1) for c in channels]
                       + [wts * flat_k, wts])
    return _bin_reduce(rows, bin_idx, num_bins)


def _kf_knyq(ng, box_size):
    return 2.0 * math.pi / box_size, math.pi * ng / box_size


def power_from_delta(delta, *, ng: int, box_size, num_particles,
                     num_bins: int = 64, k_min=None, k_max=None,
                     assignment: str = "cic", deconvolve: bool = True,
                     log_bins: bool = True) -> PowerSpectrumData:
    """Spherically binned P(k) from a real-space density-contrast grid."""
    dev = delta.device
    volume = float(box_size) ** 3
    delta_k = torch.fft.rfftn(delta)
    if deconvolve:
        delta_k = delta_k / assignment_window(ng, box_size, assignment,
                                              device=dev)
    pk3d = (delta_k.real ** 2 + delta_k.imag ** 2) * (volume / float(ng)
                                                      ** 6)
    _, _, _, k2 = fourier_grid(ng, box_size, device=dev)
    kmag = torch.sqrt(k2)
    kf, knyq = _kf_knyq(ng, box_size)
    psum, ksum, counts = _binned(
        kmag, [pk3d], kf if k_min is None else k_min,
        knyq if k_max is None else k_max, num_bins, ng, log_bins)
    safe = torch.clamp(counts, min=1e-30)
    p_raw = psum / safe
    shot = volume / max(float(num_particles), 1.0)
    p_sub = torch.where(counts > 0, p_raw - shot, 0.0)

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return PowerSpectrumData(
        k=ksum / safe, power=p_sub, power_raw=p_raw, counts=counts,
        shot_noise=scalar(shot), box_size=scalar(float(box_size)),
        num_particles=torch.tensor(int(num_particles), device=dev))


def measure_power_spectrum(positions, box_size, ng: int = 128,
                           weights=None, num_bins: int = 64,
                           assignment: str = "cic",
                           subtract_shot_noise: bool = True,
                           deconvolve: bool = True,
                           k_min=None, k_max=None) -> PowerSpectrumData:
    """Particles -> P(k) in one call."""
    grid = DEPOSITS[assignment](positions, ng, box_size, weights)
    data = power_from_delta(
        density_contrast(grid), ng=ng, box_size=box_size,
        num_particles=positions.shape[0], num_bins=num_bins,
        assignment=assignment, deconvolve=deconvolve,
        k_min=k_min, k_max=k_max)
    if not subtract_shot_noise:
        data = dataclasses.replace(data, power=data.power_raw)
    return data


def cross_power_spectrum(positions_a, positions_b, box_size, ng: int = 128,
                         num_bins: int = 64, assignment: str = "cic"):
    """Cross-spectrum P_ab(k) -> (k, P_ab, counts)."""
    dev = positions_a.device
    da = density_contrast(DEPOSITS[assignment](positions_a, ng, box_size))
    db = density_contrast(DEPOSITS[assignment](positions_b, ng, box_size))
    volume = float(box_size) ** 3
    fa = torch.fft.rfftn(da)
    fb = torch.fft.rfftn(db)
    w = assignment_window(ng, box_size, assignment, device=dev)
    fa, fb = fa / w, fb / w
    pk3d = (fa * torch.conj(fb)).real * (volume / float(ng) ** 6)
    _, _, _, k2 = fourier_grid(ng, box_size, device=dev)
    kf, knyq = _kf_knyq(ng, box_size)
    psum, ksum, counts = _binned(torch.sqrt(k2), [pk3d], kf, knyq,
                                 num_bins, ng)
    safe = torch.clamp(counts, min=1e-30)
    return ksum / safe, psum / safe, counts


def _angular_modes(n: int, fov, device):
    """(lx [n, 1], ly [1, nz], fov, pix, default l_lo, default l_hi) of
    the 2D rfft of an [n, n] map over a fov x fov field (float32 0-d
    tensors: fov is taken as float32, as under the JAX jit)."""
    fov = torch.as_tensor(fov, dtype=torch.float32, device=device)
    pix = fov / n
    idx = torch.arange(n, device=device)
    lx = 2.0 * math.pi * torch.where(idx <= (n - 1) // 2, idx, idx - n) \
        / (n * pix)
    ly = 2.0 * math.pi * torch.arange(n // 2 + 1, device=device) / (n * pix)
    l_lo = torch.tensor(2.0 * math.pi, device=device) / fov
    # the default reach includes the corner modes (|l| up to sqrt 2 Nyq)
    l_hi = (torch.sqrt(torch.tensor(2.0, device=device)) * math.pi * n
            / fov) * (1 + 1e-6)
    return lx[:, None], ly[None, :], fov, pix, l_lo, l_hi


def angular_power_spectrum(map_a, fov, map_b=None, *, num_bins: int = 24,
                           ell_min=None, ell_max=None,
                           log_bins: bool = True):
    """Flat-sky angular (cross-)power spectrum C_ell of a square map.

    `map_a` (and optional `map_b` for a cross-spectrum) is [n, n] over a
    `fov` x `fov` (radians) field; returns (ell, C_ell, counts) with ell
    the bin-averaged multipole. Estimator: C_ell = |kappa_hat|^2 / Omega
    with kappa_hat = pix^2 DFT(map), Omega = fov^2; modes binned by |l|
    (log bins from 2 pi / fov to past the corner modes by default), the
    rfft half plane weighted by Hermitian multiplicity.
    """
    n = map_a.shape[-1]
    lx, ly, fov, pix, l_lo, l_hi = _angular_modes(n, fov, map_a.device)
    fa = torch.fft.rfft2(map_a)
    fb = fa if map_b is None else torch.fft.rfft2(map_b)
    p2 = pix * pix
    spec = (fa.real * fb.real + fa.imag * fb.imag) * (p2 * p2 / (fov * fov))
    lmag = torch.sqrt(lx ** 2 + ly ** 2)
    csum, lsum, counts = _binned(
        lmag, [spec], l_lo if ell_min is None else ell_min,
        l_hi if ell_max is None else ell_max, num_bins, n, log_bins)
    safe = torch.clamp(counts, min=1e-30)
    return lsum / safe, csum / safe, counts


def shear_eb_spectra(gamma1, gamma2, fov, *, num_bins: int = 24,
                     ell_min=None, ell_max=None, log_bins: bool = True):
    """Flat-sky E/B decomposition of a shear map -> (ell, C_EE, C_BB,
    C_EB, counts).

    E(l) = cos(2 phi_l) g1(l) + sin(2 phi_l) g2(l),
    B(l) = -sin(2 phi_l) g1(l) + cos(2 phi_l) g2(l), phi_l the mode angle.
    For shear derived from a scalar lensing potential C_EE = C_kappakappa
    and C_BB = 0. Same normalization and binning as
    angular_power_spectrum. Modes on the axis-Nyquist rows (|l_i| =
    pi n / fov, even n) have sign-ambiguous angles under the real FFT and
    leak ~0.4% of E into B in their bins: pass ell_max < pi n / fov for a
    clean null test.
    """
    n = gamma1.shape[-1]
    lx, ly, fov, pix, l_lo, l_hi = _angular_modes(n, fov, gamma1.device)
    g1 = torch.fft.rfft2(gamma1)
    g2 = torch.fft.rfft2(gamma2)
    lxg = lx.expand(n, n // 2 + 1)
    lyg = ly.expand(n, n // 2 + 1)
    l2 = torch.clamp(lxg ** 2 + lyg ** 2, min=1e-30)
    c2 = (lxg ** 2 - lyg ** 2) / l2          # cos(2 phi_l)
    s2 = 2.0 * lxg * lyg / l2                # sin(2 phi_l)
    e_re = c2 * g1.real + s2 * g2.real
    e_im = c2 * g1.imag + s2 * g2.imag
    b_re = -s2 * g1.real + c2 * g2.real
    b_im = -s2 * g1.imag + c2 * g2.imag
    p2 = pix * pix
    norm = p2 * p2 / (fov * fov)
    see = (e_re ** 2 + e_im ** 2) * norm
    sbb = (b_re ** 2 + b_im ** 2) * norm
    seb = (e_re * b_re + e_im * b_im) * norm
    lmag = torch.sqrt(lxg ** 2 + lyg ** 2)
    esum, bsum, xsum, lsum, counts = _binned(
        lmag, [see, sbb, seb], l_lo if ell_min is None else ell_min,
        l_hi if ell_max is None else ell_max, num_bins, n, log_bins)
    safe = torch.clamp(counts, min=1e-30)
    return lsum / safe, esum / safe, bsum / safe, xsum / safe, counts


def redshift_space_positions(positions, velocities, box_size, *,
                             scale_factor, hubble_internal_rate,
                             axis: int = 2):
    """Real -> redshift space along one line-of-sight axis:
    s = x + v_los / (a H) (plane parallel), periodic wrap."""
    s = positions.clone()
    s[:, axis] = s[:, axis] + velocities[:, axis] / (
        scale_factor * hubble_internal_rate)
    return torch.remainder(s, float(box_size))


def power_spectrum_multipoles(positions, box_size, *, ng: int = 128,
                              weights=None, num_bins: int = 32,
                              assignment: str = "cic", axis: int = 2):
    """P_l(k) for l = 0, 2, 4 by Legendre-weighted binning in
    mu = k_los/|k| -> (k [B], P_l [3, B], counts [B])."""
    dev = positions.device
    delta = density_contrast(DEPOSITS[assignment](positions, ng, box_size,
                                                  weights))
    volume = float(box_size) ** 3
    dk = torch.fft.rfftn(delta)
    dk = dk / assignment_window(ng, box_size, assignment, device=dev)
    pk3d = (dk.real ** 2 + dk.imag ** 2) * (volume / float(ng) ** 6)
    kx, ky, kz, k2 = fourier_grid(ng, box_size, device=dev)
    k_los = (kx, ky, kz)[axis].expand(pk3d.shape)
    mu2 = torch.where(k2 > 0, (k_los ** 2) / torch.where(k2 > 0, k2, 1.0),
                      0.0)
    leg2 = 0.5 * (3.0 * mu2 - 1.0)
    leg4 = 0.125 * (35.0 * mu2 * mu2 - 30.0 * mu2 + 3.0)
    kf, knyq = _kf_knyq(ng, box_size)
    s0, s2, s4, ksum, counts = _binned(
        torch.sqrt(k2), [pk3d, pk3d * leg2, pk3d * leg4], kf, knyq,
        num_bins, ng)
    safe = torch.clamp(counts, min=1e-30)
    return ksum / safe, torch.stack([s0 / safe, 5.0 * s2 / safe,
                                     9.0 * s4 / safe]), counts


def sigma8_from_power(data: PowerSpectrumData):
    """sigma8 from binned P(k): top-hat integral by the trapezoid rule
    over the (irregular) bin centres."""
    k, p, c = data.k, data.power, data.counts
    good = c > 0
    w = _tophat_window(k * 8.0)
    integrand = torch.where(good, k ** 2 * p * w * w, 0.0)
    tr = 0.5 * (integrand[1:] + integrand[:-1]) * torch.diff(k)
    s2 = torch.sum(torch.where(good[1:] & good[:-1], tr, 0.0)) / (
        2.0 * math.pi ** 2)
    return torch.sqrt(torch.clamp(s2, min=0.0))


def save_power_spectrum(path: str, data: PowerSpectrumData) -> None:
    """ASCII table: k, P(k), modes for the bins that hold modes."""
    k = data.k.detach().cpu().numpy()
    p = data.power.detach().cpu().numpy()
    c = data.counts.detach().cpu().numpy()
    with open(path, "w") as f:
        f.write("# k[h/Mpc]  P(k)[(Mpc/h)^3]  modes\n")
        f.write(f"# shot_noise = {float(data.shot_noise):.6e}\n")
        for i in range(k.shape[0]):
            if c[i] > 0:
                f.write(f"{k[i]:.6e} {p[i]:.6e} {c[i]:.0f}\n")
