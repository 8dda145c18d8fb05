"""Gravitational-lensing raytracer through the simulated density field, in
PyTorch (counterpart of lambda_cdm_tpu/raytracing/lensing.py):

  * 2D CIC projection of particles into surface-density lens planes,
  * Born-approximation convergence maps kappa(theta) from stacked planes,
  * lens potential / deflection / shear via 2D FFT Poisson,
  * multi-plane ray tracing: a bundle of rays deflected plane by plane,
    each ray sampling the plane's field stack bilinearly (K6/K7,
    ops/lens_sample.py, on the card), with the distortion-matrix Jacobian,
  * single-box and multi-snapshot light cones, and the Limber C_ell.

Units: comoving lengths in Mpc/h, c = 299792.458 km/s; angles in radians.
Every function runs where its tensors lie; float32 throughout.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import lens_sample
from ..physics.cosmology import (C_KM_S, CosmologyParams, as_f32,
                                 comoving_distance, scale_factor_at_chi)
from ..utils import prng


def _on_card(t) -> bool:
    """Whether `t` lies on a CUDA card: the route of the sampler (K6/K7
    there, the plain version on the CPU)."""
    return t.device.type == "cuda"


def _f32(x, device):
    """x as a float32 tensor on `device` (a 0-d tensor for a number)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Lens planes
# ---------------------------------------------------------------------------

def surface_density_plane(positions, masses, box_size, *, ng: int,
                          axis: int = 2, z_min=0.0, z_max=None):
    """Project particles with axis-coordinate in [z_min, z_max) into a 2D
    comoving surface-density map [ng, ng] (mass per (Mpc/h)^2) via 2D CIC
    (box_size, z_min and z_max taken as float32, as under the JAX jit)."""
    dev = positions.device
    box = _f32(box_size, dev)
    if z_max is None:
        z_max = box
    los = positions[:, axis]
    sel = (los >= _f32(z_min, dev)) & (los < _f32(z_max, dev))
    w = torch.where(sel, masses, 0.0)
    ij = [a for a in range(3) if a != axis]
    u = positions[:, ij] / box * ng
    i0 = torch.floor(u - 0.5)
    frac = (u - 0.5) - i0
    i0 = i0.long()
    grid = torch.zeros(ng * ng, dtype=positions.dtype, device=dev)
    for dx in (0, 1):
        wx = 1.0 - frac[:, 0] if dx == 0 else frac[:, 0]
        ix = torch.remainder(i0[:, 0] + dx, ng)
        for dy in (0, 1):
            wy = 1.0 - frac[:, 1] if dy == 0 else frac[:, 1]
            iy = torch.remainder(i0[:, 1] + dy, ng)
            grid.index_add_(0, ix * ng + iy, w * wx * wy)
    cell_area = (box / ng) ** 2
    return grid.reshape(ng, ng) / cell_area


def overdensity_plane(sigma):
    """delta_Sigma / Sigma_bar: dimensionless surface overdensity."""
    return sigma / torch.clamp(torch.mean(sigma), min=1e-30) - 1.0


# ---------------------------------------------------------------------------
# Convergence (Born approximation)
# ---------------------------------------------------------------------------

def lensing_efficiency(params: CosmologyParams, chi_l, chi_s, a_l):
    """Lensing kernel W = (3/2) (H0/c)^2 Omega_m chi_l (1 - chi_l/chi_s)/a_l
    (flat universe), every length in Mpc/h, where H0/c = 100/c per (Mpc/h)
    whatever h is."""
    h0_c = 100.0 / C_KM_S   # [h/Mpc] = per (Mpc/h)
    return (1.5 * h0_c * h0_c * params.omega_m
            * chi_l * (1.0 - chi_l / chi_s) / a_l)


def born_convergence(params: CosmologyParams, delta_planes, chi_planes,
                     d_chi, chi_source, a_planes):
    """kappa(theta) = sum_l W(chi_l) delta_l dchi over lens planes.

    delta_planes: [L, ng, ng] 3D overdensity averaged through each slab,
    chi_planes/a_planes: [L], d_chi: slab comoving thickness.
    """
    dev = delta_planes.device
    w = lensing_efficiency(params, as_f32(chi_planes).to(dev),
                           _f32(chi_source, dev), as_f32(a_planes).to(dev))
    return torch.tensordot(w * d_chi, delta_planes, dims=1)


# ---------------------------------------------------------------------------
# Potential / deflection / shear from kappa (2D FFT)
# ---------------------------------------------------------------------------

def _k2d(ng: int, extent, device):
    """(kx [ng, 1], ky [1, ng//2+1], k^2) for a 2D rfft of an ng^2 map of
    side `extent` (float32 throughout, 2 pi / extent rounded once)."""
    idx = torch.arange(ng, device=device)
    two_pi_l = _f32(2.0 * math.pi, device) / _f32(extent, device)
    kf = torch.where(idx <= (ng - 1) // 2, idx, idx - ng).float() * two_pi_l
    kr = torch.arange(ng // 2 + 1, device=device).float() * two_pi_l
    kx = kf[:, None]
    ky = kr[None, :]
    return kx, ky, kx * kx + ky * ky


def _psi_k(kappa, extent, ng: int):
    """(kx, ky, psi_k) with lap(psi) = 2 kappa (periodic, DC removed), over
    the last two dimensions of kappa."""
    kk = torch.fft.rfftn(kappa, dim=(-2, -1))
    kx, ky, k2 = _k2d(ng, extent, kappa.device)
    inv = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    return kx, ky, -2.0 * inv * kk


def _irfft2(x, ng: int):
    return torch.fft.irfftn(x, s=(ng, ng), dim=(-2, -1))


def lensing_potential(kappa, extent, *, ng: int):
    """psi with lap(psi) = 2 kappa (periodic, DC removed)."""
    _, _, psi_k = _psi_k(kappa, extent, ng)
    return _irfft2(psi_k, ng)


def deflection_from_kappa(kappa, extent, *, ng: int):
    """alpha = grad(psi) -> [2, ng, ng] (radians when kappa is the true
    convergence and `extent` the angular extent; a comoving displacement
    when extent is comoving). A leading batch dimension of kappa is kept:
    [B, ng, ng] -> [B, 2, ng, ng]."""
    kx, ky, psi_k = _psi_k(kappa, extent, ng)
    ax = _irfft2(1j * kx * psi_k, ng)
    ay = _irfft2(1j * ky * psi_k, ng)
    return torch.stack([ax, ay], dim=-3)


def second_derivs_from_kappa(kappa, extent, *, ng: int):
    """[3, ng, ng]: psi_xx, psi_xy, psi_yy of the potential with
    lap(psi) = 2 kappa: U = [[kappa+gamma1, gamma2], [gamma2,
    kappa-gamma1]], the distortion trace_rays propagates (a leading batch
    dimension is kept, as in deflection_from_kappa)."""
    kx, ky, psi_k = _psi_k(kappa, extent, ng)
    uxx = _irfft2(-(kx * kx) * psi_k, ng)
    uxy = _irfft2(-(kx * ky) * psi_k, ng)
    uyy = _irfft2(-(ky * ky) * psi_k, ng)
    return torch.stack([uxx, uxy, uyy], dim=-3)


def shear_from_kappa(kappa, extent, *, ng: int):
    """gamma1 = (psi_xx - psi_yy)/2, gamma2 = psi_xy -> [2, ng, ng]."""
    kx, ky, psi_k = _psi_k(kappa, extent, ng)
    g1 = _irfft2(-0.5 * (kx * kx - ky * ky) * psi_k, ng)
    g2 = _irfft2(-(kx * ky) * psi_k, ng)
    return torch.stack([g1, g2], dim=-3)


# ---------------------------------------------------------------------------
# Multi-plane raytracing
# ---------------------------------------------------------------------------

def bilinear_sample(field, xy, extent):
    """Periodic bilinear interpolation of an [ng, ng] (or [C, ng, ng])
    field at points xy [R, 2] in [0, extent)^2 -> [R] (or [C, R]); K6 on
    the card."""
    if field.dim() == 2:
        return lens_sample.bilinear_sample_fields(field[None], xy,
                                                  extent)[0]
    return lens_sample.bilinear_sample_fields(field, xy, extent)


def bilinear_sample_matmul(fields, xy, extent):
    """Bilinear sampling of a [F, ng, ng] field stack at xy [R, 2] ->
    [F, R]. The JAX package contracts one-hot weights on the TPU's matrix
    unit here; on this card and the CPU it is the gather (K6 on the
    card, its plain version on the CPU)."""
    return lens_sample.bilinear_sample_fields(fields, xy, extent)


@dataclasses.dataclass(frozen=True)
class RayBundle:
    """State of a ray bundle during multi-plane propagation."""
    theta: torch.Tensor       # [R, 2] current angular position [rad]
    beta: torch.Tensor        # [R, 2] current comoving transverse position
    kappa: torch.Tensor       # [R] accumulated convergence along each ray
    # set when trace_rays(jacobian=True): derived from the propagated
    # distortion matrix A = d(theta_final)/d(theta0)
    gamma: torch.Tensor | None = None       # [R, 2] ray-traced shear
    mu: torch.Tensor | None = None          # [R] magnification 1/det(A)
    omega: torch.Tensor | None = None       # [R] image rotation
    kappa_jac: torch.Tensor | None = None   # [R] 1 - tr(A)/2


def lens_plane_fields(params: CosmologyParams, delta_planes, chi_planes,
                      a_planes, d_chi, box_size, chi_source, *, ng: int,
                      jacobian: bool = False):
    """Per-plane field stacks [L, F, ng, ng] for trace_rays: comoving
    deflection (alpha_x, alpha_y), the overdensity, and (jacobian=True)
    the three potential second derivatives. Split out of trace_rays so
    callers can bound the deflections before tracing
    (auto_sample_window)."""
    dev = delta_planes.device
    w = lensing_efficiency(params, as_f32(chi_planes).to(dev),
                           _f32(chi_source, dev), as_f32(a_planes).to(dev))
    kappa_planes = (w * _f32(d_chi, dev))[:, None, None] * delta_planes
    parts = [deflection_from_kappa(kappa_planes, box_size, ng=ng),
             delta_planes[:, None]]
    if jacobian:
        parts.append(second_derivs_from_kappa(kappa_planes, box_size,
                                              ng=ng))
    return torch.cat(parts, dim=1).contiguous()


def auto_sample_window(fields_l, chi_planes, theta0, box_size,
                       *, ng: int, rt: int | None = None) -> int:
    """Provable per-tile x-span bound (grid cells) for the windowed ray
    sampler, or 0 when no useful bound holds (callers then use the
    full-field sampler).

    Any ray's angular wander is bounded by sum_l max|alpha_x,l| / chi_l
    (bilinear samples are convex combinations of grid values), so a tile
    of `rt` consecutive rays spans at most (theta0 tile span + 2 wander)
    * chi_max in comoving x. On the host: pulls L scalars off the device;
    call once per geometry.
    """
    if rt is None:
        rt = lens_sample.RT
    chis = np.asarray(torch.as_tensor(chi_planes).detach().cpu(),
                      dtype=np.float64)
    a_max = torch.amax(torch.abs(fields_l[:, 0]), dim=(1, 2))
    wander = float(np.sum(a_max.detach().cpu().numpy() / chis))  # radians
    tx = np.asarray(theta0[:, 0].detach().cpu(), dtype=np.float64)
    pad = (-len(tx)) % rt
    if pad:
        tx = np.concatenate([tx, np.repeat(tx[-1], pad)])
    tiles = tx.reshape(-1, rt)
    span0 = float((tiles.max(axis=1) - tiles.min(axis=1)).max())
    cell = float(box_size) / ng
    span_cells = (span0 + 2.0 * wander) * float(chis.max()) / cell
    window = int(np.ceil(span_cells)) + 10
    return window if window < ng else 0


def trace_rays(params: CosmologyParams, delta_planes, chi_planes, a_planes,
               d_chi, box_size, theta0, chi_source, *, ng: int,
               jacobian: bool = False, window: int = 0, fields_l=None):
    """Multi-plane raytracing (beyond Born): propagate a ray bundle through
    the lens planes, deflecting at each.

    delta_planes [L, ng, ng]: 3D overdensity per slab; theta0 [R, 2]
    initial angles (radians). Returns the RayBundle at the source plane:
    final angular positions, beta = theta chi_source, and the per-ray
    accumulated convergence.

    `jacobian=True` also propagates each ray's 2x2 distortion matrix
    A_{l+1} = (I - U_l(x_l)) A_l, U the sampled Hessian of the plane
    potential (Jain, Seljak & White 1997), giving the ray-traced shear
    gamma, magnification mu = 1/det(A), rotation omega and
    kappa_jac = 1 - tr(A)/2.

    Sampling: on the card each plane is one launch of the sampler
    kernel's plane step (ops/lens_sample.trace_planes: the impact
    position, the samples, the deflection, kappa and the Jacobian in one
    pass). `window > 0` samples the unwrapped impact positions theta *
    chi_l (K7's route), as the JAX package does on the TPU (the caller
    supplies a window honouring auto_sample_window's bound), and window 0
    the positions wrapped into the box (K6's). On the CPU the window is
    ignored and the positions are wrapped, as in the JAX package's CPU
    branch. `fields_l` optionally passes precomputed lens_plane_fields.
    """
    dev = theta0.device
    chi_planes = as_f32(chi_planes).to(dev)
    a_planes = as_f32(a_planes).to(dev)
    chi_source = _f32(chi_source, dev)
    if fields_l is None:
        fields_l = lens_plane_fields(params, delta_planes, chi_planes,
                                     a_planes, d_chi, box_size, chi_source,
                                     ng=ng, jacobian=jacobian)
    # every plane's lensing weight at once (elementwise: each keeps the
    # bits of its own call)
    weights = lensing_efficiency(params, chi_planes, chi_source, a_planes)
    out = lens_sample.trace_planes(
        fields_l, theta0, chi_planes, weights, d_chi, box_size, chi_source,
        jacobian=jacobian, window=window if _on_card(theta0) else 0)
    return RayBundle(**out)


# ---------------------------------------------------------------------------
# Lens planes from a snapshot (single-box light cone)
# ---------------------------------------------------------------------------

def snapshot_lightcone_planes(positions, masses, box_size, *, ng: int,
                              n_planes: int, axis: int = 2):
    """Slice one snapshot box into `n_planes` slabs along `axis` ->
    ([L, ng, ng] 3D-overdensity planes, slab thickness): one 3D CIC
    deposit summed per slab when ng % n_planes == 0, else a hard-cut 2D
    CIC per slab."""
    d_chi = box_size / n_planes
    rho_bar = torch.sum(masses) / box_size ** 3
    if ng % n_planes == 0:
        from ..analysis.power_spectrum import cic_deposit
        grid = cic_deposit(positions, ng, box_size, masses)
        sigma = torch.movedim(grid, axis, 0) \
            .reshape(n_planes, ng // n_planes, ng, ng).sum(dim=1)
        cell_area = (box_size / ng) ** 2
        return sigma / cell_area / (rho_bar * d_chi) - 1.0, d_chi
    planes = []
    for i in range(n_planes):
        sigma = surface_density_plane(
            positions, masses, box_size, ng=ng, axis=axis,
            z_min=i * d_chi, z_max=(i + 1) * d_chi)
        planes.append(sigma / (rho_bar * d_chi) - 1.0)
    return torch.stack(planes), d_chi


def limber_convergence_cl(params: CosmologyParams, ells, z_source,
                          *, n_chi: int = 256,
                          transfer: str = "eisenstein_hu"):
    """Theory C_ell^kappa-kappa in the Limber + flat-sky approximation from
    the linear matter power spectrum:

        C_ell = int_0^chi_s dchi W(chi)^2 / chi^2 P_lin((ell + 1/2)/chi,
                                                         z(chi))

    W = lensing_efficiency (all lengths Mpc/h), midpoint rule on a uniform
    chi grid of n_chi points. Runs on ells' device."""
    from ..physics.power_spectra import linear_power
    ells = as_f32(ells)
    dev = ells.device
    chi_s = comoving_distance(params, _f32(z_source, dev)) * params.h
    i = (torch.arange(n_chi, dtype=torch.float32, device=dev) + 0.5) / n_chi
    chi = chi_s * i
    d_chi = chi_s / n_chi
    a = scale_factor_at_chi(params, chi / params.h)
    z = 1.0 / a - 1.0
    w = lensing_efficiency(params, chi, chi_s, a)
    k = (ells[:, None] + 0.5) / chi[None, :]
    p = linear_power(params, k, z=z[None, :], transfer=transfer)
    return torch.sum((w / chi)[None, :] ** 2 * p, dim=1) * d_chi


def _plane_geometry(params, box_size, n_planes, d_chi, z_source, dev):
    """(chi_s, plane distances, plane scale factors) of the single-box
    light cone: the box centred between the observer and the source."""
    chi_s = comoving_distance(params, _f32(z_source, dev)) * params.h
    chi0 = 0.5 * torch.clamp(chi_s - box_size, min=0.0)
    chis = chi0 + (torch.arange(n_planes, dtype=torch.float32, device=dev)
                   + 0.5) * d_chi
    return chi_s, chis, scale_factor_at_chi(params, chis / params.h)


def convergence_map_from_state(state, params: CosmologyParams, box_size,
                               *, ng: int = 256, n_planes: int = 8,
                               z_source: float = 1.0, axis: int = 2):
    """One-call Born convergence map [ng, ng] from a simulation state, with
    per-plane scale factors from the background a(chi_l)."""
    planes, d_chi = snapshot_lightcone_planes(
        state.positions, state.masses, box_size, ng=ng, n_planes=n_planes,
        axis=axis)
    chi_s, chis, a_l = _plane_geometry(params, box_size, n_planes, d_chi,
                                       z_source, planes.device)
    return born_convergence(params, planes, chis, d_chi, chi_s, a_l)


def raytraced_maps_from_state(state, params: CosmologyParams, box_size,
                              *, ng: int = 256, n_planes: int = 8,
                              z_source: float = 1.0, axis: int = 2,
                              n_rays_side: int = 256):
    """One-call ray-traced weak-lensing maps from a simulation state:
    multi-plane propagation with Jacobians (trace_rays(jacobian=True)) on
    an n_rays_side^2 angular grid spanning the box at the first plane.
    Returns a dict of [n, n] maps: kappa (line-of-sight estimator),
    kappa_jac / gamma1 / gamma2 / mu / omega (from the Jacobian). On the
    card the plane fields are built first and the windowed sampler is
    bounded by auto_sample_window."""
    deltas, d_chi = snapshot_lightcone_planes(
        state.positions, state.masses, box_size, ng=ng, n_planes=n_planes,
        axis=axis)
    dev = deltas.device
    chi_s, chis, a_l = _plane_geometry(params, box_size, n_planes, d_chi,
                                       z_source, dev)
    ang = (torch.arange(n_rays_side, dtype=torch.float32, device=dev)
           + 0.5) * box_size / n_rays_side / chis[0]
    theta0 = torch.stack(torch.meshgrid(ang, ang, indexing="ij"),
                         -1).reshape(-1, 2)
    window = 0
    fields_l = None
    if _on_card(deltas):
        fields_l = lens_plane_fields(params, deltas, chis, a_l, d_chi,
                                     box_size, chi_s, ng=ng, jacobian=True)
        window = auto_sample_window(fields_l, chis, theta0, box_size, ng=ng)
    b = trace_rays(params, deltas, chis, a_l, d_chi, box_size, theta0,
                   chi_s, ng=ng, jacobian=True, window=window,
                   fields_l=fields_l)
    shp = (n_rays_side, n_rays_side)
    return {"kappa": b.kappa.reshape(shp),
            "kappa_jac": b.kappa_jac.reshape(shp),
            "gamma1": b.gamma[:, 0].reshape(shp),
            "gamma2": b.gamma[:, 1].reshape(shp),
            "mu": b.mu.reshape(shp),
            "omega": b.omega.reshape(shp)}


# ---------------------------------------------------------------------------
# Multi-snapshot light cone: observer -> source, tiled boxes
# ---------------------------------------------------------------------------

def _tile_shift(key, tile: int, box_size, device) -> torch.Tensor:
    """A box tile's random translation [3]: the JAX package's
    uniform(fold_in(key, tile), (3,), 0, box_size) for a PRNG key, the
    next 3 uniforms of a torch.Generator otherwise."""
    if prng.is_key(key):
        return prng.uniform(prng.fold_in(key, tile), (3,), 0.0, box_size,
                            device=device)
    return torch.rand(3, generator=key, device=key.device).to(device) \
        * box_size


def build_lightcone(snapshots, params: CosmologyParams, box_size, *,
                    ng: int, z_source: float = 1.0,
                    planes_per_box: int = 8, axis: int = 2,
                    randomize_key=None):
    """Stack several output snapshots into an observer -> source light
    cone.

    snapshots: (positions, masses, scale_factor) tuples or objects with
    those attributes, in any order. The line of sight [0, chi_source] is
    tiled with copies of the box; each lens plane (thickness
    box/planes_per_box) takes its density from the snapshot whose epoch
    is closest to the plane's background a(chi_l), and its lensing kernel
    uses a(chi_l) itself. `randomize_key` shifts each box tile by a
    random translation: with a PRNG key (utils/prng), the JAX package's
    uniform(fold_in(key, tile), (3,), 0, box_size); with a
    torch.Generator, one draw of 3 uniforms per tile, in tile order.

    Returns (delta_planes [L, ng, ng], chi_planes [L] Mpc/h,
    a_planes [L], d_chi).
    """
    def fields(s):
        if isinstance(s, tuple):
            return s
        return (s.positions, s.masses, s.scale_factor)

    snaps = [fields(s) for s in snapshots]
    dev = snaps[0][0].device
    a_snap = torch.tensor([float(a) for (_, _, a) in snaps],
                          dtype=torch.float32, device=dev)
    chi_s = float(comoving_distance(params, z_source)) * params.h  # Mpc/h
    d_chi = box_size / planes_per_box
    n_planes = max(math.ceil(np.float32(chi_s / d_chi)) - 1, 1)
    chis = (torch.arange(n_planes, dtype=torch.float32, device=dev)
            + 0.5) * d_chi
    a_l = scale_factor_at_chi(params, chis / params.h)

    shifts = {}
    planes = []
    for li in range(n_planes):
        chi_c = float(chis[li])
        tile = int(chi_c / box_size)           # which box copy
        local = chi_c - tile * box_size        # position within the box
        snap_i = int(torch.argmin(torch.abs(a_snap - a_l[li])))
        pos, mass, _ = snaps[snap_i]
        if randomize_key is not None:
            if tile not in shifts:
                shifts[tile] = _tile_shift(randomize_key, tile, box_size,
                                           dev)
            pos = torch.remainder(pos + shifts[tile], box_size)
        z_min = local - 0.5 * d_chi
        z_max = local + 0.5 * d_chi
        sigma = surface_density_plane(
            pos, mass, box_size, ng=ng, axis=axis,
            z_min=max(z_min, 0.0), z_max=min(z_max, box_size))
        rho_bar = torch.sum(mass) / box_size ** 3
        thickness = min(z_max, box_size) - max(z_min, 0.0)
        planes.append(sigma / (rho_bar * thickness) - 1.0)
    return torch.stack(planes), chis, a_l, d_chi
