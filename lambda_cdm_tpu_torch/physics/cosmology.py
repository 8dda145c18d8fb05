"""Lambda-CDM background cosmology in PyTorch (counterpart of
lambda_cdm_tpu/physics/cosmology.py): expansion, growth, and the
distances and times the lensing path needs.

Every function takes a scale factor (or redshift, or distance) as a
Python float or a tensor and returns a float32 tensor on that tensor's
device, evaluated in the same operation order as the JAX reference so the
two agree to float32 round-off.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# Newton's constant in (Mpc/h) (km/s)^2 / (1e10 Msun/h)
G_GADGET_MPC = 43.0071057317063
# speed of light in km/s
C_KM_S = 299792.458
# 1/H0 in Gyr for H0 = 1 km/s/Mpc: Mpc in km over a Julian Gyr in s
_H_INV_TO_GYR = 3.0856775814913673e19 / 3.1556952e16


@dataclasses.dataclass(frozen=True)
class CosmologyParams:
    """Cosmological parameters as plain floats (defaults as in the JAX
    package)."""

    omega_m: float = 0.31
    omega_lambda: float = 0.69
    omega_b: float = 0.049
    omega_k: float = 0.0
    omega_r: float = 0.0
    h: float = 0.67
    sigma8: float = 0.81
    n_s: float = 0.965
    w0: float = -1.0
    wa: float = 0.0
    t_cmb: float = 2.7255

    @property
    def h0(self):
        """H0 in km/s/Mpc."""
        return 100.0 * self.h

    def validate(self) -> None:
        total = float(self.omega_m) + float(self.omega_lambda) \
            + float(self.omega_k) + float(self.omega_r)
        if abs(total - 1.0) > 1e-4:
            raise ValueError(
                f"Omega_m+Omega_lambda+Omega_k+Omega_r = {total} != 1")
        if float(self.omega_b) > float(self.omega_m):
            raise ValueError("omega_b must be <= omega_m")
        if not (0.2 < float(self.h) < 1.5):
            raise ValueError(f"h = {float(self.h)} out of sane range")


PLANCK = CosmologyParams()


def as_f32(x) -> torch.Tensor:
    """A float32 tensor of `x`, kept on x's device when x is a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32)


def de_density_evolution(params: CosmologyParams, a):
    """rho_DE(a)/rho_DE(1) for CPL (w0, wa). Equals 1 for LCDM."""
    a = as_f32(a)
    return a ** (-3.0 * (1.0 + params.w0 + params.wa)) * torch.exp(
        -3.0 * params.wa * (1.0 - a))


def e2_function(params: CosmologyParams, a):
    """E^2(a) = H^2(a)/H0^2."""
    a = as_f32(a)
    return (params.omega_r * a ** -4
            + params.omega_m * a ** -3
            + params.omega_k * a ** -2
            + params.omega_lambda * de_density_evolution(params, a))


def e_function(params: CosmologyParams, a):
    """E(a) = H(a)/H0."""
    return torch.sqrt(e2_function(params, a))


def hubble(params: CosmologyParams, a):
    """H(a) in km/s/Mpc."""
    return params.h0 * e_function(params, a)


def omega_m_a(params: CosmologyParams, a):
    """Omega_m(a) = Omega_m a^-3 / E^2(a)."""
    a = as_f32(a)
    return params.omega_m * a ** -3 / e2_function(params, a)


def omega_lambda_a(params: CosmologyParams, a):
    return (params.omega_lambda * de_density_evolution(params, a)
            / e2_function(params, a))


def _cpt92_g(params: CosmologyParams, a):
    """Carroll, Press & Turner (1992) growth suppression factor g(a)."""
    om = omega_m_a(params, a)
    ol = omega_lambda_a(params, a)
    return 2.5 * om / (om ** (4.0 / 7.0) - ol
                       + (1.0 + om / 2.0) * (1.0 + ol / 70.0))


def growth_factor(params: CosmologyParams, a):
    """Linear growth factor D(a), CPT92 approximation, D(1) = 1."""
    a = as_f32(a)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    return a * _cpt92_g(params, a) / _cpt92_g(params, one)


def growth_rate(params: CosmologyParams, a):
    """f(a) = dlnD/dlna ~= Omega_m(a)^0.55."""
    return omega_m_a(params, a) ** 0.55


def growth_factor_exact(params: CosmologyParams, a, *, n_steps: int = 256):
    """ODE-exact linear growth factor, D(1) = 1: the growth ODE in x = ln a,
        D'' + (2 + dlnH/dlna) D' = (3/2) Omega_m(a) D,
    from D = D' = a at a = 1e-3 by fixed-step RK4 in float32, as the JAX
    package integrates it, interpolated in ln a (on the CPU; the result
    goes to a's device)."""
    a = as_f32(a)
    x0 = as_f32(math.log(1e-3))
    x1 = torch.log(torch.clamp(torch.max(a.cpu()), min=1.0))
    dx = (x1 - x0) / n_steps

    def dlnh_dlna(x):
        aa = torch.exp(x)
        de2 = (-4.0 * params.omega_r * aa ** -4
               - 3.0 * params.omega_m * aa ** -3
               - 2.0 * params.omega_k * aa ** -2
               + params.omega_lambda * (
                   de_density_evolution(params, aa)
                   * (-3.0 * (1.0 + params.w0 + params.wa)
                      + 3.0 * params.wa * aa)))
        return 0.5 * de2 / e2_function(params, aa)

    def rhs(x, state):
        d, dp = state[0], state[1]
        om = omega_m_a(params, torch.exp(x))
        return torch.stack([dp, 1.5 * om * d - (2.0 + dlnh_dlna(x)) * dp])

    state = torch.stack([torch.exp(x0), torch.exp(x0)])
    d_grid = []
    for i in range(n_steps):
        x = x0 + dx * i
        k1 = rhs(x, state)
        k2 = rhs(x + dx / 2, state + dx / 2 * k1)
        k3 = rhs(x + dx / 2, state + dx / 2 * k2)
        k4 = rhs(x + dx, state + dx * k3)
        state = state + dx / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        d_grid.append(state[0])
    d_grid = torch.stack(d_grid)
    grid_x = x0 + dx * (1 + torch.arange(n_steps, dtype=torch.float32))
    d_at = _interp(torch.log(a.cpu()).reshape(-1), grid_x, d_grid)
    d_one = _interp(torch.zeros(1), grid_x, d_grid)
    return (d_at / d_one).reshape(a.shape).to(a.device)


def _gauss_legendre(n: int):
    """128-point nodes and weights on [-1, 1] as float32 tensors (the
    JAX package holds them as float32 arrays too)."""
    import numpy as np
    x, w = np.polynomial.legendre.leggauss(n)
    return (torch.as_tensor(x.astype(np.float32)),
            torch.as_tensor(w.astype(np.float32)))


_GL_X, _GL_W = _gauss_legendre(128)


def _integrate(fn, lo, hi):
    """∫_lo^hi fn(x) dx with 128-point Gauss-Legendre, for each of the
    (broadcast) bounds: lo and hi are float32 tensors of one shape S, fn
    maps [*S, 128] nodes to values -> [*S]."""
    mid = 0.5 * (hi + lo)
    half = 0.5 * (hi - lo)
    gx, gw = _GL_X.to(mid.device), _GL_W.to(mid.device)
    return half * torch.sum(gw * fn(mid[..., None] + half[..., None] * gx),
                            dim=-1)


def _interp(x, xp, fp):
    """jnp.interp(x, xp, fp) for sorted 1-D xp: the right-side
    searchsorted bracket, a lerp, and fp[0] / fp[-1] beyond the ends."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = torch.finfo(xp.dtype).eps
    dx0 = torch.abs(dx) <= eps * eps          # np.spacing(eps) of the dtype
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def comoving_distance(params: CosmologyParams, z):
    """Line-of-sight comoving distance D_C(z) in Mpc, vectorized over z; a
    0-d result for a scalar (or one-element) z, as in the JAX package."""
    z = torch.atleast_1d(as_f32(z))
    d_h = C_KM_S / params.h0
    out = d_h * _integrate(
        lambda zp: 1.0 / e_function(params, 1.0 / (1.0 + zp)),
        torch.zeros_like(z), z)
    return out if out.shape != (1,) else out[0]


def scale_factor_at_chi(params: CosmologyParams, chi, *,
                        z_max: float = 20.0, n_grid: int = 256):
    """Inverse of the comoving distance: a(chi) with chi in Mpc, from
    chi(z) tabulated on n_grid redshifts in [0, z_max] and interpolated;
    chi beyond chi(z_max) clamps to a(z_max)."""
    chi = as_f32(chi)
    z_grid = torch.linspace(0.0, z_max, n_grid, device=chi.device)
    chi_grid = comoving_distance(params, z_grid)
    return 1.0 / (1.0 + _interp(chi, chi_grid, z_grid))


def transverse_comoving_distance(params: CosmologyParams, z):
    """D_M(z): the comoving distance corrected for curvature (open, flat
    or closed)."""
    d_c = comoving_distance(params, z)
    d_h = C_KM_S / params.h0
    sqrt_ok = torch.sqrt(torch.tensor(abs(params.omega_k) + 1e-30,
                                      device=d_c.device))
    x = sqrt_ok * d_c / d_h
    if params.omega_k > 1e-8:
        return d_h / sqrt_ok * torch.sinh(x)
    if params.omega_k < -1e-8:
        return d_h / sqrt_ok * torch.sin(x)
    return d_c


def angular_diameter_distance(params: CosmologyParams, z):
    """D_A(z) = D_M / (1 + z)."""
    return transverse_comoving_distance(params, z) / (1.0 + as_f32(z))


def luminosity_distance(params: CosmologyParams, z):
    """D_L(z) = (1 + z) D_M."""
    return (1.0 + as_f32(z)) * transverse_comoving_distance(params, z)


def _log_a_integral(integrand, a):
    """∫ over x = ln a' from ln 1e-8 to ln a of integrand(x)."""
    hi = torch.log(as_f32(a))
    return _integrate(integrand, torch.log(torch.full_like(hi, 1e-8)), hi)


def conformal_time(params: CosmologyParams, a):
    """Conformal time eta(a) = ∫_0^a da' / (a'^2 H(a')), in Mpc."""
    d_h = C_KM_S / params.h0

    def integrand(x):
        aa = torch.exp(x)
        return 1.0 / (aa * e_function(params, aa))

    return d_h * _log_a_integral(integrand, a)


def cosmic_time(params: CosmologyParams, a):
    """Cosmic time t(a) = (1/H0) ∫_0^a da' / (a' E(a')), in Gyr."""
    h0_inv_gyr = _H_INV_TO_GYR / params.h0
    return h0_inv_gyr * _log_a_integral(
        lambda x: 1.0 / e_function(params, torch.exp(x)), a)


def age_of_universe(params: CosmologyParams):
    """t(a = 1) in Gyr."""
    return cosmic_time(params, 1.0)


def lookback_time(params: CosmologyParams, z):
    """t(1) - t(1 / (1 + z)) in Gyr."""
    return age_of_universe(params).to(as_f32(z).device) - cosmic_time(
        params, 1.0 / (1.0 + as_f32(z)))


def scale_factor_to_redshift(a):
    """z = 1/a - 1."""
    return 1.0 / as_f32(a) - 1.0


def redshift_to_scale_factor(z):
    return 1.0 / (1.0 + as_f32(z))
