"""Analytic halo and large-scale-structure theory in PyTorch (counterpart
of lambda_cdm_tpu/analysis/theory.py): sigma(M), the Press-Schechter and
Sheth-Tormen mass functions, linear bias, NFW profiles, the Duffy et al.
(2008) concentration and its fit, and the Zheng et al. (2005) HOD.

Plain float32 tensor functions, as the JAX package computes them. Each
takes an explicit `device` for number inputs (default: the card, as the
JAX package's arrays go to its default device); tensor inputs keep
theirs. Conventions: M in 1e10 Msun/h, R in Mpc/h, number
densities in (Mpc/h)^-3.
"""

from __future__ import annotations

import math

import torch

from ..physics.cosmology import CosmologyParams, growth_factor
from ..physics.power_spectra import eh98_transfer, sigma_r

DELTA_C = 1.686                          # spherical-collapse threshold
RHO_CRIT = 27.753662724570805            # (1e10 Msun/h) / (Mpc/h)^3


def _t(x, device=None) -> torch.Tensor:
    """x as a float32 tensor: a tensor keeps its device, a number goes to
    `device` (the card when None)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32,
                           device="cuda" if device is None else device)


def mass_to_radius(params: CosmologyParams, m, device=None):
    """Lagrangian top-hat radius R(M) with rho_bar = rho_crit Omega_m."""
    rho_bar = RHO_CRIT * params.omega_m
    return (3.0 * _t(m, device) / (4.0 * math.pi * rho_bar)) ** (1.0 / 3.0)


def sigma_m(params: CosmologyParams, m, z=0.0, transfer=eh98_transfer,
            device=None):
    """sigma(M, z)."""
    r = mass_to_radius(params, m, device)
    d = growth_factor(params, 1.0 / (1.0 + z)).to(r.device)
    return sigma_r(params, r, transfer=transfer) * d


def _dlnsigma_dlnm(params: CosmologyParams, m, z, device=None):
    """d ln sigma / d ln M by a central difference of +-0.05 in ln M."""
    lnm = torch.log(_t(m, device))
    eps = 0.05
    s_hi = torch.log(sigma_m(params, torch.exp(lnm + eps), z))
    s_lo = torch.log(sigma_m(params, torch.exp(lnm - eps), z))
    return (s_hi - s_lo) / (2.0 * eps)


def press_schechter_multiplicity(nu, device=None):
    """f_PS(nu) = sqrt(2/pi) nu exp(-nu^2/2)."""
    nu = _t(nu, device)
    return math.sqrt(2.0 / math.pi) * nu * torch.exp(-0.5 * nu * nu)


def sheth_tormen_multiplicity(nu, a=0.707, p=0.3, big_a=0.3222,
                              device=None):
    """f_ST(nu) (Sheth & Tormen 1999)."""
    nu = _t(nu, device)
    anu2 = a * nu * nu
    return (big_a * math.sqrt(2.0 * a / math.pi) * nu
            * (1.0 + anu2 ** -p) * torch.exp(-0.5 * anu2))


def mass_function(params: CosmologyParams, m, z=0.0, kind="sheth_tormen",
                  device=None):
    """dn/dlnM [(Mpc/h)^-3]: Sheth-Tormen, or Press-Schechter for a `kind`
    not starting with "sheth"."""
    m = _t(m, device)
    nu = DELTA_C / sigma_m(params, m, z)
    f = (sheth_tormen_multiplicity(nu) if kind.startswith("sheth")
         else press_schechter_multiplicity(nu))
    rho_bar = RHO_CRIT * params.omega_m
    return rho_bar / m * f * torch.abs(_dlnsigma_dlnm(params, m, z))


def linear_bias(params: CosmologyParams, m, z=0.0, a=0.707, p=0.3,
                device=None):
    """Sheth-Tormen peak-background-split linear halo bias."""
    nu = DELTA_C / sigma_m(params, m, z, device=device)
    anu2 = a * nu * nu
    return (1.0 + (anu2 - 1.0) / DELTA_C
            + 2.0 * p / (DELTA_C * (1.0 + anu2 ** p)))


# -- NFW profiles -------------------------------------------------------------

def nfw_density(r, rho_s, r_s, device=None):
    """rho(r) = rho_s / [(r/rs)(1 + r/rs)^2]."""
    x = _t(r, device) / r_s
    return rho_s / (x * (1.0 + x) ** 2)


def nfw_enclosed_mass(r, rho_s, r_s, device=None):
    """M(<r) = 4 pi rho_s rs^3 [ln(1+x) - x/(1+x)]."""
    x = _t(r, device) / r_s
    return 4.0 * math.pi * rho_s * r_s ** 3 * (torch.log(1.0 + x)
                                               - x / (1.0 + x))


def nfw_params_from_m_c(m_delta, r_delta, c):
    """(rho_s, r_s) for a halo of mass M within R at concentration c
    (numbers or tensors)."""
    r_s = r_delta / c
    lg = torch.log1p(c) if isinstance(c, torch.Tensor) else math.log1p(c)
    mu = lg - c / (1.0 + c)
    rho_s = m_delta / (4.0 * math.pi * r_s ** 3 * mu)
    return rho_s, r_s


def concentration_duffy08(m, z=0.0, device=None):
    """Duffy et al. 2008 c(M, z) (M in 1e10 Msun/h)."""
    m_pivot = 2e2   # 2e12 Msun/h in 1e10 units
    return 5.71 * (_t(m, device) / m_pivot) ** -0.084 * (1.0 + z) ** -0.47


def fit_nfw_concentration(r, m_enclosed, r_delta, m_delta, c_grid=None,
                          device=None):
    """c minimising the squared log difference of M(<r) against NFW over
    0.05 R < r <= R (a grid search over `c_grid`, default 93 values in
    [2, 25]); returns a 0-d tensor."""
    r = _t(r, device)
    m_enclosed = _t(m_enclosed, r.device)
    if c_grid is None:
        c_grid = torch.linspace(2.0, 25.0, 93, device=r.device)
    c = _t(c_grid, r.device)[:, None]
    rho_s, r_s = nfw_params_from_m_c(m_delta, r_delta, c)
    pred = nfw_enclosed_mass(r[None, :], rho_s, r_s)
    w = (r > 0.05 * r_delta) & (r <= r_delta) & (m_enclosed > 0)
    d = (torch.log(torch.clamp(pred, min=1e-20))
         - torch.log(torch.clamp(m_enclosed, min=1e-20))[None, :])
    losses = torch.sum(torch.where(w[None, :], d * d, 0.0), dim=1)
    return c[torch.argmin(losses), 0]


# -- HOD (Zheng et al. 2005 five-parameter form) ------------------------------

def hod_central(m, log_m_min=11.0 - 10.0, sigma_logm=0.2, device=None):
    """<N_cen>(M) = 1/2 [1 + erf((log M - log M_min)/sigma)]; M in 1e10
    Msun/h, so log M_min = 11 (Msun/h) is 1.0 here."""
    logm = torch.log10(_t(m, device))
    return 0.5 * (1.0 + torch.erf((logm - log_m_min)
                                  / (math.sqrt(2.0) * sigma_logm)))


def hod_satellites(m, log_m0=1.0, log_m1=2.0, alpha=1.0, log_m_min=1.0,
                   sigma_logm=0.2, device=None):
    """<N_sat>(M) = <N_cen> ((M - M0)/M1)^alpha for M > M0."""
    m = _t(m, device)
    m0, m1 = 10.0 ** log_m0, 10.0 ** log_m1
    ncen = hod_central(m, log_m_min, sigma_logm)
    return ncen * (torch.clamp(m - m0, min=0.0) / m1) ** alpha


def galaxy_number_density(params: CosmologyParams, z=0.0, *, hod_kwargs=None,
                          m_grid=None, device=None):
    """n_gal = int dn/dlnM (<N_cen> + <N_sat>) dlnM (trapezoid in ln M over
    `m_grid`, default 128 masses log-spaced over 1e10..1e15 Msun/h)."""
    hod_kwargs = hod_kwargs or {}
    if m_grid is None:
        m_grid = torch.logspace(0.0, 5.0, 128,
                                device="cuda" if device is None else device)
    m_grid = _t(m_grid, device)
    dndlnm = mass_function(params, m_grid, z)
    occ = hod_central(m_grid, **{k: v for k, v in hod_kwargs.items()
                                 if k in ("log_m_min", "sigma_logm")}) \
        + hod_satellites(m_grid, **hod_kwargs)
    return torch.trapezoid(dndlnm * occ, torch.log(m_grid))
