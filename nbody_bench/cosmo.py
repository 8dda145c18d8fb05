"""Lambda-CDM background, linear growth and the linear power spectrum,
frozen for the benchmark's inputs.

A plain copy of lambda_cdm_tpu_torch/physics/cosmology.py (e2_function,
omega_m_a, growth_factor, growth_rate) and physics/power_spectra.py
(eh98_transfer, the sigma8 normalisation, linear_power) at commit
9aff8f2. Scalars are evaluated in float64 with numpy; the transfer
function takes a torch tensor of k and returns one of its dtype. It
imports nothing of the port, so a change to the port cannot change the
benchmark's traffic.

Units as in the port: k in h/Mpc, P(k) in (Mpc/h)^3, H0 = 100 internal.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# critical density in (1e10 Msun/h) / (Mpc/h)^3 for H0 = 100 internal
RHO_CRIT = 27.753662724570805


@dataclasses.dataclass(frozen=True)
class Cosmology:
    omega_m: float = 0.31
    omega_lambda: float = 0.69
    omega_b: float = 0.049
    h: float = 0.67
    sigma8: float = 0.81
    n_s: float = 0.965
    t_cmb: float = 2.7255

    @classmethod
    def from_config(cls, cfg: dict) -> "Cosmology":
        c = cfg.get("cosmology", {})
        d = cls()
        return cls(omega_m=float(c.get("omega_m", d.omega_m)),
                   omega_lambda=float(c.get("omega_lambda", d.omega_lambda)),
                   omega_b=float(c.get("omega_b", d.omega_b)),
                   h=float(c.get("h", d.h)),
                   sigma8=float(c.get("sigma_8", d.sigma8)),
                   n_s=float(c.get("n_s", d.n_s)))


def e2(cosmo: Cosmology, a: float) -> float:
    """E^2(a) = H^2 / H0^2 (flat, w = -1, no radiation)."""
    return cosmo.omega_m * a ** -3 + cosmo.omega_lambda


def hubble(cosmo: Cosmology, a: float, h0_internal: float = 100.0) -> float:
    """H(a) in internal 1/time units."""
    return h0_internal * math.sqrt(e2(cosmo, a))


def omega_m_a(cosmo: Cosmology, a: float) -> float:
    return cosmo.omega_m * a ** -3 / e2(cosmo, a)


def _cpt92_g(cosmo: Cosmology, a: float) -> float:
    """Carroll, Press & Turner (1992) growth suppression g(a)."""
    om = omega_m_a(cosmo, a)
    ol = cosmo.omega_lambda / e2(cosmo, a)
    return 2.5 * om / (om ** (4.0 / 7.0) - ol
                       + (1.0 + om / 2.0) * (1.0 + ol / 70.0))


def growth_factor(cosmo: Cosmology, a: float) -> float:
    """Linear growth D(a), CPT92, D(1) = 1."""
    return a * _cpt92_g(cosmo, a) / _cpt92_g(cosmo, 1.0)


def growth_rate(cosmo: Cosmology, a: float) -> float:
    """f = dlnD/dlna ~ Omega_m(a)^0.55."""
    return omega_m_a(cosmo, a) ** 0.55


def _t0_tilde(q, alpha_c, beta_c):
    c = 14.2 / alpha_c + 386.0 / (1.0 + 69.9 * q ** 1.08)
    ln_term = torch.log(math.e + 1.8 * beta_c * q)
    return ln_term / (ln_term + c * q * q)


def eh98_transfer(cosmo: Cosmology, k):
    """Eisenstein & Hu (1998) transfer function with BAO; k in h/Mpc."""
    k = torch.clamp(k, min=1e-12) * cosmo.h
    om = cosmo.omega_m * cosmo.h ** 2
    ob = cosmo.omega_b * cosmo.h ** 2
    oc_frac = (cosmo.omega_m - cosmo.omega_b) / cosmo.omega_m
    ob_frac = cosmo.omega_b / cosmo.omega_m
    theta = cosmo.t_cmb / 2.7
    z_eq = 2.50e4 * om * theta ** -4
    k_eq = 7.46e-2 * om * theta ** -2
    b1 = 0.313 * om ** -0.419 * (1.0 + 0.607 * om ** 0.674)
    b2 = 0.238 * om ** 0.223
    z_d = (1291.0 * om ** 0.251 / (1.0 + 0.659 * om ** 0.828)
           * (1.0 + b1 * ob ** b2))
    r_d = 31.5 * ob * theta ** -4 * (1e3 / z_d)
    r_eq = 31.5 * ob * theta ** -4 * (1e3 / z_eq)
    s = (2.0 / (3.0 * k_eq)) * math.sqrt(6.0 / r_eq) * math.log(
        (math.sqrt(1.0 + r_d) + math.sqrt(r_d + r_eq))
        / (1.0 + math.sqrt(r_eq)))
    k_silk = 1.6 * ob ** 0.52 * om ** 0.73 * (1.0 + (10.4 * om) ** -0.95)
    q = k / (13.41 * k_eq)
    a1 = (46.9 * om) ** 0.670 * (1.0 + (32.1 * om) ** -0.532)
    a2 = (12.0 * om) ** 0.424 * (1.0 + (45.0 * om) ** -0.582)
    alpha_c = a1 ** (-ob_frac) * a2 ** (-ob_frac ** 3)
    bb1 = 0.944 / (1.0 + (458.0 * om) ** -0.708)
    bb2 = (0.395 * om) ** -0.0266
    beta_c = 1.0 / (1.0 + bb1 * (oc_frac ** bb2 - 1.0))
    f = 1.0 / (1.0 + (k * s / 5.4) ** 4)
    t_c = (f * _t0_tilde(q, 1.0, beta_c)
           + (1.0 - f) * _t0_tilde(q, alpha_c, beta_c))
    y = (1.0 + z_eq) / (1.0 + z_d)
    sqrt_1py = math.sqrt(1.0 + y)
    g_y = y * (-6.0 * sqrt_1py + (2.0 + 3.0 * y)
               * math.log((sqrt_1py + 1.0) / (sqrt_1py - 1.0)))
    alpha_b = 2.07 * k_eq * s * (1.0 + r_d) ** -0.75 * g_y
    beta_b = (0.5 + ob_frac
              + (3.0 - 2.0 * ob_frac) * math.sqrt((17.2 * om) ** 2 + 1.0))
    beta_node = 8.41 * om ** 0.435
    s_tilde = s / (1.0 + (beta_node / (k * s)) ** 3) ** (1.0 / 3.0)
    ks_t = k * s_tilde
    sinc = torch.sin(ks_t) / torch.clamp(ks_t, min=1e-12)
    t_b = (_t0_tilde(q, 1.0, 1.0) / (1.0 + (k * s / 5.2) ** 2)
           + alpha_b / (1.0 + (beta_b / (k * s)) ** 3)
           * torch.exp(-(k / k_silk) ** 1.4)) * sinc
    return ob_frac * t_b + oc_frac * t_c


def sigma8_amplitude(cosmo: Cosmology) -> float:
    """A with P(k) = A k^ns T(k)^2 and sigma(8 Mpc/h) = sigma8: the
    port's 128-point Gauss-Legendre integral in ln k over [1e-5, 1e3],
    here in float64."""
    x, w = np.polynomial.legendre.leggauss(128)
    lo, hi = math.log(1e-5), math.log(1e3)
    k = torch.as_tensor(np.exp(0.5 * (hi + lo) + 0.5 * (hi - lo) * x))
    t = eh98_transfer(cosmo, k).numpy()
    kr = np.clip(k.numpy() * 8.0, 1e-8, None)
    win = np.where(kr < 1e-3, 1.0 - kr * kr / 10.0,
                   3.0 * (np.sin(kr) - kr * np.cos(kr)) / kr ** 3)
    integrand = k.numpy() ** (3.0 + cosmo.n_s) * t * t * win ** 2
    sigma2 = 0.5 * (hi - lo) * np.sum(w * integrand) / (2.0 * math.pi ** 2)
    return cosmo.sigma8 ** 2 / sigma2


def linear_power(cosmo: Cosmology, k):
    """P(k, z = 0) in (Mpc/h)^3 for a tensor of k (h/Mpc)."""
    return (sigma8_amplitude(cosmo) * k ** cosmo.n_s
            * eh98_transfer(cosmo, k) ** 2)


def time_between(cosmo: Cosmology, a0: float, a1: float,
                 weight_power: int = 0, h0_internal: float = 100.0) -> float:
    """Integral of a^-weight_power dt from a0 to a1 (dt = da / (a H)),
    by 64-point Gauss-Legendre in ln a: weight 0 is the elapsed time, 1
    the comoving kick factor, 2 the comoving drift factor."""
    x, w = np.polynomial.legendre.leggauss(64)
    lo, hi = math.log(a0), math.log(a1)
    lna = 0.5 * (hi + lo) + 0.5 * (hi - lo) * x
    a = np.exp(lna)
    f = a ** -weight_power / (h0_internal
                              * np.sqrt(cosmo.omega_m * a ** -3
                                        + cosmo.omega_lambda))
    return 0.5 * (hi - lo) * float(np.sum(w * f))
