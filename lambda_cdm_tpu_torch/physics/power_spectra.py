"""Linear matter power spectra in PyTorch (counterpart of
lambda_cdm_tpu/physics/power_spectra.py): the BBKS and Eisenstein-Hu
transfer functions, sigma8 normalization, sigma(R) and P(k, z).

Conventions: k in h/Mpc, P(k) in (Mpc/h)^3, R in Mpc/h. Scalar
constants are Python floats; k-dependent terms are float32 tensors.
"""

from __future__ import annotations

import math

import torch

from .cosmology import CosmologyParams, _GL_W, _GL_X, as_f32, growth_factor


def bbks_transfer(params: CosmologyParams, k):
    """BBKS CDM transfer function with the Sugiyama (1995) baryon
    correction to the shape parameter. k in h/Mpc."""
    k = as_f32(k)
    gamma = params.omega_m * params.h * math.exp(
        -params.omega_b * (1.0 + math.sqrt(2.0 * params.h) / params.omega_m))
    q = k * params.h / gamma / params.h
    q = torch.clamp(q, min=1e-12)
    ln_term = torch.log(1.0 + 2.34 * q) / (2.34 * q)
    poly = (1.0 + 3.89 * q + (16.1 * q) ** 2 + (5.46 * q) ** 3
            + (6.71 * q) ** 4)
    return ln_term * poly ** -0.25


def _t0_tilde(q, alpha_c, beta_c):
    """EH98 eq. 19-20: the pressureless CDM shape."""
    c = 14.2 / alpha_c + 386.0 / (1.0 + 69.9 * q ** 1.08)
    ln_term = torch.log(math.e + 1.8 * beta_c * q)
    return ln_term / (ln_term + c * q * q)


def eh98_transfer(params: CosmologyParams, k):
    """Eisenstein & Hu (1998) transfer function with baryon acoustic
    oscillations. k in h/Mpc; converted to 1/Mpc internally."""
    k = torch.clamp(as_f32(k), min=1e-12) * params.h
    om = params.omega_m * params.h ** 2
    ob = params.omega_b * params.h ** 2
    oc_frac = (params.omega_m - params.omega_b) / params.omega_m
    ob_frac = params.omega_b / params.omega_m
    theta = params.t_cmb / 2.7

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


def eh98_nowiggle_transfer(params: CosmologyParams, k):
    """Eisenstein & Hu (1998) zero-baryon ('no-wiggle') shape fit."""
    k = torch.clamp(as_f32(k), min=1e-12)
    om = params.omega_m * params.h ** 2
    ob = params.omega_b * params.h ** 2
    theta = params.t_cmb / 2.7
    ob_frac = params.omega_b / params.omega_m

    s = 44.5 * math.log(9.83 / om) / math.sqrt(1.0 + 10.0 * ob ** 0.75)
    alpha_g = (1.0 - 0.328 * math.log(431.0 * om) * ob_frac
               + 0.38 * math.log(22.3 * om) * ob_frac ** 2)
    gamma_eff = params.omega_m * params.h * (
        alpha_g + (1.0 - alpha_g) / (1.0 + (0.43 * k * params.h * s) ** 4))
    q = k * theta ** 2 / gamma_eff
    l0 = torch.log(2.0 * math.e + 1.8 * q)
    c0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
    return l0 / (l0 + c0 * q * q)


TRANSFERS = {
    "bbks": bbks_transfer,
    "eisenstein_hu": eh98_transfer,
    "eh98": eh98_transfer,
    "eh98_nowiggle": eh98_nowiggle_transfer,
}


def _tophat_window(x):
    """Fourier transform of a real-space spherical top-hat."""
    x = torch.clamp(x, min=1e-8)
    w = 3.0 * (torch.sin(x) - x * torch.cos(x)) / x ** 3
    return torch.where(x < 1e-3, 1.0 - x * x / 10.0, w)


def _sigma2_unnormalized(params: CosmologyParams, r, transfer):
    """(1/2pi^2) int k^2 k^ns T^2 W^2 dk, 128-point Gauss-Legendre in
    ln k, in float32 as in the JAX package; `r` a number or a tensor of
    radii (the result has its shape, on its device)."""
    r = as_f32(r)
    ln_lo = math.log(1e-5)
    ln_hi = math.log(1e3)
    mid = as_f32(0.5 * (ln_hi + ln_lo))
    half = as_f32(0.5 * (ln_hi - ln_lo))
    lnk = (mid + half * _GL_X).to(r.device)
    k = torch.exp(lnk)
    t = transfer(params, k)
    integrand = (k ** (3.0 + params.n_s) * t * t
                 * _tophat_window(k * r[..., None]) ** 2)
    return half.to(r.device) * torch.sum(_GL_W.to(r.device) * integrand,
                                         dim=-1) / (2.0 * math.pi ** 2)


def sigma8_normalization(params: CosmologyParams, transfer=eh98_transfer):
    """Amplitude A such that sigma(R=8 Mpc/h) = params.sigma8 with
    P(k) = A k^ns T(k)^2 (a float32 tensor on the CPU)."""
    return params.sigma8 ** 2 / _sigma2_unnormalized(params, 8.0, transfer)


def sigma_r(params: CosmologyParams, r, transfer=eh98_transfer):
    """RMS linear density fluctuation in top-hat spheres of radius R
    [Mpc/h] at z = 0, on r's device (a 0-d tensor for one radius)."""
    r = as_f32(r)
    amp = sigma8_normalization(params, transfer).to(r.device)
    return torch.sqrt(amp * _sigma2_unnormalized(params, r, transfer))


def linear_power(params: CosmologyParams, k, z=0.0,
                 transfer="eisenstein_hu"):
    """Linear matter power spectrum P(k, z) in (Mpc/h)^3, sigma8
    normalized, scaled to redshift z with the linear growth factor."""
    t_fn = TRANSFERS[transfer] if isinstance(transfer, str) else transfer
    k = as_f32(k)
    amp = sigma8_normalization(params, t_fn).to(k.device)
    t = t_fn(params, k)
    d = growth_factor(params, 1.0 / (1.0 + z)).to(k.device)
    return amp * k ** params.n_s * t * t * d * d
