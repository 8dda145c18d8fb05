"""Lambda-CDM background cosmology in PyTorch (counterpart of
lambda_cdm_tpu/physics/cosmology.py, the parts the treepm_fast path uses).

Every function takes a scale factor as a Python float or a tensor and
returns a float32 tensor on the scale factor's device, evaluated in the
same operation order as the JAX reference so the two agree to float32
round-off.
"""

from __future__ import annotations

import dataclasses

import torch

# Newton's constant in (Mpc/h) (km/s)^2 / (1e10 Msun/h)
G_GADGET_MPC = 43.0071057317063


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


def _gauss_legendre(n: int):
    """128-point nodes and weights on [-1, 1] as float32 tensors (the
    JAX package holds them as float32 arrays too)."""
    import numpy as np
    x, w = np.polynomial.legendre.leggauss(n)
    return (torch.as_tensor(x.astype(np.float32)),
            torch.as_tensor(w.astype(np.float32)))


_GL_X, _GL_W = _gauss_legendre(128)
