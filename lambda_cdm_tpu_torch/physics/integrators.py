"""Time integration helpers in PyTorch (counterpart of
lambda_cdm_tpu/physics/integrators.py): the KDK prefactors, the
scale-factor ODE step, the periodic wrap and the adaptive limiter.

Scale factors are float32 tensors (0-d on the host in the stepper), so
the arithmetic runs in float32 in the same order as the JAX reference.
"""

from __future__ import annotations

import torch

from .cosmology import CosmologyParams, as_f32, e_function


def hubble_internal(params: CosmologyParams, a, h0_internal):
    """H(a) in internal 1/time units: H0_internal * E(a)."""
    return h0_internal * e_function(params, a)


def scale_factor_derivative(params: CosmologyParams, a, h0_internal):
    """da/dt = a H(a)."""
    return a * hubble_internal(params, a, h0_internal)


def update_scale_factor(params: CosmologyParams, a, dt, h0_internal,
                        method: str = "rk4"):
    """Advance a by dt along the Friedmann equation (rk4 or euler)."""
    a = as_f32(a)

    def f(aa):
        return scale_factor_derivative(params, aa, h0_internal)

    if method == "euler":
        return a + f(a) * dt
    k1 = f(a)
    k2 = f(a + 0.5 * dt * k1)
    k3 = f(a + 0.5 * dt * k2)
    k4 = f(a + dt * k3)
    return a + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def kick_factor(a, mode: str = "reference"):
    """Velocity-update prefactor for the comoving equations of motion."""
    a = as_f32(a)
    if mode == "reference":
        return 1.0 / (a * a)
    if mode == "comoving":
        return 1.0 / a
    if mode == "newtonian":
        return torch.ones_like(a)
    raise ValueError(f"unknown kick mode {mode!r}")


def drift_factor(a, mode: str = "reference"):
    """Position-update prefactor."""
    a = as_f32(a)
    if mode == "reference" or mode == "newtonian":
        return torch.ones_like(a)
    if mode == "comoving":
        return 1.0 / (a * a)
    raise ValueError(f"unknown drift mode {mode!r}")


def wrap_positions(positions, box_size):
    """Periodic wrap into [0, box): torch.remainder is the same
    floor-mod (fmod plus a sign fix) as jnp.mod."""
    return torch.remainder(positions, box_size)


def adaptive_dt(acc, softening, dt, min_dt, max_dt, eta=0.25,
                hubble=None, max_dloga=0.0):
    """dt <= eta*sqrt(eps/|a|_max), optionally also dt <= max_dloga/H(a);
    acc is [N, 3]. Returns a float32 0-d tensor on acc's device."""
    amax = torch.max(torch.sqrt(torch.sum(acc * acc, dim=-1)))
    dt_lim = eta * torch.sqrt(softening / torch.clamp(amax, min=1e-30))
    if hubble is not None and max_dloga > 0:
        h = as_f32(hubble).to(dt_lim.device)
        dt_lim = torch.minimum(dt_lim, max_dloga / torch.clamp(h, min=1e-30))
    dt = as_f32(dt).to(dt_lim.device)
    return torch.clamp(torch.minimum(dt, dt_lim), min_dt, max_dt)
