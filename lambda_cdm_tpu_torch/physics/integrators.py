"""Time integration in PyTorch (counterpart of
lambda_cdm_tpu/physics/integrators.py): the KDK prefactors, the
scale-factor ODE step, the periodic wrap, the adaptive limiter and the
kick-drift-kick steps of the stateless solvers.

Scale factors are float32 tensors (0-d on the host in the stepper), so
the arithmetic runs in float32 in the same order as the JAX reference.
"""

from __future__ import annotations

from typing import NamedTuple

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
                hubble=None, max_dloga=0.0, amax=None):
    """dt <= eta*sqrt(eps/|a|_max), optionally also dt <= max_dloga/H(a);
    acc is [N, 3], or `amax` (a 0-d tensor) gives |a|_max (the largest
    over every rank's rows of a mesh). Returns a float32 0-d tensor on
    acc's device."""
    if amax is None:
        amax = torch.max(torch.sqrt(torch.sum(acc * acc, dim=-1)))
    dt_lim = eta * torch.sqrt(softening / torch.clamp(amax, min=1e-30))
    if hubble is not None and max_dloga > 0:
        h = as_f32(hubble).to(dt_lim.device)
        dt_lim = torch.minimum(dt_lim, max_dloga / torch.clamp(h, min=1e-30))
    dt = as_f32(dt).to(dt_lim.device)
    return torch.clamp(torch.minimum(dt, dt_lim), min_dt, max_dt)


def kdk_step(state, accel_fn, params: CosmologyParams, dt, box_size: float,
             *, h0_internal: float = 100.0, kick_mode: str = "reference",
             sf_method: str = "rk4", periodic: bool = True,
             cosmological: bool = True):
    """One kick-drift-kick leapfrog step with two force evaluations:
    half kick at a0, drift at the half-step scale factor, half kick at a1
    with the forces at the new positions. `accel_fn(state) -> [N, 3]` is
    any force computer."""
    a0 = state.scale_factor
    dt = as_f32(dt)
    acc = accel_fn(state)
    vel = state.velocities + acc * (0.5 * dt) * kick_factor(a0, kick_mode)
    a_half = (update_scale_factor(params, a0, 0.5 * dt, h0_internal,
                                  sf_method) if cosmological else a0)
    pos = state.positions + vel * dt * drift_factor(a_half, kick_mode)
    if periodic:
        pos = wrap_positions(pos, box_size)
    a1 = (update_scale_factor(params, a_half, 0.5 * dt, h0_internal,
                              sf_method) if cosmological else a0)
    mid = state.replace(positions=pos, velocities=vel, scale_factor=a1)
    acc2 = accel_fn(mid)
    vel = vel + acc2 * (0.5 * dt) * kick_factor(a1, kick_mode)
    return state.replace(positions=pos, velocities=vel, scale_factor=a1,
                         time=state.time + dt, step=state.step + 1)


class StepFactors(NamedTuple):
    """The host scalars of one fused KDK step (0-d float32 tensors): the
    half step, the kick factor at a0, the drift factor at a_half, a1 and
    the kick factor at a1."""
    half_dt: torch.Tensor
    kf0: torch.Tensor
    df: torch.Tensor
    a1: torch.Tensor
    kf1: torch.Tensor


def kdk_factors(params: CosmologyParams, a0, dt, *,
                h0_internal: float = 100.0, kick_mode: str = "reference",
                sf_method: str = "rk4",
                cosmological: bool = True) -> StepFactors:
    """kdk_step_fused's scalars of one step of `dt` from scale factor
    `a0`: they depend on a0 and dt alone, so a run of fixed dt can
    compute a chunk's ahead of its steps."""
    dt = as_f32(dt)
    if cosmological:
        a_half = update_scale_factor(params, a0, 0.5 * dt, h0_internal,
                                     sf_method)
        a1 = update_scale_factor(params, a_half, 0.5 * dt, h0_internal,
                                 sf_method)
    else:
        a_half, a1 = a0, a0
    return StepFactors(0.5 * dt, kick_factor(a0, kick_mode),
                       drift_factor(a_half, kick_mode), a1,
                       kick_factor(a1, kick_mode))


def kdk_step_fused(state, acc, accel_fn, params: CosmologyParams, dt,
                   box_size: float, *, h0_internal: float = 100.0,
                   kick_mode: str = "reference", sf_method: str = "rk4",
                   periodic: bool = True, cosmological: bool = True,
                   factors: StepFactors | None = None):
    """KDK step with one force evaluation: `acc` is the acceleration at
    the current positions (the previous step's closing half-kick force).
    `factors`: kdk_factors of this step, computed ahead (else here).
    The kicks and the drift are ops/kdk_update's flat forms: two kernels
    on the card, their plain chain of operations on the CPU. Returns (new
    state, acceleration at the new positions)."""
    from ..ops.kdk_update import kdk_kick_flat, kdk_open_flat
    dt = as_f32(dt)
    f = factors if factors is not None else kdk_factors(
        params, state.scale_factor, dt, h0_internal=h0_internal,
        kick_mode=kick_mode, sf_method=sf_method, cosmological=cosmological)
    pos, vel = kdk_open_flat(state.positions, state.velocities, acc,
                             half_dt=f.half_dt, kf=f.kf0, dt=dt, df=f.df,
                             box=box_size if periodic else None)
    mid = state.replace(positions=pos, velocities=vel, scale_factor=f.a1)
    acc_new = accel_fn(mid)
    vel = kdk_kick_flat(vel, acc_new, s1=f.half_dt, s2=f.kf1)
    return state.replace(positions=pos, velocities=vel, scale_factor=f.a1,
                         time=state.time + dt, step=state.step + 1), acc_new
