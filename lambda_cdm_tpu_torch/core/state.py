"""Simulation state as a dataclass of tensors (counterpart of
lambda_cdm_tpu/core/state.py).

Per-particle arrays live on the simulation device. The scalars
(`scale_factor`, `time`, `step`) are 0-d tensors on the host: the
stepper advances them with host arithmetic in float32, so reading them
never waits for the device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SimState:
    """Full simulation state (the JAX SimState minus its PRNG key, which
    nothing in the run loop reads: the port's draws take explicit keys
    from utils/prng)."""

    positions: torch.Tensor      # [N, 3] comoving, in [0, box)
    velocities: torch.Tensor     # [N, 3]
    masses: torch.Tensor         # [N]
    scale_factor: torch.Tensor   # [] float32, host
    time: torch.Tensor           # [] float32, host
    step: torch.Tensor           # [] int32, host

    @property
    def num_particles(self) -> int:
        return self.positions.shape[0]

    @property
    def redshift(self):
        return 1.0 / self.scale_factor - 1.0

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def host_scalar(x, dtype=torch.float32) -> torch.Tensor:
    """A 0-d host tensor of `x` (a number or any tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", dtype).reshape(())
    return torch.tensor(x, dtype=dtype)


def make_state(positions, velocities, masses, scale_factor=1.0, time=0.0,
               step=0, device=None, dtype=torch.float32) -> SimState:
    """Build a SimState with canonical dtypes; arrays go to `device`
    (default: the device of `positions` when it is a tensor, else CPU)."""
    if device is None:
        device = (positions.device if isinstance(positions, torch.Tensor)
                  else "cpu")
    return SimState(
        positions=torch.as_tensor(positions, dtype=dtype, device=device),
        velocities=torch.as_tensor(velocities, dtype=dtype, device=device),
        masses=torch.as_tensor(masses, dtype=dtype, device=device),
        scale_factor=host_scalar(scale_factor, dtype),
        time=host_scalar(time, dtype),
        step=host_scalar(step, torch.int32),
    )


def random_state(key, num_particles: int, box_size: float,
                 velocity_scale: float = 1.0, mass: float = 1.0,
                 scale_factor: float = 1.0, device="cuda") -> SimState:
    """Uniform random positions and Gaussian velocities on `device`, the
    JAX package's random_state drawn from the same key (utils/prng: the
    key split in three, positions from the first, velocities from the
    second)."""
    from ..utils import prng
    kp, kv, _ = prng.split(key, 3)
    pos = prng.uniform(kp, (num_particles, 3), 0.0, box_size, device=device)
    vel = velocity_scale * prng.normal(kv, (num_particles, 3), device=device)
    masses = torch.full((num_particles,), mass, dtype=torch.float32,
                        device=device)
    return make_state(pos, vel, masses, scale_factor=scale_factor,
                      device=device)
