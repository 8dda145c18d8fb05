"""Pluggable force solvers and their registry (counterpart of
lambda_cdm_tpu/forces/__init__.py).

  name                 solver
  ------------------   -----------------------------------------------------
  direct_reference     PyTorch broadcast O(N^2) (oracle; small N)
  direct               O(N^2): the K4 CUDA kernel on the card; on the CPU
                       the broadcast up to 2048 particles, row blocks above
  pm                   particle-mesh Poisson solver (CIC + FFT)
  treepm               PM long-range + short-range pairwise correction

A force computer is a function `accel_fn(state) -> [N, 3]` accelerations
on the state's device, closed over the config's static parameters.
"""

from __future__ import annotations

from typing import Callable

from . import direct as _direct

_REGISTRY: dict[str, Callable] = {}


def register_force_computer(name: str):
    """Decorator: register a builder `(config) -> accel_fn` under `name`."""
    def deco(builder):
        _REGISTRY[name] = builder
        return builder
    return deco


def available_force_computers() -> list[str]:
    return sorted(_REGISTRY)


def load_plugin(module_path: str) -> list[str]:
    """Import a module whose import registers force computers (through
    `register_force_computer`); returns the names it registered."""
    import importlib
    before = set(_REGISTRY)
    importlib.import_module(module_path)
    return sorted(set(_REGISTRY) - before)


def load_plugins_from_env(var: str = "LCDM_FORCE_PLUGINS") -> list[str]:
    """Load the colon-separated plugin modules named in `var`."""
    import os
    new: list[str] = []
    for mod in filter(None, os.environ.get(var, "").split(":")):
        new += load_plugin(mod)
    return new


def create_force_computer(config) -> Callable:
    """The configured solver's accel_fn, or forces.fallback's when
    forces.type is not registered; KeyError when neither is."""
    name = config.forces.type
    if name not in _REGISTRY:
        fallback = config.forces.fallback
        if fallback in _REGISTRY:
            import logging
            logging.getLogger("lambda_cdm_tpu").warning(
                "force computer %r not registered; falling back to %r",
                name, fallback)
            name = fallback
        else:
            raise KeyError(
                f"unknown force computer {config.forces.type!r}; "
                f"available: {available_force_computers()}")
    return _REGISTRY[name](config)


def auto_pm_grid(config) -> int:
    """PM mesh size: configured value or ~2 cells per particle dimension
    (power-of-two >= cbrt(8N))."""
    if config.forces.pm_grid_size > 0:
        return int(config.forces.pm_grid_size)
    n = config.particles.num_particles
    ng = 16
    while ng ** 3 < 8 * n and ng < 1024:
        ng *= 2
    return ng


def select_optimal_method(num_particles: int, has_tpu: bool = True) -> str:
    """Solver choice by N (the JAX package's heuristic; `has_tpu` is kept
    for its signature and does not change the choice)."""
    if num_particles < 32_768:
        return "direct"
    return "treepm"


def get_recommended_parameters(num_particles: int) -> dict:
    pm_grid = 1
    while pm_grid ** 3 < max(num_particles // 8, 64):
        pm_grid *= 2
    return {
        "softening_length": 0.01,
        "pm_grid_size": pm_grid,
        "cutoff_cells": 3,
        "chunk_size": 4096 if num_particles > 4096 else num_particles,
    }


# ---------------------------------------------------------------------------
# Built-in solvers
# ---------------------------------------------------------------------------

def _common(config):
    f = config.forces
    mg = (f.modified_gravity_strength
          if f.force_kernel == "modified_gravity" else 0.0)
    return (config.particles.box_size, f.softening_length,
            config.units.G, mg)


def _precision(config):
    """forces.precision "bfloat16": the contraction's operands in bf16
    with float32 accumulation; float32 otherwise."""
    return "bfloat16" if config.forces.precision == "bfloat16" else None


@register_force_computer("direct_reference")
def _build_direct_reference(config):
    box, soft, g, mg = _common(config)
    prec = _precision(config)

    def accel_fn(state):
        return _direct.direct_accelerations(
            state.positions, state.masses, box, soft, g, mg, precision=prec)
    return accel_fn


@register_force_computer("direct")
def _build_direct(config):
    box, soft, g, mg = _common(config)
    n = config.particles.num_particles
    chunk = min(4096, max(256, n))
    prec = _precision(config)

    def accel_fn(state):
        if state.positions.device.type == "cuda":
            # K4 at every N: it masks its ragged tile, so the small-N
            # broadcast branch (there for the TPU kernel's 2048-wide
            # padding) has no purpose on the card. float32 whatever
            # forces.precision, as the JAX package's Pallas path
            from ..ops.direct import pairwise_accelerations
            return (1.0 + mg) * pairwise_accelerations(
                state.positions, state.masses, box, soft, g)
        if state.positions.shape[0] <= 2048:
            return _direct.direct_accelerations(
                state.positions, state.masses, box, soft, g, mg,
                precision=prec)
        return _direct.direct_accelerations_chunked(
            state.positions, state.masses, box, soft, g, mg,
            chunk_size=chunk, precision=prec)
    return accel_fn


@register_force_computer("pm")
def _build_pm(config):
    box, soft, g, mg = _common(config)
    ng = auto_pm_grid(config)

    def accel_fn(state):
        from .pm import pm_accelerations
        return (1.0 + mg) * pm_accelerations(
            state.positions, state.masses, ng, box, g)
    return accel_fn


@register_force_computer("treepm")
def _build_treepm(config):
    box, soft, g, mg = _common(config)
    f = config.forces
    ng = auto_pm_grid(config)

    def accel_fn(state):
        from .treepm import treepm_accelerations
        return (1.0 + mg) * treepm_accelerations(
            state.positions, state.masses, box, pm_grid=ng, softening=soft,
            g_const=g, split_factor=f.split_factor, cut_factor=f.cut_factor,
            capacity=f.bucket_capacity)
    return accel_fn
