"""Carry state between lambda_cdm_tpu (JAX) and this package without
importing JAX: the port's SimState, FastState and CosmologyParams are
built from dicts of numpy arrays and floats -- the JAX objects' fields
after np.asarray -- and converted back the same way. Arrays are copied,
so the tensors never alias read-only JAX buffers.

    fields = {f.name: np.asarray(getattr(jax_obj, f.name))
              for f in dataclasses.fields(jax_obj)}
    st = sim_state_from_arrays(fields, device="cpu")

Like every entry point of the port, the loaders default to the card
(device="cuda").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .analysis.halo_finder import HaloCatalog
from .analysis.power_spectrum import PowerSpectrumData
from .core.state import SimState, host_scalar
from .ops.fast_treepm import FastState
from .physics.cosmology import CosmologyParams
from .raytracing.lensing import RayBundle

_SCALARS = {"scale_factor": torch.float32, "time": torch.float32,
            "step": torch.int32}


def _to_numpy(t):
    return t.detach().cpu().numpy()


def sim_state_from_arrays(d: dict, device="cuda") -> SimState:
    """SimState from {positions, velocities, masses, scale_factor, time,
    step} (other keys, such as the JAX rng_key, are ignored)."""
    return SimState(
        positions=torch.tensor(np.asarray(d["positions"], np.float32),
                               device=device),
        velocities=torch.tensor(np.asarray(d["velocities"], np.float32),
                                device=device),
        masses=torch.tensor(np.asarray(d["masses"], np.float32),
                            device=device),
        **{k: host_scalar(np.asarray(d[k]).item(), dt)
           for k, dt in _SCALARS.items()})


def sim_state_to_arrays(st: SimState) -> dict:
    return {f.name: _to_numpy(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def fast_state_from_arrays(d: dict, device="cuda") -> FastState:
    """FastState from the JAX FastState's fields (SoA [3, C, K] layout)."""
    def dev(name, dtype):
        return torch.tensor(np.asarray(d[name], dtype), device=device)

    return FastState(
        bpos=dev("bpos", np.float32), bvel=dev("bvel", np.float32),
        bmass=dev("bmass", np.float32), ids=dev("ids", np.int32),
        acc=dev("acc", np.float32),
        scale_factor=host_scalar(np.asarray(d["scale_factor"]).item()),
        time=host_scalar(np.asarray(d["time"]).item()),
        step=host_scalar(np.asarray(d["step"]).item(), torch.int32),
        overflow=dev("overflow", np.int32).reshape(()),
        dropped=dev("dropped", np.int32).reshape(()))


def fast_state_to_arrays(fs: FastState) -> dict:
    return {f.name: _to_numpy(getattr(fs, f.name))
            for f in dataclasses.fields(fs)}


def cosmology_params_from_dict(d: dict) -> CosmologyParams:
    names = {f.name for f in dataclasses.fields(CosmologyParams)}
    return CosmologyParams(**{k: float(np.asarray(v)) for k, v in d.items()
                              if k in names})


def cosmology_params_to_dict(p: CosmologyParams) -> dict:
    return dataclasses.asdict(p)


def halo_catalog_to_arrays(cat: HaloCatalog) -> dict:
    """HaloCatalog -> {field: numpy array} (the JAX catalogue's fields)."""
    return {f.name: _to_numpy(getattr(cat, f.name))
            for f in dataclasses.fields(cat)}


def power_spectrum_to_arrays(data: PowerSpectrumData) -> dict:
    """PowerSpectrumData -> {field: numpy array}."""
    return {f.name: _to_numpy(getattr(data, f.name))
            for f in dataclasses.fields(data)}


def ray_bundle_to_arrays(b: RayBundle) -> dict:
    """RayBundle -> {field: numpy array, or None for a Jacobian field of a
    trace without one} (the JAX RayBundle's fields)."""
    return {f.name: None if getattr(b, f.name) is None
            else _to_numpy(getattr(b, f.name))
            for f in dataclasses.fields(b)}
