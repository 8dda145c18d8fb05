"""Snapshot and checkpoint I/O (counterpart of
lambda_cdm_tpu/utils/checkpoint.py): npz snapshots (with the `fields`
filter and the config in `__meta__`) and ascii snapshots; npz checkpoints
with the config and the run statistics.

The file format is the JAX package's, so a checkpoint written by either
package loads in the other with bitwise arrays. The port's SimState has
no PRNG key: `rng_key` is written as two zero uint32 words and ignored
when loading. The hdf5, lcdm (native codec) and orbax formats are not
ported (ROADMAP): they raise NotImplementedError.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.state import SimState, host_scalar

_STATE_FIELDS = ("positions", "velocities", "masses", "scale_factor",
                 "time", "step", "rng_key")
_HOST_DTYPES = {"positions": np.float32, "velocities": np.float32,
                "masses": np.float32, "scale_factor": np.float32,
                "time": np.float32, "step": np.int32}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to lambda_cdm_tpu_torch yet; see "
        f"ROADMAP.md (the JAX package lambda_cdm_tpu has it)")


def _check_format(path: str) -> None:
    if path.endswith((".h5", ".hdf5")):
        raise _not_ported("the hdf5 snapshot format (needs h5py)")
    if path.endswith(".lcdm"):
        raise _not_ported("the lcdm snapshot format (the native codec)")


def state_to_host(state: SimState) -> dict:
    """The JAX package's checkpoint arrays: the state's tensors as numpy
    in its dtypes, plus a zero `rng_key`."""
    out = {f: getattr(state, f).detach().cpu().numpy().astype(dt)
           for f, dt in _HOST_DTYPES.items()}
    out["rng_key"] = np.zeros(2, np.uint32)
    return out


def state_from_host(arrays: dict, device="cuda") -> SimState:
    """SimState from the checkpoint arrays (`rng_key` ignored); particle
    arrays on `device` (the card by default, as the engine's), scalars on
    the host."""
    return SimState(
        positions=torch.tensor(arrays["positions"], device=device),
        velocities=torch.tensor(arrays["velocities"], device=device),
        masses=torch.tensor(arrays["masses"], device=device),
        scale_factor=host_scalar(float(arrays["scale_factor"])),
        time=host_scalar(float(arrays["time"])),
        step=host_scalar(int(arrays["step"]), torch.int32))


def _makedirs_for(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def save_snapshot(path: str, state: SimState, config=None,
                  fields=None) -> str:
    """Write a particle snapshot: `.txt`/`.ascii` as whitespace columns,
    anything else as npz (`.npz` appended). `fields` filters the stored
    arrays; the scalars needed to read the snapshot are always kept."""
    _check_format(path)
    if path.endswith((".txt", ".ascii")):
        return _save_snapshot_ascii(path, state)
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = state_to_host(state)
    if fields:
        keep = set(fields) | {"scale_factor", "time", "step", "rng_key"}
        data = {k: v for k, v in data.items() if k in keep}
    meta = {}
    if config is not None:
        meta["config"] = config.to_dict()
    _makedirs_for(path)
    np.savez_compressed(path, __meta__=json.dumps(meta), **data)
    return path


def _save_snapshot_ascii(path: str, state: SimState) -> str:
    """Columns x y z vx vy vz mass, one header line with the scalars."""
    _makedirs_for(path)
    host = state_to_host(state)
    table = np.hstack([host["positions"], host["velocities"],
                       host["masses"][:, None]])
    header = (f"lambda_cdm_tpu snapshot  a={float(host['scale_factor'])!r} "
              f"time={float(host['time'])!r} step={int(host['step'])} "
              f"columns=x y z vx vy vz mass")
    np.savetxt(path, table, header=header)
    return path


def _fill_missing_fields(arrays: dict) -> dict:
    """Field-filtered snapshots may omit arrays: neutral values."""
    if "positions" not in arrays:
        raise KeyError("snapshot has no positions array")
    n = arrays["positions"].shape[0]
    defaults = {
        "velocities": lambda: np.zeros((n, 3), np.float32),
        "masses": lambda: np.ones((n,), np.float32),
        "scale_factor": lambda: np.float32(1.0),
        "time": lambda: np.float32(0.0),
        "step": lambda: np.int32(0),
    }
    for f, mk in defaults.items():
        if f not in arrays:
            arrays[f] = mk()
    return arrays


def load_snapshot(path: str, device="cuda") -> tuple[SimState, dict]:
    """(state on `device`, meta dict) from an npz snapshot."""
    _check_format(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"])) if "__meta__" in z else {}
        arrays = {f: z[f] for f in _STATE_FIELDS if f in z}
    return state_from_host(_fill_missing_fields(arrays), device), meta


def save_checkpoint(path: str, state: SimState, config=None,
                    statistics: dict | None = None) -> str:
    """Full checkpoint: the state, the config and the run statistics."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    meta = {"statistics": statistics or {}}
    if config is not None:
        meta["config"] = config.to_dict()
    _makedirs_for(path)
    np.savez_compressed(path, __meta__=json.dumps(meta),
                        **state_to_host(state))
    return path


def load_checkpoint(path: str, device="cuda") -> tuple[SimState, dict, dict]:
    """(state on `device`, config dict, statistics dict)."""
    if os.path.isdir(path):
        raise _not_ported("orbax checkpoints (directories)")
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"])) if "__meta__" in z else {}
        arrays = {f: z[f] for f in _STATE_FIELDS}
    return (state_from_host(arrays, device), meta.get("config", {}),
            meta.get("statistics", {}))
