"""Snapshot and checkpoint I/O (counterpart of
lambda_cdm_tpu/utils/checkpoint.py): npz snapshots (with the `fields`
filter and the config in `__meta__`), hdf5 snapshots (gzip, h5py),
`.lcdm` snapshots (the native checksummed codec, lambda_cdm_tpu_torch
.native) and ascii snapshots; npz checkpoints with the config and the run
statistics, and "orbax" checkpoint directories.

The npz, hdf5 and lcdm layouts are the JAX package's, so a file written
by either package loads in the other with bitwise arrays. The port's
SimState has no PRNG key: `rng_key` is written as two zero uint32 words
and ignored when loading.

Orbax is JAX-only. The port's `save_checkpoint_orbax` /
`load_checkpoint_orbax` keep the JAX names and layout of the directory
(one `step_XXXXXXXX` entry a checkpoint, the latest step loaded from a
parent directory), but each entry holds a `torch.save` file of the state:
it does NOT load across packages, in either direction, and a JAX orbax
directory handed to the port raises an error that says so.
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


ORBAX_STATE_FILE = "state.pt"     # the torch.save file of a step entry


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
    """Write a particle snapshot: `.lcdm` through the native codec,
    `.h5`/`.hdf5` as gzip hdf5, `.txt`/`.ascii` as whitespace columns,
    anything else as npz (`.npz` appended). `fields` filters the stored
    arrays of npz and hdf5; the scalars needed to read the snapshot are
    always kept."""
    if path.endswith(".lcdm"):
        from ..native import write_snapshot_native
        _makedirs_for(path)
        host = state_to_host(state)
        write_snapshot_native(path, host["positions"], host["velocities"],
                              host["masses"], float(host["scale_factor"]),
                              float(host["time"]), int(host["step"]))
        return path
    if path.endswith((".h5", ".hdf5")):
        return _save_snapshot_hdf5(path, state, config, fields)
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


def _save_snapshot_hdf5(path: str, state: SimState, config=None,
                        fields=None) -> str:
    """The JAX package's hdf5 layout: group `particles` with a gzip
    (level 4) dataset for each array, the scalars, `format_version` and
    the config (JSON) as file attributes."""
    import h5py
    _makedirs_for(path)
    data = state_to_host(state)
    if fields:
        keep = set(fields) | {"scale_factor", "time", "step", "rng_key"}
        data = {k: v for k, v in data.items() if k in keep}
    with h5py.File(path, "w") as f:
        g = f.create_group("particles")
        for k, v in data.items():
            if np.ndim(v) > 0:
                g.create_dataset(k, data=v, compression="gzip",
                                 compression_opts=4)
            else:
                f.attrs[k] = v
        f.attrs["format_version"] = 1
        if config is not None:
            f.attrs["config"] = json.dumps(config.to_dict())
    return path


def _load_snapshot_hdf5(path: str, device) -> tuple[SimState, dict]:
    import h5py
    arrays = {}
    meta = {}
    with h5py.File(path, "r") as f:
        for k in f["particles"]:
            arrays[k] = np.asarray(f["particles"][k])
        for k in f.attrs:
            if k == "config":
                meta["config"] = json.loads(f.attrs[k])
            elif k != "format_version":
                arrays[k] = np.asarray(f.attrs[k])
    return state_from_host(_fill_missing_fields(arrays), device), meta


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
    """(state on `device`, meta dict) from an hdf5, `.lcdm` or npz
    snapshot (`.npz` appended to any other name)."""
    if path.endswith((".h5", ".hdf5")):
        return _load_snapshot_hdf5(path, device)
    if path.endswith(".lcdm"):
        from ..native import read_snapshot_native
        pos, vel, mass, a, t, step = read_snapshot_native(path)
        return state_from_host({"positions": pos, "velocities": vel,
                                "masses": mass, "scale_factor": a,
                                "time": t, "step": step}, device), {}
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
    """(state on `device`, config dict, statistics dict) from an npz
    checkpoint (`.npz` appended to a name without it)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"])) if "__meta__" in z else {}
        arrays = {f: z[f] for f in _STATE_FIELDS}
    return (state_from_host(arrays, device), meta.get("config", {}),
            meta.get("statistics", {}))


# ---------------------------------------------------------------------------
# "orbax" checkpoint directories (port-only: torch.save, not Orbax)
# ---------------------------------------------------------------------------

def save_checkpoint_orbax(directory: str, state: SimState,
                          step: int | None = None) -> str:
    """Write `directory/step_XXXXXXXX/state.pt` (the state's arrays as host
    tensors, torch.save) and return the step directory: the JAX package's
    orbax layout with a torch.save entry, so it loads only in this
    package."""
    import torch
    directory = os.path.abspath(directory)
    step = int(state.step) if step is None else int(step)
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    arrays = {f: torch.from_numpy(np.array(v))
              for f, v in state_to_host(state).items()}
    tmp = os.path.join(path, ORBAX_STATE_FILE + f".{os.getpid()}.tmp")
    torch.save(arrays, tmp)
    os.replace(tmp, os.path.join(path, ORBAX_STATE_FILE))
    return path


def load_checkpoint_orbax(path: str, device="cuda") -> SimState:
    """The state of a checkpoint written by save_checkpoint_orbax, on
    `device`. `path` may be a `step_XXXXXXXX` directory or a parent
    holding them (the latest step wins). A directory the JAX package's
    Orbax wrote raises ValueError: orbax does not load across packages."""
    import torch
    path = os.path.abspath(path)
    if not os.path.basename(path).startswith("step_"):
        steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
        if not steps:
            raise FileNotFoundError(f"no step_* checkpoints under {path}")
        path = os.path.join(path, steps[-1])
    state_file = os.path.join(path, ORBAX_STATE_FILE)
    if not os.path.exists(state_file):
        raise ValueError(
            f"{path} holds no {ORBAX_STATE_FILE}: it is not a "
            f"lambda_cdm_tpu_torch checkpoint directory (a JAX package "
            f"orbax checkpoint? Orbax is JAX-only and does not load "
            f"across packages; write an npz checkpoint instead)")
    arrays = torch.load(state_file, map_location="cpu", weights_only=True)
    return state_from_host({f: v.numpy() for f, v in arrays.items()},
                           device)
