"""Start a multi-rank example: under torchrun join the process group
torchrun describes, otherwise spawn --ranks processes that join one over
a free localhost port. Each rank builds the 1D mesh over the group and
calls the example module's `run(mesh)`; rank 0's returned numbers come
back as JSON. The backend defaults to nccl when every rank has a card of
its own, else gloo (several ranks on one card: their exchanges are staged
through host memory, Mesh.transport)."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import tempfile

import torch


def _rank(rank: int, module: str, n_ranks: int, init_method: str,
          backend: str, device: str, result_path: str | None) -> dict:
    import torch.distributed as dist
    from lambda_cdm_tpu_torch.parallel import mesh as pmesh
    from lambda_cdm_tpu_torch.utils.precision import disable_tf32
    disable_tf32()
    if device == "cpu":       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    pmesh.init_process_group(rank, n_ranks, init_method, backend)
    try:
        out = importlib.import_module(module).run(
            pmesh.make_mesh(device=device))
        if rank == 0 and result_path:
            with open(result_path, "w") as f:
                json.dump(out, f)
        return out
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(module: str, argv, *, description: str,
         default_ranks: int) -> dict:
    """Parse --ranks, --device and --backend, run `module`'s run(mesh) on
    every rank and return rank 0's numbers."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--ranks", type=int, default=default_ranks,
                    help="ranks to spawn (ignored under torchrun)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    under_torchrun = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    n_ranks = int(os.environ["WORLD_SIZE"]) if under_torchrun \
        else args.ranks
    backend = args.backend or (
        "nccl" if args.device != "cpu"
        and torch.cuda.device_count() >= n_ranks else "gloo")
    if under_torchrun:
        return _rank(int(os.environ["RANK"]), module, n_ranks, "env://",
                     backend, args.device, None)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "rank0.json")
        mp.start_processes(
            _rank, args=(module, n_ranks,
                         f"tcp://localhost:{_free_port()}", backend,
                         args.device, result),
            nprocs=n_ranks, join=True, start_method="spawn")
        with open(result) as f:
            return json.load(f)
