"""The 1D rank mesh on torch.distributed (counterpart of the slab part of
lambda_cdm_tpu/parallel/mesh.py).

Where the JAX package shards arrays over a `jax.sharding.Mesh` of devices
with the axis "shard", the port runs one process (rank) a shard: `Mesh`
wraps a `torch.distributed.device_mesh.DeviceMesh` with the axis name
"shard" over an initialised process group, names the device this rank
computes on, and holds the collectives the parallel modules need (ring
shift, all_to_all, all_reduce, all_gather, reduce_scatter), in one place.

Particle arrays shard along N: rank r holds the contiguous rows
[r n_loc, (r + 1) n_loc), the rows the JAX shard r holds (`shard_state`);
mesh grids shard along x in slabs of ng / D planes.

The backend decides the transport. NCCL moves card tensors. Gloo moves no
card tensor, so a rank computing on the card stages each collective's
tensors through host memory (copy out, collective, copy back), and
`make_mesh` says so when it builds such a mesh (`Mesh.transport`). Every
rank computes on its own device: there is no path that drops a rank's
compute to the CPU.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

from ..core.state import SimState

SHARD_AXIS = "shard"

_log = logging.getLogger("lambda_cdm_tpu")


def init_process_group(rank: int, world_size: int, init_method: str,
                       backend: str = "gloo") -> None:
    """Join the process group (`init_method` such as "tcp://localhost:PORT"
    or "file:///path"); nccl moves card tensors, gloo host tensors."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _log.info("rank %d of %d joined a %s process group", rank, world_size,
              backend)


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """One rank's view of the 1D "shard" mesh: `size` ranks, this `rank`,
    the `device` it computes on, and the collectives over the group."""

    def __init__(self, device_mesh, device, axis_name: str = SHARD_AXIS):
        self.device_mesh = device_mesh
        self.axis_name = axis_name
        self.group = device_mesh.get_group(axis_name)
        self.size = device_mesh.size()
        self.rank = device_mesh.get_local_rank(axis_name)
        self.device = torch.device(device)
        self.backend = dist.get_backend(self.group)
        # gloo moves host tensors only: card tensors go through the host
        self.staged = self.device.type == "cuda" and self.backend == "gloo"

    @property
    def transport(self) -> str:
        if self.staged:
            return "gloo, card tensors staged through host memory"
        return self.backend

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.staged else t

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device) if self.staged else t

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The reduction ("sum", "max" or "min") of t over the ranks, on
        t's device (t is left as it was)."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}
        buf = self._out(t).clone()
        dist.all_reduce(buf, op=ops[op], group=self.group)
        return self._back(buf, t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size * n, ...]: every rank's t (the same shape on each),
        concatenated along dim 0 in rank order."""
        src = self._out(t)
        out = src.new_empty((self.size * src.shape[0],) + src.shape[1:])
        dist.all_gather_into_tensor(out, src, group=self.group)
        return self._back(out, t)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t [size, ...]: chunk d goes to rank d; returns [size, ...] whose
        chunk d came from rank d (jax.lax.all_to_all over dim 0)."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all: dim 0 must be {self.size}, got "
                             f"{t.shape[0]}")
        src = self._out(t)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return self._back(out, t)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of t [size * k, ...], this rank's chunk
        [k, ...] of it (chunk r to rank r)."""
        src = self._out(t)
        if src.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: dim 0 ({src.shape[0]}) must "
                             f"divide by {self.size}")
        out = src.new_empty((src.shape[0] // self.size,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, group=self.group)
        return self._back(out, t)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send t to rank + 1 and return what rank - 1 sent (the JAX ring's
        ppermute s -> s + 1); t is the same shape on every rank."""
        if self.size == 1:
            return t
        src = self._out(t)
        out = torch.empty_like(src)
        ranks = dist.get_process_group_ranks(self.group)
        ops = [dist.P2POp(dist.isend, src, ranks[(self.rank + 1) % self.size],
                          self.group),
               dist.P2POp(dist.irecv, out,
                          ranks[(self.rank - 1) % self.size], self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(out, t)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def make_mesh(n_devices: int | None = None, axis_name: str = SHARD_AXIS,
              device=None) -> Mesh:
    """The 1D mesh over every rank of the initialised process group.
    `device` is where this rank computes: the card by default (card
    rank % count, so several ranks may share one card), or "cpu".
    `n_devices`, if given, must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group (parallel.mesh.init_process_group)")
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"requested {n_devices} ranks, the process group "
                         f"has {n}")
    if device is None or torch.device(device) == torch.device("cuda"):
        device = torch.device("cuda",
                              dist.get_rank() % torch.cuda.device_count())
    backend = dist.get_backend()
    # the mesh's own device type is where its collectives move tensors
    mesh = Mesh(DeviceMesh("cuda" if backend == "nccl" else "cpu",
                           list(range(n)), mesh_dim_names=(axis_name,)),
                device, axis_name)
    if mesh.staged and mesh.rank == 0:
        _log.warning("mesh of %d ranks on %s: gloo moves no card tensor, "
                     "so each collective is staged through host memory",
                     n, mesh.device)
    return mesh


def axis_size(mesh: Mesh, axis_name=SHARD_AXIS) -> int:
    """Ranks along the mesh axis."""
    return mesh.size


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of the rows of x, on the mesh device."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks "
                         f"(parallel.exchange.pad_particles pads them)")
    n_loc = n // mesh.size
    return x[mesh.rank * n_loc:(mesh.rank + 1) * n_loc].to(mesh.device)


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """A global SimState's rows of this rank (the JAX shard's rows), on
    the mesh device; the scalars as they are."""
    return state.replace(positions=shard_rows(state.positions, mesh),
                         velocities=shard_rows(state.velocities, mesh),
                         masses=shard_rows(state.masses, mesh))


def gather_state(state: SimState, mesh: Mesh) -> SimState:
    """The global SimState from every rank's rows, in rank order (the JAX
    package's row order of a sharded state); a collective."""
    return state.replace(positions=mesh.all_gather(state.positions),
                         velocities=mesh.all_gather(state.velocities),
                         masses=mesh.all_gather(state.masses))
