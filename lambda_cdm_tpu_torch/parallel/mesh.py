"""The rank mesh on torch.distributed (counterpart of
lambda_cdm_tpu/parallel/mesh.py).

Where the JAX package shards arrays over a `jax.sharding.Mesh` of devices
with named axes, the port runs one process (rank) a shard: `Mesh` wraps a
`torch.distributed.device_mesh.DeviceMesh` over an initialised process
group, names the device this rank computes on, and holds the collectives
the parallel modules need, in one place:

  * over the whole grid, in the flattened (row-major) rank order, which
    is the JAX device order of a mesh's devices: all_to_all, all_reduce,
    all_gather, reduce_scatter and the ring shift;
  * along one named axis: `shift`, to the rank at coordinate +-1 (mod the
    axis size) inside that axis's sub-group (jax.lax.ppermute over one
    mesh axis);
  * along one named axis or a tuple of axes in mesh order: `all_to_all`
    and `axis_index` (jax.lax.all_to_all and jax.lax.axis_index over
    those axes). A tuple's ranks are ordered first-major, the first axis
    slowest (the (shy, shz) index is iy dz + iz), as JAX's tuple-axis
    collectives order them; its sub-groups are built once with the mesh,
    collectively on every rank.

Three grids: `make_mesh`, the 1D "shard" axis (slabs); `make_mesh3d`,
(dx, dy, dz) ranks with the axes ("shx", "shy", "shz") (blocks; a 2D
(shx, shy) request is the (dx, dy, 1) grid); and `make_mesh2d`, the (dx,
dy) grid with ("shx", "shy"). Particle arrays shard along N: rank r holds
the contiguous rows [r n_loc, (r + 1) n_loc), the rows the JAX shard r
holds (`shard_state`); mesh grids shard along x in slabs of ng / D planes
over all D ranks.

The backend decides the transport. NCCL moves card tensors. Gloo moves no
card tensor, so a rank computing on the card stages each collective's
tensors through host memory (copy out, collective, copy back), and
`make_mesh` says so when it builds such a mesh (`Mesh.transport`). Every
rank computes on its own device: there is no path that drops a rank's
compute to the CPU.
"""

from __future__ import annotations

import itertools
import logging
import math

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
    """One rank's view of a mesh of `dims` ranks along `axis_names`:
    `size` ranks in all, this flat `rank` (row-major), its `coords`, the
    `device` it computes on, and the collectives over the whole grid and
    along each axis."""

    def __init__(self, device_mesh, device, axis_names=(SHARD_AXIS,),
                 tuple_groups=None):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.dims = tuple(int(d) for d in device_mesh.shape)
        self.group = dist.group.WORLD
        self.size = device_mesh.size()
        self.rank = dist.get_rank()
        self.coords = tuple(device_mesh.get_coordinate())
        self._axis_groups = {a: device_mesh.get_group(a)
                             for a in self.axis_names}
        self._axis_groups.update(tuple_groups or {})
        self._axis_groups[self.axis_names] = self.group
        self.device = torch.device(device)
        self.backend = dist.get_backend(self.group)
        # gloo moves host tensors only: card tensors go through the host
        self.staged = self.device.type == "cuda" and self.backend == "gloo"

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def shape(self) -> dict:
        """{axis name: ranks along it} (jax.sharding.Mesh.shape)."""
        return dict(zip(self.axis_names, self.dims))

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

    def _axes(self, axis) -> tuple:
        """`axis` (a name or a tuple of names) as a tuple in mesh order."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        pos = [self.axis_names.index(a) for a in axes]
        if pos != sorted(set(pos)):
            raise ValueError(f"axes {axes} must be distinct and in the "
                             f"mesh's order {self.axis_names}")
        return axes

    def axis_index(self, axis) -> int:
        """This rank's index along `axis`, a name or a tuple of names
        (first-major: the first axis slowest; jax.lax.axis_index)."""
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.shape[a] + self.coord(a)
        return idx

    def all_to_all(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        """t [d, ...]: chunk i goes to the rank at index i along `axis` (a
        name, a tuple of names in mesh order, or None: the whole grid in
        the flattened order), the other coordinates kept; returns [d, ...]
        whose chunk i came from the rank at index i (jax.lax.all_to_all
        over dim 0, untiled). On an axis of one rank that is t itself."""
        if axis is None:
            group, d = self.group, self.size
        else:
            axes = self._axes(axis)
            d = math.prod(self.shape[a] for a in axes)
            group = self._axis_groups[axes[0] if len(axes) == 1 else axes]
        if t.shape[0] != d:
            raise ValueError(f"all_to_all: dim 0 must be {d}, got "
                             f"{t.shape[0]}")
        if d == 1:
            return t
        src = self._out(t)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
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

    def _exchange(self, t: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        """Send t to global rank `to`, return what global rank `frm` sent
        (the same shape); one send and one receive."""
        src = self._out(t)
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, to),
               dist.P2POp(dist.irecv, out, frm)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(out, t)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send t to rank + 1 and return what rank - 1 sent, over the
        flattened rank order (the JAX ring's ppermute s -> s + 1); t is the
        same shape on every rank."""
        if self.size == 1:
            return t
        return self._exchange(t, (self.rank + 1) % self.size,
                              (self.rank - 1) % self.size)

    def coord(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.coords[self.axis_names.index(axis)]

    def shift(self, t: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        """Send t to the rank at coordinate + step (mod the axis size)
        along `axis`, the other coordinates kept, and return what the rank
        at coordinate - step sent (jax.lax.ppermute s -> s + step over one
        mesh axis). On an axis of one rank that is t itself; on an axis of
        two, +1 and -1 reach the same peer, one call at a time."""
        i = self.axis_names.index(axis)
        d = self.dims[i]
        if d == 1:
            return t
        ranks = dist.get_process_group_ranks(self._axis_groups[axis])
        c = self.coords[i]
        return self._exchange(t, ranks[(c + step) % d], ranks[(c - step) % d])

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def _tuple_groups(dims: tuple, axis_names: tuple) -> dict:
    """{each tuple of two or more axes in mesh order, short of all of them:
    this rank's sub-group over them}, its ranks in first-major order of
    the tuple's coordinates (ascending global rank, as the row-major grid
    numbers them). Every rank builds every sub-group, collectively."""
    out = {}
    grid = torch.arange(math.prod(dims)).reshape(dims)
    for k in range(2, len(dims)):
        for sub in itertools.combinations(range(len(dims)), k):
            rest = [i for i in range(len(dims)) if i not in sub]
            members = grid.permute(rest + list(sub)).reshape(
                -1, math.prod(dims[i] for i in sub))
            mine, _ = dist.new_subgroups_by_enumeration(members.tolist())
            out[tuple(axis_names[i] for i in sub)] = mine
    return out


def _grid(dims: tuple, axis_names: tuple, device) -> Mesh:
    """The mesh of `dims` ranks (their product the world size) with
    `axis_names`, ranks in row-major order; `device` as make_mesh's."""
    if not dist.is_initialized():
        raise RuntimeError("a rank mesh needs an initialised "
                           "torch.distributed process group "
                           "(parallel.mesh.init_process_group)")
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    if math.prod(dims) != n:
        raise ValueError(f"mesh {tuple(dims)} needs {math.prod(dims)} ranks, "
                         f"the process group has {n}")
    if device is None or torch.device(device) == torch.device("cuda"):
        device = torch.device("cuda",
                              dist.get_rank() % torch.cuda.device_count())
    backend = dist.get_backend()
    # the mesh's own device type is where its collectives move tensors
    mesh = Mesh(DeviceMesh("cuda" if backend == "nccl" else "cpu",
                           torch.arange(n).reshape(dims),
                           mesh_dim_names=tuple(axis_names)),
                device, axis_names, _tuple_groups(dims, axis_names))
    if mesh.staged and mesh.rank == 0:
        _log.warning("mesh %s of %d ranks on %s: gloo moves no card "
                     "tensor, so each collective is staged through host "
                     "memory", dict(mesh.shape), n, mesh.device)
    return mesh


def make_mesh(n_devices: int | None = None, axis_name: str = SHARD_AXIS,
              device=None) -> Mesh:
    """The 1D mesh over every rank of the initialised process group.
    `device` is where this rank computes: the card by default (card
    rank % count, so several ranks may share one card), or "cpu".
    `n_devices`, if given, must be the world size."""
    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"requested {n_devices} ranks, the process group "
                         f"has {n}")
    return _grid((n,), (axis_name,), device)


X_AXIS, Y_AXIS, Z_AXIS = "shx", "shy", "shz"
AXES_3D = (X_AXIS, Y_AXIS, Z_AXIS)


def make_mesh2d(shape: tuple | None = None,
                axis_names: tuple = (X_AXIS, Y_AXIS), device=None) -> Mesh:
    """The 2D (dx, dy) mesh over the process group's ranks; `shape=None`
    takes the most square factorisation of the world size (JAX
    make_mesh2d's)."""
    if shape is None:
        n = world_size()
        dx = int(math.isqrt(n))
        while n % dx:
            dx -= 1
        shape = (dx, n // dx)
    return _grid(tuple(shape), axis_names, device)


def make_mesh3d(shape: tuple | None = None, axis_names: tuple = AXES_3D,
                device=None) -> Mesh:
    """The 3D (dx, dy, dz) block mesh over the process group's ranks (the
    reference's MPI_Dims_create(3) Cartesian communicator); `shape=None`
    takes JAX make_mesh3d's most cubic factorisation of the world size."""
    if shape is None:
        n = world_size()
        dx = max(d for d in range(1, int(round(n ** (1 / 3))) + 1)
                 if n % d == 0)
        rem = n // dx
        dy = int(math.isqrt(rem))
        while rem % dy:
            dy -= 1
        shape = (dx, dy, rem // dy)
    return _grid(tuple(shape), axis_names, device)


def axis_size(mesh: Mesh, axis_name=None) -> int:
    """Ranks along a mesh axis, the product over a tuple of axes, or (no
    axis named) the whole mesh's."""
    if axis_name is None:
        return mesh.size
    if isinstance(axis_name, tuple):
        return math.prod(mesh.shape[a] for a in axis_name)
    return mesh.shape[axis_name]


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
