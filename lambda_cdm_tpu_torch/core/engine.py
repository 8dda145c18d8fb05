"""SimulationEngine + SimulationBuilder on one device (counterpart of
lambda_cdm_tpu/core/engine.py).

The engine generates (or accepts) a SimState on `device` and advances it
in output-cadence chunks on one of two branches:

* stateless solvers (forces.type direct, direct_reference, pm, treepm, or
  a registered plugin): a Python loop of kdk_step_fused with one force
  evaluation a step, the closing force of a step opening the next (the
  JAX engine's jit(scan) chunk); the cached acceleration feeds the
  adaptive timestep;
* treepm_fast and pm_fast (the unsplit PM alone): the state is bucketed
  into the persistent FastState (ops/fast_treepm) and each chunk applies
  the proactive drift guard,
carries the rebucket cadence across chunks, grows the bucket capacity
and retries when a rebucket would overflow, halves the cadence when
deposits were dropped, and syncs the public SimState (original particle
order, positions wrapped into the box) for the observers. One device and
the ranks' sharded steppers share that set-up, chunk and grow-and-retry
loop through one record, FastStepper, which holds where they differ.

Diagnostics (energy, momentum, angular momentum), the force-accuracy
harness (validate_force_accuracy against a direct-sum oracle), npz
snapshots and checkpoints (periodic ones at
simulation.checkpoint_frequency, timed into statistics.io_time_s) and
resume follow the JAX engine.

`warmup` builds the kernels and runs the run loop's programs once before
the first step; `profiling.trace_dir` traces run() with torch.profiler
(utils/profiling.trace_dir). The run loop, the reset and the fast stepper
record spans and counters (utils/profiling.span, count) while a torch
profiler is active or `profiling.tracing()` is open, which
profiling.detailed_timing opens for a run.

compute.mesh (the JAX engine's _init_mesh_path / _mesh_migrate) runs on
the ranks of an initialised torch.distributed process group when there
are more than one (on one rank the run is the single-device one, as the
JAX engine's on one device). treepm_fast runs a sharded fast stepper
(the JAX engine's _try_init_mesh_fast_path): parallel/fast_mesh on the
1D slab mesh (axes without shz and without both shx and shy),
parallel/fast_mesh2d on {shx, shy} (z-pencil rods), parallel/fast_mesh3d
on {shx, shy, shz} (blocks). Every rank buckets the same global state
and keeps its cells between steps, the stepper migrates inside its
rebucket, the chunk grows the capacity and retries (6 times, then counts
the loss), and `state` is the global state in the original particle
order on every rank, synced at each chunk end; where the stepper's plan
is None, or with shz alone, the run takes the stateless sharded TreePM,
as the JAX engine does. Otherwise every rank builds the same global
initial state, pads it
(compute.mesh.migrate_capacity_factor) and keeps its rows
(parallel/mesh.shard_state) on the 1D slab mesh, or on the 3D block mesh
of compute.mesh.axes {shx, shy, shz} ({shx, shy}: the (dx, dy, 1) grid);
the forces are the ring direct sum (direct, direct_reference), the
sharded TreePM (treepm, and treepm_fast where no fast stepper applies:
halo short range, or the ring where the slab plan is None), or the
sharded PM (pm, pm_fast); energy is parallel/sharded.sharded_energy, and
the run loop re-homes particles between chunks (emigrant-only exchange
with grow-and-retry; adaptive bounds for direct, direct_reference and
pm, uniform slabs or blocks otherwise). `state` is then the global
padded state gathered in rank order (a collective: every rank reads it
together), and rank 0 writes the files.
"""

from __future__ import annotations

import contextlib
import enum
import functools
import logging
import math
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from .config import SimulationConfig
from .observers import Observer, ObserverBus
from .state import SimState, host_scalar
from ..ops.direct import check_range
from ..utils import profiling
from ..utils.profiling import Profiler, count, span, synchronize

_log = logging.getLogger("lambda_cdm_tpu")


def _force_seconds() -> tuple:
    """(count, device seconds) of the `fast.accel` spans reduced so far."""
    tot = profiling.totals_of("fast.accel")
    return (tot.count, tot.device_s) if tot is not None else (0, 0.0)


def _live_rows(fstate):
    """(positions, velocities, masses, ids) of the slots of fstate that
    hold a particle (id >= 0), in slot order."""
    from ..ops.fast_treepm import flatten_fast_state
    pos, vel, mass, ids = flatten_fast_state(fstate, with_ids=True)
    live = ids >= 0
    count("readbacks", 4)            # each boolean mask waits
    return pos[live], vel[live], mass[live], ids[live]


class FastStepper(NamedTuple):
    """The fast stepper the engine drives, with the configuration's
    keywords bound into `initialize` (and the mesh into both functions on
    ranks): ops/fast_treepm's initialize_fast and fast_run on one device,
    or a sharded stepper's (parallel/fast_mesh, fast_mesh2d,
    fast_mesh3d). Where the two differ, the difference is here: `rows`
    gives the live rows of every rank (a collective on ranks), `all_max`
    the largest of a [1] tensor over the ranks; ranks grow and retry
    `retries` times, then count the loss (strays farther than a neighbour
    slab are not cured by capacity); `carry_drops`: a grown state's first
    force adds its drops to the counter (the JAX engine's does on one
    device, not on ranks)."""
    initialize: Callable
    run: Callable
    rows: Callable
    all_max: Callable
    retries: float
    carry_drops: bool
    mesh: object                     # parallel.mesh.Mesh, None on one device

    @property
    def ndim(self) -> int:
        """The rank grid's dimensions: 0 on one device, 1 on the slabs, 2
        on the pencils, 3 on the blocks."""
        return 0 if self.mesh is None else self.mesh.ndim


class LifecycleState(enum.Enum):
    UNINITIALIZED = "uninitialized"
    INITIALIZED = "initialized"
    RUNNING = "running"
    PAUSED = "paused"
    FINISHED = "finished"
    ERROR = "error"


@dataclass
class SimulationStatistics:
    """Run statistics (fields as in the JAX package)."""
    total_steps: int = 0
    total_time_s: float = 0.0
    compile_time_s: float = 0.0
    compute_time_s: float = 0.0
    force_time_s: float = 0.0
    integration_time_s: float = 0.0
    analysis_time_s: float = 0.0
    io_time_s: float = 0.0
    steps_per_second: float = 0.0
    particle_updates_per_second: float = 0.0
    current_scale_factor: float = 0.0
    current_redshift: float = 0.0
    current_time: float = 0.0
    time_units: str = "internal"
    energy_error: float = 0.0
    force_avg_err: float = 0.0
    force_max_err: float = 0.0

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["force_avg_rel_err"] = self.force_avg_err
        d["force_max_rel_err"] = self.force_max_err
        return d


class SimulationEngine:
    """Config-driven Lambda-CDM engine on one device (`device`, default
    "cuda"; pass "cpu" to run the kernels' plain PyTorch versions)."""

    def __init__(self, config: SimulationConfig | None = None,
                 observers=None, device="cuda"):
        self.config = config or SimulationConfig()
        from .config import configure_logging
        configure_logging(self.config)
        self.device = torch.device(device)
        self.lifecycle = LifecycleState.UNINITIALIZED
        self.observers = ObserverBus(observers)
        self.profiler = Profiler(enabled=self.config.profiling.enabled)
        self.statistics = SimulationStatistics()
        self.last_energy_error: float | None = None
        self._state: SimState | None = None
        self._fstate = None
        self._fast_kw: dict | None = None     # the stepper's dict
        # kept through release_force_state(): the next run/step re-buckets
        self._stepper: FastStepper | None = None
        self._state_sharded = False       # _state holds this rank's rows
        self._acc = None                  # accelerations at state.positions
        # (key, kdk_factors of the steps) computed ahead by the last chunk
        self._ahead = None
        self._accel_fn = None
        self._dt = None
        self._mesh = None                 # parallel.mesh.Mesh (compute.mesh)
        self._mesh_bounds = None
        self.mesh_overflow = 0            # the last migration's overflow
        # the sharded TreePM's last {"overflow", "plan"} (return_diagnostics)
        self.mesh_force_diagnostics = None

    # -- properties ---------------------------------------------------------
    @property
    def state(self) -> SimState:
        """The simulation state; on the stateless mesh path the global
        (padded) state gathered in rank order, a collective every rank
        reads together (the sharded fast stepper keeps the global state on
        every rank)."""
        if self._state is None:
            raise RuntimeError("engine not initialized")
        if self._state_sharded:
            from ..parallel.mesh import gather_state
            return gather_state(self._state, self._mesh)
        return self._state

    @state.setter
    def state(self, new_state: SimState) -> None:
        if self._state_sharded:
            from ..parallel.mesh import shard_state
            self._state = shard_state(new_state, self._mesh)
        else:
            self._state = self._on_device(new_state)
        self._acc = None
        if self._fstate is not None and not self._init_fast(self._state):
            self._init_mesh_path(self._state)

    @property
    def accel_fn(self):
        """The stateless solver's `accel_fn(state) -> [N, 3]`."""
        if self._accel_fn is None:
            raise RuntimeError("engine not initialized")
        return self._accel_fn

    def _on_device(self, st: SimState) -> SimState:
        return st.replace(positions=st.positions.to(self.device),
                          velocities=st.velocities.to(self.device),
                          masses=st.masses.to(self.device))

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, state: SimState | None = None) -> None:
        """Validate the config, generate (or accept) the initial state and
        build the force solver: the persistent buckets of treepm_fast, or
        the registry's accel_fn for a stateless solver."""
        try:
            cfg = self.config
            cfg.validate()
            use_mesh = self._on_ranks()
            # pm_fast on ranks is the sharded PM (the JAX engine's rule)
            use_fast = cfg.forces.type == "treepm_fast" or (
                cfg.forces.type == "pm_fast" and not use_mesh)
            if state is None:
                from ..physics.initial_conditions import generate_state
                state = generate_state(cfg, device=self.device)
            if not (use_fast and self._init_fast(state)):
                if use_mesh:
                    self._init_mesh_path(state)
                else:
                    from ..forces import create_force_computer
                    self._accel_fn = create_force_computer(cfg)
                    self._state = self._on_device(state)
            self._acc = None
            self._dt = host_scalar(cfg.time.initial_timestep)
            if cfg.validation.check_initial_conditions:
                self._validate_state()
            if cfg.validation.validate_forces:
                self.validate_force_accuracy(
                    n_sample=cfg.validation.force_samples)
            self.lifecycle = LifecycleState.INITIALIZED
        except Exception as exc:
            self.lifecycle = LifecycleState.ERROR
            self.observers.notify("on_error", self, exc)
            raise

    def _validate_state(self) -> None:
        st = self.state
        box = self.config.particles.box_size
        pos = st.positions
        if bool(torch.any(~torch.isfinite(pos))):
            raise ValueError("non-finite positions in initial conditions")
        if self.config.particles.periodic_boundaries and (
                bool(torch.any(pos < 0)) or bool(torch.any(pos >= box))):
            raise ValueError("positions outside [0, box)")
        if bool(torch.any(st.masses < 0)):
            raise ValueError("negative particle masses")
        if not bool(torch.any(st.masses > 0)):
            raise ValueError("no live particles (all masses zero)")
        if self._mesh is None and bool(torch.any(st.masses == 0)):
            raise ValueError("zero-mass particles outside mesh-padding mode")

    # -- multi-rank path: the rank mesh on torch.distributed -----------------
    def _on_ranks(self) -> bool:
        """Whether the run is sharded over ranks: compute.mesh and a
        process group of more than one (on one rank the JAX engine runs
        its single-device path, and so does this one)."""
        if not self.config.compute.mesh.enabled:
            return False
        from ..parallel.mesh import world_size
        return world_size() > 1

    def _init_mesh_path(self, state: SimState) -> None:
        """Shard the run over the rank mesh (the JAX engine's
        _init_mesh_path): compute.mesh.axes with shx, shy and shz builds
        the 3D block mesh, shx and shy the (dx, dy, 1) one, anything else
        the 1D slab mesh. Pad the global state with zero-mass rows
        (compute.mesh.migrate_capacity_factor), keep this rank's rows,
        build the force (the ring direct sum; the sharded TreePM, halo or,
        on a slab mesh where the plan is None, ring short range; else the
        sharded PM), and home the rows before the first force: against
        load-adaptive bounds for direct, direct_reference and pm when
        compute.mesh.load_balancing, against uniform slabs or blocks
        otherwise (the halo TreePM needs them aligned with its cell
        planes, and the JAX engine leaves pm_fast out too)."""
        from ..forces import auto_pm_grid
        from ..parallel.exchange import pad_particles
        from ..parallel.mesh import make_mesh, make_mesh3d, shard_state
        from ..parallel.sharded import (ring_direct_accelerations,
                                        sharded_pm_accelerations)
        cfg = self.config
        axes = dict(cfg.compute.mesh.axes or {})
        if all(a in axes for a in ("shx", "shy", "shz")):
            mesh = make_mesh3d((int(axes["shx"]), int(axes["shy"]),
                                int(axes["shz"])), device=self.device)
        elif all(a in axes for a in ("shx", "shy")):
            # the generic solvers on pencils: the z = 1 block mesh (its z
            # shifts return their input, the one-rank wrap)
            mesh = make_mesh3d((int(axes["shx"]), int(axes["shy"]), 1),
                               device=self.device)
        else:
            mesh = make_mesh(device=self.device)
        pos, vel, mass = pad_particles(
            state.positions, state.velocities, state.masses,
            n_dev=mesh.size, factor=cfg.compute.mesh.migrate_capacity_factor)
        self._mesh = mesh
        self._state = shard_state(state.replace(
            positions=pos, velocities=vel, masses=mass), mesh)
        self._state_sharded = True
        box = cfg.particles.box_size
        soft = cfg.forces.softening_length
        g = cfg.units.G
        solver = cfg.forces.type
        if solver in ("direct", "direct_reference"):
            def accel_fn(st):
                return ring_direct_accelerations(
                    st.positions, st.masses, box_size=box, softening=soft,
                    g_const=g, mesh=mesh)
        elif solver in ("treepm", "treepm_fast"):
            accel_fn = self._mesh_treepm(pos.shape[0])
        else:
            ng = auto_pm_grid(cfg)

            def accel_fn(st):
                return sharded_pm_accelerations(
                    st.positions, st.masses, ng, box, g, mesh=mesh)
        self._accel_fn = accel_fn
        self._mesh_bounds = None
        if self._mesh_balanced():
            # a heavy cluster may not fit a uniform slab's rows, so the
            # ownership-agnostic solvers home on adaptive bounds at once
            self._mesh_bounds = self._adaptive_bounds()
        self._mesh_migrate()

    def _mesh_treepm(self, n_alloc: int):
        """The sharded TreePM's accel_fn over the padded global count
        n_alloc: raise the JAX engine's ValueError when the 3D plan is
        None, log the ring short range when the slab plan is. Each call
        keeps its diagnostics in mesh_force_diagnostics."""
        from ..forces import auto_pm_grid
        from ..parallel.sharded_treepm import (sharded_treepm_accelerations,
                                               sharded_treepm_plan,
                                               sharded_treepm_plan_3d)
        cfg = self.config
        mesh = self._mesh
        ng = auto_pm_grid(cfg)
        kw = dict(split_factor=cfg.forces.split_factor,
                  cut_factor=cfg.forces.cut_factor,
                  capacity=cfg.forces.bucket_capacity,
                  occupancy_headroom=cfg.compute.mesh.ghost_capacity_factor)
        box = cfg.particles.box_size
        if mesh.ndim == 3:
            if sharded_treepm_plan_3d(n_alloc, box, ng, mesh.dims,
                                      **kw) is None:
                raise ValueError(
                    "compute.mesh 3D axes: box too small for one r_cut cell "
                    "per device along every axis; use the 1D slab mesh "
                    "(omit shz) for this geometry")
        elif sharded_treepm_plan(n_alloc, box, ng, mesh.size, **kw) is None:
            _log.info("mesh treepm: box too small for one r_cut cell plane "
                      "per device; using the exact ring short-range")

        def accel_fn(st):
            acc, self.mesh_force_diagnostics = sharded_treepm_accelerations(
                st.positions, st.masses, box_size=box, pm_grid=ng,
                softening=cfg.forces.softening_length, g_const=cfg.units.G,
                mesh=mesh, return_diagnostics=True, **kw)
            return acc
        return accel_fn

    def _mesh_balanced(self) -> bool:
        """Whether the mesh homes against load-adaptive bounds: only the
        ownership-agnostic solvers, and only with
        compute.mesh.load_balancing (the JAX engine's gate)."""
        return (self.config.compute.mesh.load_balancing
                and self.config.forces.type in ("direct",
                                                 "direct_reference", "pm"))

    def _balance_weights(self):
        """None for count balancing, or the pair-cost weights of this
        rank's rows (compute.mesh.balance_weight="pair_cost")."""
        if self.config.compute.mesh.balance_weight != "pair_cost":
            return None
        from ..parallel.exchange import pair_cost_weights
        st = self._state
        return pair_cost_weights(st.positions, st.masses,
                                 self.config.particles.box_size,
                                 mesh=self._mesh)

    def _adaptive_bounds(self):
        """Equal-load bounds from every rank's rows: slab planes [D + 1] on
        the 1D mesh, adaptive_bounds_nd's bricks on the 3D one."""
        from ..parallel.exchange import (adaptive_bounds_nd,
                                         adaptive_slab_bounds)
        st = self._state
        mesh = self._mesh
        box = self.config.particles.box_size
        if mesh.ndim == 3:
            return adaptive_bounds_nd(st.positions, st.masses, mesh.dims, box,
                                      weights=self._balance_weights(),
                                      mesh=mesh)
        return adaptive_slab_bounds(st.positions, st.masses, mesh.size, box,
                                    weights=self._balance_weights(),
                                    mesh=mesh)

    def _mesh_migrate(self) -> None:
        """Re-home particles to their owning slabs or blocks (between
        chunks): where the bounds are adaptive (_mesh_balanced), recompute
        them when the live-count imbalance exceeds
        compute.mesh.rebalance_threshold; then the emigrant-only
        exchange at a capacity of compute.mesh.migrate_fraction of the
        rows (at least 128), discarding an overflowed result and retrying
        at twice the capacity up to the rows a rank holds."""
        from ..parallel.exchange import (load_imbalance,
                                         migrate_particles_emigrant)
        cfg = self.config
        st = self._state
        mesh = self._mesh
        n_loc = st.positions.shape[0]
        bounds = self._mesh_bounds
        if self._mesh_balanced():
            imb = load_imbalance(st.masses, mesh=mesh,
                                 weights=self._balance_weights())
            if imb > cfg.compute.mesh.rebalance_threshold:
                bounds = self._mesh_bounds = self._adaptive_bounds()
        cap = min(max(128, int(cfg.compute.mesh.migrate_fraction * n_loc)),
                  n_loc)
        while True:
            pos, vel, mass, overflow = migrate_particles_emigrant(
                st.positions, st.velocities, st.masses,
                box_size=cfg.particles.box_size, capacity=cap, mesh=mesh,
                bounds=bounds)
            self.mesh_overflow = overflow
            if overflow == 0:
                self._state = st.replace(positions=pos, velocities=vel,
                                         masses=mass)
                break
            if cap >= n_loc:
                _log.warning(
                    "mesh migration overflow persists at capacity %d (%d "
                    "particles); keeping the stale partition -- raise "
                    "compute.mesh.migrate_capacity_factor", cap, overflow)
                break
            cap = min(cap * 2, n_loc)
        self._acc = None

    # -- treepm_fast path: persistent cell-list state ------------------------
    def _stepper_kw(self) -> dict:
        """The fast steppers' keywords from the configuration (every
        initializer takes them), kdk_factors' among them."""
        from ..forces import auto_pm_grid
        cfg = self.config
        return dict(self._factor_kw(), box_size=cfg.particles.box_size,
                    pm_grid=auto_pm_grid(cfg),
                    softening=cfg.forces.softening_length,
                    g_const=cfg.units.G, split_factor=cfg.forces.split_factor,
                    cut_factor=cfg.forces.cut_factor,
                    capacity=cfg.forces.bucket_capacity)

    def _fast_stepper(self) -> FastStepper | None:
        """The fast stepper the configuration chooses, its keywords bound:
        ops/fast_treepm's on one device; on ranks (the JAX engine's
        _try_init_mesh_fast_path) with compute.mesh.axes shx, shy and shz
        the 3D block stepper (parallel/fast_mesh3d), with shx and shy the
        2D pencil one (fast_mesh2d), without shz the 1D slab one
        (fast_mesh), and None with shz alone, where the JAX engine takes
        the stateless sharded TreePM."""
        cfg = self.config
        kw = self._stepper_kw()
        if not self._on_ranks():
            from ..ops import fast_treepm as ft
            return FastStepper(
                initialize=functools.partial(
                    ft.initialize_fast, gradient=cfg.forces.gradient,
                    pm_only=cfg.forces.type == "pm_fast", **kw),
                run=ft.fast_run, rows=_live_rows, all_max=lambda t: t,
                retries=math.inf, carry_drops=True, mesh=None)
        from ..parallel import mesh as pmesh
        from ..parallel.fast_mesh import gather_fast_state
        axes = dict(cfg.compute.mesh.axes or {})
        dims = tuple(int(axes[a]) for a in pmesh.AXES_3D if a in axes)
        if len(dims) == 3:
            from ..parallel import fast_mesh3d as m
            mesh = pmesh.make_mesh3d(dims, device=self.device)
            init, run = m.initialize_mesh_fast3d, m.mesh_fast_run3d
        elif "shz" in axes:
            return None
        elif len(dims) == 2:
            from ..parallel import fast_mesh2d as m
            mesh = pmesh.make_mesh2d(dims, device=self.device)
            init, run = m.initialize_mesh_fast2d, m.mesh_fast_run2d
        else:
            from ..parallel import fast_mesh as m
            mesh = pmesh.make_mesh(device=self.device)
            init, run = m.initialize_mesh_fast, m.mesh_fast_run
        return FastStepper(
            initialize=functools.partial(init, mesh=mesh, **kw),
            run=functools.partial(run, mesh=mesh),
            rows=lambda fs: _live_rows(gather_fast_state(fs, mesh)),
            all_max=lambda t: mesh.all_reduce(t, "max"),
            retries=6, carry_drops=False, mesh=mesh)

    def _init_fast(self, state: SimState) -> bool:
        """The fast stepper's set-up (span `engine.init_fast`): the stepper
        `_fast_stepper` chooses buckets `state` once and evaluates its
        first force, without grow-and-retry. On ranks every rank buckets
        the same global state and keeps its cells, and `state` stays the
        global state on every rank. False, where the JAX engine takes the
        stateless sharded TreePM instead: shz alone, or a box whose
        sharded plan is None (logged)."""
        self._fstate = self._fast_kw = self._stepper = None
        stepper = self._fast_stepper()
        if stepper is None:
            return False
        state = self._on_device(state)
        t0 = time.perf_counter()
        with span("engine.init_fast", device=state.positions.is_cuda):
            profiling.set_step(state.step)
            try:
                fstate, kw = stepper.initialize(
                    state.positions, state.velocities, state.masses,
                    state.scale_factor, time=state.time, step=state.step)
            except ValueError as exc:
                if stepper.mesh is None:
                    raise
                _log.info("mesh treepm_fast unavailable (%s); falling back "
                          "to the stateless sharded TreePM", exc)
                return False
            synchronize(fstate.acc)
        self.statistics.compile_time_s += time.perf_counter() - t0
        self._stepper, self._fstate, self._fast_kw = stepper, fstate, kw
        self._state, self._state_sharded = state, False
        self._mesh, self._mesh_bounds = stepper.mesh, None
        self._accel_fn = None
        self._fast_n = state.positions.shape[0]
        self._fast_since_rebucket = 0
        return True

    def _fast_cadence(self, n: int) -> int:
        """The rebucket cadence of a fast chunk of `n` steps: the
        configured (or halved) cadence, bounded by the drift guard and
        snapped to a divisor of `n` (span `engine.cadence`)."""
        from ..physics.integrators import drift_factor
        with span("engine.cadence"):
            kw = self._fast_kw
            rebucket_every = getattr(self, "_fast_rebucket_every", None) \
                or self.config.forces.rebucket_every
            # proactive drift guard: bound the steps between rebuckets by
            # the distance the fastest particle can drift into the deposit
            # margin (one vmax readback per chunk; on ranks the largest over
            # them, so every rank picks the same cadence)
            a0 = float(self._fstate.scale_factor)
            df = float(drift_factor(a0, kw["kick_mode"]))
            vmax = self._stepper.all_max(
                torch.max(torch.abs(self._fstate.bvel)).reshape(1))
            count("readbacks")
            vmax = float(vmax[0])
            step_drift = vmax * float(self._dt) * df
            margin_dist = (kw["margin"] * kw["box_size"]
                           / max(kw["ng"], kw["ncell"]))
            if step_drift > 0:
                safe = max(1, int(0.6 * margin_dist / step_drift))
                if safe < rebucket_every:
                    rebucket_every = safe
            # snap the cadence to a divisor of the chunk length (as the
            # JAX engine does, so both packages rebucket at the same steps)
            d = max(1, min(rebucket_every, n))
            while n % d:
                d -= 1
            return d

    def _fast_chunk(self, n: int) -> None:
        from ..ops.fast_treepm import BucketOverflowError, \
            next_rebucket_offset
        params = self.config.cosmology_params()
        # the counters are totals over the ranks on every rank, so every
        # rank takes the decisions below alike
        count("readbacks")
        dropped_before = int(self._fstate.dropped)
        rebucket_every = self._fast_cadence(n)
        since = getattr(self, "_fast_since_rebucket", 0)
        # grow-and-retry: re-plan with a doubled capacity from the intact
        # pre-rebucket state instead of zero-massing the overflow, until
        # the stepper's retries are spent; then the loss is counted
        remaining = n
        grow_attempts = 0
        while remaining > 0:
            try:
                self._fstate = self._stepper.run(
                    self._fstate, params, float(self._dt), n_steps=remaining,
                    rebucket_every=rebucket_every, steps_since_rebucket=since,
                    on_overflow="raise"
                    if grow_attempts < self._stepper.retries else "count",
                    **self._fast_kw)
                since = next_rebucket_offset(since, remaining,
                                             rebucket_every)
                remaining = 0
            except BucketOverflowError as exc:
                remaining -= exc.steps_done
                since = 0
                grow_attempts += 1
                self._grow_fast_capacity(exc.fstate)
        self._fast_since_rebucket = since
        count("readbacks")
        new_drops = int(self._fstate.dropped) - dropped_before
        if new_drops > 0:
            if rebucket_every > 1:
                self._fast_rebucket_every = max(1, rebucket_every // 2)
                _log.warning(
                    "treepm_fast: %d particle-deposits dropped this "
                    "chunk (drift exceeded the block margin) -- "
                    "halving rebucket cadence to every %d steps",
                    new_drops, self._fast_rebucket_every)
            else:
                _log.warning(
                    "treepm_fast: %d particle-deposits dropped this "
                    "chunk even at rebucket_every=1 -- reduce the "
                    "timestep or increase forces margin", new_drops)
        self._sync_state_from_fast()

    def _grow_fast_capacity(self, fstate) -> None:
        """Rebuild the stepper from an intact pre-rebucket state (the live
        rows of every rank, wrapped) at a doubled bucket capacity until
        the rebuild itself is lossless, keeping ncell, rs, margin and the
        ids (the JAX engine's grow-and-retry, on one device and on
        ranks; span `engine.grow`)."""
        from ..ops.fast_treepm import grown_plan
        from ..physics.integrators import wrap_positions
        stepper, kw = self._stepper, self._fast_kw
        with span("engine.grow"):
            pos, vel, mass, ids = stepper.rows(fstate)
            pos = wrap_positions(pos, kw["box_size"])
            t0 = time.perf_counter()
            cap = kw["capacity"]
            while True:
                cap *= 2
                st, new_kw = stepper.initialize(
                    pos, vel, mass, fstate.scale_factor, time=fstate.time,
                    step=fstate.step, plan_override=grown_plan(kw, cap),
                    ids=ids)
                count("readbacks")
                if int(st.overflow) == 0 or cap >= pos.shape[0]:
                    break
            _log.warning(
                "treepm_fast: bucket capacity %d exceeded by clustering; "
                "re-planned with capacity %d (no particles lost)",
                kw["capacity"], cap)
            self._fstate = st.replace(
                overflow=fstate.overflow,
                dropped=(fstate.dropped + st.dropped) if stepper.carry_drops
                else fstate.dropped)
            self._fast_kw = new_kw
            self.statistics.compile_time_s += time.perf_counter() - t0

    def _sync_state_from_fast(self) -> None:
        """Restore the bucket layout into the public SimState in the
        original particle order (via the persistent ids), positions
        wrapped into [0, box); overflowed particles leave zero-mass rows.
        Runs on the device with index ops; on ranks every rank gathers
        every rank's slots and holds the global state (span
        `engine.sync_state`)."""
        from ..physics.integrators import wrap_positions
        with span("engine.sync_state", device=self._fstate.bpos.is_cuda):
            fpos, fvel, fmass, ids = self._stepper.rows(self._fstate)
            fpos = wrap_positions(fpos, self.config.particles.box_size)
            ids = ids.to(torch.int64)
            n = self._fast_n
            dev = fpos.device
            pos = torch.zeros((n, 3), dtype=torch.float32, device=dev)
            vel = torch.zeros((n, 3), dtype=torch.float32, device=dev)
            mass = torch.zeros((n,), dtype=torch.float32, device=dev)
            pos[ids] = fpos
            vel[ids] = fvel
            mass[ids] = fmass
            self._state = self._state.replace(
                positions=pos, velocities=vel, masses=mass,
                scale_factor=self._fstate.scale_factor.clone(),
                time=self._fstate.time.clone(),
                step=self._fstate.step.clone())

    def release_force_state(self) -> None:
        """Drop the fast stepper's bucket state (and its accelerations) to
        free device memory for analysis; the next run() or step() rebuilds
        it from `state`, which every chunk keeps in sync. The statistics
        keep their totals; read the bucket state's overflow and drop
        counters before releasing."""
        if self._fstate is None:
            return
        self._fstate = None
        self._acc = None
        self._fast_since_rebucket = 0

    def _maybe_rebuild_fast(self) -> None:
        """Re-bucket `state` after a release_force_state() (on ranks into
        the sharded stepper, or the stateless sharded TreePM where its
        plan is None, as initialize() does)."""
        if self._stepper is not None and self._fstate is None \
                and not self._init_fast(self._state):
            self._init_mesh_path(self._state)

    # -- stateless solvers: a loop of the fused KDK step ---------------------
    def _ensure_acc(self) -> None:
        if self._acc is None and self._fstate is None:
            self._acc = self._force(self._state)

    def _force(self, st: SimState):
        """The stateless solver's accelerations at `st` (span
        `fast.accel`, as the fast stepper's force)."""
        with span("fast.accel", device=st.positions.is_cuda):
            return self._accel_fn(st)

    def _factor_kw(self) -> dict:
        """kdk_factors' keywords from the configuration."""
        cfg = self.config
        cosmological = cfg.cosmology.model != "Newtonian"
        return dict(h0_internal=cfg.units.H0_internal,
                    kick_mode=(cfg.integration.kick_mode if cosmological
                               else "newtonian"),
                    sf_method=cfg.integration.scale_factor_update,
                    cosmological=cosmological)

    def _step_factors(self, a0, n: int):
        """Yield the kdk_factors of `n` steps of the current dt from
        scale factor a0: the ones the last chunk computed ahead where
        they start at a0 with this dt, else each as its step comes (so
        that the first step's kernels need not wait for the last step's
        factors)."""
        from ..physics.integrators import kdk_factors
        params, kw = self.config.cosmology_params(), self._factor_kw()
        key = (float(a0), float(self._dt), params, tuple(kw.items()))
        if self._ahead is not None and self._ahead[0] == key \
                and len(self._ahead[1]) >= n:
            yield from self._ahead[1][:n]
            return
        out = []
        for _ in range(n):
            out.append(kdk_factors(params, a0, self._dt, **kw))
            a0 = out[-1].a1
            yield out[-1]
        self._ahead = (key, out)

    def _kdk_steps(self, st: SimState, acc, n: int):
        """`n` fused KDK steps from (st, acc), one force evaluation each
        (the JAX engine's jit(scan) chunk as a Python loop); returns the
        new (state, acc)."""
        from ..physics.integrators import kdk_step_fused
        cfg = self.config
        params = cfg.cosmology_params()
        step_kw = dict(self._factor_kw(),
                       periodic=cfg.particles.periodic_boundaries)
        for f in self._step_factors(st.scale_factor, n):
            st, acc = kdk_step_fused(st, acc, self._force, params,
                                     self._dt, cfg.particles.box_size,
                                     factors=f, **step_kw)
        return st, acc

    def _stateless_chunk(self, n: int, ahead: int = 0) -> None:
        self._ensure_acc()
        self._state, self._acc = self._kdk_steps(self._state, self._acc, n)
        # the next chunk's `ahead` steps' scale factors (the rk4 on 0-d
        # host tensors, ~0.9 ms a step on a server CPU) while the card
        # works through this one, so that the next chunk's launches start
        # at once after its synchronize
        if ahead:
            for _ in self._step_factors(self._state.scale_factor, ahead):
                pass

    def _chunk(self, n: int, ahead: int = 0) -> None:
        """`n` steps; `ahead`: the steps of a next chunk of the same dt,
        whose scale factors a stateless chunk computes while the card
        works (0: none follows, or dt changes between chunks)."""
        if self._fstate is not None:
            self._fast_chunk(n)
        else:
            self._stateless_chunk(n, ahead)

    def warmup(self, chunk_len: int | None = None) -> dict:
        """Build and run, once, the programs run() will request before its
        first step (the JAX engine's AOT warmup, in eager PyTorch): on a
        card, the CUDA kernels build (ops/cuda_build; the git-ignored
        _build/ keeps the library, so a fresh process with unchanged
        sources builds nothing, as the JAX persistent cache compiles
        nothing); then, on the fast path, one call of the stepper's run:
        the rebucket pass, then one segment at the rebucket cadence run()
        takes for a chunk (`_fast_cadence`: every segment of a chunk has
        that length); or the stateless solver's chunk of fused KDK steps.
        They run on the current state and their results are dropped: the
        engine's state, step count and statistics are left as they were.
        `chunk_len` defaults to the run loop's chunk
        (simulation.output_frequency). Returns {"programs": n, "seconds":
        s}."""
        if self._dt is None:
            raise RuntimeError("warmup() requires initialize() first")
        t0 = time.perf_counter()
        if self._fstate is not None and self._mesh is not None:
            # the JAX engine's warmup covers no sharded stepper either
            return {"programs": 0, "seconds": time.perf_counter() - t0}
        if self.device.type == "cuda":
            from ..ops import cuda_build
            cuda_build.library()
        chunk = int(chunk_len or
                    max(1, self.config.simulation.output_frequency))
        if self._fstate is not None:
            n = self._fast_cadence(chunk)
            synchronize(self._stepper.run(
                self._fstate, self.config.cosmology_params(),
                float(self._dt), n_steps=n, rebucket_every=n,
                steps_since_rebucket=n, on_overflow="drop",
                **self._fast_kw).bpos)
            n_prog = 2
        else:
            acc = self._acc if self._acc is not None \
                else self._accel_fn(self._state)
            synchronize(self._kdk_steps(self._state, acc, chunk)[0]
                        .positions)
            n_prog = 1
        return {"programs": n_prog, "seconds": time.perf_counter() - t0}

    def step(self, num_steps: int = 1) -> SimState:
        """Advance `num_steps` steps in one chunk."""
        if self.lifecycle == LifecycleState.UNINITIALIZED:
            raise RuntimeError("initialize() first")
        self._maybe_rebuild_fast()
        self._chunk(num_steps)
        check_range()
        self.statistics.total_steps += num_steps
        return self._state

    def run(self, num_steps: int | None = None) -> SimState:
        """Advance in output-cadence chunks, firing observers between
        chunks, until max_steps, final_redshift or final_time.

        Each chunk is the span `engine.chunk` (utils/profiling: spans and
        counters record while a torch profiler is active or a
        `profiling.tracing()` context is open) and ends in a synchronize,
        after which the chunk's spans are reduced to the totals that
        `profiling.trace_totals()` returns. profiling.detailed_timing
        opens `profiling.tracing()` for the run: `statistics.force_time_s`
        accumulates the device seconds of the chunks' `fast.accel` spans
        and `integration_time_s` the rest of each such chunk's wall
        time."""
        if self.lifecycle == LifecycleState.UNINITIALIZED:
            self.initialize()
        self._maybe_rebuild_fast()
        cfg = self.config
        a_final = 1.0 / (1.0 + cfg.cosmology.final_redshift)
        max_steps = (num_steps if num_steps is not None
                     else cfg.time.max_steps)
        cadence = max(1, cfg.simulation.output_frequency)

        self.lifecycle = LifecycleState.RUNNING
        self.observers.notify("on_simulation_start", self)
        t_start = time.perf_counter()
        steps_done = 0
        trace_ctx = contextlib.ExitStack()
        if cfg.profiling.enabled and cfg.profiling.trace_dir:
            trace_ctx.enter_context(profiling.trace_dir(
                cfg.profiling.trace_dir))
        if cfg.profiling.detailed_timing:
            trace_ctx.enter_context(profiling.tracing())
        try:
            self._ensure_acc()
            profiling.flush()            # a chunk's force time is its own
            fixed_dt = not (cfg.integration.adaptive_timestep
                            or cfg.integration.max_dloga > 0)
            if not fixed_dt:
                self._update_dt()
            while steps_done < max_steps:
                if self.lifecycle != LifecycleState.RUNNING:
                    break
                a = float(self._state.scale_factor)
                if a >= a_final:
                    break
                if float(self._state.time) >= cfg.time.final_time:
                    break
                n = min(cadence, max_steps - steps_done)
                # exact-stop clamp, quantized to a power of two (rounded
                # down) as in the JAX engine
                dloga_est = getattr(self, "_dloga_per_step", 0.0)
                if dloga_est > 0 and a > 0:
                    to_final = math.log(a_final / a) / dloga_est
                    if to_final < n:
                        need = max(1, int(math.ceil(to_final)))
                        n = 1 << (need.bit_length() - 1)
                self.observers.notify("on_step_start", self,
                                      int(self._state.step))
                profiling.set_step(self._state.step)
                accel0 = _force_seconds()
                t_chunk0 = time.perf_counter()
                with self.profiler.timer("run.chunk",
                                         span_name="engine.chunk"):
                    self._chunk(n, min(cadence, max_steps - steps_done - n)
                                if fixed_dt else 0)
                    synchronize(self._state.positions)
                check_range()
                dt_chunk = time.perf_counter() - t_chunk0
                profiling.flush()
                self.statistics.compute_time_s += dt_chunk
                a_after = float(self._state.scale_factor)
                if a_after > a > 0:
                    self._dloga_per_step = math.log(a_after / a) / n
                if cfg.logging.performance_logging:
                    _log.info(
                        "step %d: a=%.4f  %.1f ms/step  (%.3e "
                        "particle-updates/s)", int(self._state.step),
                        a_after, 1e3 * dt_chunk / n,
                        n * self._num_particles() / max(dt_chunk,
                                                            1e-9))
                if cfg.profiling.detailed_timing:
                    accel1 = _force_seconds()
                    if accel1[0] > accel0[0]:
                        f_chunk = accel1[1] - accel0[1]
                        self.statistics.force_time_s += f_chunk
                        self.statistics.integration_time_s += \
                            dt_chunk - f_chunk
                if cfg.validation.check_finite:
                    count("readbacks")
                    finite = bool(torch.all(torch.isfinite(
                        self._state.positions)))
                    if not self._all_ranks(finite):
                        raise FloatingPointError(
                            f"non-finite positions after step "
                            f"{self.statistics.total_steps + n} "
                            f"(validation.check_finite)")
                if not fixed_dt:
                    self._update_dt()
                # the sharded fast stepper migrates inside its rebucket
                if self._mesh is not None and self._fstate is None:
                    with self.profiler.timer("run.migrate"):
                        self._mesh_migrate()
                steps_done += n
                self.statistics.total_steps += n
                t_obs0 = time.perf_counter()
                self.observers.notify("on_step_end", self,
                                      int(self._state.step))
                self.statistics.analysis_time_s += \
                    time.perf_counter() - t_obs0
                if (cfg.simulation.checkpoint_frequency > 0
                        and self.statistics.total_steps
                        % cfg.simulation.checkpoint_frequency == 0):
                    t_io0 = time.perf_counter()
                    self._periodic_checkpoint()
                    self.statistics.io_time_s += \
                        time.perf_counter() - t_io0
            self.lifecycle = LifecycleState.FINISHED
        except Exception as exc:
            self.lifecycle = LifecycleState.ERROR
            self.observers.notify("on_error", self, exc)
            raise
        finally:
            trace_ctx.close()
            wall = time.perf_counter() - t_start
            st = self.statistics
            st.total_time_s += wall
            st.steps_per_second = steps_done / max(wall, 1e-9)
            st.particle_updates_per_second = (
                st.steps_per_second * self._num_particles())
            st.current_scale_factor = float(self._state.scale_factor)
            st.current_redshift = float(self._state.redshift)
            st.time_units = cfg.time.time_units
            t_int = float(self._state.time)
            st.current_time = (t_int * 977.79 / max(cfg.cosmology.h, 1e-9)
                               if cfg.time.time_units == "gyr" else t_int)
            if self.last_energy_error is not None:
                st.energy_error = self.last_energy_error
            self.observers.notify("on_simulation_end", self)
            if cfg.profiling.enabled and cfg.profiling.output_file:
                try:
                    self.profiler.write_report(
                        cfg.profiling.output_file,
                        extra={"statistics": st.to_dict()})
                except OSError:
                    pass
        return self._state

    def _num_particles(self) -> int:
        """Rows of the (global) state."""
        n = self._state.num_particles
        return n * self._mesh.size if self._state_sharded else n

    def _all_ranks(self, ok: bool) -> bool:
        """`ok` on every rank of the mesh (a collective), or `ok` itself
        on one device."""
        if self._mesh is None:
            return ok
        flag = torch.tensor([0 if ok else 1], dtype=torch.int32)
        return int(self._mesh.all_reduce(flag, "max")) == 0

    def _update_dt(self) -> None:
        from ..physics.integrators import adaptive_dt, hubble_internal
        cfg = self.config
        if self._fstate is not None:
            # padding slots carry field values at their parked positions
            live = (self._fstate.bmass > 0)[None]
            acc = torch.where(live, self._fstate.acc, 0.0).reshape(3, -1).T
        elif self._acc is not None:
            acc = self._acc
        else:
            return
        hubble = None
        if cfg.integration.max_dloga > 0 \
                and cfg.cosmology.model != "Newtonian":
            hubble = hubble_internal(cfg.cosmology_params(),
                                     self._state.scale_factor,
                                     cfg.units.H0_internal)
        amax = None
        if self._mesh is not None:
            # the largest |a| over every rank's rows, as the JAX engine
            # reduces its sharded array
            amax = self._mesh.all_reduce(torch.max(torch.sqrt(torch.sum(
                acc * acc, dim=-1))).reshape(1), "max")[0]
        count("readbacks")
        self._dt = host_scalar(adaptive_dt(
            acc, cfg.forces.softening_length, cfg.time.initial_timestep,
            cfg.integration.min_timestep, cfg.integration.max_timestep,
            hubble=hubble, max_dloga=cfg.integration.max_dloga, amax=amax))

    def pause(self) -> None:
        if self.lifecycle == LifecycleState.RUNNING:
            self.lifecycle = LifecycleState.PAUSED

    def resume(self) -> None:
        if self.lifecycle == LifecycleState.PAUSED:
            self.lifecycle = LifecycleState.RUNNING

    def reset(self) -> None:
        self._state = None
        self._state_sharded = False
        self._mesh = None
        self._mesh_bounds = None
        self.mesh_force_diagnostics = None
        self._fstate = None
        self._fast_kw = None
        self._stepper = None
        self._acc = None
        self._accel_fn = None
        self.statistics = SimulationStatistics()
        self.lifecycle = LifecycleState.UNINITIALIZED

    # -- diagnostics ---------------------------------------------------------
    def compute_energy(self) -> dict:
        """KE, PE (the O(N^2) pair sum: K9 on the card, its plain version
        on the CPU) and their total, as 0-d tensors on the engine's
        device; on a mesh parallel/sharded.sharded_energy (K9's cross form
        a ring step), equal on every rank. The sharded fast stepper's
        global state gives each rank its contiguous share of the rows,
        padded with zero-mass rows to a multiple of the ranks."""
        from ..forces.direct import kinetic_energy, potential_energy
        cfg = self.config
        if self._mesh is not None:
            from ..parallel.sharded import sharded_energy
            st = self._state
            if not self._state_sharded:
                from ..parallel.mesh import shard_state
                pad = -st.num_particles % self._mesh.size

                def padded(x):
                    return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                st = shard_state(st.replace(
                    positions=padded(st.positions),
                    velocities=padded(st.velocities),
                    masses=padded(st.masses)), self._mesh)
            return sharded_energy(
                st.positions, st.velocities, st.masses,
                box_size=cfg.particles.box_size,
                softening=cfg.forces.softening_length, g_const=cfg.units.G,
                mesh=self._mesh)
        st = self.state
        ke = kinetic_energy(st.velocities, st.masses)
        pe = potential_energy(st.positions, st.masses,
                              cfg.particles.box_size,
                              cfg.forces.softening_length, cfg.units.G)
        return {"kinetic": ke, "potential": pe, "total": ke + pe}

    def momentum(self) -> torch.Tensor:
        """Total momentum [3]."""
        st = self.state
        return torch.sum(st.masses[:, None] * st.velocities, dim=0)

    def angular_momentum(self) -> torch.Tensor:
        """Total angular momentum about the box centre [3]."""
        st = self.state
        rel = st.positions - self.config.particles.box_size / 2.0
        return torch.sum(st.masses[:, None]
                         * torch.cross(rel, st.velocities, dim=-1), dim=0)

    # -- snapshots / checkpoints ---------------------------------------------
    def save_snapshot(self, path: str | None = None) -> str:
        """Snapshot of the public state; without `path`, the configured
        filename pattern with the extension io.output_format selects."""
        from ..utils import checkpoint as ckpt
        cfg = self.config
        if path is None:
            path = cfg.io.snapshots.filename_pattern.format(
                step=int(self.state.step),
                redshift=float(self.state.redshift))
            ext = {"hdf5": ".h5", "lcdm": ".lcdm",
                   "ascii": ".txt"}.get(cfg.io.output_format)
            if ext and path.endswith(".npz"):
                path = path[:-4] + ext
        return self._rank0_writes(lambda st: ckpt.save_snapshot(
            path, st, self.config, fields=cfg.io.snapshots.fields))

    def _rank0_writes(self, write):
        """write(global state) -> path on one device; on a mesh every rank
        gathers the state, rank 0 writes, the others get the path rank 0
        wrote (after it has written)."""
        st = self.state
        if self._mesh is None:
            return write(st)
        import torch.distributed as dist
        out = [write(st) if self._mesh.rank == 0 else None]
        dist.broadcast_object_list(out, src=0, group=self._mesh.group)
        return out[0]

    def save_checkpoint(self, path: str) -> str:
        """An npz checkpoint (state, config, statistics), or with
        io.output_format "orbax" a `step_XXXXXXXX` directory under `path`
        holding the state (utils/checkpoint.save_checkpoint_orbax: the
        port's own torch.save format, not Orbax's)."""
        from ..utils import checkpoint as ckpt
        if self.config.io.output_format == "orbax":
            out = self._rank0_writes(
                lambda st: ckpt.save_checkpoint_orbax(path, st))
        else:
            out = self._rank0_writes(lambda st: ckpt.save_checkpoint(
                path, st, self.config, self.statistics.to_dict()))
        self.observers.notify("on_checkpoint", self, out)
        return out

    def load_checkpoint(self, path: str) -> None:
        """Resume from an npz checkpoint (the state, initializing the
        engine if needed, and the saved statistics) or from a directory of
        save_checkpoint's orbax form (the state alone)."""
        import os
        from ..utils import checkpoint as ckpt
        if os.path.isdir(path):
            state, stats = ckpt.load_checkpoint_orbax(path, self.device), {}
        else:
            state, _cfg_dict, stats = ckpt.load_checkpoint(path,
                                                           self.device)
        if self._fstate is None and self._accel_fn is None:
            self.initialize(state=state)
        else:
            self.state = state
        for k, v in stats.items():
            if hasattr(self.statistics, k):
                setattr(self.statistics, k, v)
        self.lifecycle = LifecycleState.INITIALIZED

    def _periodic_checkpoint(self) -> None:
        import os
        outdir = self.config.simulation.output_directory
        os.makedirs(outdir, exist_ok=True)
        self.save_checkpoint(os.path.join(
            outdir, f"checkpoint_{self.statistics.total_steps:06d}"))

    # -- force accuracy -------------------------------------------------------
    def validate_force_accuracy(self, n_sample: int = 1024,
                                seed: int = 0) -> dict:
        """The configured solver against exact direct summation: the
        solver on the whole current state, the oracle (plain PyTorch,
        minimum image) for `n_sample` live targets drawn with
        np.random.default_rng(seed) -- the JAX package's draw, so both
        packages pick the same rows -- over all sources. treepm_fast
        validates through treepm on the same state. Returns
        {"avg_err", "max_err"} (|a_solver - a_direct| over the rms
        |a_direct|), {"avg_rel_err", "max_rel_err"} (per target) and
        "n_sample", "solver"; warns above validation.force_tolerance."""
        import copy

        import numpy as np

        from ..forces import create_force_computer
        from ..forces.direct import direct_accelerations_chunked
        cfg = self.config
        st = self.state
        solver_name = {"treepm_fast": "treepm", "pm_fast": "pm"}.get(
            cfg.forces.type, cfg.forces.type)
        vcfg = copy.deepcopy(cfg)
        vcfg.forces.type = solver_name
        acc_solver = create_force_computer(vcfg)(st)

        idx_all = np.nonzero((st.masses > 0).cpu().numpy())[0]
        rng = np.random.default_rng(seed)
        k = int(min(n_sample, idx_all.size))
        idx = torch.as_tensor(rng.choice(idx_all, size=k, replace=False),
                              device=st.positions.device)

        mg = (float(cfg.forces.modified_gravity_strength)
              if cfg.forces.force_kernel == "modified_gravity" else 0.0)
        # 64 rows a block: peak temporary 64 * N * 3
        a_ref = direct_accelerations_chunked(
            st.positions, st.masses, float(cfg.particles.box_size),
            float(cfg.forces.softening_length), float(cfg.units.G), mg,
            chunk_size=64, targets=idx)
        a_sol = acc_solver[idx]
        diff = torch.linalg.norm(a_sol - a_ref, dim=-1)
        ref_mag = torch.linalg.norm(a_ref, dim=-1)
        # scale-normalized error: per-target relative errors diverge on
        # near-cancellation targets
        scale = torch.sqrt(torch.mean(ref_mag ** 2))
        floor = 1e-12 * torch.max(ref_mag)
        rel = diff / torch.maximum(ref_mag, floor)
        result = {"avg_err": float(torch.mean(diff) / scale),
                  "max_err": float(torch.max(diff) / scale),
                  "avg_rel_err": float(torch.mean(rel)),
                  "max_rel_err": float(torch.max(rel)),
                  "n_sample": k, "solver": solver_name}
        self.statistics.force_avg_err = result["avg_err"]
        self.statistics.force_max_err = result["max_err"]
        if result["avg_err"] > cfg.validation.force_tolerance:
            _log.warning(
                "force validation: scale-normalized error %.3e vs direct "
                "summation exceeds validation.force_tolerance %.1e "
                "(solver=%s, max %.3e, per-target avg/max rel %.3e/%.3e "
                "over %d targets)", result["avg_err"],
                cfg.validation.force_tolerance, solver_name,
                result["max_err"], result["avg_rel_err"],
                result["max_rel_err"], k)
        else:
            _log.info(
                "force validation: solver=%s scale-normalized err avg "
                "%.3e max %.3e (per-target rel avg %.3e) over %d targets",
                solver_name, result["avg_err"], result["max_err"],
                result["avg_rel_err"], k)
        return result

    # -- observers ------------------------------------------------------------
    def add_observer(self, observer: Observer) -> None:
        self.observers.add(observer)

    def remove_observer(self, observer: Observer) -> None:
        self.observers.remove(observer)


class SimulationBuilder:
    """Fluent builder; `device` (default "cuda") is where the engine
    keeps and advances the particles."""

    def __init__(self, device="cuda"):
        self._config = SimulationConfig()
        self._observers: list[Observer] = []
        self._state: SimState | None = None
        self._device = device

    def with_config_file(self, path: str) -> "SimulationBuilder":
        self._config = SimulationConfig.from_file(path)
        return self

    def with_config(self, config: SimulationConfig) -> "SimulationBuilder":
        self._config = config
        return self

    def with_particles(self, n: int) -> "SimulationBuilder":
        self._config.particles.num_particles = int(n)
        return self

    def with_box_size(self, box: float) -> "SimulationBuilder":
        self._config.particles.box_size = float(box)
        return self

    def with_time_step(self, dt: float) -> "SimulationBuilder":
        self._config.time.initial_timestep = float(dt)
        return self

    def with_force_computer(self, type_name: str, **params
                            ) -> "SimulationBuilder":
        self._config.forces.type = type_name
        for k, v in params.items():
            setattr(self._config.forces, k, v)
        return self

    def with_integrator(self, type_name: str = "LeapfrogIntegrator",
                        **params) -> "SimulationBuilder":
        self._config.integration.type = type_name
        for k, v in params.items():
            setattr(self._config.integration, k, v)
        return self

    def with_cosmology(self, **params) -> "SimulationBuilder":
        for k, v in params.items():
            setattr(self._config.cosmology, k, v)
        return self

    def with_initial_conditions(self, type_name: str, **params
                                ) -> "SimulationBuilder":
        ic = self._config.particles.initial_conditions
        ic.type = type_name
        for k, v in params.items():
            setattr(ic, k, v)
        return self

    def with_initial_state(self, state: SimState) -> "SimulationBuilder":
        self._state = state
        return self

    def with_observer(self, observer: Observer) -> "SimulationBuilder":
        self._observers.append(observer)
        return self

    def with_units(self, system: str = "cosmological", G: float | None = None,
                   H0_internal: float | None = None) -> "SimulationBuilder":
        u = self._config.units
        u.system = system
        if system == "box":
            u.G = 1.0 if G is None else G
            u.H0_internal = 0.1 if H0_internal is None else H0_internal
        if G is not None:
            u.G = G
        if H0_internal is not None:
            u.H0_internal = H0_internal
        return self

    def enable_mesh(self, enabled: bool = True, **axes) -> "SimulationBuilder":
        self._config.compute.mesh.enabled = enabled
        if axes:
            self._config.compute.mesh.axes = axes
        return self

    @property
    def config(self) -> SimulationConfig:
        return self._config

    def build(self) -> SimulationEngine:
        engine = SimulationEngine(self._config, self._observers,
                                  device=self._device)
        engine.initialize(state=self._state)
        return engine
