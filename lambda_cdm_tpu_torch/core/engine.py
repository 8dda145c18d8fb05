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
order, positions wrapped into the box) for the observers.

Diagnostics (energy, momentum, angular momentum), the force-accuracy
harness (validate_force_accuracy against a direct-sum oracle), npz
snapshots and checkpoints (periodic ones at
simulation.checkpoint_frequency, timed into statistics.io_time_s) and
resume follow the JAX engine.

`warmup` builds the kernels and runs the run loop's programs once before
the first step; `profiling.trace_dir` traces run() with torch.profiler
(utils/profiling.trace_dir). Not ported yet (each raises
NotImplementedError, see ROADMAP.md): the device mesh and orbax
checkpoints.
"""

from __future__ import annotations

import enum
import logging
import math
import time
from dataclasses import dataclass

import torch

from .config import SimulationConfig
from .observers import Observer, ObserverBus
from .state import SimState, host_scalar
from ..ops.direct import check_range
from ..utils.profiling import Profiler, synchronize

_log = logging.getLogger("lambda_cdm_tpu")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to lambda_cdm_tpu_torch yet; see "
        f"ROADMAP.md (the JAX package lambda_cdm_tpu has it)")


def _accel_kw(fast_kw: dict) -> dict:
    """The keys of initialize_fast's dict that fast_treepm._accel takes."""
    keys = ("box_size", "ng", "ncell", "capacity", "margin", "rs",
            "softening", "g_const", "gradient", "pm_only", "variant")
    return {k: fast_kw[k] for k in keys if k in fast_kw}


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
        self._fast_kw: dict | None = None
        self._fast_rebuild = False        # re-bucket at the next run/step
        self._acc = None                  # accelerations at state.positions
        self._accel_fn = None
        self._dt = None

    # -- properties ---------------------------------------------------------
    @property
    def state(self) -> SimState:
        if self._state is None:
            raise RuntimeError("engine not initialized")
        return self._state

    @state.setter
    def state(self, new_state: SimState) -> None:
        self._state = self._on_device(new_state)
        self._acc = None
        if self._fstate is not None:
            self._init_fast_path()

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
            if cfg.compute.mesh.enabled:
                raise _not_ported("compute.mesh (multi-device runs)")
            use_fast = cfg.forces.type in ("treepm_fast", "pm_fast")
            if state is None:
                from ..physics.initial_conditions import generate_state
                state = generate_state(cfg, device=self.device)
            if not use_fast:
                from ..forces import create_force_computer
                self._accel_fn = create_force_computer(cfg)
            self._state = self._on_device(state)
            self._acc = None
            self._dt = host_scalar(cfg.time.initial_timestep)
            if use_fast:
                self._init_fast_path()
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
        st = self._state
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
        if bool(torch.any(st.masses == 0)):
            raise ValueError("zero-mass particles outside mesh-padding mode")

    # -- treepm_fast path: persistent cell-list state ------------------------
    def _init_fast_path(self) -> None:
        from ..forces import auto_pm_grid
        from ..ops.fast_treepm import initialize_fast
        cfg = self.config
        st = self._state
        cosmological = cfg.cosmology.model != "Newtonian"
        self._fast_n = st.positions.shape[0]
        t0 = time.perf_counter()
        self._fstate, self._fast_kw = initialize_fast(
            st.positions, st.velocities, st.masses, st.scale_factor,
            box_size=cfg.particles.box_size, pm_grid=auto_pm_grid(cfg),
            softening=cfg.forces.softening_length, g_const=cfg.units.G,
            split_factor=cfg.forces.split_factor,
            cut_factor=cfg.forces.cut_factor,
            capacity=cfg.forces.bucket_capacity,
            gradient=cfg.forces.gradient,
            pm_only=(cfg.forces.type == "pm_fast"),
            time=st.time, step=st.step,
            h0_internal=cfg.units.H0_internal,
            kick_mode=(cfg.integration.kick_mode if cosmological
                       else "newtonian"),
            sf_method=cfg.integration.scale_factor_update,
            cosmological=cosmological)
        self._fast_since_rebucket = 0
        synchronize(self._fstate.acc)
        self.statistics.compile_time_s += time.perf_counter() - t0

    def _fast_cadence(self, n: int) -> int:
        """The rebucket cadence of a fast chunk of `n` steps: the
        configured (or halved) cadence, bounded by the drift guard and
        snapped to a divisor of `n`."""
        from ..physics.integrators import drift_factor
        kw = self._fast_kw
        rebucket_every = getattr(self, "_fast_rebucket_every", None) \
            or self.config.forces.rebucket_every
        # proactive drift guard: bound the steps between rebuckets by the
        # distance the fastest particle can drift into the deposit margin
        # (one vmax readback per chunk)
        a0 = float(self._fstate.scale_factor)
        df = float(drift_factor(a0, kw.get("kick_mode", "reference")))
        vmax = float(torch.max(torch.abs(self._fstate.bvel)))
        step_drift = vmax * float(self._dt) * df
        margin_dist = (float(kw.get("margin", 1)) * kw["box_size"]
                       / max(kw.get("ng", kw["ncell"]), kw["ncell"]))
        if step_drift > 0:
            safe = max(1, int(0.6 * margin_dist / step_drift))
            if safe < rebucket_every:
                rebucket_every = safe
        # snap the cadence to a divisor of the chunk length (as the JAX
        # engine does, so both packages rebucket at the same steps)
        d = max(1, min(rebucket_every, n))
        while n % d:
            d -= 1
        return d

    def _fast_chunk(self, n: int) -> None:
        from ..ops.fast_treepm import (BucketOverflowError, fast_run,
                                       next_rebucket_offset)
        params = self.config.cosmology_params()
        kw = self._fast_kw
        dropped_before = int(self._fstate.dropped)
        rebucket_every = self._fast_cadence(n)
        since = getattr(self, "_fast_since_rebucket", 0)
        # grow-and-retry: re-plan with a doubled capacity from the intact
        # pre-rebucket state instead of zero-massing the overflow
        remaining = n
        while remaining > 0:
            try:
                self._fstate = fast_run(
                    self._fstate, params, float(self._dt),
                    n_steps=remaining, on_overflow="raise",
                    rebucket_every=rebucket_every,
                    steps_since_rebucket=since, **kw)
                since = next_rebucket_offset(since, remaining,
                                             rebucket_every)
                remaining = 0
            except BucketOverflowError as exc:
                remaining -= exc.steps_done
                since = 0
                self._grow_fast_capacity(exc.fstate)
        self._fast_since_rebucket = since
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
        """Rebuild the fast state from an intact pre-rebucket state with
        doubled bucket capacity until the rebuild itself is lossless."""
        from ..ops.fast_treepm import _accel, build_fast_state, \
            flatten_fast_state
        from ..physics.integrators import wrap_positions
        kw = self._fast_kw
        old_cap = kw["capacity"]
        pos, vel, mass, ids = flatten_fast_state(fstate, with_ids=True)
        pos = wrap_positions(pos, kw["box_size"])
        n_live = pos.shape[0]
        t0 = time.perf_counter()
        new_cap = old_cap
        while True:
            new_cap *= 2
            plan = {"ncell": kw["ncell"], "capacity": new_cap,
                    "margin": kw["margin"], "rs": kw["rs"]}
            st = build_fast_state(
                pos, vel, mass, fstate.scale_factor,
                box_size=kw["box_size"], plan=plan,
                time=fstate.time, step=fstate.step, ids=ids)
            if int(st.overflow) == 0 or new_cap >= n_live:
                break
        _log.warning(
            "treepm_fast: bucket capacity %d exceeded by clustering; "
            "re-planned with capacity %d (no particles lost)",
            old_cap, new_cap)
        st = st.replace(overflow=fstate.overflow, dropped=fstate.dropped)
        kw["capacity"] = new_cap
        # the JAX engine's variant switch (a grown capacity leaves the
        # vpu4b pairing; above 128 it plans vpu5): one split function here
        if new_cap > 128:
            kw["variant"] = "vpu5"
        elif kw.get("variant") == "vpu4b" and new_cap != 64:
            kw["variant"] = "vpu3"
        acc, dropped = _accel(st, **_accel_kw(kw))
        self._fstate = st.replace(acc=acc, dropped=st.dropped + dropped)
        self.statistics.compile_time_s += time.perf_counter() - t0

    def _sync_state_from_fast(self) -> None:
        """Restore the bucket layout into the public SimState in the
        original particle order (via the persistent ids), positions
        wrapped into [0, box); overflowed particles leave zero-mass rows.
        Runs on the device with index ops."""
        from ..ops.fast_treepm import flatten_fast_state
        from ..physics.integrators import wrap_positions
        fpos, fvel, fmass, fids = flatten_fast_state(self._fstate,
                                                     with_ids=True)
        fpos = wrap_positions(fpos, self.config.particles.box_size)
        live = fids >= 0
        ids = fids[live].to(torch.int64)
        n = self._fast_n
        dev = fpos.device
        pos = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        vel = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        mass = torch.zeros((n,), dtype=torch.float32, device=dev)
        pos[ids] = fpos[live]
        vel[ids] = fvel[live]
        mass[ids] = fmass[live]
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
        self._fast_rebuild = True

    def _maybe_rebuild_fast(self) -> None:
        """Re-bucket `state` after a release_force_state(), once."""
        if not self._fast_rebuild:
            return
        self._fast_rebuild = False
        if self._fstate is None:
            self._init_fast_path()

    # -- stateless solvers: a loop of the fused KDK step ---------------------
    def _ensure_acc(self) -> None:
        if self._acc is None and self._fstate is None:
            self._acc = self._accel_fn(self._state)

    def _kdk_steps(self, st: SimState, acc, n: int):
        """`n` fused KDK steps from (st, acc), one force evaluation each
        (the JAX engine's jit(scan) chunk as a Python loop); returns the
        new (state, acc)."""
        from ..physics.integrators import kdk_step_fused
        cfg = self.config
        cosmological = cfg.cosmology.model != "Newtonian"
        params = cfg.cosmology_params()
        step_kw = dict(
            h0_internal=cfg.units.H0_internal,
            kick_mode=(cfg.integration.kick_mode if cosmological
                       else "newtonian"),
            sf_method=cfg.integration.scale_factor_update,
            periodic=cfg.particles.periodic_boundaries,
            cosmological=cosmological)
        for _ in range(n):
            st, acc = kdk_step_fused(st, acc, self._accel_fn, params,
                                     self._dt, cfg.particles.box_size,
                                     **step_kw)
        return st, acc

    def _stateless_chunk(self, n: int) -> None:
        self._ensure_acc()
        self._state, self._acc = self._kdk_steps(self._state, self._acc, n)

    def _chunk(self, n: int) -> None:
        if self._fstate is not None:
            self._fast_chunk(n)
        else:
            self._stateless_chunk(n)

    def warmup(self, chunk_len: int | None = None) -> dict:
        """Build and run, once, the programs run() will request before its
        first step (the JAX engine's AOT warmup, in eager PyTorch): on a
        card, the CUDA kernels build (ops/cuda_build; the git-ignored
        _build/ keeps the library, so a fresh process with unchanged
        sources builds nothing, as the JAX persistent cache compiles
        nothing); then, on the fast path, one segment at the rebucket
        cadence run() takes for a chunk (`_fast_cadence`: every segment of
        a chunk has that length) and the rebucket pass, or the stateless
        solver's chunk of fused KDK steps. They run on the current state
        and their results are dropped: the engine's state, step count and
        statistics are left as they were. `chunk_len` defaults to the run
        loop's chunk (simulation.output_frequency). Returns
        {"programs": n, "seconds": s}."""
        if self._dt is None:
            raise RuntimeError("warmup() requires initialize() first")
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from ..ops import cuda_build
            cuda_build.library()
        chunk = int(chunk_len or
                    max(1, self.config.simulation.output_frequency))
        if self._fstate is not None:
            from ..ops.fast_treepm import _fast_segment, _rebucket
            kw = self._fast_kw
            seg_kw = {k: v for k, v in kw.items() if k != "n_rows"}
            synchronize(_fast_segment(
                self._fstate, self.config.cosmology_params(),
                float(self._dt), n_steps=self._fast_cadence(chunk),
                **seg_kw).bpos)
            synchronize(_rebucket(self._fstate, box_size=kw["box_size"],
                                  ncell=kw["ncell"],
                                  capacity=kw["capacity"],
                                  n_rows=kw.get("n_rows", 0)).bpos)
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

    def _measure_force_fraction(self) -> None:
        """profiling.detailed_timing: time one standalone force
        evaluation; the run loop attributes min(chunk, n * t_force) of
        each chunk to force time."""
        if getattr(self, "_force_eval_s", None) is not None:
            return
        if self._fstate is not None:
            from ..ops.fast_treepm import _accel
            kw = _accel_kw(self._fast_kw)

            def force():
                return _accel(self._fstate, **kw)[0]
        else:
            def force():
                return self._accel_fn(self._state)
        synchronize(force())                            # warm caches
        t0 = time.perf_counter()
        synchronize(force())
        self._force_eval_s = time.perf_counter() - t0

    def run(self, num_steps: int | None = None) -> SimState:
        """Advance in output-cadence chunks, firing observers between
        chunks, until max_steps, final_redshift or final_time."""
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
        trace_ctx = None
        if cfg.profiling.enabled and cfg.profiling.trace_dir:
            from ..utils.profiling import trace_dir
            trace_ctx = trace_dir(cfg.profiling.trace_dir)
            trace_ctx.__enter__()
        try:
            self._ensure_acc()
            if cfg.profiling.detailed_timing:
                self._measure_force_fraction()
            if cfg.integration.adaptive_timestep \
                    or cfg.integration.max_dloga > 0:
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
                t_chunk0 = time.perf_counter()
                with self.profiler.timer("run.chunk"):
                    self._chunk(n)
                    synchronize(self._state.positions)
                check_range()
                dt_chunk = time.perf_counter() - t_chunk0
                self.statistics.compute_time_s += dt_chunk
                a_after = float(self._state.scale_factor)
                if a_after > a > 0:
                    self._dloga_per_step = math.log(a_after / a) / n
                if cfg.logging.performance_logging:
                    _log.info(
                        "step %d: a=%.4f  %.1f ms/step  (%.3e "
                        "particle-updates/s)", int(self._state.step),
                        a_after, 1e3 * dt_chunk / n,
                        n * self._state.num_particles / max(dt_chunk,
                                                            1e-9))
                t_force = getattr(self, "_force_eval_s", None)
                if t_force is not None:
                    f_share = min(dt_chunk, n * t_force)
                    self.statistics.force_time_s += f_share
                    self.statistics.integration_time_s += \
                        dt_chunk - f_share
                if cfg.validation.check_finite and not bool(
                        torch.all(torch.isfinite(self._state.positions))):
                    raise FloatingPointError(
                        f"non-finite positions after step "
                        f"{self.statistics.total_steps + n} "
                        f"(validation.check_finite)")
                if cfg.integration.adaptive_timestep \
                        or cfg.integration.max_dloga > 0:
                    self._update_dt()
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
            if trace_ctx is not None:
                trace_ctx.__exit__(None, None, None)
            wall = time.perf_counter() - t_start
            st = self.statistics
            st.total_time_s += wall
            st.steps_per_second = steps_done / max(wall, 1e-9)
            st.particle_updates_per_second = (
                st.steps_per_second * self._state.num_particles)
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
        self._dt = host_scalar(adaptive_dt(
            acc, cfg.forces.softening_length, cfg.time.initial_timestep,
            cfg.integration.min_timestep, cfg.integration.max_timestep,
            hubble=hubble, max_dloga=cfg.integration.max_dloga))

    def pause(self) -> None:
        if self.lifecycle == LifecycleState.RUNNING:
            self.lifecycle = LifecycleState.PAUSED

    def resume(self) -> None:
        if self.lifecycle == LifecycleState.PAUSED:
            self.lifecycle = LifecycleState.RUNNING

    def reset(self) -> None:
        self._state = None
        self._fstate = None
        self._fast_kw = None
        self._fast_rebuild = False
        self._acc = None
        self._accel_fn = None
        self.statistics = SimulationStatistics()
        self.lifecycle = LifecycleState.UNINITIALIZED

    # -- diagnostics ---------------------------------------------------------
    def compute_energy(self) -> dict:
        """KE, PE (the O(N^2) pair sum: K9 on the card, its plain version
        on the CPU) and their total, as 0-d tensors on the engine's
        device."""
        from ..forces.direct import kinetic_energy, potential_energy
        cfg = self.config
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
        return ckpt.save_snapshot(path, self.state, self.config,
                                  fields=cfg.io.snapshots.fields)

    def save_checkpoint(self, path: str) -> str:
        from ..utils import checkpoint as ckpt
        if self.config.io.output_format == "orbax":
            raise _not_ported("orbax checkpoints (io.output_format)")
        out = ckpt.save_checkpoint(path, self.state, self.config,
                                   self.statistics.to_dict())
        self.observers.notify("on_checkpoint", self, out)
        return out

    def load_checkpoint(self, path: str) -> None:
        """Resume from an npz checkpoint: the state (initializing the
        engine if needed) and the saved statistics."""
        from ..utils import checkpoint as ckpt
        state, _cfg_dict, stats = ckpt.load_checkpoint(path, self.device)
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
