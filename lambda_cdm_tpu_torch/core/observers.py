"""Observer bus: lifecycle event hooks with fan-out (counterpart of
lambda_cdm_tpu/core/observers.py).

Real implementation of the reference's IObserver pattern
(include/core/interfaces.hpp:84-93: on_simulation_start/end,
on_step_start/end, on_checkpoint, on_error) and the notify fan-out of
SimulationContext (src/core/simulation_context.cpp:90-124).

Observers run host-side at output cadence -- device arrays crossing into an
observer have already been pulled by the engine, so observers never force
extra host syncs inside the hot loop.
"""

from __future__ import annotations

import json
import time
from typing import Any


class Observer:
    """Base observer; subclass and override any hook
    (cf. IObserver, interfaces.hpp:84-93)."""

    def on_simulation_start(self, engine) -> None: ...

    def on_simulation_end(self, engine) -> None: ...

    def on_step_start(self, engine, step: int) -> None: ...

    def on_step_end(self, engine, step: int) -> None: ...

    def on_checkpoint(self, engine, path: str) -> None: ...

    def on_error(self, engine, error: Exception) -> None: ...


class ObserverBus:
    """Fan-out with error isolation (a failing observer must not kill the
    run -- unlike the reference, which would propagate)."""

    def __init__(self, observers=None):
        self._observers: list[Observer] = list(observers or [])

    def add(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def notify(self, hook: str, *args) -> None:
        for obs in self._observers:
            try:
                getattr(obs, hook)(*args)
            except Exception as exc:  # noqa: BLE001
                import logging
                logging.getLogger("lambda_cdm_tpu").warning(
                    "observer %s.%s raised: %s",
                    type(obs).__name__, hook, exc)

    def __iter__(self):
        return iter(self._observers)

    def __len__(self):
        return len(self._observers)


class ProgressObserver(Observer):
    """Console progress printer: step, a, z, energy drift, steps/sec --
    the reporting the reference's cuda_nbody_test example does inline
    (examples/cuda_nbody_test.cpp:55-93)."""

    def __init__(self, every: int = 1):
        self.every = every
        self._t0 = None
        self._last_step = 0
        self._last_t = None

    def on_simulation_start(self, engine):
        self._t0 = self._last_t = time.perf_counter()
        print(f"[lambda_cdm_tpu_torch] start: N={engine.state.num_particles} "
              f"box={engine.config.particles.box_size} "
              f"solver={engine.config.forces.type}")

    def on_step_end(self, engine, step):
        if step % self.every:
            return
        now = time.perf_counter()
        dsteps = step - self._last_step
        rate = dsteps / max(now - self._last_t, 1e-9)
        self._last_step, self._last_t = step, now
        a = float(engine.state.scale_factor)
        msg = (f"  step {step:6d}  a={a:.5f}  z={1 / a - 1:7.3f}  "
               f"{rate * engine.state.num_particles:.3e} part-steps/s")
        if engine.last_energy_error is not None:
            msg += f"  dE/E={engine.last_energy_error:.3e}"
        print(msg)

    def on_simulation_end(self, engine):
        dt = time.perf_counter() - self._t0
        print(f"[lambda_cdm_tpu_torch] done: "
              f"{engine.statistics.total_steps} steps in {dt:.2f}s")


class EnergyMonitor(Observer):
    """Total energy drift relative to the energy at the start of the run:
    engine.last_energy_error and a history of KE, PE, total and relative
    error at every chunk end."""

    def __init__(self):
        self.initial_energy: float | None = None
        self.history: list[dict[str, float]] = []

    def on_simulation_start(self, engine):
        # baseline before any step
        if self.initial_energy is None:
            self.initial_energy = float(engine.compute_energy()["total"])

    def on_step_end(self, engine, step):
        e = engine.compute_energy()
        total = float(e["total"])
        if self.initial_energy is None:
            self.initial_energy = total
        err = abs(total - self.initial_energy) / max(
            abs(self.initial_energy), 1e-30)
        engine.last_energy_error = err
        self.history.append({
            "step": int(step), "kinetic": float(e["kinetic"]),
            "potential": float(e["potential"]), "total": total,
            "relative_error": err,
        })


class MetricsRecorder(Observer):
    """Accumulates arbitrary per-step metrics into memory and (optionally)
    a JSON-lines file -- the structured-metrics capability the reference's
    config promises (basic_lambda_cdm.json logging/profiling blocks)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict[str, Any]] = []
        self._fh = None

    def on_simulation_start(self, engine):
        if self.path:
            self._fh = open(self.path, "a")

    def record(self, **metrics) -> None:
        self.records.append(metrics)
        if self._fh:
            self._fh.write(json.dumps(metrics) + "\n")
            self._fh.flush()

    def on_step_end(self, engine, step):
        self.record(step=int(step),
                    scale_factor=float(engine.state.scale_factor),
                    time=float(engine.state.time))

    def on_simulation_end(self, engine):
        if self._fh:
            self._fh.close()
            self._fh = None
