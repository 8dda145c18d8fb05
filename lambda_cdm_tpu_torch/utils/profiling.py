"""Named-phase timers + JSON report (counterpart of
lambda_cdm_tpu/utils/profiling.py; its jax.profiler trace is not ported).

`stop(name, sync_on=t)` synchronizes t's CUDA device first, so a timer
measures finished device work rather than the enqueue.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass


@dataclass
class TimerStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {"count": self.count, "total_s": self.total_s,
                "mean_s": self.mean_s, "min_s": self.min_s,
                "max_s": self.max_s}


def synchronize(tensor) -> None:
    """Wait for the device work that produces `tensor` (no-op on CPU)."""
    if getattr(tensor, "is_cuda", False):
        import torch
        torch.cuda.synchronize(tensor.device)


class Profiler:
    """Named timers."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.timers: dict[str, TimerStats] = {}
        self._open: dict[str, float] = {}

    def start(self, name: str) -> None:
        if self.enabled:
            self._open[name] = time.perf_counter()

    def stop(self, name: str, sync_on=None) -> float:
        if not self.enabled or name not in self._open:
            return 0.0
        if sync_on is not None:
            synchronize(sync_on)
        dt = time.perf_counter() - self._open.pop(name)
        self.timers.setdefault(name, TimerStats()).add(dt)
        return dt

    @contextlib.contextmanager
    def timer(self, name: str, sync_on=None):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name, sync_on=sync_on)

    def get(self, name: str) -> TimerStats:
        return self.timers.get(name, TimerStats())

    def summary(self) -> dict:
        return {k: v.to_dict() for k, v in sorted(self.timers.items())}

    def print_summary(self) -> None:
        print(f"{'phase':<28}{'count':>8}{'total[s]':>12}{'mean[ms]':>12}")
        for name, t in sorted(self.timers.items()):
            print(f"{name:<28}{t.count:>8}{t.total_s:>12.4f}"
                  f"{t.mean_s * 1e3:>12.4f}")

    def reset(self) -> None:
        self.timers.clear()
        self._open.clear()

    def write_report(self, path: str, extra: dict | None = None) -> None:
        report = {"timers": self.summary()}
        if extra:
            report.update(extra)
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
