"""Named-phase timers + JSON report, and the profiler trace (counterpart
of lambda_cdm_tpu/utils/profiling.py: `trace_dir` takes jax_trace's
place, with `trace_summary` to read what it wrote).

`stop(name, sync_on=t)` synchronizes t's CUDA device first, so a timer
measures finished device work rather than the enqueue.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from dataclasses import dataclass

# the trace's device activity (Kineto's categories)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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


@contextlib.contextmanager
def trace_dir(log_dir: str):
    """Trace a region with torch.profiler (the counterpart of the JAX
    package's jax_trace): CPU activity, and CUDA activity when a card is
    present, written at the region's end into `log_dir` as a Chrome /
    TensorBoard trace (`<host>_<pid>.<ns>.pt.trace.json`, what
    torch.profiler.tensorboard_trace_handler writes)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def trace_summary(path: str, top: int = 5) -> dict:
    """Read a trace that trace_dir wrote (`path`: the file, or its
    directory, whose newest trace is read): the traced window (first
    event's start to last event's end), the device's busy time in it (the
    union of its kernels, copies and sets) and that share of the window,
    and the `top` device kernels by total time."""
    if os.path.isdir(path):
        files = glob.glob(os.path.join(path, "*.pt.trace.json"))
        if not files:
            raise FileNotFoundError(f"no *.pt.trace.json in {path}")
        path = max(files, key=os.path.getmtime)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no complete events")
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("cat") in DEVICE_CATEGORIES)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in device:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    kernels: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = kernels.setdefault(e["name"], [0.0, 0])
            k[0] += float(e["dur"])
            k[1] += 1
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    window_us = end - start
    return {"trace": path, "window_ms": window_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / window_us if window_us > 0 else 0.0,
            "device_events": len(device),
            "top_kernels": [{"name": n, "ms": t / 1e3, "count": c}
                            for n, (t, c) in ranked]}
