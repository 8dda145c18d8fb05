"""Named-phase timers + JSON report, spans and counters inside the
program, and the profiler trace (counterpart of
lambda_cdm_tpu/utils/profiling.py: `trace_dir` takes jax_trace's place,
with `trace_summary` to read what it wrote).

`stop(name, sync_on=t)` synchronizes t's CUDA device first, so a timer
measures finished device work rather than the enqueue.

Spans and counters (`span(name, device=False)`, `count(name, k=1)`) are
on only while a torch profiler is active or a `tracing()` context is
open; otherwise `span` returns one shared no-op context and `count`
returns at once (one flag read each). When on, a span enters
`torch.profiler.record_function(name)` under an active torch profiler,
so it lands in the exported trace as a `user_annotation` on the clock of
the device events, and keeps a record in memory: its name, its parent
span, its host start and end, the engine step it started at, and with
`device=True` a CUDA event pair on the current stream. `flush()` (the
engine's run loop calls it at each chunk end, after its synchronize)
reduces the records to per-name totals (`SpanTotals`); `trace_totals()`
returns them with the counters and `reset_trace()` clears both. The
`profiling.detailed_timing` setting opens `tracing()` for a run. A
span's device seconds are the stream time between its two events, idle
time inside the span included; a span without events (a host-only span,
or any span on the CPU) reports its host seconds there. `Profiler.timer`
opens a span of its timer's name. The registry is the process's, for
spans opened and closed on one thread.

The program's span names: `engine.chunk`, `engine.cadence`,
`engine.sync_state`, `engine.init_fast` (with `fast.build`),
`engine.grow` (core/engine.py); `fast.rebucket`, `fast.kick`,
`fast.drift`, `fast.accel` (with `fast.pm` and `fast.short_range`)
(ops/fast_treepm.py; the stateless solvers' force is `fast.accel` too,
and the stateless PM's phases inside it `pm.deposit`, `pm.solve` and
`pm.gather`, ops/pm_cic.py).
Counters: `rebuckets` (one a rebucket pass), `readbacks` (one a point
where the host waits on the card: every `synchronize` here, and each
read of a device value on the fast path), `fused_kdk` (one a launch
of ops/kdk_update.py's kernels) and `pm_forces` (one a stateless PM
force evaluation, forces/pm.pm_accelerations).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

# the trace's device activity (Kineto's categories)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# closed span records held between flushes before one is forced
MAX_PENDING = 65536


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


@dataclass
class SpanTotals:
    """One span name's records reduced: how many, their host seconds,
    their self host seconds (minus child spans), their device seconds,
    the names of the spans they opened in (None: none) and the engine
    steps the first and the last started at."""
    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    parents: list = field(default_factory=list)
    first_step: int = 0
    last_step: int = 0

    def to_dict(self) -> dict:
        return dict(self.__dict__, parents=list(self.parents))


@dataclass
class _Registry:
    """The process's spans and counters: the open `tracing()` contexts,
    the open spans, closed records not yet reduced, the totals, the
    counters, the engine step, a pool of CUDA events and the streams
    they were recorded on."""
    depth: int = 0
    stack: list = field(default_factory=list)
    pending: list = field(default_factory=list)
    totals: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    step: int = 0
    events: list = field(default_factory=list)
    streams: dict = field(default_factory=dict)

    def record(self):
        """A pooled CUDA event recorded on the current stream (a cached
        Stream object: building one costs more than the record)."""
        ev = self.events.pop() if self.events else \
            torch.cuda.Event(enable_timing=True)
        key = torch._C._cuda_getCurrentStream(-1)
        stream = self.streams.get(key)
        if stream is None:
            stream = self.streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        ev.record(stream)
        return ev


_REG = _Registry()


def tracing_on() -> bool:
    """Whether spans and counters record: a torch profiler is active or
    a `tracing()` context is open."""
    return bool(_REG.depth or _autograd_profiler._is_profiler_enabled)


class _Span:
    __slots__ = ("name", "device", "parent", "step", "child_s", "rf", "ev0",
                 "t0")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        reg = _REG
        self.parent = reg.stack[-1] if reg.stack else None
        reg.stack.append(self)
        self.step = reg.step
        self.child_s = 0.0
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.ev0 = reg.record() if self.device else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        reg = _REG
        ev1 = reg.record() if self.ev0 is not None else None
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self in reg.stack:
            reg.stack.remove(self)
        host = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_s += host
        reg.pending.append((self.name, parent and parent.name, host,
                            host - self.child_s, self.ev0, ev1, self.step))
        if not reg.stack and len(reg.pending) >= MAX_PENDING:
            flush()
        return False


_NOOP = contextlib.nullcontext()


def span(name: str, device: bool = False):
    """A span named `name` (a context manager); `device=True` (pass
    whether the work runs on a card) also records CUDA events around it.
    A shared no-op while tracing is off."""
    if not tracing_on():
        return _NOOP
    return _Span(name, device)


def count(name: str, k: int = 1) -> None:
    """Add `k` to the counter `name` while tracing is on."""
    if tracing_on():
        _REG.counters[name] = _REG.counters.get(name, 0) + k


def set_step(step) -> None:
    """The engine step that spans opened from now on start at."""
    if tracing_on():
        _REG.step = int(step)


@contextlib.contextmanager
def tracing():
    """Turn spans and counters on for the block, without a profiler."""
    _REG.depth += 1
    try:
        yield
    finally:
        _REG.depth -= 1


def flush() -> None:
    """Reduce the closed spans' records to per-name totals (waiting for
    their device events) and return the events to the pool."""
    reg = _REG
    for name, parent, host, self_s, ev0, ev1, step in reg.pending:
        if ev0 is not None:
            ev1.synchronize()
            dev = ev0.elapsed_time(ev1) * 1e-3
            reg.events += [ev0, ev1]
        else:
            dev = host
        tot = reg.totals.get(name)
        if tot is None:
            tot = reg.totals[name] = SpanTotals(first_step=step)
        if parent not in tot.parents:
            tot.parents.append(parent)
        tot.count += 1
        tot.host_s += host
        tot.self_s += self_s
        tot.device_s += dev
        tot.last_step = step
    reg.pending.clear()


def trace_totals() -> dict:
    """{"spans": {name: SpanTotals as a dict}, "counters": {name: n}}
    of everything recorded since the last `reset_trace()`."""
    flush()
    return {"spans": {k: v.to_dict() for k, v in _REG.totals.items()},
            "counters": dict(_REG.counters)}


def totals_of(name: str) -> SpanTotals | None:
    """The totals of span `name` reduced so far (no flush), or None."""
    return _REG.totals.get(name)


def reset_trace() -> None:
    """Clear the totals, the counters and the records not yet reduced."""
    _REG.pending.clear()
    _REG.totals.clear()
    _REG.counters.clear()
    _REG.stack.clear()
    _REG.step = 0


def synchronize(tensor) -> None:
    """Wait for the device work that produces `tensor` (no-op on CPU);
    counted as a readback."""
    count("readbacks")
    if getattr(tensor, "is_cuda", False):
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
    def timer(self, name: str, sync_on=None, span_name: str | None = None):
        """Time the block as `name`, inside a span named `span_name`
        (default: `name`)."""
        with span(span_name or name):
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
        report = {"timers": self.summary(), **trace_totals()}
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
