"""Reading a torch.profiler trace: the device's busy time, its kernels by
name, and the idle gaps by what the host was doing.

`summary` is a copy of lambda_cdm_tpu_torch/utils/profiling.trace_summary
at commit 9aff8f2 (the traced window from the first event's start to the
last event's end; device busy time as the union of its kernels, copies
and sets), extended to keep the device events for the per-layer readers
and the host events for the idle gaps.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

# the trace's device activity (Kineto's categories)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host activity that can explain an idle device
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function",
                   "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device: list = field(default_factory=list)   # (name, cat, ts_us, dur_us)
    gaps: list = field(default_factory=list)     # (start_us, end_us)
    host: list = field(default_factory=list)     # (name, ts_us, dur_us)

    def kernels(self, pattern: str):
        """Device kernels whose name matches the regular expression."""
        rx = re.compile(pattern)
        return [e for e in self.device
                if e[1] == "kernel" and rx.search(e[0])]

    def seconds(self, events) -> float:
        return sum(e[3] for e in events) * 1e-6

    def device_seconds(self) -> float:
        """Summed duration of every device event."""
        return self.seconds(self.device)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summary(path: str) -> Trace:
    """Read a Chrome trace that torch.profiler exported."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no complete events")
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    device = [(e["name"], e["cat"], float(e["ts"]), float(e["dur"]))
              for e in events if e.get("cat") in DEVICE_CATEGORIES]
    busy = _union([(ts, ts + dur) for _, _, ts, dur in device])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    host = [(e["name"], float(e["ts"]), float(e["dur"]))
            for e in events if e.get("cat") in HOST_CATEGORIES]
    return Trace(window_s=(end - start) * 1e-6,
                 busy_s=sum(e - s for s, e in busy) * 1e-6,
                 device=device, gaps=gaps, host=host)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by the innermost host event under each gap's midpoint."""
    by_name: dict = {}
    for name, _, _, dur in trace.device:
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # sweep: host events by start (the outer first), a stack of the open
    # ones; the innermost open event at a gap's midpoint names the gap
    host = sorted(trace.host, key=lambda h: (h[1], -h[2]))
    stack: list = []
    nxt = 0
    idle: dict = {}
    for g0, g1 in sorted(trace.gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while nxt < len(host) and host[nxt][1] <= mid:
            stack.append(host[nxt])
            nxt += 1
        while stack and stack[-1][1] + stack[-1][2] < mid:
            stack.pop()
        label = stack[-1][0] if stack else "no host event"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}
