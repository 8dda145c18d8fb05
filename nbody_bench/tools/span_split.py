"""Where a cell's device time and idle time go, by the program's spans:
whole segments under torch.profiler for at least 2 s (a `--trace 1`
window, after the same set-up), the Chrome trace kept, and each device
event given to the innermost program span (`engine.*`, `fast.*`) open
when the host launched it (the runtime call of the same correlation id),
each idle gap to the innermost program span open at its midpoint.

    python3 nbody_bench/tools/span_split.py <cell> [<cell> ...] \
        [--seed 5] [--out FILE.json]

Prints one JSON line a cell, in ms a step: the device time of the PM
kernels, of K3 and of the rest (the glue, as metrics/glue_ms_per_step
counts it) under each span; the idle gaps under each span; and the
program's span totals (device and host ms a step, counts).
"""

import argparse
import bisect
import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from nbody_bench import harness, trace  # noqa: E402
from nbody_bench.metrics import k3_ms_per_step, pm_ms_per_step  # noqa: E402

PROGRAM_SPAN = re.compile(r"^(engine|fast)\.")
OUTSIDE = "outside the program's spans"


def _innermost(spans, t):
    """The innermost span of `spans` ((start, end, name), nested, sorted
    by start and then longest first) open at time t: the latest started
    that has not ended."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    while i >= 0:
        if spans[i][1] >= t:
            return spans[i][2]
        i -= 1
    return OUTSIDE


def split(path: str, steps: int) -> dict:
    """The split of one exported trace (see the module's docstring)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and PROGRAM_SPAN.match(e["name"])),
                   key=lambda s: (s[0], -s[1]))
    launch = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr:
            launch[corr] = float(e["ts"])
    pm = re.compile(pm_ms_per_step.PATTERN)
    k3 = re.compile(k3_ms_per_step.PATTERN)
    device: dict = {}
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATEGORIES:
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        where = _innermost(spans, t) if t is not None else "unlaunched"
        kind = "glue"
        if e["cat"] == "kernel" and pm.search(e["name"]):
            kind = "pm"
        elif e["cat"] == "kernel" and k3.search(e["name"]):
            kind = "k3"
        row = device.setdefault(where, {"pm": 0.0, "k3": 0.0, "glue": 0.0})
        row[kind] += float(e["dur"]) * 1e-3 / steps
    tr = trace.summary(path)
    idle: dict = {}
    for g0, g1 in tr.gaps:
        where = _innermost(spans, 0.5 * (g0 + g1))
        idle[where] = idle.get(where, 0.0) + (g1 - g0) * 1e-3 / steps
    return {"device_ms_per_step": device, "idle_ms_per_step": idle,
            "window_s": tr.window_s, "busy_s": tr.busy_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile
    from lambda_cdm_tpu_torch.utils import profiling
    results = {}
    for name in args.cells:
        cell = harness.Cell(name)
        run = harness.Run(cell, args.seed, "cuda")
        profiling.reset_trace()
        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                while True:
                    run.segment(annotate=True)
                    if time.perf_counter() - t0 >= harness.TRACE_MIN_S:
                        break
                torch.cuda.synchronize()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            steps = run.attempted * cell.steps
            out = split(path, steps)
        tot = profiling.trace_totals()
        out.update(cell=name, steps=steps,
                   device=torch.cuda.get_device_name(run.device),
                   spans={k: {"count": v["count"],
                              "device_ms_per_step": v["device_s"] * 1e3
                              / steps,
                              "host_ms_per_step": v["host_s"] * 1e3 / steps,
                              "self_host_ms_per_step": v["self_s"] * 1e3
                              / steps}
                          for k, v in tot["spans"].items()},
                   counters=tot["counters"])
        results[name] = out
        print(json.dumps(out), flush=True)
        del run
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
