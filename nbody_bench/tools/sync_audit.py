"""The program's `readbacks` counter against the card's own count of the
points where the host waited: one segment of a cell (`engine.state =
start`, `engine.run(num_steps=S)`, after the set-up and warm-up of a
benchmark run) under torch.cuda.set_sync_debug_mode("warn"), with the
explicit torch.cuda.synchronize calls counted beside the synchronizing
operations it warns of, each by the program's line that made it. A
warning raised with no frame of the program on the stack (the first
switch of the mode in a process warns once, inside torch) is listed
apart and not counted.

    python3 nbody_bench/tools/sync_audit.py <cell> [<cell> ...] \
        [--seed 5] [--out FILE.json]

Prints one JSON line a cell: the counter, the warnings, the
synchronizes, whether the counter equals their sum, the sites and the
program's span totals for the segment. `--device cpu` rehearses the run
(no sync-debug mode there: warnings and synchronizes read 0), with
`--root` a directory that holds a BENCHMARK.json and its files (the CPU
tests' tiny cells).
"""

import argparse
import collections
import json
import os
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from nbody_bench import harness  # noqa: E402

PROGRAM = os.sep + "lambda_cdm_tpu_torch" + os.sep


def _site():
    """The innermost frame of the program on the stack (file:line
    function), or None where none is."""
    mine = [f for f in traceback.extract_stack()
            if PROGRAM in f.filename]
    if not mine:
        return None
    f = mine[-1]
    return f"{f.filename.split(PROGRAM)[-1]}:{f.lineno} {f.name}"


def audit(run: harness.Run) -> dict:
    """One segment of `run` with every host wait counted, on the card by
    the sync-debug mode, and by the program's counter."""
    from lambda_cdm_tpu_torch.utils import profiling
    on_card = run.device.type == "cuda"
    sites = collections.Counter()
    n = {"warned": 0, "synchronized": 0, "outside": 0}
    real_sync = torch.cuda.synchronize

    def counting_sync(*a, **k):
        n["synchronized"] += 1
        sites[f"synchronize {_site()}"] += 1
        return real_sync(*a, **k)

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        if "synchroniz" not in str(message):
            return
        site = _site()
        if site is None:
            n["outside"] += 1
        else:
            n["warned"] += 1
            sites["warning " + site] += 1

    profiling.reset_trace()
    torch.cuda.synchronize = counting_sync
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            with profiling.tracing():
                if on_card:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    run.engine.state = run.start
                    run.engine.run(num_steps=run.cell.steps)
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.cuda.synchronize = real_sync
    tot = profiling.trace_totals()
    profiling.reset_trace()
    readbacks = tot["counters"].get("readbacks", 0)
    return {"readbacks": readbacks, **n,
            "equal": readbacks == n["warned"] + n["synchronized"],
            "rebuckets": tot["counters"].get("rebuckets", 0),
            "sites": dict(sorted(sites.items())),
            "spans": {k: {"count": v["count"],
                          "device_ms": v["device_s"] * 1e3,
                          "host_ms": v["host_s"] * 1e3}
                      for k, v in tot["spans"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root) if args.root else ROOT
    results = {}
    for name in args.cells:
        cell = harness.Cell(name, root=root,
                            bench_dir=root if args.root else None)
        run = harness.Run(cell, args.seed, args.device)
        results[name] = dict(cell=name, device=(
            torch.cuda.get_device_name(run.device)
            if run.device.type == "cuda" else "cpu"), **audit(run))
        print(json.dumps(results[name]), flush=True)
        del run
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if all(r["equal"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
