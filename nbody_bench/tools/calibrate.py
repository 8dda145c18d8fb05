"""The readings a cell's correctness limits are set from, in one
process, each judged as a run judges it (harness.judge, the cell's
limits): for each seed the program after one segment; on the first
`--control` seeds the control (the reference in TF32, put in the
program's place) and three faults planted in the reference put in its
place: every other particle left out with the rest at twice the mass;
the drift 1% long; and, where the configuration's law has a short range,
the short range of the fullest search cell left out and the gap by which
the port's cell plan truncates the law (the reference summed over the
plan's 27 neighbour cells), else the CIC window divided out once instead
of twice. `--program-fault skip_rebucket` runs every seed of a fast
stepper's cell with the program's in-run rebucket left out.

    python3 nbody_bench/tools/calibrate.py <cell> --seeds 1 2 ... \
        [--control 3] [--program-fault skip_rebucket]

One JSON line a seed. The set-up, the segment, the check steps and the
sample are the benchmark run's own (harness.Run).
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from nbody_bench import harness, reference  # noqa: E402


def _values(checks):
    return {k: c["value"] for k, c in checks.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--program-fault", choices=("skip_rebucket",))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from lambda_cdm_tpu_torch.ops import fast_treepm
    if args.program_fault == "skip_rebucket":
        fast_treepm._rebucket = lambda fstate, **kw: fstate
    cell = harness.Cell(args.cell)
    g = cell.geometry
    short = reference.LAWS[g["law"]]["short"]
    f = cell.config["forces"]
    plan = (fast_treepm.fast_plan(cell.n, g["box"], g["ng"],
                                  split_factor=f["split_factor"],
                                  cut_factor=f["cut_factor"],
                                  capacity=f["bucket_capacity"])
            if short else None)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, args.device)
        t_setup = time.perf_counter() - t0
        run.window(0.0)                          # one segment
        steps = run.check_steps()
        targets = run.targets(steps["xs"].positions)
        t1 = time.perf_counter()
        want = harness.reference_step(cell, steps, targets, run.dt)
        if args.device == "cuda":
            torch.cuda.synchronize()
        t_ref = time.perf_counter() - t1
        checks, correct = harness.judge(
            harness.program_step(cell, steps, targets), want, run,
            cell.limits)
        row = {"cell": args.cell, "seed": seed, "dt": run.dt,
               "a_start": float(run.start.scale_factor),
               "a_end": float(steps["xs"].scale_factor),
               "setup_s": t_setup, "reference_s": t_ref,
               "targets": int(targets.numel()), "failed": run.failed,
               "program": _values(checks), "correct": correct,
               "program_fault": args.program_fault}
        if i < args.control and not args.program_fault:
            xs = steps["xs"]
            planted = [("control_tf32", {"precision": "tf32"}),
                       ("fault_half", {"fault": "half"}),
                       ("fault_drift", {"fault": "drift"})]
            if short:
                cid = reference.cell_ids(xs.positions, g["box"],
                                         reference.search_grid(g["box"],
                                                               g["rs"]))
                fullest = int(torch.argmax(torch.bincount(cid)))
                planted.append(("fault_cell",
                                {"fault": ("drop_cell", fullest)}))
            else:
                planted.append(("fault_window_once",
                                {"fault": "window_once"}))
            for name, kw in planted:
                got = harness.reference_step(cell, steps, targets, run.dt,
                                             **kw)
                c, ok = harness.judge(got, want, run, cell.limits)
                row[name] = dict(_values(c), correct=ok)
            if short:
                trunc = reference.forces(xs.positions, xs.masses, targets,
                                         geometry=g, ncell=plan["ncell"])
                full = reference.forces(xs.positions, xs.masses, targets,
                                        geometry=g)
                row["plan_ncell"] = plan["ncell"]
                row["plan_truncation_gap"] = harness.gap(trunc, full)
        print(json.dumps(row), flush=True)
        del run, steps, want
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
