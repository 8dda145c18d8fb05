"""The benchmark's harness: one cell of BENCHMARK.json, run once.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name: configs/<config>.json (the port's SimulationConfig
as it is run, with the source, the cut and the segment length),
traffic/<mix>.json (how the start state is made and the check's
sample), metrics/<metric>.py (a reader), limits/<cell>.json (the
correctness limit of each compared number).

A run: set-up (the start state from the traffic and --seed, with the
time step the configuration's rule takes on it, held fixed; the port's
SimulationEngine on it; one warm-up segment), then the window: segments
of S steps, each `engine.state = start` (a reset through the public
setter: the fast stepper buckets the state and evaluates its forces, a
stateless solver evaluates them at the segment's first step) and
`engine.run(num_steps=S)`, until --seconds have passed. Every segment is
the same work. After the window, through the same engine: one more step
from the last segment's output (on the fast path, on the buckets the
segments left: its kick and its drift), and one step from that output
at rest after a reset (its velocities are the two force evaluations
alone). The plain reference (reference.py), in the law of the
configuration's forces.type, recomputes all three for a sample of
particles.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import logging
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from . import inputs, reference
from . import trace as trace_mod

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
TRACE_MIN_S = 2.0        # a traced window covers whole segments this long
FORBIDDEN = ("jax", "jaxlib", "flax", "lambda_cdm_tpu")
EXACT_CHECKS = ("lost", "nonfinite", "dropped", "bad_steps")
# each compared number: the check step's quantity it holds to the reference
COMPARED = {"force_gap": "rest", "kick_gap": "kick", "drift_gap": "drift"}


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its files."""

    def __init__(self, name: str, root: str = ROOT, bench_dir: str = None):
        bench_dir = bench_dir or BENCH_DIR
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = found[0]
        conf = [c for c in self.bench["configs"]
                if c["name"] == self.entry["config"]][0]
        self.config = load_json(os.path.join(root, conf["file"]))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bench_dir, "limits",
                                             name + ".json"))
        self.chips = int(self.entry.get("chips", 1))
        cfg = self.config
        # the law of its forces.type (ValueError where the reference has
        # none), with the sizes it reads
        self.geometry = reference.geometry(cfg)
        self.steps = int(cfg["bench"]["segment_steps"])
        chunk = int(cfg["simulation"]["output_frequency"])
        if self.steps <= 0 or self.steps % chunk:
            raise ValueError(f"{name}: a segment of {self.steps} steps is "
                             f"not whole output chunks of {chunk}")
        self.n = int(cfg["particles"]["num_particles"])

    def metrics(self, traced: bool) -> list:
        """The cell's metrics: end to end untraced, per layer traced; a
        metric with a `workloads` key only in the cells it lists."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def engine_config(self, dt: float):
        """The port's SimulationConfig of the configuration file, with
        the time step `dt` held fixed."""
        from lambda_cdm_tpu_torch.core.config import SimulationConfig
        cfg = SimulationConfig.from_dict(self.config)
        cfg.time.initial_timestep = float(dt)
        cfg.integration.adaptive_timestep = False
        cfg.integration.max_dloga = 0.0
        return cfg


def read_metrics(metrics: list, ctx: dict) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        reader = importlib.import_module(
            f"{__package__}.metrics.{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


class _Counter(logging.Handler):
    """Counts the engine's warnings of dropped deposits (package logger
    "lambda_cdm_tpu")."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.dropped = 0

    def emit(self, record):
        if "dropped" in record.getMessage():
            self.dropped += 1


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Run:
    """A cell's set-up on one device: the start state and the engine,
    warmed up; then segments, the window and the check."""

    def __init__(self, cell: Cell, seed: int, device="cuda"):
        from lambda_cdm_tpu_torch.core.engine import SimulationEngine
        from lambda_cdm_tpu_torch.core.state import make_state
        self.cell = cell
        self.device = torch.device(device)
        marks = [time.perf_counter()]
        torch.zeros(1, device=self.device).sum().item()   # the context
        marks.append(time.perf_counter())
        start = inputs.start_state(cell.config, cell.traffic, seed,
                                   self.device)
        _sync(self.device)
        marks.append(time.perf_counter())
        self.rng = start["rng"]
        self.dt = start["dt"]
        mass = torch.full((cell.n,), start["mass"], dtype=torch.float32,
                          device=self.device)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.counter = _Counter()
        self.engine = SimulationEngine(cell.engine_config(self.dt),
                                       device=self.device)
        logging.getLogger("lambda_cdm_tpu").addHandler(self.counter)
        self.engine.initialize(state=make_state(
            start["pos"], start["vel"], mass, scale_factor=start["a"]))
        self.start = self.engine.state
        self.bad = dict.fromkeys(EXACT_CHECKS, 0)
        self.attempted = self.failed = 0
        _sync(self.device)
        marks.append(time.perf_counter())
        self.segment(count=False)          # warm-up: the window's work
        _sync(self.device)
        marks.append(time.perf_counter())
        self.setup_phases = dict(zip(
            ("device", "inputs", "engine", "warm_up"),
            np.diff(marks).tolist()))

    def segment(self, count=True, annotate=False):
        """Reset to the start state and run S steps; count the segment
        and what it broke."""
        span = (torch.profiler.record_function if annotate
                else lambda _: contextlib.nullcontext())
        drops0 = self.counter.dropped
        ok = True
        try:
            with span("bench.reset"):
                self.engine.state = self.start
            with span("bench.segment"):
                st = self.engine.run(num_steps=self.cell.steps)
            bad = self.validate(st, self.start, self.cell.steps)
        except Exception as exc:                   # a segment that raises
            print(f"segment failed: {exc!r}", file=sys.stderr)
            bad, ok = {}, False
        bad["dropped"] = self.counter.dropped - drops0
        if count:
            self.attempted += 1
            for k, v in bad.items():
                self.bad[k] += v
            if not ok or any(bad.values()):
                self.failed += 1

    @staticmethod
    def validate(st, before, steps: int) -> dict:
        """Rows without mass, non-finite positions, and whether the state
        advanced by `steps`: one readback."""
        flags = torch.stack([torch.sum(st.masses <= 0),
                             torch.sum(~torch.isfinite(st.positions))]).cpu()
        return {"lost": int(flags[0]), "nonfinite": int(flags[1]),
                "bad_steps": int(int(st.step) - int(before.step) != steps)}

    def window(self, seconds: float) -> float:
        """Segments until `seconds` have passed; returns the wall time of
        the whole segments run."""
        t0 = time.perf_counter()
        while True:
            self.segment()
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        return time.perf_counter() - t0

    def traced_window(self):
        """Whole segments under torch.profiler until TRACE_MIN_S have
        passed -> trace_mod.Trace. The trace file goes to a temporary
        directory (under TMPDIR) and is deleted once read."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        tmp = tempfile.mkdtemp(prefix="nbody_bench_trace_")
        try:
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                while True:
                    self.segment(annotate=True)
                    if time.perf_counter() - t0 >= TRACE_MIN_S:
                        break
                _sync(self.device)
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            return trace_mod.summary(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def check_steps(self) -> dict:
        """After the window, through the same engine: {"xs": the last
        segment's output, "x1": one more step from it on the buckets the
        segments left, "r1": one step from xs at rest after a reset}. The
        engine is released afterwards."""
        xs = self.engine.state
        x1 = self.step_once(xs)
        self.engine.state = xs.replace(
            velocities=torch.zeros_like(xs.velocities))
        r1 = self.step_once(xs)
        logging.getLogger("lambda_cdm_tpu").removeHandler(self.counter)
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"xs": xs, "x1": x1, "r1": r1}

    def step_once(self, before):
        """One engine step, with what it broke counted."""
        drops0 = self.counter.dropped
        after = self.engine.run(num_steps=1)
        bad = self.validate(after, before, 1)
        bad["dropped"] = self.counter.dropped - drops0
        for k, v in bad.items():
            self.bad[k] += v
        return after

    def targets(self, pos):
        """The check's sample: random particles drawn from the seed and
        up to `dense_targets` of the fullest cell of the reference's
        search grid at the configuration's split_factor. Where the law
        has no short range (pm, pm_fast), rs and r_cut take no part in
        the force: the grid only finds the fullest cell."""
        t = self.cell.traffic
        g = self.cell.geometry
        n = pos.shape[0]
        rand = self.rng.choice(n, min(int(t["check_targets"]), n),
                               replace=False)
        cid = reference.cell_ids(pos, g["box"], reference.search_grid(
            g["box"], g["rs"]))
        full = int(torch.argmax(torch.bincount(cid)))
        members = torch.nonzero(cid == full)[:, 0].cpu().numpy()
        dense = self.rng.choice(members, min(int(t["dense_targets"]),
                                             members.size), replace=False)
        return torch.as_tensor(np.union1d(rand, dense), device=pos.device)


def program_step(cell: Cell, steps: dict, targets) -> dict:
    """The program's compared quantities at `targets` (float64): the
    rest step's velocities, and the continuing step's change of the
    velocities and drift (unwrapped)."""
    xs, x1, r1 = steps["xs"], steps["x1"], steps["r1"]
    box = cell.geometry["box"]

    def at(t):
        return t[targets].to(torch.float64)

    drift = at(x1.positions) - at(xs.positions)
    drift = drift - box * torch.round(drift / box)
    return {"rest": at(r1.velocities),
            "kick": at(x1.velocities) - at(xs.velocities), "drift": drift}


def reference_step(cell: Cell, steps: dict, targets, dt: float,
                   precision="float64", fault=None) -> dict:
    """The same quantities by the reference: its forces at the program's
    positions, moved by its KDK step. precision="tf32" is the control;
    `fault` plants one in the reference: "half", "window_once" and
    ("drop_cell", id) as in reference.forces, "drift" the drift 1% long.
    The law is the configuration's (`cell.geometry["law"]`)."""
    g = cell.geometry
    xs = steps["xs"]
    force_fault = None if fault == "drift" else fault

    def acc(st):
        return reference.forces(st.positions, st.masses, targets,
                                geometry=g, precision=precision,
                                fault=force_fault).to(torch.float64)

    acc_s = acc(xs)
    kw = dict(a0=float(xs.scale_factor), dt=dt, omega_m=g["omega_m"],
              omega_lambda=g["omega_lambda"])
    kick, drift = reference.kdk(
        acc_s, acc(steps["x1"]), xs.velocities[targets].to(torch.float64),
        drift_scale=1.01 if fault == "drift" else 1.0, **kw)
    rest, _ = reference.kdk(acc_s, acc(steps["r1"]), torch.zeros_like(acc_s),
                            **kw)
    return {"rest": rest, "kick": kick, "drift": drift}


def gap(v, v_ref) -> float:
    """The widest gap |v - v_ref| over the sample, against the sample's
    rms |v_ref|."""
    scale = torch.sqrt(torch.mean(torch.sum(v_ref * v_ref, dim=1)))
    return float(torch.max(torch.linalg.norm(v - v_ref, dim=1)) / scale)


def judge(got: dict, want: dict, run: Run, limits: dict):
    """(checks, correct): each compared number of `got` against `want`
    and the exact counts of the run, each beside its limit; correct when
    every segment ran whole and every number is within its limit."""
    checks = {name: {"value": gap(got[q], want[q]),
                     "limit": limits.get(name)}
              for name, q in COMPARED.items()}
    for k in EXACT_CHECKS:
        checks[k] = {"value": run.bad[k], "limit": 0}
    correct = (run.failed == 0 and run.attempted > 0
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    return checks, bool(correct)


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start=None, root=ROOT, bench_dir=None) -> dict:
    """One run of a cell -> the result dict (the contract's last line,
    with "checks" last). `t_start`: the process's start on the host
    clock (perf_counter), from which set-up is counted."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, root=root, bench_dir=bench_dir)
    t_run = time.perf_counter()
    run = Run(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    print("setup " + " ".join(f"{k} {v:.3f} s" for k, v in
                              [("imports", t_run - t_start)]
                              + list(run.setup_phases.items())),
          file=sys.stderr)
    ctx = {"n": cell.n, "geometry": cell.geometry,
           "segment_steps": cell.steps,
           "rng": np.random.default_rng([int(seed) % 2 ** 64, 1])}
    if traced:
        tr = run.traced_window()
        ctx.update(trace=tr, steps=run.attempted * cell.steps,
                   start_positions=run.start.positions)
    else:
        wall = run.window(seconds)
        ctx.update(steps=run.attempted * cell.steps, wall_s=wall,
                   setup_s=setup_s)
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    ctx["peak_bytes"] = peak
    metrics = read_metrics(cell.metrics(traced), ctx)
    steps = run.check_steps()
    targets = run.targets(steps["xs"].positions)
    checks, correct = judge(program_step(cell, steps, targets),
                            reference_step(cell, steps, targets, run.dt),
                            run, cell.limits)
    if run.device.type == "cuda":
        dev = {"platform": "gpu",
               "kind": torch.cuda.get_device_name(run.device),
               "count": cell.chips, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = trace_mod.breakdown(tr)
    result["checks"] = checks
    return result
