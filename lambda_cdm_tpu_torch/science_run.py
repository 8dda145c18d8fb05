"""The science run on one card: the 1M-particle Lambda-CDM box evolved
z = 24 -> 0 through the SimulationEngine, then checked end to end
(counterpart of the JAX package's science_run.py at the repository root).

  2LPT ICs -> treepm_fast (persistent cell-list stepper, adaptive dt)
  -> P(k) observer at every chunk -> Layzer-Irvine energy ledger (the
  pairwise U of K9, sampled every 0.15 e-folds) -> FoF/SO catalogue and
  the HMF against Sheth-Tormen at z = 0 -> Born convergence map.

The evolve phase writes its whole output (final state, IC and snapshot
spectra, ledger samples, engine statistics, the final-state step
breakdown) to a record before any analysis runs; `--analyze-only`
re-runs the checks from a record. The record is the JAX package's npz
layout, so a record written by either package loads in the other.

The ICs come from the port's lpt_displacements on the key
PRNGKey(2026) of utils/prng, the JAX run's jax.random key: the two
packages start from the same particles.

    python -m lambda_cdm_tpu_torch.science_run            (1M, the card)
    python -m lambda_cdm_tpu_torch.science_run --small --device cpu
    python -m lambda_cdm_tpu_torch.science_run --analyze-only [record.npz]

Writes SCIENCE[_small].json and science_record[_small].npz to --out
(default chiprun_out/ under the current directory) and exits nonzero on a
failed check. LCDM_SCIENCE_ZFINAL=z stops the run early (z = 0 checks are
then recorded, not asserted).
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .forces.direct import kinetic_energy, potential_energy

Z_INIT = 24.0
SEED = 2026


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class LayzerIrvineLedger:
    """Tracks C = T + U + int H (2T+U) dt across the run.

    U is the pairwise minimum-image potential (forces/direct.potential_energy:
    K9 on the card), sampled every `dlna_sample` e-folds of expansion, not
    every chunk. The per-interval integral of H(2T+U)dt = (2T+U)/a da
    uses the analytic 1/a^2, 1/a forms with trapezoid comoving
    coefficients (a plain trapezoid cannot resolve 1/a^2 across large
    early steps in a)."""

    def __init__(self, engine, dlna_sample: float = 0.15):
        self.engine = engine
        self.dlna = dlna_sample
        self.samples: list[dict] = []
        self._prev = None
        self._li = 0.0
        self._c0 = None
        self.worst = 0.0
        self.wall_s = 0.0

    def sample(self, force: bool = False):
        a = float(self.engine.state.scale_factor)
        if (not force and self._prev is not None
                and math.log(a / self._prev[0]) < self.dlna):
            return
        t_in = time.perf_counter()
        st = self.engine.state
        cfg = self.engine.config
        ke = float(kinetic_energy(st.velocities, st.masses))
        pe = float(potential_energy(
            st.positions, st.masses, cfg.particles.box_size,
            cfg.forces.softening_length, cfg.units.G))
        t_pec = ke / (a * a)                # comoving-kick u = a^2 dx/dt
        u_phys = pe / a
        if self._prev is not None:
            a_p, t_p, u_p = self._prev
            tc = 0.5 * (t_pec * a * a + t_p * a_p * a_p)
            uc = 0.5 * (u_phys * a + u_p * a_p)
            self._li += (2 * tc * 0.5 * (1 / a_p ** 2 - 1 / a ** 2)
                         + uc * (1 / a_p - 1 / a))
        if self._c0 is None:
            self._c0 = t_pec + u_phys
        resid = abs(t_pec + u_phys + self._li - self._c0) / abs(u_phys)
        self.worst = max(self.worst, resid)
        self.samples.append({"a": a, "T": t_pec, "U": u_phys,
                             "residual": resid})
        self._prev = (a, t_pec, u_phys)
        self.wall_s += time.perf_counter() - t_in
        log(f"  [LI] a={a:.4f}  T={t_pec:.4e}  U={u_phys:.4e}  "
            f"resid={resid:.3e}")


def geometry(small: bool) -> dict:
    """The run's geometry: the JAX package's two (40^3 in 62.5 Mpc/h for
    --small; else 100^3 = 1M particles in 100 Mpc/h on a 192^3 PM mesh,
    P(k) at 256^3, softening 0.1, buckets pre-sized to capacity 8192)."""
    if small:
        return dict(n_side=40, ng_ic=80, box=62.5, pm_grid=0,
                    pk_grid=64, softening=0.3, chunk=50,
                    bucket_capacity=2048)
    return dict(n_side=100, ng_ic=200, box=100.0, pm_grid=192,
                pk_grid=256, softening=0.1, chunk=50,
                bucket_capacity=8192)


def _config(g: dict, n: int, z_final: float, small: bool, on_card: bool):
    from .core.config import SimulationConfig
    cfg = SimulationConfig()
    cfg.particles.num_particles = n
    cfg.particles.box_size = g["box"]
    cfg.forces.type = "treepm_fast"
    cfg.forces.softening_length = g["softening"]
    cfg.forces.pm_grid_size = g["pm_grid"]
    # pre-sized on the card, where K3's work follows occupancy, not the
    # capacity; the CPU's plain short range walks every padded slot, so
    # there the auto plan and grow-and-retry size the buckets
    cfg.forces.bucket_capacity = g["bucket_capacity"] if on_card else 0
    # the drift guard shortens the cadence whenever safety needs it: this
    # is only the amortisation ceiling
    cfg.forces.rebucket_every = 16 if small else 64
    cfg.time.initial_timestep = 1e-4
    cfg.time.final_time = 1e9
    cfg.cosmology.initial_redshift = Z_INIT
    cfg.cosmology.final_redshift = z_final
    cfg.integration.kick_mode = "comoving"
    cfg.integration.adaptive_timestep = True
    cfg.integration.max_dloga = 0.03
    cfg.integration.min_timestep = 1e-9
    cfg.integration.max_timestep = 1e-3
    cfg.simulation.output_frequency = g["chunk"]
    cfg.simulation.checkpoint_frequency = 0
    cfg.io.snapshots.enabled = False
    cfg.profiling.output_file = ""
    return cfg


def initial_conditions(g: dict, device) -> tuple:
    """The run's 2LPT ICs at z = Z_INIT from the key PRNGKey(SEED) (the
    JAX run's noise, drawn on `device`): (positions [N, 3], velocities
    [N, 3], the particle mass in 1e10 Msun/h)."""
    from .physics.cosmology import CosmologyParams
    from .physics.initial_conditions import lpt_displacements
    from .utils.prng import PRNGKey
    params = CosmologyParams()
    ng_ic, box = g["ng_ic"], g["box"]
    pos, vel = lpt_displacements(
        PRNGKey(SEED), params, ng=ng_ic, n_side=g["n_side"],
        box_size=box, a_init=1.0 / (1.0 + Z_INIT), kick_mode="comoving",
        device=device)
    n = pos.shape[0]
    return pos, vel, 27.7536 * params.omega_m * box ** 3 / n


def plan_engine(g: dict, pos, vel, mass, a: float, device):
    """A SimulationEngine on the 1M run's config and bucket plan (ncell
    16, capacity 8192 on the card), initialized at (pos, vel, mass, a):
    its fast state holds K3's buckets of that state."""
    from .core.engine import SimulationEngine
    from .core.state import make_state
    device = torch.device(device)
    cfg = _config(g, pos.shape[0], 0.0, False, device.type == "cuda")
    eng = SimulationEngine(cfg, device=device)
    eng.initialize(state=make_state(pos, vel, mass, scale_factor=a))
    return eng


def evolve_phase(small: bool, record_path: str, device="cuda") -> dict:
    """ICs, the run to LCDM_SCIENCE_ZFINAL (default 0) with the P(k)
    observer and the ledger, the step breakdown (on the card, at the 1M
    geometry), then the record."""
    from .analysis.power_spectrum import measure_power_spectrum
    from .core.analysis_observers import PowerSpectrumObserver
    from .core.engine import SimulationEngine
    from .core.observers import Observer
    from .core.state import make_state

    device = torch.device(device)
    on_card = device.type == "cuda"
    g = geometry(small)
    n_side, box = g["n_side"], g["box"]
    pk_grid = g["pk_grid"]
    z_final = float(os.environ.get("LCDM_SCIENCE_ZFINAL", "0.0"))
    a_i = 1.0 / (1.0 + Z_INIT)

    t_wall0 = time.perf_counter()
    log(f"[1/3] 2LPT ICs: {n_side}^3 particles, box={box}, z={Z_INIT}, "
        f"numpy white noise (seed {SEED}) on {device}")
    pos, vel, m_p = initial_conditions(g, device)
    n = pos.shape[0]
    mass = torch.full((n,), m_p, dtype=torch.float32, device=device)
    # no shot-noise subtraction: a displaced lattice has suppressed
    # discreteness noise below the particle Nyquist, and subtracting
    # 1/nbar there can zero the small-scale bins the ratios divide by
    pk_i = measure_power_spectrum(pos, box, ng=pk_grid, num_bins=32,
                                  subtract_shot_noise=False)
    t_ic = time.perf_counter() - t_wall0

    cfg = _config(g, n, z_final, small, on_card)
    # frequency 1: fire at every chunk boundary (the mid-z growth check
    # needs a snapshot near a ~ 0.4)
    pk_obs = PowerSpectrumObserver(frequency=1, grid_size=pk_grid,
                                   num_bins=32, subtract_shot_noise=False)
    eng = SimulationEngine(cfg, observers=[pk_obs], device=device)
    eng.initialize(state=make_state(pos, vel, mass, scale_factor=a_i))
    li = LayzerIrvineLedger(eng, dlna_sample=0.15)

    class LIObserver(Observer):
        def on_step_end(self, engine, step):
            li.sample()

    eng.add_observer(LIObserver())
    li.sample(force=True)
    # K3 at the early end, beside the final state's breakdown
    initial = (short_range_timing(eng, reps=1) if on_card and not small
               else {})

    log(f"[2/3] evolving z={Z_INIT} -> {z_final} (treepm_fast, "
        f"{g['pm_grid']}^3 PM, adaptive dt)")
    t0 = time.perf_counter()
    eng.run(num_steps=1_000_000)
    li.sample(force=True)
    if on_card:
        torch.cuda.synchronize(device)
    t_evolve = time.perf_counter() - t0
    a_f = float(eng.state.scale_factor)
    steps = int(eng.statistics.total_steps)
    log(f"  evolved to a={a_f:.4f} in {steps} steps, {t_evolve:.1f} s wall "
        f"({1e3 * t_evolve / max(steps, 1):.1f} ms/step incl. analysis)")
    overflow = int(eng._fstate.overflow)
    dropped = int(eng._fstate.dropped)

    breakdown = {}
    if on_card and not small:
        breakdown = dict(step_breakdown(eng), initial=initial)
        log(f"  final-state step breakdown: {breakdown}")
    eng.release_force_state()

    record = {
        "small": small, "geometry": g,
        "n": n, "m_p": m_p, "a_i": a_i, "a_f": a_f, "z_final": z_final,
        "steps": steps, "t_ic": t_ic, "t_evolve": t_evolve,
        "ic_cached": False,
        "overflow": overflow, "dropped": dropped,
        "platform": device.type,
        "device_kind": (torch.cuda.get_device_name(device) if on_card
                        else "cpu"),
        "engine_stats": eng.statistics.to_dict(),
        "li_samples": li.samples, "li_worst": li.worst,
        "li_wall_s": round(li.wall_s, 1),
        "breakdown": breakdown,
        "pk_i": {"k": pk_i.k.cpu().numpy(), "power": pk_i.power.cpu().numpy(),
                 "counts": pk_i.counts.cpu().numpy()},
        "pk_snapshots": [{"scale_factor": r["scale_factor"],
                          "step": r["step"], "power": r["power"]}
                         for r in pk_obs.results],
        "pos_f": eng.state.positions.cpu().numpy(),
        "vel_f": eng.state.velocities.cpu().numpy(),
        "masses": eng.state.masses.cpu().numpy(),
    }
    save_record(record_path, record)
    log(f"  evolve record saved: {record_path} (re-analyze with "
        f"--analyze-only)")
    return record


def short_range_timing(eng, reps: int = 3) -> dict:
    """K3 on the engine's current fast state, timed on the card (CUDA
    events, mean of `reps` calls), with the pair tests and the occupancy
    that set its work and its tail. Raises on a state that is not on a
    CUDA card."""
    from .core.engine import _accel_kw
    from .ops.bucketed_pm import live_counts
    from .ops.cuda_build import cuda_ms
    from .ops.short_range import neighbour_load, short_range
    fs, kw = eng._fstate, eng._fast_kw
    if not fs.bpos.is_cuda:
        raise RuntimeError("short_range_timing times the card: the "
                           "engine's state is not on a CUDA device")
    counts = live_counts(fs.bmass)
    nc = kw["ncell"]
    akw = _accel_kw(kw)
    return {
        "short_range_ms": round(cuda_ms(lambda: short_range(
            fs.bpos, fs.bmass, counts, ncell=nc, capacity=kw["capacity"],
            box_size=akw["box_size"], rs=akw["rs"],
            softening=akw["softening"], variant=akw["variant"]), reps), 3),
        "short_range_pairs": float((counts.to(torch.float64)
                                    * neighbour_load(counts, nc)).sum()),
        "max_cell_count": int(counts.max()),
        "mean_cell_count": round(float(counts.double().mean()), 3)}


def step_breakdown(eng, reps: int = 3) -> dict:
    """The step's phases on the engine's current (final, clustered) fast
    state, timed on the card: the run's own ms/step, a 4-step chunk
    without a rebucket, one rebucket, K3 and the bucketed PM, each on
    copies (the engine's state is not advanced), with the occupancy that
    sets K3's tail. Raises on a state that is not on a CUDA card."""
    from .core.engine import _accel_kw
    from .ops.bucketed_pm import live_counts, pm_accelerations_bucketed
    from .ops.cuda_build import cuda_ms
    from .ops.fast_treepm import _rebucket, fast_run
    fs, kw = eng._fstate, eng._fast_kw
    if not fs.bpos.is_cuda:
        raise RuntimeError("step_breakdown times the card: the engine's "
                           "state is not on a CUDA device")
    params = eng.config.cosmology_params()
    dt = float(eng._dt)
    counts = live_counts(fs.bmass)
    nc, cap = kw["ncell"], kw["capacity"]
    out = {}
    st = eng.statistics
    if st.total_steps:
        out["run_ms_per_step"] = round(1e3 * st.compute_time_s
                                       / st.total_steps, 3)
    out["chunk_ms_per_step"] = round(cuda_ms(lambda: fast_run(
        fs, params, dt, n_steps=4, rebucket_every=4, **kw), reps) / 4, 3)
    out["rebucket_ms"] = round(cuda_ms(lambda: _rebucket(
        fs, box_size=kw["box_size"], ncell=nc, capacity=cap,
        n_rows=kw["n_rows"]), reps), 3)
    out.update(short_range_timing(eng, reps))
    out["pm_ms"] = round(cuda_ms(lambda: pm_accelerations_bucketed(
        fs.bpos, fs.bmass, ncell=nc, ng=kw["ng"], box_size=kw["box_size"],
        g_const=kw["g_const"], split_scale=kw["rs"], margin=kw["margin"],
        gradient=kw["gradient"], counts=counts), reps), 3)
    out["variant"] = _accel_kw(kw)["variant"]
    out["ncell"] = nc
    out["capacity"] = cap
    return out


# -- record I/O (one npz: arrays + one JSON metadata blob) --------------------

def save_record(path: str, record: dict) -> None:
    """Write a record in the JAX package's layout (science_run._save_record)."""
    arrays = {"pos_f": record["pos_f"], "vel_f": record["vel_f"],
              "masses": record["masses"],
              "pk_i_k": record["pk_i"]["k"],
              "pk_i_power": record["pk_i"]["power"],
              "pk_i_counts": record["pk_i"]["counts"]}
    for i, s in enumerate(record["pk_snapshots"]):
        arrays[f"pk_snap_{i}_power"] = s["power"]
    meta = {k: v for k, v in record.items()
            if k not in ("pos_f", "vel_f", "masses", "pk_i",
                         "pk_snapshots")}
    meta["pk_snap_meta"] = [{"scale_factor": s["scale_factor"],
                             "step": s["step"]}
                            for s in record["pk_snapshots"]]
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, meta_json=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)


def load_record(path: str) -> dict:
    """Read a record written by either package."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        rec = dict(meta)
        rec["pos_f"] = z["pos_f"]
        rec["vel_f"] = z["vel_f"]
        rec["masses"] = z["masses"]
        rec["pk_i"] = {"k": z["pk_i_k"], "power": z["pk_i_power"],
                       "counts": z["pk_i_counts"]}
        rec["pk_snapshots"] = [
            {"scale_factor": m["scale_factor"], "step": m["step"],
             "power": z[f"pk_snap_{i}_power"]}
            for i, m in enumerate(meta["pk_snap_meta"])]
    return rec


# -- analysis and certificate -------------------------------------------------

def analyze_phase(rec: dict, device="cuda") -> dict:
    """Every check of the JAX package's analyze_phase, with its bars, on
    the record's final state (on `device`) -> the certificate."""
    from .analysis import halo_finder
    from .analysis.power_spectrum import measure_power_spectrum
    from .analysis.theory import mass_function as st_mass_function
    from .core.state import make_state
    from .physics.cosmology import CosmologyParams, growth_factor_exact
    from .raytracing.lensing import convergence_map_from_state

    device = torch.device(device)
    small = rec["small"]
    g = rec["geometry"]
    box, pk_grid = g["box"], g["pk_grid"]
    n, m_p = rec["n"], rec["m_p"]
    a_i, a_f, z_final = rec["a_i"], rec["a_f"], rec["z_final"]
    steps = rec["steps"]
    params = CosmologyParams()
    t_an0 = time.perf_counter()

    pos_f = torch.as_tensor(rec["pos_f"], dtype=torch.float32, device=device)
    vel_f = torch.as_tensor(rec["vel_f"], dtype=torch.float32, device=device)
    masses = torch.as_tensor(rec["masses"], dtype=torch.float32,
                             device=device)

    checks: dict[str, dict] = {}

    def check(name, value, ok, bar):
        checks[name] = {"value": value, "pass": bool(ok), "bar": bar}
        log(f"  check {name}: {value} ({'PASS' if ok else 'FAIL'}; "
            f"bar {bar})")

    def record_only(name, value, bar):
        checks[name] = {"value": value, "pass": None,
                        "bar": bar + " [not asserted: early stop]"}
        log(f"  check {name}: {value} (SKIPPED, early stop; bar {bar})")

    z_target_hit = (a_f >= 0.98 or
                    (z_final > 0 and a_f >= 0.97 / (1.0 + z_final)))
    check("completed_to_target", a_f, z_target_hit,
          f"a_final >= {0.98 if z_final == 0 else 0.97/(1+z_final):.3f}"
          f" (z_final={z_final})")
    check("bucket_overflow", rec["overflow"], rec["overflow"] == 0, "== 0")
    check("dropped_deposits", rec["dropped"], rec["dropped"] == 0, "== 0")
    n_live = int(torch.sum(masses > 0))
    check("particles_conserved", n_live, n_live == n, f"== {n}")

    # early stops (LCDM_SCIENCE_ZFINAL) record the z = 0 science without
    # asserting it: a z = 10 box has no 20-particle halos by physics
    at_z0 = a_f >= 0.98

    def check_z0(name, value, ok, bar):
        if at_z0:
            check(name, value, ok, bar)
        else:
            record_only(name, value, bar)

    # -- P(k) growth ----------------------------------------------------------
    log("[a] P(k) science checks")
    pk_f = measure_power_spectrum(pos_f, box, ng=pk_grid, num_bins=32,
                                  subtract_shot_noise=False)
    k = np.asarray(rec["pk_i"]["k"])
    p_i_arr = np.asarray(rec["pk_i"]["power"])
    p_i_counts = np.asarray(rec["pk_i"]["counts"])
    ratio = pk_f.power.cpu().numpy() / np.maximum(p_i_arr, 1e-30)
    growth = (float(growth_factor_exact(params, a_f))
              / float(growth_factor_exact(params, a_i))) ** 2
    # the z = 0 linear window is only quasi-linear in a 100 Mpc/h box: its
    # bars carry the JAX package's measured envelope; the strict linear
    # bars are the mid-run snapshot's below
    k_lin = 0.15 if not small else 0.25
    bar_max, bar_mean = (0.45, 0.20) if not small else (0.50, 0.30)
    lin = (k > 0) & (k < k_lin) & np.isfinite(ratio)
    rel = ratio[lin] / growth - 1.0
    check("pk_linear_bins", int(lin.sum()), lin.sum() >= 2, ">= 2")
    check("pk_linear_growth_max_dev",
          float(np.max(np.abs(rel))) if lin.any() else float("nan"),
          lin.any() and np.all(np.abs(rel) < bar_max),
          f"< {bar_max} per bin")
    check("pk_linear_growth_mean_dev",
          float(np.mean(rel)) if lin.any() else float("nan"),
          lin.any() and abs(float(np.mean(rel))) < bar_mean,
          f"|mean| < {bar_mean}")
    nl = (k > 0.3) & (k < 0.7) & np.isfinite(ratio)
    nl_ratio = float(np.mean(ratio[nl])) / growth if nl.any() else 0.0
    check_z0("pk_nonlinear_excess", nl_ratio, 1.0 < nl_ratio < 20.0,
             "in (1, 20) x linear")

    # strict linear growth at a mid-run snapshot (a in [0.28, 0.58]), 1M
    # geometry only; runs that never cross the window record it
    if not small:
        mids = [r for r in rec["pk_snapshots"]
                if 0.28 <= r["scale_factor"] <= 0.58]
        crossed_window = a_f >= 0.58
        if mids:
            r_mid = min(mids, key=lambda r: abs(r["scale_factor"] - 0.4))
            a_m = r_mid["scale_factor"]
            g_m = (float(growth_factor_exact(params, a_m))
                   / float(growth_factor_exact(params, a_i))) ** 2
            ratio_m = (np.asarray(r_mid["power"])
                       / np.maximum(p_i_arr, 1e-30))
            lin_m = (k > 0) & (k < k_lin) & np.isfinite(ratio_m)
            rel_m = ratio_m[lin_m] / g_m - 1.0
            check("pk_linear_growth_midz_a", a_m, lin_m.sum() >= 2,
                  "snapshot with >= 2 linear bins")
            check("pk_linear_growth_midz_max_dev",
                  float(np.max(np.abs(rel_m))) if lin_m.any()
                  else float("nan"),
                  lin_m.any() and np.all(np.abs(rel_m) < 0.25),
                  "< 0.25 per bin (strict, linear regime)")
            check("pk_linear_growth_midz_mean_dev",
                  float(np.mean(rel_m)) if lin_m.any() else float("nan"),
                  lin_m.any() and abs(float(np.mean(rel_m))) < 0.10,
                  "|mean| < 0.10 (strict, linear regime)")
        elif crossed_window:
            check("pk_linear_growth_midz_a", None, False,
                  "no snapshot in a in [0.28, 0.58]")
        else:
            record_only("pk_linear_growth_midz_a", None,
                        "run stopped before a=0.58; no mid-z window")
    fin = np.isfinite(ratio) & (k > 0) & (p_i_counts > 0)
    pk_table = {"k": [round(float(x), 5) for x in k[fin]],
                "ratio_over_growth": [round(float(x), 5)
                                      for x in (ratio[fin] / growth)]}

    # -- HMF against Sheth-Tormen at z = 0 ------------------------------------
    log("[b] FoF/SO catalogue + HMF against Sheth-Tormen at z=0")
    t0 = time.perf_counter()
    t_fof = 0.0
    hmf = {}
    fof = {}
    try:
        b_link = 0.2 * box / n ** (1.0 / 3.0)
        plan = halo_finder.fof_plan(n, float(box), float(b_link),
                                    positions=pos_f, live=masses > 0)
        cat = halo_finder.find_halos(pos_f, vel_f, masses, box,
                                     min_particles=20, plan=plan)
        n_h = int(cat.num_halos)
        sizes = np.sort(cat.n_particles.cpu().numpy()[:n_h])[::-1]
        t_fof = time.perf_counter() - t0
        fof = {"ncell": int(plan["ncell"]),
               "capacity": int(plan["capacity"]),
               "overflow": int(halo_finder.last_fof["overflow"]),
               "rounds": int(halo_finder.last_fof["rounds"])}
        log(f"  {n_h} halos >= 20 particles in {t_fof:.1f} s (catalogue "
            f"capacity {int(cat.mass.shape[0])}; FoF plan {fof})")
        check("catalog_not_truncated", int(cat.mass.shape[0]),
              n_h < int(cat.mass.shape[0]), "num_halos < capacity")
        check_z0("num_halos", n_h, n_h >= (10 if small else 500),
                 ">= 500 at 1M (>= 10 small)")
        biggest = int(sizes[0]) if n_h else 0
        check_z0("no_percolation", biggest, 0 < biggest < 0.2 * n,
                 "largest halo < 20% of box")

        z_f = max(1.0 / a_f - 1.0, 0.0)
        h_masses = sizes.astype(np.float64) * m_p
        m_lo = 32.0 * m_p
        m_hi = float(h_masses[0]) * (1 + 1e-5) if n_h else m_lo * 10
        nbins_h = 8
        edges = np.logspace(np.log10(m_lo), np.log10(m_hi), nbins_h + 1)
        counts, _ = np.histogram(h_masses, bins=edges)
        centers = np.sqrt(edges[:-1] * edges[1:])
        dlog10 = np.log10(edges[1] / edges[0])
        measured = counts / (box ** 3 * dlog10)
        theory = st_mass_function(
            params, torch.as_tensor(centers, dtype=torch.float32),
            z=z_f).numpy() * math.log(10.0)
        ok_bins = counts >= 8
        if ok_bins.sum() >= 2:
            r = measured[ok_bins] / theory[ok_bins]
            sigma = 1.0 / np.sqrt(counts[ok_bins])
            lo_b = 1.0 / 2.5 / (1.0 + 3.0 * sigma)
            hi_b = 2.5 * (1.0 + 3.0 * sigma)
            per_bin_ok = bool(np.all((r > lo_b) & (r < hi_b)))
            gmean = float(np.exp(np.mean(np.log(r))))
            hmf = {"bins": centers[ok_bins].tolist(),
                   "counts": counts[ok_bins].tolist(),
                   "ratio_vs_st": r.tolist()}
            check_z0("hmf_per_bin_vs_st",
                     [round(x, 3) for x in r.tolist()],
                     per_bin_ok, "factor 2.5 + 3 sigma Poisson per bin")
            check_z0("hmf_band_gmean_vs_st", gmean,
                     1 / 1.7 < gmean < 1.7,
                     "geometric mean in (1/1.7, 1.7)")
        else:
            check_z0("hmf_per_bin_vs_st", counts.tolist(), False,
                     ">= 2 bins with >= 8 halos")
    except Exception as exc:  # noqa: BLE001 -- record, don't lose the cert
        log(f"  FoF/HMF stage failed: {exc!r}")
        check("fof_stage_ok", repr(exc)[:300], False, "no exception")

    # -- Layzer-Irvine --------------------------------------------------------
    li_bar = 0.05
    li_worst = rec["li_worst"]
    check("layzer_irvine_worst_residual", li_worst, li_worst < li_bar,
          f"< {li_bar} of |U| (pairwise U vs TreePM force: PM split + "
          f"min-image-vs-Ewald systematics)")

    # -- lensing --------------------------------------------------------------
    log("[c] Born convergence map from the final state")
    try:
        state_f = make_state(pos_f, vel_f, masses, scale_factor=a_f)
        kap = convergence_map_from_state(
            state_f, params, box, ng=256 if not small else 96,
            n_planes=16 if not small else 8, z_source=1.0).cpu().numpy()
        krms = float(np.std(kap))
        check("lensing_map_finite", krms,
              np.all(np.isfinite(kap)) and 1e-4 < krms < 1.0,
              "finite, rms in (1e-4, 1)")
    except Exception as exc:  # noqa: BLE001 -- record, don't lose the cert
        log(f"  lensing stage failed: {exc!r}")
        check("lensing_stage_ok", repr(exc)[:300], False, "no exception")

    t_analysis = time.perf_counter() - t_an0
    wall = rec["t_ic"] + rec["t_evolve"] + t_analysis
    passed = all(c["pass"] for c in checks.values()
                 if c["pass"] is not None)
    return {
        "kind": "lambda_cdm_tpu_torch science certificate",
        "passed": passed,
        "config": {"n_particles": n, "box_Mpc_h": box,
                   "pm_grid": g["pm_grid"], "softening": g["softening"],
                   "z_init": Z_INIT, "solver": "treepm_fast",
                   "kick_mode": "comoving", "small": small,
                   "z_final_override": z_final if z_final > 0 else None},
        "platform": rec["platform"],
        "device_kind": rec.get("device_kind"),
        "analysis_device": device.type,
        "steps": steps,
        "wall_clock_s": round(wall, 1),
        "evolve_s": round(rec["t_evolve"], 1),
        "ic_s": round(rec["t_ic"], 1),
        "analysis_s": round(t_analysis, 1),
        "fof_s": round(t_fof, 1),
        "fof": fof,
        "li_wall_s": rec.get("li_wall_s", 0.0),
        "ms_per_step_incl_analysis": round(1e3 * rec["t_evolve"]
                                           / max(steps, 1), 2),
        "a_final": a_f,
        "growth_factor_sq": growth,
        "pk_snapshots": len(rec["pk_snapshots"]),
        "pk_table": pk_table,
        "hmf": hmf,
        "engine_stats": rec.get("engine_stats", {}),
        "step_breakdown": rec.get("breakdown", {}),
        "layzer_irvine_samples": rec["li_samples"],
        "checks": checks,
        "measured_at": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }


def summary(cert: dict) -> dict:
    """The one-line result: passed, steps, wall, failed and skipped checks."""
    return {"passed": cert["passed"], "steps": cert["steps"],
            "wall_clock_s": cert["wall_clock_s"],
            "checks_failed": [k for k, v in cert["checks"].items()
                              if v["pass"] is False],
            "checks_skipped": [k for k, v in cert["checks"].items()
                               if v["pass"] is None]}


def main(argv=None) -> int:
    from .utils.precision import disable_tf32
    disable_tf32()
    ap = argparse.ArgumentParser(
        prog="python -m lambda_cdm_tpu_torch.science_run",
        description="The 1M-particle science run (z=24 -> 0) and its "
                    "checks.")
    ap.add_argument("--small", action="store_true",
                    help="the 40^3 geometry (any device)")
    ap.add_argument("--analyze-only", nargs="?", const="", default=None,
                    metavar="RECORD",
                    help="re-analyse a record (default: the one in --out)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out",
                    help="directory of the certificate and the record")
    args = ap.parse_args(argv)
    suffix = "_small" if args.small else ""
    out_path = os.path.join(args.out, f"SCIENCE{suffix}.json")
    record_path = os.path.join(args.out, f"science_record{suffix}.npz")
    if args.analyze_only is not None:
        import logging
        logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                            format="%(asctime)s %(levelname)s %(name)s: "
                                   "%(message)s")
        record_path = args.analyze_only or record_path
        log(f"analyze-only: loading {record_path}")
        rec = load_record(record_path)
    else:
        rec = evolve_phase(args.small, record_path, args.device)
    cert = analyze_phase(rec, args.device)
    os.makedirs(args.out, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(cert, f, indent=1)
    log(f"wrote {out_path}")
    print(json.dumps(summary(cert)))
    return 0 if cert["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
