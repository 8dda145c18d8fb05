#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (it imports
lambda_cdm_tpu_torch from the directory this script sits in). Phases, each
fatal on failure and each printing its seconds:

  1. build the CUDA kernels from lambda_cdm_tpu_torch/csrc (one nvcc per
     source, all started together, sm_90a) into lambda_cdm_tpu_torch/_build/;
  2. kernel phase: at the shapes of the examples/configs/treepm_1m.json
     plan (1M particles, 192^3 mesh, 32^3 cells of capacity 64), run K1
     (CIC deposit), K2 (fd4 gather) and K3 (short-range pairs) and their
     plain PyTorch versions on the same inputs, hold each kernel against
     its plain version and time both with CUDA events (K1 and K2 also as
     CUDA graphs of calls: device time without the wrappers' host work);
     K3 again on a clustered state whose largest cell holds several
     thousand particles (half the sampled rows from it), and K1 and K2
     there too; K3's plan of units built on the card against its plain
     version on both states;
  3. stepper path: reset the launch counters, build the engine from
     treepm_1m.json through SimulationBuilder (2LPT ICs from the JAX
     package's key for the config's seed, utils/prng) and run 32 steps; K1-K3 must have launched,
     positions must be finite and the live mass must equal N * m; a
     LensingObserver fires at step 32;
  4. lensing phase, on paths each driven with the launch counts reset
     just before and read just after: bench.py's lensing geometry (16
     planes, 65,536 rays, 256^2 with the Jacobian off and on, 512^2)
     through lens_plane_fields and trace_rays with auto_sample_window's
     window, rays/s, one launch of the trace kernel a trace and the
     trace's device launches a plane (torch.profiler, at most 3);
     bench.py's accuracy geometry, the card's windowed trace against the
     CPU trace at 1e-3, and a planted half-cell fault (the impact
     positions moved in x inside the trace kernel) that must fail that
     check;
     tests/test_lensing_limber.py's traced C_ell against Limber at its
     bars; raytraced_maps_from_state on the 1M state after the stepper
     path and on a uniform 4096-particle box (weak-field checks), the E/B
     null test on the 1M state's Born map's shear,
     and the LensingObserver's time; then K6 and K7 against their plain
     version at path 2's shapes, a ragged R with edge points and an
     unwrapped bundle, one device launch a call, timed as CUDA graphs
     beside grid_sample; and the trace kernel on both routes (wrapped
     impact positions, K6's; unwrapped, K7's) against its plain version
     run on the card (trace_planes_plain) at path 2's geometries, timed
     as CUDA graphs;
  5. K5 phase: a 1M-particle clustered box (clumps, two periodic chains,
     uniform rest): fof_plan on the card, one FoF hook sweep of K5 against
     its plain version on sampled rows (exactly equal labels), fof_labels
     on a 131,072-particle subset against a scipy cKDTree + connected-
     components oracle (exactly equal labels), fof_labels and find_halos
     at 1M (converged before max_rounds), find_halos's split (plan,
     _fof_setup, the rounds with K5's share of them, the overflow
     adoption, the catalogue; a synchronise after each part; its labels
     and rounds equal to fof_labels'), and K5's first sweep on each cell
     level fof_plan weighs, in the plan's order;
  6. CLI phase: treepm_1m.json as shipped through the CLI's
     _build_engine -> initialize -> run for 40 steps with every observer
     the config asks for (P(k) every 20 steps, FoF halos, snapshot and
     checkpoint at 40, energy conservation on); K1-K5 and K9 must have
     launched, K5 through the halo-finder observer, K9 once for each
     compute_energy, each call under 10 s; then `resume` from the
     checkpoint and `analyze` of the snapshot through cli.main;
  7. reference check: a small run with every observer on (energy too) on
     the card against the same run on the CPU (the kernels' plain
     versions) from one initial state;
  8. K9 phase: pair_potential (the potential energy's pair sum) against
     its plain version at 131,072 particles, on a 32^3 lattice whose
     middle layer sits one ulp past half a box and on coincident particles
     at softening 0, two calls equal bit for bit, timed; K9 alone on 1M
     uniform particles; the bound counts the
     n(n-1)/2 unordered pairs the sum needs;
  9. K4 phase: 100,000 particles uniform in a 100 Mpc/h box (unit
     masses, softening 0.05: the JAX package's bench.py direct figure);
     K4s's path first (sym and sym2 through pairwise_accelerations, the
     counts reset just before: its launches in the kernels line), then K4
     (v1, v2) and K4s (sym, sym2) against their plain versions, two
     calls equal bit for bit, and timed; K4 also at two and three ragged
     tiles and without the minimum image; K4s at n = 1, 2, 31, 33, 255,
     257 with zero-mass rows, with a tile's k cut into runs, on the
     half-box lattice and on positions over three boxes; the image's
     range flag clear;
 10. direct_10k phase: examples/configs/direct_10k.json at full size
     (10,648 particles, direct solver) through the CLI's engine for its
     500 steps with its energy and momentum observers; K4 must have
     launched once at the start, once a step and twice for the
     force-fraction timing; then validate_force_accuracy on the final
     state, and K4 against its plain version there (the kernels line's
     K4 numbers), two calls equal;
 11. stateless pm/treepm phase (plain PyTorch, no TPU kernel on their
     path): pm_128_256.json (2,097,152 particles, 256^3) and
     basic_lambda_cdm.json (262,144 particles, treepm on 128^3) at full
     size for 10 steps each, with validate_force_accuracy;
 12. stateless reference check: a 4096-particle direct run of 8 steps on
     the card (K4) against the CPU (the solver's row-blocked sum) from
     three seeds' 2LPT states in chunks of one step (the rows of a pair
     whose minimum image differs between the two runs at some step, a
     pair about half a box apart, left out: at most 8, and only pairs
     that K4's plain arithmetic on the CPU flips as well), the card's
     chunks of 4 fused steps bit for bit its chunks of one, the same card
     run with two planted K4 faults (which the check must see, under the
     same cap), and pm and treepm accelerations of one state on both.

Then the fast stepper's other options:

 13. row-7 kernel phase: K3 in the vpu, vpu2 and mxu split forms on the
     live-first counts of the main-path state of phase 2, each against
     its plain version on sampled rows (2e-5: under the 3.7e-5 between two
     split forms), without counts (equal bit for bit) and on a shuffled
     (not live-first) copy of the buckets, vpu2 against vpu3 and vpu
     against mxu on live slots, timed with CUDA events;
 14. row-7 path: fast_run from that state for 16 steps (a rebucket after
     8) in each of vpu3, vpu, vpu2 and mxu: launches, finite positions,
     conserved mass, no overflow or drops, positions against vpu3's;
 18. rebucket forms (run after phase 14, on its state): the treepm_1m
     particles moved 0.2 cell rms, bucketed at capacity 64, 128, 256 and
     512 (the capacities grow-and-retry gives), the gather and compact
     forms of the rebucket timed on each layout, their states equal;
 15. row-13 phase: benchmarks/bench_short_range_rd.py's geometry (1M
     particles uniform in 100 Mpc/h from numpy, ncell 24, rs 1.25 x
     100/192, window 4.5 rs, softening 0.01, k_rod 3072): rd_pack and
     rd_window_tables on the card, then K8 (short_range_rd: its plan,
     against rd_plan_plain, and its pair kernel) against its plain version
     on sampled rows, two calls equal byte for byte, K8 and K3 vpu3 (cell
     buckets of capacity 128) against the exact-erfc sum over all N at
     256 particles, and the times;
 16. pm_fast phase: pm_128_256.json with --forces.type=pm_fast through the
     CLI's engine for 10 steps, beside the stateless pm run of phase 11:
     validate_force_accuracy, pm_fast's own force against the oracle at
     1.25x the pm run's errors, and pm_fast's force against the stateless
     pm force on a clustered box of the same geometry, where a planted
     fault (split_scale = rs) must fail;
 17. gradient phase: treepm_1m.json with forces.gradient = spectral and
     interp for 8 steps each, and each against the CPU on one small state.

Then this slice's paths:

 19. K10 phase: the alias probe's entry point (python -m
     lambda_cdm_tpu_torch.ops.alias_probe, both modes), then the sequential
     mode against its plain version (1..8 in column 0; and bit for bit
     from a random buffer) and the blocks mode's column 0 as the card
     gives it, timed as a CUDA graph beside an empty kernel's launch at
     each mode's shape (the floor) and one that reads and writes a float a
     thread;
 20. science phase: python -m lambda_cdm_tpu_torch.science_run's main at
     the 1M geometry (100^3 particles, 100 Mpc/h, 192^3 PM, buckets of
     capacity 8192 on 16^3 cells) from z = 24 to z = 0: 2LPT ICs, the
     treepm_fast run with adaptive dt, P(k) at every chunk, the
     Layzer-Irvine ledger through K9, K3 timed on the initial buckets
     (z = 24) and the final-state step breakdown, the FoF/SO catalogue
     with the HMF against Sheth-Tormen and the Born map;
     K1-K3, K5 and K9 must have launched, overflow and drops 0, every
     check of its certificate must pass; then --analyze-only on the
     record (certificate and record in chiprun_out/chip_smoke_science/),
     find_halos's split on the run's final state (as in phase 5) and
     its labels against the cKDTree oracle's on the same particles (the
     groups of 20-31 and 32-63 particles beside the oracle's), K9
     against its plain version on the run's final 1M state (the
     kernels line's K9 numbers), and K3 against its plain version on that
     state bucketed by the run's plan (half the sampled rows from the
     fullest cell), with its plan against the plain one, and K1 and K2
     against theirs on the same buckets, timed there. The ICs come from
     PRNGKey(2026), the JAX run's key: the run prints its low-k
     pk_table.ratio_over_growth, steps, HMF geometric mean and
     Layzer-Irvine worst beside SCIENCE.json's (the TPU run).

Then, before phase 20, the paths of the JAX package's random streams and
tools:

 21. prng phase: treepm_10m.json's IC noise (216^3 normals) and 1M x 3
     uniforms drawn with utils/prng on the card, bit for bit the CPU's,
     the noise draw timed;
 22. accuracy phase: bench.py's accuracy geometry (2LPT at a = 0.35 from
     PRNGKey(7), 1M, pm_grid 192, softening 0.05, capacity pre-sized, 512
     targets from default_rng(0)): the treepm_fast forces (K1-K3) against
     the float64 Ewald oracle on the card (RMS bar 5e-3, overflow and
     drops 0) and min-image against Ewald, beside the TPU's readings;
 23. merger phase: that snapshot evolved 24 steps through the engine,
     find_halos (K5) at three chunk ends, the MergerForest over them, and
     match_halos on the card against numpy's bincount;
 24. trace phase: treepm_1m.json (8 steps) and direct_10k.json (50 steps)
     under profiling.trace_dir (torch.profiler), read back by
     trace_summary: the device-busy share and the top 5 kernels, with the
     untraced ms/step beside the traced;
 25. warmup/aot phase: SimulationEngine.warmup on a fresh treepm_1m.json
     engine (programs, seconds, state untouched, the first chunk after
     it), a fresh process that compiles nothing, and CompiledForceEngine
     at profiles (16,384, 131,072): its CUDA graphs' replays, into
     outputs filled with NaN first, against K4 on the padded inputs and
     after a save/load round trip, bit for bit.

The CLI phase also validates the treepm_1m state's forces through the
stateless treepm solver.

Prints the card, the errors and times, one JSON line of kernel records,
the `nvidia-smi` name and power limit, and last one JSON status line.
Exits nonzero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "examples", "configs", "treepm_1m.json")
N_STEPS = 32

# kernel-vs-plain tolerances, relative to the largest magnitude of the
# plain result (float32 sums taken in another order: the deposit's global
# adds land in an order that changes from run to run, a dense tile's part
# summed exactly in its window and rounded once; the gather's per-corner
# differences; the pair sums' order)
TOL = {"cic_deposit": 1e-5, "fd4_gather": 1e-4, "short_range": 1e-4}

# H100 SXM peaks (NVIDIA's data sheet, at 700 W): float32 outside the
# tensor cores, and HBM bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float operations per unit of work, counted from each kernel's source (an
# FMA counts 2): per live particle for K1 and K2, per pair test for K3
# (rsqrt as 1) and K5
FLOPS = {"cic_deposit": 47, "fd4_gather": 175, "short_range": 44,
         "fof_hook": 8,
         # K3's other split forms: the x-space Horner costs what the even
         # one does, the factored form one more degree and its (1 - t)
         # factor; K8 is the even split
         "short_range_vpu": 44, "short_range_vpu2": 48,
         "short_range_mxu": 44, "short_range_rd": 44}

# K4/K4s against their plain versions (relative to the plain result's
# largest |a|): every variant holds the JAX package's bar for its kernel
DIRECT_TOL = {"v1": 1e-5, "sym": 1e-5, "v2": 1e-5, "sym2": 1e-5}
# float operations per pair, as the JAX package's cost estimates count
# them (pallas_direct.py:380-384, :442-446): 22 per ordered pair for K4,
# 26 per unordered pair for K4s
DIRECT_FLOPS = {"direct": 22, "direct_sym": 26}
DIRECT_CONFIG = os.path.join(ROOT, "examples", "configs", "direct_10k.json")
PM_CONFIG = os.path.join(ROOT, "examples", "configs", "pm_128_256.json")
TREEPM_CONFIG = os.path.join(ROOT, "examples", "configs",
                             "basic_lambda_cdm.json")

# the CLI phase: treepm_1m.json cut to 40 steps, every observer at a
# cadence that fires inside them (energy on, as the file ships it: K9)
CLI_OVERRIDES = ["--time.max_steps=40",
                 "--io.analysis.power_spectrum.frequency=20",
                 "--io.analysis.halo_finder.frequency=40",
                 "--io.snapshots.frequency=40",
                 "--simulation.checkpoint_frequency=40"]
# the most a compute_energy call may take at 1M on the card (K9)
CLI_ENERGY_MAX_S = 10.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call of fn(): the package's timer
    (lambda_cdm_tpu_torch.ops.cuda_build.cuda_ms)."""
    from lambda_cdm_tpu_torch.ops.cuda_build import cuda_ms as timer
    return timer(fn, reps, warmup)


def rel_err(got, ref, mask=None) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|) over `mask`."""
    import torch
    diff = (got - ref).abs()
    if mask is not None:
        diff = torch.where(mask, diff, 0.0)
        ref = torch.where(mask, ref, 0.0)
    err = float(diff.max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def check(name: str, ok: bool, what: str, failures=None) -> None:
    """Raise on a failed check, or record it in `failures` (a phase that
    reports every kernel before it fails)."""
    if ok:
        return
    if failures is None:
        raise AssertionError(f"{name}: {what}")
    failures.append(f"{name}: {what}")


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the float32 peak."""
    t_bytes = 1e3 * n_bytes / PEAK_BYTES
    t_ops = 1e3 * n_flops / PEAK_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def stencil_pairs(counts, ncell: int) -> float:
    """Pair tests of a 27-cell stencil sweep over live slots: sum over
    cells of n_c times the live slots of its 27 periodic neighbours."""
    import torch
    from lambda_cdm_tpu_torch.ops.short_range import neighbour_load
    return float((counts.to(torch.float64)
                  * neighbour_load(counts, ncell)).sum())


def _counted():
    from lambda_cdm_tpu_torch.ops import alias_probe, direct, fof_hook, \
        lens_sample, pm_rods, short_range, short_range_rd
    return (pm_rods, short_range, fof_hook, direct, lens_sample,
            short_range_rd, alias_probe)


def reset_counts() -> None:
    for mod in _counted():
        mod.reset_launch_counts()


def read_counts() -> dict:
    out = {}
    for mod in _counted():
        out.update(mod.launches)
    return out


def timed(name: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{name}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


def main_path_state(cfg, device):
    """The IC state and plan of the main path (initialize_fast on the
    port's generate_state), for the kernel phase."""
    from lambda_cdm_tpu_torch.core.engine import SimulationEngine
    eng = SimulationEngine(cfg, device=device)
    eng.initialize()
    return eng._fstate, dict(eng._fast_kw)


def drifted(fs, kw, frac: float, seed: int):
    """A copy of fs.bpos with `frac` of the live slots pushed 2.5 PM cells
    along x (unwrapped): some leave their block window and are dropped."""
    import torch
    gen = torch.Generator(device=fs.bpos.device).manual_seed(seed)
    live = fs.bmass > 0
    push = (torch.rand(live.shape, generator=gen, device=live.device) < frac)
    bpos = fs.bpos.clone()
    bpos[0] += torch.where(live & push, 2.5 * kw["box_size"] / kw["ng"], 0.0)
    return bpos


def kernel_phase(fs, kw, device, card):
    """Each kernel against its plain version at the main-path shapes."""
    import torch
    from lambda_cdm_tpu_torch.ops import bucketed_pm, pm_rods, short_range
    ncell, cap, ng = kw["ncell"], kw["capacity"], kw["ng"]
    box, margin = kw["box_size"], kw["margin"]
    geo = dict(ncell=ncell, ng=ng, box_size=box, margin=margin)
    counts = bucketed_pm.live_counts(fs.bmass)
    bpos = drifted(fs, kw, 0.01, seed=1)
    live = (torch.arange(cap, device=device)[None] < counts[:, None])
    n_live = float(counts.sum())
    cells = float(ncell ** 3)
    # bytes each kernel must move: live slots read once (positions 12 B,
    # mass 4 B), counts, the mesh read or written once, outputs of live
    # slots written once
    need = {"cic_deposit": (16 * n_live + 4 * cells + 4 * ng ** 3,
                            FLOPS["cic_deposit"] * n_live),
            "fd4_gather": (4 * ng ** 3 + 24 * n_live + 4 * cells,
                           FLOPS["fd4_gather"] * n_live),
            "short_range": (28 * n_live + 4 * cells,
                            FLOPS["short_range"]
                            * stencil_pairs(counts, ncell))}
    rec = {}
    failures = []

    # K1: deposit
    grid_k, drop_k = pm_rods.cic_deposit(bpos, fs.bmass, counts, **geo)
    grid_p, drop_p = pm_rods.cic_deposit_plain(bpos, fs.bmass, counts, **geo)
    err, rel = rel_err(grid_k, grid_p)
    print(f"K1 cic_deposit: max_abs_err {err:.3e} (rel {rel:.3e}, tol "
          f"{TOL['cic_deposit']:g}); dropped kernel {int(drop_k)} plain "
          f"{int(drop_p)}")
    check("K1", rel <= TOL["cic_deposit"], f"rel err {rel} > tol", failures)
    check("K1", int(drop_k) == int(drop_p) > 0, "drop counts differ or 0",
          failures)
    # K1 and K2: eager wrapper calls (the stepper's cost, host work
    # included: the kernels line's ms) and their device time alone, from
    # a CUDA graph of calls
    graph = {}
    ms = cuda_ms(lambda: pm_rods.cic_deposit(bpos, fs.bmass, counts, **geo),
                 20)
    graph["cic_deposit"] = graph_ms(lambda: pm_rods.cic_deposit(
        bpos, fs.bmass, counts, **geo), 20)
    pms = cuda_ms(lambda: pm_rods.cic_deposit_plain(bpos, fs.bmass, counts,
                                                    **geo), 5)
    rec["cic_deposit"] = (err, rel, ms, pms) + bound(*need["cic_deposit"])

    # K2: gather from the potential of that deposit
    green = bucketed_pm._greens(ng, float(box), float(kw["rs"]), str(device))
    rho_k = torch.fft.rfftn(grid_p / (box / ng) ** 3)
    phi = torch.fft.irfftn(green * rho_k, s=(ng, ng, ng)).contiguous()
    acc_k = pm_rods.fd4_gather(phi, bpos, counts, **geo)
    acc_p = pm_rods.fd4_gather_plain(phi, bpos, counts, **geo)
    err, rel = rel_err(acc_k, acc_p, live[None])
    dead_max = float(torch.where(live[None], 0.0, acc_k).abs().max())
    print(f"K2 fd4_gather: max_abs_err {err:.3e} on live slots (rel "
          f"{rel:.3e}, tol {TOL['fd4_gather']:g}); dead-slot max "
          f"{dead_max:g}")
    check("K2", rel <= TOL["fd4_gather"], f"rel err {rel} > tol", failures)
    check("K2", dead_max == 0.0, "dead slots not zero", failures)
    ms = cuda_ms(lambda: pm_rods.fd4_gather(phi, bpos, counts, **geo), 20)
    graph["fd4_gather"] = graph_ms(lambda: pm_rods.fd4_gather(
        phi, bpos, counts, **geo), 20)
    pms = cuda_ms(lambda: pm_rods.fd4_gather_plain(phi, bpos, counts, **geo),
                  5)
    rec["fd4_gather"] = (err, rel, ms, pms) + bound(*need["fd4_gather"])

    # K3: pairs, on 4096 sampled live rows of the main-path state
    sr = dict(ncell=ncell, capacity=cap, box_size=box, rs=kw["rs"],
              softening=kw["softening"])
    err, rel, rows = k3_compare(fs.bpos, fs.bmass, counts, sr, 4096, seed=2)
    print(f"K3 short_range (main-path state, {rows} rows): max_abs_err "
          f"{err:.3e} (rel {rel:.3e}, tol {TOL['short_range']:g})")
    check("K3", rel <= TOL["short_range"], f"rel err {rel} > tol", failures)
    plan_check(counts, ncell, "main-path state")
    ms = cuda_ms(lambda: short_range.short_range(fs.bpos, fs.bmass, counts,
                                                 **sr), 20)
    pms = cuda_ms(lambda: short_range.short_range_plain(
        fs.bpos, fs.bmass, counts, **sr), 1)
    rec["short_range"] = (err, rel, ms, pms) + bound(*need["short_range"])

    # K3 again on a clustered state: several thousand particles in a cell
    cbpos, cbmass, ccounts, ccap = clustered_state(kw, device)
    csr = dict(sr, capacity=ccap)
    cerr, crel, rows = k3_compare(cbpos, cbmass, ccounts, csr, 4096, seed=3,
                                  heavy=True)
    cms = cuda_ms(lambda: short_range.short_range(cbpos, cbmass, ccounts,
                                                  **csr), 3)
    print(f"K3 short_range (clustered: capacity {ccap}, largest cell "
          f"{int(ccounts.max())}, {rows} rows): max_abs_err {cerr:.3e} "
          f"(rel {crel:.3e}, tol {TOL['short_range']:g}); kernel "
          f"{cms:.3f} ms on {card}")
    check("K3 clustered", crel <= TOL["short_range"],
          f"rel err {crel} > tol", failures)
    plan_check(ccounts, ncell, "clustered state")
    pm_kernel_check(cbpos, cbmass, ccounts, kw, device, card,
                    "clustered state")
    for name, (e, r, k_ms, p_ms, b_ms, b_by) in rec.items():
        dev_ms = (f" (device time {graph[name]:.4f} ms as a CUDA graph)"
                  if name in graph else "")
        print(f"{name}: kernel {k_ms:.4f} ms{dev_ms}, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}) at the 1M/192^3 plan (ncell "
              f"{ncell}, capacity {cap}) on {card}")
    if failures:
        raise AssertionError("kernel phase: " + "; ".join(failures))
    return rec


def sample_rows(counts, cap: int, n_rows: int, seed: int, heavy=False):
    """n_rows random flat slot indices of live rows (with heavy=True half
    of them from the fullest cell)."""
    import torch
    dev = counts.device
    live_rows = torch.nonzero((torch.arange(cap, device=dev)[None]
                               < counts[:, None]).reshape(-1))[:, 0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    pick = torch.randint(0, live_rows.numel(), (n_rows,), generator=gen,
                         device=dev)
    rows = live_rows[pick]
    if heavy:
        top = int(torch.argmax(counts))
        k = min(n_rows // 2, int(counts[top]))
        rows = torch.cat([rows[:n_rows - k],
                          top * cap + torch.arange(k, device=dev)])
    return rows


def k3_compare(bpos, bmass, counts, sr, n_rows, seed, heavy=False):
    """K3's full output against the plain rows= form on sampled live rows
    (with heavy=True half of them from the fullest cell)."""
    from lambda_cdm_tpu_torch.ops import short_range
    out = short_range.short_range(bpos, bmass, counts, **sr)
    rows = sample_rows(counts, sr["capacity"], n_rows, seed, heavy)
    ref = short_range.short_range_plain(bpos, bmass, counts, rows=rows, **sr)
    got = out.reshape(3, -1)[:, rows]
    err, rel = rel_err(got, ref)
    return err, rel, rows.numel()


def plan_check(counts, ncell: int, label: str) -> None:
    """K3's plan built on the card against its plain version (header,
    classes, the order of the non-empty cells and their first units equal),
    with the unit sizes it gives."""
    import torch
    from lambda_cdm_tpu_torch.ops import short_range
    plan = short_range.unit_plan(counts, ncell).cpu()
    ref = short_range.unit_plan_plain(counts.cpu(), ncell)
    n_live, base = int(ref[1]), short_range.PLAN_HEADER + ncell ** 3
    same = all(torch.equal(plan[lo:hi], ref[lo:hi]) for lo, hi in (
        (0, base + n_live), (base + ncell ** 3, base + ncell ** 3 + n_live)))
    units = short_range.plan_units(plan, counts, ncell)
    print(f"K3 plan ({label}): {int(plan[2])} units of at most "
          f"{int(units[:, 2].max())} rows over {n_live} non-empty cells "
          f"(fullest {int(counts.max())} rows); card plan equal to plain "
          f"{same}")
    check(f"K3 plan ({label})", same and int(units[:, 2].max())
          <= short_range.UNIT_ROWS, "card plan differs from plain")


def clustered_state(kw, device, n=1_000_000, n_clump=10_000):
    """n particles on the main-path cell grid, n_clump of them in a
    Gaussian clump of 1 Mpc/h and the rest uniform; capacity the next
    power of two above the fullest cell (as grow-and-retry would reach)."""
    import torch
    from lambda_cdm_tpu_torch.ops.bucketed_pm import live_counts
    from lambda_cdm_tpu_torch.ops.fast_treepm import build_fast_state
    box, ncell = kw["box_size"], kw["ncell"]
    gen = torch.Generator(device=device).manual_seed(4)
    pos = torch.rand((n, 3), generator=gen, device=device) * box
    centre = (ncell // 2 + 0.5) * box / ncell
    pos[:n_clump] = centre + torch.randn((n_clump, 3), generator=gen,
                                         device=device)
    pos = torch.remainder(pos, box)
    mass = torch.ones(n, device=device)
    cid = torch.clamp((pos / box * ncell).long(), 0, ncell - 1)
    occ = torch.bincount((cid[:, 0] * ncell + cid[:, 1]) * ncell + cid[:, 2],
                         minlength=ncell ** 3)
    cap = 1 << int(occ.max() - 1).bit_length()
    plan = {"ncell": ncell, "capacity": cap, "margin": kw["margin"],
            "rs": kw["rs"]}
    fs = build_fast_state(pos, torch.zeros_like(pos), mass, 0.5,
                          box_size=box, plan=plan)
    check("clustered", int(fs.overflow) == 0, "clustered state overflowed")
    return fs.bpos, fs.bmass, live_counts(fs.bmass), cap


def main_path(cfg, device, card):
    """The user's path: SimulationBuilder -> build -> run(32 steps), with a
    LensingObserver (the JAX package's defaults) that fires at step 32.
    Returns (launches, the engine)."""
    import torch
    from lambda_cdm_tpu_torch import LensingObserver, SimulationBuilder
    reset_counts()
    t0 = time.perf_counter()
    eng = SimulationBuilder(device=device).with_config(cfg).with_observer(
        LensingObserver(frequency=N_STEPS)).build()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    eng.run(num_steps=N_STEPS)
    torch.cuda.synchronize()
    launches = read_counts()

    st = eng.state
    stats = eng.statistics
    n = st.num_particles
    ms_step = 1e3 * stats.compute_time_s / max(stats.total_steps, 1)
    rate = n * stats.total_steps / max(stats.compute_time_s, 1e-9)
    print(f"main path: N={n} box={cfg.particles.box_size} "
          f"ng={eng._fast_kw['ng']} ncell={eng._fast_kw['ncell']} "
          f"capacity={eng._fast_kw['capacity']}; init {t_init:.2f} s; "
          f"{stats.total_steps} steps: {ms_step:.2f} ms/step, "
          f"{rate:.4e} particle-updates/s on {card}")
    print(f"main path: a {float(st.scale_factor):.6f} step "
          f"{int(st.step)} overflow {int(eng._fstate.overflow)} dropped "
          f"{int(eng._fstate.dropped)}; launches {json.dumps(launches)}")
    check("main path", stats.total_steps == N_STEPS, "steps not taken")
    check("main path", all(launches[k] > 0 for k in
                            ("cic_deposit", "fd4_gather", "short_range")),
          "a kernel of the path was not launched")
    check("main path", bool(torch.all(torch.isfinite(st.positions))),
          "non-finite positions")
    check("main path", tuple(st.positions.shape) == (n, 3), "shape")
    m0 = float(st.masses.max())
    live_n = int(torch.sum(st.masses == m0))
    total = float(st.masses.double().sum())
    check("main path", live_n == n and abs(total - n * m0) <= 1e-6 * n * m0,
          f"mass not conserved: {live_n} live of {n}, total {total}")
    return launches, eng


def fof_state(n: int, seed: int, box: float = 100.0, n_clumps: int = 1000,
              clumped: int = 300_000, step: float = 0.18):
    """A clustered box for FoF, made with numpy from `seed`: about
    `clumped` particles in `n_clumps` Gaussian clumps (sizes drawn from
    dn/ds ~ s^-1.5 on [20, 5000] and rescaled to the total; radii 0.05-0.5
    Mpc/h), two periodic chains of spacing `step` along x and along y,
    and the rest uniform; rows shuffled. -> (positions [n, 3] float32,
    chain mask [n])."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = 20 ** -0.5, 5000 ** -0.5
    sizes = (lo - rng.uniform(size=n_clumps) * (lo - hi)) ** -2
    sizes = np.clip(np.round(sizes * clumped / sizes.sum()), 20,
                    5000).astype(np.int64)
    centres = rng.uniform(0, box, (n_clumps, 3))
    radii = rng.uniform(0.05, 0.5, n_clumps)
    clumps = np.repeat(centres, sizes, 0) + np.repeat(
        radii, sizes)[:, None] * rng.standard_normal((sizes.sum(), 3))
    npts = int(box / step)
    line = np.arange(npts) * step
    yz = rng.uniform(0, box, 4)
    chains = np.concatenate([
        np.stack([line, np.full(npts, yz[0]), np.full(npts, yz[1])], 1),
        np.stack([np.full(npts, yz[2]), line, np.full(npts, yz[3])], 1)])
    rest = rng.uniform(0, box, (n - len(clumps) - len(chains), 3))
    pos = np.concatenate([clumps, chains, rest]) % box
    chain = np.zeros(n, bool)
    chain[len(clumps):len(clumps) + len(chains)] = True
    perm = rng.permutation(n)
    return pos[perm].astype(np.float32), chain[perm]


def fof_oracle(pos, box: float, b: float):
    """FoF labels independent of the port: scipy cKDTree pairs within
    b (1 + 1e-5), r^2 recomputed in float32 as the plain hook computes it
    ((x_j + shift) - x_i, (dx^2 + dy^2) + dz^2, kept if < float32(b^2)),
    connected components, each labelled with its least particle index.
    -> (labels, links, pairs whose two directions disagree)."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree
    n = len(pos)
    pairs = cKDTree(pos.astype(np.float64), boxsize=box).query_pairs(
        b * (1 + 1e-5), output_type="ndarray")
    i, j = pairs[:, 0], pairs[:, 1]
    b2 = np.float32(b * b)

    def r2(p, q):            # p reads q, as the hook's row p does
        raw = pos[q].astype(np.float64) - pos[p]
        shift = (-box * np.round(raw / box)).astype(np.float32)
        d = (pos[q] + shift) - pos[p]
        return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]

    fwd, bwd = r2(i, j) < b2, r2(j, i) < b2
    link = fwd | bwd
    graph = coo_matrix((np.ones(int(link.sum())), (i[link], j[link])),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    least = np.full(comp.max() + 1, n)
    np.minimum.at(least, comp, np.arange(n))
    return least[comp], int(link.sum()), int((fwd != bwd).sum())


def find_halos_split(pos, vel, mass, box: float, factor: float):
    """halo_finder.find_halos step by step, with a synchronise after each
    part -> ({seconds for fof_plan, _fof_setup, the rounds (K5's share of
    them from CUDA events around each sweep), the overflow adoption and
    the catalogue (group count, window plan, catalog_from_labels); the
    rounds, plan, overflow and halo count}, the labels): its labels and
    rounds must equal fof_labels'."""
    import torch
    from lambda_cdm_tpu_torch.analysis import halo_finder as hf
    from lambda_cdm_tpu_torch.ops import fof_hook
    n = pos.shape[0]
    b = factor * box / n ** (1.0 / 3.0)
    live = mass > 0
    out = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return time.perf_counter()

    torch.cuda.synchronize()
    t = time.perf_counter()
    plan = hf.fof_plan(n, box, b, positions=pos, live=live)
    t = lap("plan_s", t)
    ncell, cap = plan["ncell"], plan["capacity"]
    bxyz, _, counts, pslot, slot_particle, ovf = hf._fof_setup(
        pos, live, box, ncell, cap)
    t = lap("setup_s", t)
    sweeps = []

    def hook(*args, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res = fof_hook.fof_hook(*args, **kw)
        ev[1].record()
        sweeps.append(ev)
        return res

    lab = torch.arange(n, device=pos.device)
    active = torch.ones(ncell ** 3, dtype=torch.int32, device=pos.device)
    rounds = 0
    while rounds < 64:
        lab, changed, active = hf._fof_round(
            lab, bxyz, counts, pslot, box_size=float(box),
            linking_length=float(b), ncell=ncell, capacity=cap,
            hook_fn=hook, active=active)
        rounds += 1
        if not bool(changed):
            break
    t = lap("rounds_s", t)
    out["k5_s"] = 1e-3 * sum(e0.elapsed_time(e1) for e0, e1 in sweeps)
    out["k5_sweeps_ms"] = [round(e0.elapsed_time(e1), 4)
                           for e0, e1 in sweeps]
    lab = hf._fof_adopt_overflow(lab, pslot, slot_particle, live, pos, box,
                                 ncell=ncell, capacity=cap)
    t = lap("adopt_s", t)
    del bxyz, pslot, slot_particle
    labels = lab.to(torch.int32)
    n_groups = int(hf.count_groups(labels, min_particles=20))
    max_halos = max(256, 1 << max(n_groups - 1, 0).bit_length())
    window = (hf.catalog_window_plan(pos, box, live=live)
              if n >= 200_000 else None)
    cat = hf.catalog_from_labels(pos, vel, mass, labels, box,
                                 max_halos=max_halos, min_particles=20,
                                 window=window)
    t = lap("catalogue_s", t)
    out.update(rounds=rounds, overflow=int(ovf), plan=plan,
               num_halos=int(cat.num_halos), total_s=sum(
                   v for k, v in out.items() if k.endswith("_s")
                   and k != "k5_s"))
    return out, labels


def print_split(label: str, split: dict, card: str) -> None:
    print(f"find_halos split ({label}): plan {split['plan_s']:.3f}"
          f" s, _fof_setup {split['setup_s']:.3f} s, {split['rounds']} "
          f"rounds {split['rounds_s']:.3f} s (K5 {split['k5_s']:.4f} s of "
          f"them; sweeps {split['k5_sweeps_ms']} ms), adoption "
          f"{split['adopt_s']:.3f} s, catalogue {split['catalogue_s']:.3f} "
          f"s; total {split['total_s']:.3f} s; plan {split['plan']}, "
          f"overflow {split['overflow']}, {split['num_halos']} halos on "
          f"{card}")


def fof_phase(device, card):
    """K5 at 1M clustered: the plan, one sweep against the plain version,
    fof_labels on a subset against the oracle, fof_labels and find_halos
    at 1M."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.analysis import halo_finder as hf
    from lambda_cdm_tpu_torch.ops import fof_hook
    box, b = 100.0, 0.2
    pos_np, chain = fof_state(1_000_000, seed=21, box=box)
    n = len(pos_np)
    pos = torch.from_numpy(pos_np).to(device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    print(f"K5 state: N={n} box={box} b={b}: {int(chain.sum())} in two "
          f"chains, 1000 clumps")

    t0 = time.perf_counter()
    plan = hf.fof_plan(n, box, b, positions=pos, live=live)
    t_plan = time.perf_counter() - t0
    ncell, cap = plan["ncell"], plan["capacity"]
    bxyz, _, counts, pslot, _, ovf = hf._fof_setup(pos, live, box, ncell,
                                                    cap)
    nslots = ncell ** 3 * cap
    lab = torch.full((nslots + 1,), n, dtype=torch.int32, device=device)
    lab[torch.where(pslot >= 0, pslot, nslots)] = torch.arange(
        n, dtype=torch.int32, device=device)
    lab = lab[:nslots].reshape(ncell ** 3, cap)
    active = torch.ones(ncell ** 3, dtype=torch.int32, device=device)
    kw = dict(ncell=ncell, capacity=cap, n_sentinel=n, box_size=box,
              linking_length=b)
    out = fof_hook.fof_hook(*bxyz, lab, counts, active, **kw)
    rows = sample_rows(counts, cap, 4096, seed=5, heavy=True)
    ref = fof_hook.fof_hook_plain(*bxyz, lab, counts, active, rows=rows,
                                  **kw)
    mism = int((out.reshape(-1)[rows] != ref).sum())
    moved = int((out.reshape(-1)[rows] != lab.reshape(-1)[rows]).sum())
    print(f"K5 plan {plan} ({t_plan:.2f} s); bucket overflow {int(ovf)}, "
          f"fullest cell {int(counts.max())}; one sweep, {rows.numel()} "
          f"sampled rows (half from the fullest cell): {mism} labels differ "
          f"from the plain version, {moved} rows hooked")
    check("K5", mism == 0, "kernel and plain labels differ")
    check("K5", moved > 0, "the sweep changed no sampled label")
    ms = cuda_ms(lambda: fof_hook.fof_hook(*bxyz, lab, counts, active, **kw),
                 10)
    pms = cuda_ms(lambda: fof_hook.fof_hook_plain(
        *bxyz, lab, counts, active, rows=rows, **kw), 3)
    n_live = float(counts.sum())
    pairs = stencil_pairs(counts, ncell)
    # positions and label of each live slot read once, its label written
    # once, counts and the active mask read once
    b_ms, b_by = bound(20 * n_live + 8 * ncell ** 3,
                       FLOPS["fof_hook"] * pairs)
    print(f"K5 fof_hook: kernel {ms:.4f} ms per sweep, plain {pms:.4f} ms on "
          f"the {rows.numel()} sampled rows; {pairs:.4e} pair tests, bound "
          f"{b_ms:.4f} ms ({b_by}) on {card}")
    del bxyz, lab, out, pslot

    # the whole labelling on a subset (both chains kept) against the oracle
    rng = np.random.default_rng(22)
    others = np.nonzero(~chain)[0]
    keep = np.sort(np.concatenate([np.nonzero(chain)[0], rng.choice(
        others, 131_072 - int(chain.sum()), replace=False)]))
    sub = pos_np[keep]
    sub_t = torch.from_numpy(sub).to(device)
    # 32^3 cells (3.125 Mpc/h >= b), capacity above the fullest cell: no
    # overflow, so the labels are exact FoF components
    occ = torch.bincount(hf._cell_ids(sub_t, box, 32), minlength=32 ** 3)
    cap_s = 1 << int(occ.max() - 1).bit_length()
    t0 = time.perf_counter()
    lab_s, ovf_s = hf.fof_labels(sub_t, box, b, ncell=32, capacity=cap_s)
    torch.cuda.synchronize()
    t_sub = time.perf_counter() - t0
    rounds_s = hf.last_fof["rounds"]
    t0 = time.perf_counter()
    oracle, links, asym = fof_oracle(sub, box, b)
    t_oracle = time.perf_counter() - t0
    mism = int((lab_s.cpu().numpy() != oracle).sum())
    print(f"K5 fof_labels, {len(sub)}-particle subset (ncell 32, capacity "
          f"{cap_s}): {rounds_s} rounds, {t_sub:.2f} s, overflow "
          f"{int(ovf_s)}; oracle ({links} links, {asym} pairs whose two "
          f"directions disagree, {t_oracle:.1f} s): {mism} labels differ, "
          f"{len(np.unique(oracle))} groups")
    check("K5 oracle", int(ovf_s) == 0 and mism == 0,
          "card fof_labels differs from the cKDTree oracle")

    # fof_labels and find_halos at 1M through the plan
    fof_hook.reset_launch_counts()
    t0 = time.perf_counter()
    labels, ovf = hf.fof_labels(pos, box, b, **plan, live=live)
    torch.cuda.synchronize()
    t_fof = time.perf_counter() - t0
    rounds = dict(hf.last_fof, launches=fof_hook.launches["fof_hook"])
    n_groups = int(hf.count_groups(labels))
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(23)
    vel = torch.randn((n, 3), generator=gen, device=device)
    cat = hf.find_halos(pos, vel, torch.ones(n, device=device), box,
                        linking_length_factor=b * n ** (1 / 3) / box)
    torch.cuda.synchronize()
    t_halos = time.perf_counter() - t0
    nh = int(cat.num_halos)
    print(f"K5 fof_labels at 1M: {rounds['rounds']} rounds (converged "
          f"{rounds['converged']}, max_rounds 64), {rounds['launches']} K5 "
          f"launches, {t_fof:.2f} s, overflow "
          f"{int(ovf)} (adopted by their cells' groups), {n_groups} groups "
          f">= 20; find_halos {t_halos:.2f} s, num_halos {nh} on {card}")
    check("K5 1M", rounds["converged"], "fof_labels did not converge")
    check("K5 1M", nh > 500 and bool(torch.all(torch.isfinite(
        cat.radius[:nh]))), "implausible halo catalogue")
    split, split_labels = find_halos_split(
        pos, vel, torch.ones(n, device=device), box, b * n ** (1 / 3) / box)
    print_split("1M clustered", split, card)
    check("K5 1M split", split["rounds"] == rounds["rounds"]
          and bool(torch.equal(split_labels, labels))
          and split["num_halos"] == nh, "the split differs from find_halos")
    del split_labels, labels
    fof_layouts(pos, live, box, b, plan, card)
    return {"ms": ms, "plain_ms": pms, "max_abs_err": float(mism),
            "bound_ms": b_ms, "bound_by": b_by, "rounds": rounds["rounds"]}


def fof_layouts(pos, live, box: float, b: float, plan: dict, card) -> None:
    """The layouts fof_plan weighs at the three finest cell levels (each
    level's capacity of least overflow within the plan's 2 GB budget),
    ranked as fof_plan ranks them (overflow within 0.1% of the particles
    first, by the K5 cost model's slot visits; else by overflow, then
    slot visits), beside K5's first sweep on each."""
    import torch
    from lambda_cdm_tpu_torch.analysis import halo_finder as hf
    from lambda_cdm_tpu_torch.ops import fof_hook
    n = pos.shape[0]
    nmax = max(min(int(math.floor(box / b)), 128), 1)
    nf = 1 << (nmax.bit_length() - 1)
    caps = hf._FOF_CAPS
    stats = hf._occupancy_pyramid(pos, live, box, nf, caps)
    rows = []
    for lvl, ncell in enumerate(hf._pyramid_levels(nf)[:3]):
        max_occ, ovf_tab, sweep = stats[lvl]
        cap_occ = max(16, 1 << (max(max_occ, 1) - 1).bit_length())
        fit = [(0 if c >= max_occ else ovf_tab[k], c)
               for k, c in enumerate(caps)
               if c <= cap_occ and 16 * ncell ** 3 * c <= 2 << 30]
        if not fit:
            continue
        ovf, cap = min(fit)
        bxyz, _, counts, pslot, _, _ = hf._fof_setup(pos, live, box, ncell,
                                                     cap)
        nslots = ncell ** 3 * cap
        lab = torch.full((nslots + 1,), n, dtype=torch.int32,
                         device=pos.device)
        lab[torch.where(pslot >= 0, pslot, nslots)] = torch.arange(
            n, dtype=torch.int32, device=pos.device)
        lab = lab[:nslots].reshape(ncell ** 3, cap)
        kw = dict(ncell=ncell, capacity=cap, n_sentinel=n, box_size=box,
                  linking_length=b)
        ms = cuda_ms(lambda: fof_hook.fof_hook(*bxyz, lab, counts, None,
                                               **kw), 5)
        key = ((0, sweep, ovf) if ovf <= max(1, n // 1000)
               else (1, ovf, sweep))
        rows.append((key, ncell, cap, ovf, sweep, ms))
        del bxyz, lab, pslot
        torch.cuda.empty_cache()
    print("K5 layouts fof_plan weighs: " + "; ".join(
        f"ncell {nc} capacity {cap}: overflow {ovf}, model {w:.4e} slot "
        f"visits, K5 first sweep {ms:.4f} ms" + (
            " (the plan)" if (nc, cap) == (plan["ncell"], plan["capacity"])
            else "") for _, nc, cap, ovf, w, ms in rows) + f" on {card}")
    by_plan = [r[1] for r in sorted(rows)]
    by_time = [r[1] for r in sorted(rows, key=lambda r: r[5])]
    print(f"K5 layouts: fof_plan ranks the cell levels {by_plan}, K5's "
          f"first sweep {by_time}")


def cli_phase(device, card):
    """treepm_1m.json through the CLI's engine with its observers, then
    resume and analyze through cli.main."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch import cli
    from lambda_cdm_tpu_torch.core.analysis_observers import \
        HaloFinderObserver
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    tmp = tempfile.mkdtemp(prefix="lcdm_chip_smoke_")
    try:
        out_dir = os.path.join(tmp, "out")
        cfg = SimulationConfig.from_file(CONFIG)
        rest = cfg.apply_cli_overrides(CLI_OVERRIDES + [
            f"--simulation.output_directory={out_dir}",
            f"--profiling.output_file={os.path.join(tmp, 'profile.json')}"])
        check("CLI", not rest, f"overrides not taken: {rest}")
        cfg.validate()
        print(f"CLI phase: run {os.path.relpath(CONFIG, ROOT)} "
              f"{' '.join(CLI_OVERRIDES)} (energy on: K9)")
        reset_counts()
        t0 = time.perf_counter()
        eng = cli._build_engine(cfg, device=device)
        eng.initialize()
        eng.run()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = read_counts()
        stats = eng.statistics
        print(f"CLI run: {stats.total_steps} steps in {t_run:.2f} s "
              f"(compute {stats.compute_time_s:.2f} s, "
              f"{1e3 * stats.compute_time_s / max(stats.total_steps, 1):.2f}"
              f" ms/step; observers {stats.analysis_time_s:.2f} s; "
              f"checkpoints {stats.io_time_s:.2f} s) on {card}; "
              f"launches {json.dumps(launches)}")
        for name, t in eng.profiler.summary().items():
            if name.startswith(("analysis.", "diagnostics.")):
                print(f"  {name}: {t['count']} x {1e3 * t['mean_s']:.2f} ms")
        check("CLI", stats.total_steps == 40, "steps not taken")
        check("CLI", all(launches[k] > 0 for k in (
            "cic_deposit", "fd4_gather", "short_range", "fof_hook",
            "pair_potential")), "a kernel of the path was not launched")
        energy = eng.profiler.get("diagnostics.energy")
        print(f"CLI energy: {energy.count} compute_energy calls at N="
              f"{eng.state.num_particles} through K9 ({launches['pair_potential']}"
              f" launches), {energy.min_s:.3f}-{energy.max_s:.3f} s a call "
              f"(mean {energy.mean_s:.3f} s) on {card}")
        check("CLI", energy.count >= 1
              and launches["pair_potential"] == energy.count
              and energy.max_s < CLI_ENERGY_MAX_S,
              f"compute_energy: {energy.count} calls, {launches['pair_potential']}"
              f" K9 launches, max {energy.max_s:.3f} s (limit "
              f"{CLI_ENERGY_MAX_S} s)")
        halo_obs = [o for o in eng.observers if isinstance(
            o, HaloFinderObserver)]
        check("CLI", len(halo_obs) == 1 and len(halo_obs[0].catalogs) == 1,
              "no halo catalogue recorded")
        print(f"CLI halo catalogue at step 40: "
              f"{halo_obs[0].catalogs[0]['num_halos']} halos")
        # the treepm_fast state's forces through the stateless treepm
        # solver against the min-image direct oracle
        t0 = time.perf_counter()
        res = eng.validate_force_accuracy(n_sample=1024)
        torch.cuda.synchronize()
        print(f"CLI state force validation (treepm, 1024 targets, "
              f"{time.perf_counter() - t0:.2f} s): scale-normalized avg "
              f"{res['avg_err']:.4e} max {res['max_err']:.4e}, per-target "
              f"avg {res['avg_rel_err']:.4e}; against the min-image "
              f"oracle, where the JAX package's bar is force RMS 2.84e-3 "
              f"(bar 5e-3) against Ewald")
        check("CLI", res["n_sample"] == 1024 and math.isfinite(
            res["max_err"]), "force validation failed")
        names = sorted(os.listdir(out_dir))
        pk_files = [f for f in names if f.startswith("power_")]
        check("CLI", len(pk_files) == 2, f"P(k) files {pk_files}")
        for f in pk_files:
            pk = np.loadtxt(os.path.join(out_dir, f))
            check("CLI", pk.ndim == 2 and pk.shape[0] > 10
                  and bool(np.all(np.isfinite(pk))), f"{f}: bad P(k)")
        snaps = [f for f in names if f.startswith("snapshot_000040")]
        ckpt = os.path.join(out_dir, "checkpoint_000040.npz")
        check("CLI", len(snaps) == 1 and os.path.exists(ckpt),
              f"snapshot or checkpoint missing: {names}")
        del eng
        t0 = time.perf_counter()
        rc = cli.main(["resume", ckpt, "--time.max_steps=8"], device=device)
        print(f"[CLI resume: rc {rc}, {time.perf_counter() - t0:.1f} s]")
        check("CLI resume", rc == 0, f"exit code {rc}")
        t0 = time.perf_counter()
        rc = cli.main(["analyze", os.path.join(out_dir, snaps[0]), "--ng",
                       "192"], device=device)
        print(f"[CLI analyze: rc {rc}, {time.perf_counter() - t0:.1f} s]")
        check("CLI analyze", rc == 0, f"exit code {rc}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def binned_match(ca, cb, pa, pb, tol: float) -> tuple[float, int]:
    """The assignment-invariant comparison of two binned spectra: bins
    whose mode counts agree within `tol` relative (to the larger of the
    bin's |P| and 1% of the largest), runs of bins whose counts differ
    conserving their count with count-weighted power within 10 tol.
    -> (largest error, bins that differ in count); raises on a failure."""
    import numpy as np
    ca, cb, pa, pb = (np.asarray(x, np.float64) for x in (ca, cb, pa, pb))
    same = ca == cb
    floor = 1e-2 * np.abs(pb).max()
    err = float(np.max(np.where(same & (cb > 0), np.abs(pa - pb)
                                / np.maximum(np.abs(pb), floor), 0.0)))
    check("P(k)", err <= tol, f"power differs by {err}")
    idx = np.nonzero(~same)[0]
    if idx.size:
        for run in np.split(idx, np.nonzero(np.diff(idx) > 1)[0] + 1):
            check("P(k)", ca[run].sum() == cb[run].sum(),
                  "modes leaked across bins")
            w = np.sum(cb[run] * np.abs(pb[run])) + 1e-30
            d = abs(np.sum(ca[run] * pa[run]) - np.sum(cb[run] * pb[run]))
            check("P(k)", d / w <= 10 * tol, f"merged run differs {d / w}")
    return err, int(idx.size)


def reference_check(device):
    """A small run with every observer on through the kernels on the card
    against the same run through the plain versions on the CPU, from one
    initial state."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch import SimulationBuilder
    from lambda_cdm_tpu_torch.analysis import halo_finder as hf
    from lambda_cdm_tpu_torch.core.analysis_observers import (
        ConservationObserver, HaloFinderObserver, PowerSpectrumObserver,
        build_observers_from_config)
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.forces.direct import potential_energy
    from lambda_cdm_tpu_torch.physics.initial_conditions import \
        generate_state
    tmp = tempfile.mkdtemp(prefix="lcdm_chip_smoke_ref_")
    try:
        cfg = SimulationConfig.from_dict({
            "forces": {"type": "treepm_fast", "pm_grid_size": 32,
                       "softening_length": 0.1, "rebucket_every": 4},
            "particles": {"num_particles": 4096, "box_size": 50.0},
            "cosmology": {"initial_redshift": 9.0},
            "time": {"initial_timestep": 2e-5},
            "simulation": {"output_frequency": 4, "checkpoint_frequency": 8,
                           "output_directory": tmp},
            "profiling": {"enabled": False},
            "logging": {"performance_logging": False},
            "io": {"snapshots": {"frequency": 8},
                   "analysis": {"enabled": True,
                                "power_spectrum": {
                                    "enabled": True, "frequency": 4,
                                    "grid_size": 32, "num_bins": 16},
                                "halo_finder": {
                                    "enabled": True, "frequency": 8,
                                    "min_particles": 10}}}})
        # set on the object: the loader reads only the reference layout's
        # initial-conditions block
        ic = cfg.particles.initial_conditions
        ic.type, ic.grid_size, ic.random_seed = "2lpt", 32, 5
        st0 = generate_state(cfg, device="cpu")
        out = {}
        for dev in (device, "cpu"):
            eng = (SimulationBuilder(device=dev).with_config(cfg)
                   .with_initial_state(st0).build())
            for o in build_observers_from_config(cfg):
                eng.add_observer(o)
            st = eng.run(num_steps=8)
            obs = {type(o): o for o in eng.observers}
            out[dev] = dict(
                pos=st.positions.cpu(), vel=st.velocities.cpu(),
                counters=(int(eng._fstate.overflow),
                          int(eng._fstate.dropped)),
                pk=obs[PowerSpectrumObserver].results,
                halos=obs[HaloFinderObserver].catalogs,
                cons=obs[ConservationObserver].history, state=st)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    g, c = out[device], out["cpu"]
    box = cfg.particles.box_size
    d = torch.remainder(g["pos"] - c["pos"] + box / 2, box) - box / 2
    pos_err = float(d.abs().max()) / box
    vel_err = float((g["vel"] - c["vel"]).abs().max() / c["vel"].abs().max())
    print(f"reference check (4096 particles, 8 steps, every observer, card "
          f"vs CPU plain): positions {pos_err:.3e} of the box, velocities "
          f"{vel_err:.3e} of max |v|; overflow/dropped {g['counters']} / "
          f"{c['counters']}")
    check("reference", pos_err <= 1e-5 and vel_err <= 1e-4,
          "card and CPU runs disagree")
    check("reference", g["counters"] == c["counters"], "counters differ")
    # P(k) at steps 4 and 8
    check("reference", len(g["pk"]) == len(c["pk"]) == 2, "P(k) records")
    pk_err, flipped = 0.0, 0
    for a, b_ in zip(g["pk"], c["pk"]):
        e, f = binned_match(a["counts"], b_["counts"], a["power"],
                            b_["power"], 1e-4)
        pk_err, flipped = max(pk_err, e), flipped + f
    # the runs' catalogues (a 2LPT state this early holds few groups), then
    # one clustered state catalogued on both devices
    nh = [h["num_halos"] for h in (g["halos"][0], c["halos"][0])]
    cpos, _ = fof_state(16384, seed=24, box=20.0, n_clumps=30,
                        clumped=5000)
    cpos = torch.from_numpy(cpos)
    cvel = torch.from_numpy(np.random.default_rng(25).standard_normal(
        cpos.shape).astype(np.float32))
    cats = [hf.find_halos(cpos.to(dev), cvel.to(dev),
                          torch.ones(len(cpos), device=dev), 20.0)
            for dev in (device, "cpu")]
    lab_diff = int((cats[0].particle_label.cpu()
                    != cats[1].particle_label).sum())
    cat_nh = [int(cat.num_halos) for cat in cats]
    cat_err = max(float(rel_err(cats[0].mass.cpu(), cats[1].mass)[1]),
                  float(rel_err(cats[0].radius.cpu(), cats[1].radius)[1]))
    # KE, PE and momentum at every record
    e_err, p_err = 0.0, 0.0
    for a, b_ in zip(g["cons"], c["cons"]):
        for k in ("kinetic", "potential", "total"):
            e_err = max(e_err, abs(a[k] - b_[k]) / abs(b_[k]))
        p_scale = float((c["state"].masses[:, None]
                         * c["vel"].abs()).sum())
        p_err = max(p_err, float(np.abs(a["momentum"] - b_["momentum"])
                                 .max()) / p_scale)
    st_c = c["state"]
    pe = [float(potential_energy(st_c.positions.to(dev),
                                 st_c.masses.to(dev), box,
                                 cfg.forces.softening_length, cfg.units.G))
          for dev in (device, "cpu")]
    pe_same = abs(pe[0] - pe[1]) / abs(pe[1])
    print(f"reference check: P(k) {pk_err:.3e} (tol 1e-4; {flipped} bins "
          f"with other mode counts), run halos {nh[0]} / {nh[1]}; clustered "
          f"state catalogued card vs CPU: {cat_nh[0]} / {cat_nh[1]} halos, "
          f"{lab_diff} labels differ, mass and radius {cat_err:.3e} (tol "
          f"1e-5); KE/PE/total "
          f"{e_err:.3e} (tol 1e-4), momentum {p_err:.3e} of sum |m v| "
          f"(tol 1e-4); PE of one state card vs CPU {pe_same:.3e} "
          f"(tol 1e-5)")
    check("reference", nh[0] == nh[1], "halo counts differ")
    check("reference", cat_nh[0] == cat_nh[1] > 10 and lab_diff == 0
          and cat_err <= 1e-5, "halo catalogues differ")
    check("reference", e_err <= 1e-4 and p_err <= 1e-4,
          "energies or momentum differ")
    check("reference", pe_same <= 1e-5, "potential energy differs")


# K9 against its plain version (relative to |U|): float32 pair terms,
# float64 sums in another order
PAIR_POTENTIAL_TOL = 1e-6
# float operations per pair term of K9, counted from csrc/direct.cu: 3
# differences, 3 minimum images (a rounded quotient and a multiply-
# subtract: 3 each), r^2 (3 products, 3 sums), the exclusion compare,
# one rsqrt, the mass product and the running sum
PAIR_POTENTIAL_FLOPS = 21
# (particles, softening): K9 against its plain version at the first, K9
# alone on uniform particles at the science run's 1M; the science phase
# holds it against plain on that run's final clustered 1M state
PAIR_POTENTIAL_SIZES = ((131_072, 0.02), (1_000_000, 0.1))


def pair_potential_bound(n: int) -> tuple[float, str]:
    """K9's bound: each position and mass read once, the per-block
    partials written once, and the n(n-1)/2 unordered pair terms the
    sum needs at PAIR_POTENTIAL_FLOPS each (the work, whatever the
    kernel does per pair)."""
    from lambda_cdm_tpu_torch.ops import direct
    return bound(16.0 * n + 8.0 * direct.pair_schedule(n)[0].numel(),
                 PAIR_POTENTIAL_FLOPS * float(n) * (n - 1) / 2)


def half_box_lattice(box: float, side: int):
    """side^3 unit masses on a lattice, jittered in y and z (numpy, seed
    3), whose middle x layer sits one ulp past half a box from layer 0:
    pairs whose image d * (1/box) and d / box round apart."""
    import numpy as np
    g = np.arange(side, dtype=np.float32) * np.float32(box / side)
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(3)
    pos[:, 1:] = np.mod(pos[:, 1:] + rng.uniform(-0.3, 0.3, (len(pos), 2)),
                        box)
    half = np.float32(box / 2)
    pos[pos[:, 0] == half, 0] = np.nextafter(half, np.float32(box))
    return pos.astype(np.float32), np.ones(len(pos), np.float32)


def pair_potential_check(pos, mass, box, soft, label, card, reps=1):
    """K9 on (pos, mass) twice (bit for bit equal), timed, and held
    against pair_potential_plain (timed once) and potential_energy;
    prints the numbers and returns (max_abs_err, rel, ms, plain_ms,
    bound_ms, bound_by)."""
    import torch
    from lambda_cdm_tpu_torch.ops import direct
    from lambda_cdm_tpu_torch.forces.direct import potential_energy
    n = pos.shape[0]
    u1 = direct.pair_potential(pos, mass, box, soft)
    u2 = direct.pair_potential(pos, mass, box, soft)
    same = float(u1) == float(u2)
    ms = cuda_ms(lambda: direct.pair_potential(pos, mass, box, soft), reps,
                 warmup=0)
    pe = float(potential_energy(pos, mass, box, soft))
    t0 = time.perf_counter()
    ref = direct.pair_potential_plain(pos, mass, box, soft)
    torch.cuda.synchronize()
    pms = 1e3 * (time.perf_counter() - t0)
    err = abs(float(u1) - float(ref))
    rel = err / abs(float(ref))
    b_ms, b_by = pair_potential_bound(n)
    print(f"K9 pair_potential on {label} (N={n}, softening {soft:g}): U "
          f"{float(u1):.10e} against plain {float(ref):.10e}: max_abs_err "
          f"{err:.3e} (rel {rel:.3e}, tol {PAIR_POTENTIAL_TOL:g}), two "
          f"calls equal {same}; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}, {float(n) * (n - 1) / 2:.4e} "
          f"unordered pairs, each evaluated once) on {card}")
    check("K9", same, f"two calls on {label} differ: {float(u1)!r} "
          f"{float(u2)!r}")
    check("K9", pe < 0 and math.isfinite(pe) and pe == float(
        u1.to(torch.float32)), f"potential_energy on {label}: {pe}")
    check("K9", rel <= PAIR_POTENTIAL_TOL, f"rel err {rel} > tol on {label}")
    return err, rel, ms, pms, b_ms, b_by


def pair_potential_phase(device, card):
    """K9 (pair_potential) against its plain version at 131,072 particles
    uniform in 100 Mpc/h (softening 0.02), on a 32^3 half-box lattice in
    50 Mpc/h and on 16,384 particles at softening 0 with 4096 coincident
    pairs, two calls bit for bit equal, timed beside it; K9 alone on
    1M uniform particles (softening 0.1, the science run's), with the
    bound at both."""
    import torch
    from lambda_cdm_tpu_torch.ops import direct
    from lambda_cdm_tpu_torch.forces.direct import potential_energy
    box = 100.0
    gen = torch.Generator(device=device).manual_seed(31)
    n, soft = PAIR_POTENTIAL_SIZES[0]
    pos = torch.rand((n, 3), generator=gen, device=device) * box
    pair_potential_check(pos, torch.ones(n, device=device), box, soft,
                         "uniform particles", card, reps=3)
    lat, lm = half_box_lattice(50.0, 32)
    pair_potential_check(torch.from_numpy(lat).to(device),
                         torch.from_numpy(lm).to(device), 50.0, soft,
                         "the half-box lattice", card)
    # softening 0 with a quarter of the particles doubled: the self pairs
    # and the coincident pairs have r^2 = 0 and are left out
    pos = torch.rand((16_384, 3), generator=gen, device=device) * box
    pos[8192:12_288] = pos[:4096]
    pair_potential_check(pos, torch.ones(16_384, device=device), box, 0.0,
                         "coincident particles at softening 0", card)
    n, soft = PAIR_POTENTIAL_SIZES[1]
    pos = torch.rand((n, 3), generator=gen, device=device) * box
    mass = torch.ones(n, device=device)
    u1 = direct.pair_potential(pos, mass, box, soft)
    u2 = direct.pair_potential(pos, mass, box, soft)
    same = float(u1) == float(u2)
    ms = cuda_ms(lambda: direct.pair_potential(pos, mass, box, soft), 1,
                 warmup=0)
    pe = float(potential_energy(pos, mass, box, soft))
    b_ms, b_by = pair_potential_bound(n)
    print(f"K9 pair_potential on uniform particles (N={n}): kernel "
          f"{ms:.4f} ms a call (U {float(u1):.10e}, two calls equal "
          f"{same}), bound {b_ms:.4f} ms ({b_by}) on {card}")
    check("K9", same, f"two calls at N={n} differ: {float(u1)!r} "
          f"{float(u2)!r}")
    check("K9", pe < 0 and math.isfinite(pe) and pe == float(
        u1.to(torch.float32)), f"potential_energy at N={n}: {pe}")


ALIAS_ROWS, ALIAS_COLS = 8, 128


def alias_probe_phase(device, card):
    """K10 on its own path: the entry point python -m
    lambda_cdm_tpu_torch.ops.alias_probe (both modes, counts reset just
    before), then each mode against its plain version on an [8, 128] zero
    buffer: the sequential mode must equal it (1..8 in column 0), and
    from a random buffer too, the blocks mode's column 0 is what the card
    gives; timed as a CUDA graph of launches and eagerly, beside the floor
    kernel at each mode's shape (rows x 128 threads for blocks, 1 x 128
    for sequential) in the same kind of graph: empty, and adding 1 to one
    float a thread."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.ops import alias_probe
    reset_counts()
    check("K10", alias_probe.main([]) == 0, "entry point failed")
    torch.cuda.synchronize()
    launches = {"alias_probe": read_counts()["alias_probe"]}
    check("K10", launches["alias_probe"] == 2,
          f"launches {launches['alias_probe']} (expected 2)")
    n_bytes = 2.0 * 4 * ALIAS_ROWS * ALIAS_COLS
    b_ms, b_by = bound(n_bytes, ALIAS_ROWS * ALIAS_COLS)
    shapes = {"blocks": (ALIAS_ROWS, ALIAS_COLS), "sequential": (1,
                                                                 ALIAS_COLS)}
    floor = {mode: graph_ms(lambda: alias_probe.launch_floor(*shape))
             for mode, shape in shapes.items()}
    scratch = torch.zeros(ALIAS_ROWS * ALIAS_COLS, device=device)
    touch = {mode: graph_ms(lambda: alias_probe.launch_floor(*shape,
                                                             scratch))
             for mode, shape in shapes.items()}
    rec = {}
    for mode in alias_probe.MODES:
        cols = []
        for _ in range(5):
            x = alias_probe.alias_probe(
                torch.zeros((ALIAS_ROWS, ALIAS_COLS), device=device), mode)
            torch.cuda.synchronize()
            cols.append(x[:, 0].tolist())
        ref = alias_probe.alias_probe_plain(
            torch.zeros((ALIAS_ROWS, ALIAS_COLS)), mode == "sequential")
        err = float((x.cpu() - ref).abs().max())
        buf = torch.zeros((ALIAS_ROWS, ALIAS_COLS), device=device)
        ms = graph_ms(lambda: alias_probe.alias_probe(buf, mode))
        eager = cuda_ms(lambda: alias_probe.alias_probe(buf, mode), 100)
        t0 = time.perf_counter()
        for _ in range(100):
            alias_probe.alias_probe_plain(
                torch.zeros((ALIAS_ROWS, ALIAS_COLS), device=device),
                mode == "sequential")
        torch.cuda.synchronize()
        pms = 10.0 * (time.perf_counter() - t0)
        print(f"K10 alias_probe {mode}: column 0 over 5 launches "
              f"{cols}; against plain {ref[:, 0].tolist()}: max_abs_err "
              f"{err:g}; {1e3 * ms:.3f} us a launch (CUDA graph; at "
              f"{shapes[mode][0]} x {shapes[mode][1]} an empty kernel "
              f"{1e3 * floor[mode]:.3f} us, one read and write a thread "
              f"{1e3 * touch[mode]:.3f} us), eager {1e3 * eager:.3f} us, "
              f"plain {1e3 * pms:.3f} us, bound {1e3 * b_ms:.6f} us "
              f"({b_by}) on {card}")
        if mode == "sequential":
            check("K10", err == 0.0 and cols[-1] == [float(i) for i in
                                                     range(1, 9)],
                  f"sequential mode {cols[-1]}")
            rnd = np.random.default_rng(19).normal(size=(
                ALIAS_ROWS, ALIAS_COLS)).astype(np.float32)
            got = alias_probe.alias_probe(torch.from_numpy(rnd).to(device),
                                          mode)
            same = bool(torch.equal(got.cpu(), alias_probe.alias_probe_plain(
                torch.from_numpy(rnd), True)))
            print(f"K10 sequential from a random buffer: bit for bit the "
                  f"plain version's: {same}")
            check("K10", same, "sequential mode from a random buffer")
            rec["alias_probe"] = (err, 0.0, ms, pms, b_ms, b_by)
        else:
            check("K10", all(c[0] == 1.0 and max(c) <= 8.0 for c in cols),
                  f"blocks mode {cols}")
    return rec, launches


SCIENCE_OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke_science")


def science_phase(device, card):
    """The port's science run at the 1M geometry (100^3 particles, 100
    Mpc/h, 192^3 PM, capacity 8192) from z = 24 to z = 0 through
    python -m lambda_cdm_tpu_torch.science_run's main, with the launch
    counts reset just before and read just after; then --analyze-only on
    the record it wrote, and K9 against its plain version on the run's
    final state. Its certificate and record go to
    chiprun_out/chip_smoke_science/. Returns the launch counts and K9's
    numbers on that state."""
    import torch
    from lambda_cdm_tpu_torch import science_run
    shutil.rmtree(SCIENCE_OUT, ignore_errors=True)
    z_final = float(os.environ.get("LCDM_SCIENCE_ZFINAL", "0.0"))
    reset_counts()
    t0 = time.perf_counter()
    rc = science_run.main(["--out", SCIENCE_OUT])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = read_counts()
    with open(os.path.join(SCIENCE_OUT, "SCIENCE.json")) as f:
        cert = json.load(f)
    checks = cert["checks"]
    bd = cert["step_breakdown"]
    li = cert["layzer_irvine_samples"]
    print(f"science run (1M, z={science_run.Z_INIT:g} -> {z_final:g}): "
          f"rc {rc}, {cert['steps']} steps to a={cert['a_final']:.4f} in "
          f"{t_run:.1f} s (evolve {cert['evolve_s']} s, "
          f"{cert['ms_per_step_incl_analysis']} ms/step with observers; "
          f"ICs {cert['ic_s']} s; analysis {cert['analysis_s']} s, FoF "
          f"{cert['fof_s']} s; ledger {cert['li_wall_s']} s for {len(li)} "
          f"samples) on {card}; launches {json.dumps(launches)}")
    print(f"science Layzer-Irvine: " + "; ".join(
        f"a={s['a']:.4f} T={s['T']:.4e} U={s['U']:.4e} "
        f"resid={s['residual']:.3e}" for s in li))
    print(f"science final-state breakdown (K3 at z = {science_run.Z_INIT:g} "
          f"under 'initial'): {json.dumps(bd)}")
    print(f"science FoF at the final state: {json.dumps(cert['fof'])}; "
          f"HMF {json.dumps(cert['hmf'])}")
    for name, c in checks.items():
        print(f"science check {name}: {c['value']} "
              f"({ {True: 'PASS', False: 'FAIL', None: 'recorded'}[c['pass']]}"
              f"; bar {c['bar']})")
    for name in ("completed_to_target", "bucket_overflow",
                 "dropped_deposits", "particles_conserved"):
        check("science", checks[name]["pass"], f"{name}: {checks[name]}")
    check("science", cert["config"]["n_particles"] == 1_000_000
          and cert["config"]["pm_grid"] == 192, "not the 1M geometry")
    check("science", all(launches[k] > 0 for k in (
        "cic_deposit", "fd4_gather", "short_range", "fof_hook",
        "pair_potential")), "a kernel of the path was not launched")
    check("science", launches["pair_potential"] == len(li),
          f"{launches['pair_potential']} K9 launches for {len(li)} ledger "
          f"samples")
    check("science", bd.get("variant") == "vpu5" and bd.get("ncell") == 16
          and bd.get("capacity") == 8192, f"plan {bd}")
    failed = [k for k, c in checks.items() if c["pass"] is False]
    check("science", rc == 0 and not failed and cert["passed"],
          f"failed checks {failed}")
    science_vs_tpu(cert)
    t0 = time.perf_counter()
    rc = science_run.main(["--analyze-only", "--out", SCIENCE_OUT])
    with open(os.path.join(SCIENCE_OUT, "SCIENCE.json")) as f:
        again = json.load(f)
    print(f"[science --analyze-only: rc {rc}, "
          f"{time.perf_counter() - t0:.1f} s]")
    check("science --analyze-only", rc == 0 and again["passed"] and {
        k: c["pass"] for k, c in again["checks"].items()} == {
        k: c["pass"] for k, c in checks.items()}, "re-analysis differs")
    # K9 against plain at the shape the ledger gives it: the run's final
    # clustered 1M state (1e6 % THREADS = 64: a partial last tile)
    final = science_run.load_record(os.path.join(SCIENCE_OUT,
                                                 "science_record.npz"))
    g = science_run.geometry(False)
    split, labels = find_halos_split(
        *(torch.from_numpy(final[k]).to(device) for k in
          ("pos_f", "vel_f", "masses")), g["box"], 0.2)
    print_split("the science run's final state", split, card)
    check("science FoF split", split["rounds"] == cert["fof"]["rounds"]
          and split["plan"]["ncell"] == cert["fof"]["ncell"],
          f"the split differs from the run's FoF {cert['fof']}")
    science_fof_oracle(final, labels, g["box"], split["overflow"])
    k9 = pair_potential_check(
        torch.from_numpy(final["pos_f"]).to(device),
        torch.from_numpy(final["masses"]).to(device), g["box"],
        g["softening"], "the science run's final clustered state", card)
    science_kernel_check(final, g, device, card)
    return launches, k9


def science_fof_oracle(final, labels, box: float, overflow: int) -> None:
    """The science run's final-state FoF groups (find_halos's labels, K5)
    against the cKDTree oracle's on the same particles: the labels that
    differ, and for both the groups of >= 20, 20-31 and 32-63 particles
    (the small groups where the run's HMF and SCIENCE.json's part).
    Without overflow the labels are exact FoF components and must equal
    the oracle's."""
    import numpy as np
    pos = final["pos_f"]
    oracle, links, asym = fof_oracle(pos, box, 0.2 * box
                                     / len(pos) ** (1.0 / 3.0))
    ours = labels.cpu().numpy()
    differ = int((ours != oracle).sum())

    def bands(lab):
        sizes = np.unique(lab, return_counts=True)[1]
        return [int(np.sum((sizes >= lo) & (sizes <= hi)))
                for lo, hi in ((20, len(lab)), (20, 31), (32, 63))]

    print(f"science FoF vs the cKDTree oracle on the final particles "
          f"({links} links, {asym} pairs whose two directions disagree; "
          f"overflow {overflow}): {differ} labels differ; groups of >= 20, "
          f"20-31 and 32-63 particles: find_halos {bands(ours)}, oracle "
          f"{bands(oracle)}")
    check("science FoF oracle", overflow != 0 or differ == 0,
          f"{differ} labels differ from the oracle's")


def science_vs_tpu(cert: dict) -> None:
    """The run (ICs from PRNGKey(2026), the JAX run's key) beside the JAX
    package's TPU certificate SCIENCE.json: the low-k
    pk_table.ratio_over_growth bins (the same noise gives the same linear
    modes), the steps, the HMF geometric mean and the Layzer-Irvine worst
    residual."""
    with open(os.path.join(ROOT, "SCIENCE.json")) as f:
        tpu = json.load(f)
    k = cert["pk_table"]["k"][:6]
    ours = cert["pk_table"]["ratio_over_growth"][:6]
    theirs = tpu["pk_table"]["ratio_over_growth"][:6]
    print("science vs SCIENCE.json (TPU v5e): low-k ratio_over_growth "
          + "; ".join(f"k={a:.4f}: {b:.5f} vs {c:.5f}"
                      for a, b, c in zip(k, ours, theirs)))
    for name in ("hmf_band_gmean_vs_st", "layzer_irvine_worst_residual"):
        print(f"science vs SCIENCE.json: {name} {cert['checks'][name]['value']}"
              f" vs {tpu['checks'][name]['value']}")
    print(f"science vs SCIENCE.json: steps {cert['steps']} vs {tpu['steps']}")


def science_kernel_check(final, g, device, card):
    """K3 against its plain version on the science run's final state,
    bucketed afresh by the run's own engine plan (ncell 16, capacity 8192,
    vpu5; particles past a full cell's capacity are left out and counted),
    on 4096 sampled live rows, half of them from the fullest cell; the
    card's plan against its plain version; K1 and K2 against theirs on
    the same buckets, each timed there."""
    import torch
    from lambda_cdm_tpu_torch import science_run
    from lambda_cdm_tpu_torch.ops.bucketed_pm import live_counts
    eng = science_run.plan_engine(
        g, *(torch.from_numpy(final[k]).to(device) for k in
             ("pos_f", "vel_f", "masses")), float(final["a_f"]), device)
    fs, kw = eng._fstate, eng._fast_kw
    counts = live_counts(fs.bmass)
    sr = {k: kw[k] for k in ("ncell", "capacity", "box_size", "rs",
                             "softening", "variant")}
    err, rel, rows = k3_compare(fs.bpos, fs.bmass, counts, sr, 4096, seed=9,
                                heavy=True)
    plan_check(counts, kw["ncell"], "science run's final state")
    timing = science_run.short_range_timing(eng)
    print(f"K3 short_range (science run's final state: ncell {kw['ncell']}"
          f", capacity {kw['capacity']}, {kw['variant']}, fullest cell "
          f"{int(counts.max())}, {int(fs.overflow)} particles past capacity "
          f"left out by bucketing the final positions afresh, {rows} rows, "
          f"half from the fullest cell): "
          f"max_abs_err {err:.3e} (rel {rel:.3e}, tol "
          f"{TOL['short_range']:g}); {json.dumps(timing)} on {card}")
    check("K3 science", rel <= TOL["short_range"], f"rel err {rel} > tol")
    pm_kernel_check(fs.bpos, fs.bmass, counts, kw, device, card,
                    "science run's final state")


def pm_kernel_check(bpos, bmass, counts, kw, device, card, label):
    """K1 and K2 against their plain versions on one bucket layout (K2 on
    the potential of that deposit), plain's drop count, 0 on dead slots;
    both kernels timed eagerly and as CUDA graphs, beside their wrappers'
    memsets."""
    import torch
    from lambda_cdm_tpu_torch.ops import bucketed_pm, pm_rods
    ng, box = kw["ng"], kw["box_size"]
    geo = dict(ncell=kw["ncell"], ng=ng, box_size=box, margin=kw["margin"])
    grid_k, drop_k = pm_rods.cic_deposit(bpos, bmass, counts, **geo)
    grid_p, drop_p = pm_rods.cic_deposit_plain(bpos, bmass, counts, **geo)
    derr, drel = rel_err(grid_k, grid_p)
    green = bucketed_pm._greens(ng, float(box), float(kw["rs"]), str(device))
    phi = torch.fft.irfftn(green * torch.fft.rfftn(grid_p / (box / ng) ** 3),
                           s=(ng, ng, ng)).contiguous()
    del grid_k, grid_p
    acc_k = pm_rods.fd4_gather(phi, bpos, counts, **geo)
    acc_p = pm_rods.fd4_gather_plain(phi, bpos, counts, **geo)
    live = torch.arange(bmass.shape[1], device=device)[None] < counts[:, None]
    gerr, grel = rel_err(acc_k, acc_p, live[None])
    dead_max = float(torch.where(live[None], 0.0, acc_k).abs().max())
    del acc_k, acc_p

    def k1():
        return pm_rods.cic_deposit(bpos, bmass, counts, **geo)

    def k2():
        return pm_rods.fd4_gather(phi, bpos, counts, **geo)

    k1_ms, k2_ms = cuda_ms(k1, 10), cuda_ms(k2, 10)
    k1_dev, k2_dev = graph_ms(k1, 10), graph_ms(k2, 10)
    # the wrappers' memsets (the grid; K2's [3, C, K] output, which gives
    # the dead slots their 0), as CUDA graphs
    grid_set = graph_ms(lambda: torch.zeros((ng, ng, ng), device=device), 10)
    out_set = graph_ms(lambda: torch.zeros_like(bpos), 10)
    tiles = pm_rods.tile_plan(geo["ncell"], ng, geo["margin"])
    print(f"K1/K2 ({label}: ncell {geo['ncell']}, capacity "
          f"{bmass.shape[1]}, tiles {json.dumps(tiles)}, fullest cell "
          f"{int(counts.max())}): K1 max_abs_err {derr:.3e} "
          f"(rel {drel:.3e}, tol {TOL['cic_deposit']:g}), dropped kernel "
          f"{int(drop_k)} plain {int(drop_p)}, {k1_ms:.4f} ms eager, "
          f"{k1_dev:.4f} ms as a CUDA graph (grid memset {grid_set:.4f}); K2 "
          f"max_abs_err {gerr:.3e} on live slots (rel {grel:.3e}, tol "
          f"{TOL['fd4_gather']:g}), dead-slot max {dead_max:g}, "
          f"{k2_ms:.4f} ms eager, {k2_dev:.4f} ms as a CUDA graph (output "
          f"memset {out_set:.4f}) on {card}")
    check(f"K1 ({label})", drel <= TOL["cic_deposit"], f"rel err {drel}")
    check(f"K1 ({label})", int(drop_k) == int(drop_p), "drop counts differ")
    check(f"K2 ({label})", grel <= TOL["fd4_gather"], f"rel err {grel}")
    check(f"K2 ({label})", dead_max == 0.0, "dead slots not zero")


def direct_inputs(n: int, box: float, seed: int, device):
    """n particles uniform in the box (torch generator on the card), unit
    masses."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    pos = torch.rand((n, 3), generator=gen, device=device) * box
    return pos, torch.ones(n, device=device)


def k4_phase(device, card):
    """K4s's path first: pairwise_accelerations with variant sym and sym2
    at 100k, counts reset just before and read just after. Then K4 (v1,
    v2) and K4s (sym, sym2) at 100k against their plain versions, two
    calls equal, timed; K4 at ragged tiles and without the minimum image;
    K4s at small n (1, 2, 31, 33, one tile +- 1, two zero-mass rows),
    where a tile's k are cut into runs, on the half-box lattice and on
    positions spread over three boxes (its exact image); the range flag
    clear. Returns (the kernels' records, K4s's launches on its path)."""
    import torch
    from lambda_cdm_tpu_torch.ops import direct
    n, box, soft = 100_000, 100.0, 0.05
    pos, mass = direct_inputs(n, box, 41, device)
    failures = []
    out = {}
    reset_counts()
    path = {v: direct.pairwise_accelerations(pos, mass, box, soft, variant=v)
            for v in ("sym", "sym2")}
    torch.cuda.synchronize()
    launches = {"direct_sym": read_counts()["direct_sym"]}
    print(f"K4s path (sym, sym2 at N={n}): {launches['direct_sym']} "
          f"launches of direct_sym, {direct.sym_tiles(n)} tiles x "
          f"{direct.sym_runs(n)} runs = "
          f"{direct.sym_tiles(n) * direct.sym_runs(n)} blocks")
    check("K4s", launches["direct_sym"] == 2,
          f"{launches['direct_sym']} launches on its path (expected 2)",
          failures)
    for variant in direct.VARIANTS:
        kw = dict(periodic=True, variant=variant)
        name = "direct_sym" if variant.startswith("sym") else "direct"
        got = path.get(variant)
        if got is None:
            got = direct.pairwise_accelerations(pos, mass, box, soft, **kw)
        again = direct.pairwise_accelerations(pos, mass, box, soft, **kw)
        ref = direct.pairwise_accelerations_plain(pos, mass, box, soft, **kw)
        err, rel = rel_err(got, ref)
        check(f"K4 {variant}", bool(torch.equal(got, again)),
              "two calls differ", failures)
        ms = cuda_ms(lambda: direct.pairwise_accelerations(
            pos, mass, box, soft, **kw), 10)
        pms = cuda_ms(lambda: direct.pairwise_accelerations_plain(
            pos, mass, box, soft, **kw), 1, warmup=0)
        pairs = float(n) * n / (2 if name == "direct_sym" else 1)
        b_ms, b_by = bound(28.0 * n, DIRECT_FLOPS[name] * pairs)
        print(f"K4 {variant} at N={n}: max_abs_err {err:.3e} (rel "
              f"{rel:.3e}, tol {DIRECT_TOL[variant]:g}); kernel {ms:.4f} "
              f"ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{pairs:.3e} pairs) on {card}")
        check(f"K4 {variant}", rel <= DIRECT_TOL[variant],
              f"rel err {rel} > tol", failures)
        out[variant] = (err, rel, ms, pms, b_ms, b_by)

    def compare(label, variant, p, m, b, periodic=True, zero=()):
        kw = dict(periodic=periodic, variant=variant)
        got = direct.pairwise_accelerations(p, m, b, soft, **kw)
        _, rel = rel_err(got, direct.pairwise_accelerations_plain(
            p, m, b, soft, **kw))
        zeros = bool(torch.all(got[list(zero)] == 0)) if zero else True
        print(f"K4 {variant} {label} periodic={periodic}: rel {rel:.3e} "
              f"(tol {DIRECT_TOL[variant]:g})"
              + (f", zero-mass rows 0: {zeros}" if zero else ""))
        check(f"K4 {variant} {label}", rel <= DIRECT_TOL[variant]
              and bool(torch.isfinite(got).all()) and zeros,
              f"rel err {rel} > tol, or a zero-mass row not 0", failures)

    # ragged tiles (two and three of K4's 128) and no minimum image
    for m_n, periodic in ((200, True), (333, True), (4096, False)):
        p, m = direct_inputs(m_n, 20.0, m_n, device)
        for variant in ("v1", "sym"):
            compare(f"N={m_n}", variant, p, m, 20.0, periodic)
    # K4s around a warp's columns and one tile, two zero-mass rows
    for m_n in (1, 2, 31, 33, direct.SYM_TILE - 1, direct.SYM_TILE + 1):
        p, m = direct_inputs(m_n, 20.0, m_n + 5, device)
        zero = (0, m_n - 1) if m_n > 2 else ()
        m[list(zero)] = 0.0
        for variant in ("sym", "sym2"):
            for periodic in (True, False):
                compare(f"N={m_n}", variant, p, m, 20.0, periodic, zero)
    # a tile's five k cut into runs of 1, 2 and 2 (SYM_BLOCKS 27 at 2100)
    keep = direct.SYM_BLOCKS
    direct.SYM_BLOCKS = 27
    try:
        p, m = direct_inputs(2100, 20.0, 2100, device)
        for variant in ("sym", "sym2"):
            compare(f"N=2100 in {direct.sym_runs(2100)} runs a tile",
                    variant, p, m, 20.0)
    finally:
        direct.SYM_BLOCKS = keep
    # pairs one ulp past half a box; positions over three boxes
    lat, lm = (torch.from_numpy(a).to(device)
               for a in half_box_lattice(50.0, 8))
    compare("half-box lattice", "sym", lat, lm, 50.0)
    p, m = direct_inputs(3000, 20.0, 3000, device)
    for variant in ("sym", "sym2"):
        compare("over three boxes", variant, 3.0 * p - 20.0, m, 20.0)
    direct.check_range()
    if failures:
        raise AssertionError("K4 phase: " + "; ".join(failures))
    return out, launches


def direct_phase(device, card):
    """direct_10k.json at full size through the CLI's engine (energy and
    momentum observers on, output every 10), then its force accuracy."""
    import torch
    from lambda_cdm_tpu_torch import cli
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    tmp = tempfile.mkdtemp(prefix="lcdm_chip_smoke_direct_")
    try:
        cfg = SimulationConfig.from_file(DIRECT_CONFIG)
        rest = cfg.apply_cli_overrides([
            f"--simulation.output_directory={tmp}",
            f"--profiling.output_file={os.path.join(tmp, 'profile.json')}"])
        check("direct_10k", not rest, f"overrides not taken: {rest}")
        cfg.validate()
        reset_counts()
        t0 = time.perf_counter()
        eng = cli._build_engine(cfg, device=device)
        eng.initialize()
        eng.run()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = read_counts()
        st, stats = eng.state, eng.statistics
        n = st.num_particles
        steps = stats.total_steps
        ms_step = 1e3 * stats.compute_time_s / max(steps, 1)
        rate = n * steps / max(stats.compute_time_s, 1e-9)
        expect = steps + 1 + (2 if cfg.profiling.detailed_timing else 0)
        print(f"direct_10k: N={n} box={cfg.particles.box_size} softening "
              f"{cfg.forces.softening_length}; {steps} steps to a="
              f"{float(st.scale_factor):.5f} (z={float(st.redshift):.4f}) in "
              f"{t_run:.2f} s (compute {stats.compute_time_s:.3f} s, "
              f"{ms_step:.4f} ms/step, {rate:.4e} particle-updates/s; "
              f"observers {stats.analysis_time_s:.2f} s) on {card}")
        print(f"direct_10k: K4 launches {launches['direct']} (expected "
              f"{expect}: one at the start, one a step, two for the "
              f"force-fraction timing); final relative energy error "
              f"{eng.last_energy_error:.4e}")
        check("direct_10k", steps == cfg.time.max_steps, "steps not taken")
        check("direct_10k", launches["direct"] == expect,
              "K4 launch count differs")
        check("direct_10k", bool(torch.all(torch.isfinite(st.positions))),
              "non-finite positions")
        check("direct_10k", eng.last_energy_error is not None
              and eng.last_energy_error == eng.last_energy_error,
              "no energy error recorded")
        # the step's split: one K4 launch at this N against the step, and
        # K4 against its plain version on the final state (the kernels
        # line's K4 numbers: the shape of the path that launches it)
        from lambda_cdm_tpu_torch.ops import direct
        args = (st.positions, st.masses, cfg.particles.box_size,
                cfg.forces.softening_length, cfg.units.G)
        k_ms = cuda_ms(lambda: direct.pairwise_accelerations(*args), 20)
        got = direct.pairwise_accelerations(*args)
        again = direct.pairwise_accelerations(*args)
        ref = direct.pairwise_accelerations_plain(*args)
        err, rel = rel_err(got, ref)
        p_ms = cuda_ms(lambda: direct.pairwise_accelerations_plain(*args), 3)
        direct.check_range()
        b_ms, b_by = bound(28.0 * n, DIRECT_FLOPS["direct"] * float(n) * n)
        print(f"direct_10k: K4 at N={n} ({direct.j_slices(n)} j slices) "
              f"{k_ms:.4f} ms a launch (CUDA events, mean of 20; bound "
              f"{b_ms:.4f} ms, {b_by}): {100 * k_ms / ms_step:.1f}% of the "
              f"step; the rest is the fused KDK's elementwise launches and "
              f"its host-side scale-factor arithmetic; on the final state "
              f"max_abs_err {err:.3e} (rel {rel:.3e}, tol "
              f"{DIRECT_TOL['v1']:g}) against plain ({p_ms:.4f} ms), two "
              f"calls {'equal' if torch.equal(got, again) else 'DIFFER'}")
        check("direct_10k K4", rel <= DIRECT_TOL["v1"], f"rel err {rel}")
        check("direct_10k K4", bool(torch.equal(got, again)),
              "two calls differ")
        res = eng.validate_force_accuracy(n_sample=1024)
        print(f"direct_10k force validation (1024 targets): scale-normalized"
              f" avg {res['avg_err']:.4e} max {res['max_err']:.4e} against "
              f"the plain min-image oracle")
        check("direct_10k", res["max_err"] < 1e-4, "K4 forces disagree")
        return launches, (err, rel, k_ms, p_ms, b_ms, b_by)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def stateless_phase(device, card):
    """pm_128_256.json and basic_lambda_cdm.json at full size, 10 steps
    each, through SimulationBuilder; plain PyTorch (no TPU kernel on
    these paths), with validate_force_accuracy and peak memory. Returns
    (ms/step, the validation's result) by config path."""
    import torch
    from lambda_cdm_tpu_torch import SimulationBuilder
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.forces import auto_pm_grid
    from lambda_cdm_tpu_torch.forces.treepm import treepm_plan
    out = {}
    for path in (PM_CONFIG, TREEPM_CONFIG):
        cfg = SimulationConfig.from_file(path)
        cfg.profiling.output_file = ""
        cfg.io.diagnostics.energy_conservation = False
        n = cfg.particles.num_particles
        ng = auto_pm_grid(cfg)
        t0 = time.perf_counter()
        eng = SimulationBuilder(device=device).with_config(cfg).build()
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        eng.run(num_steps=10)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stats = eng.statistics
        ms_step = 1e3 * stats.compute_time_s / max(stats.total_steps, 1)
        extra = ""
        if cfg.forces.type == "treepm":
            plan = treepm_plan(n, cfg.particles.box_size, ng,
                               split_factor=cfg.forces.split_factor,
                               cut_factor=cfg.forces.cut_factor,
                               capacity=cfg.forces.bucket_capacity)
            extra = (f", plan ncell {plan['ncell']} capacity "
                     f"{plan['capacity']}")
        res = eng.validate_force_accuracy(n_sample=1024)
        rate = n * stats.total_steps / max(stats.compute_time_s, 1e-9)
        print(f"{os.path.basename(path)} ({cfg.forces.type}, plain PyTorch: "
              f"no TPU kernel on this path): N={n} ng={ng}{extra}; init "
              f"{t_init:.2f} s; {stats.total_steps} steps {ms_step:.3f} "
              f"ms/step, {rate:.4e} particle-updates/s, peak memory {peak:.2f} GiB on {card}; "
              f"force validation (1024 targets, min-image oracle): avg "
              f"{res['avg_err']:.4e} max {res['max_err']:.4e}")
        check(path, stats.total_steps == 10, "steps not taken")
        check(path, bool(torch.all(torch.isfinite(eng.state.positions))),
              "non-finite positions")
        check(path, res["n_sample"] == 1024 and math.isfinite(
            res["max_err"]), "force validation failed")
        out[path] = (ms_step, res)
        del eng
    return out


# the stateless reference check: the card's 8-step direct run against the
# CPU's, positions relative to the box and velocities to max |v|. On the
# H100 sound runs read at most 1.5e-6 in velocity (1.2e-4 while K4 took
# the image of d * (1/box), which differs from the CPU's d / box for some
# pairs half a box apart); a planted K4 fault of G 0.1% high reads 3.0e-4
# and one without the minimum image 1.7
REF_SEEDS = (6, 7, 8)
REF_TOL = {"pos": 1e-5, "vel": 1e-5}
# a pair about half a box apart takes the minimum image that the last bit
# of its positions decides, so two runs whose sums round otherwise can
# take the two images of it at one step (seed 7's state, since the ICs
# draw the JAX package's stream, does so at step 6). The rows of such
# pairs are left out of the comparison, at most REF_MAX_FLIP_ROWS (a
# sound run flips one pair; a faulty force moves every particle and flips
# many), and only where K4's plain arithmetic run on the CPU (the
# witness) flips the same pairs against the CPU sum: then the difference
# is the minimum image's discontinuity, not the card
REF_MAX_FLIP_ROWS = 8


def image_flip_pairs(traj_a, traj_b, box: float) -> list:
    """[(i, j)], i < j: the pairs whose minimum image (round(d / box)
    along an axis) differs between two runs' positions at some step."""
    import torch
    box_t = torch.tensor(box, dtype=torch.float32)
    n = traj_a[0].shape[0]
    flip = torch.zeros((n, n), dtype=torch.bool)
    for pa, pb in zip(traj_a, traj_b):
        for c in range(3):
            flip |= (torch.round((pa[None, :, c] - pa[:, None, c]) / box_t)
                     != torch.round((pb[None, :, c] - pb[:, None, c])
                                    / box_t))
    i, j = torch.nonzero(torch.triu(flip, 1), as_tuple=True)
    return list(zip(i.tolist(), j.tolist()))


def _k4_solver(g_factor: float, periodic: bool):
    """A `direct` solver builder that calls K4's wrapper (ops/direct) with
    G scaled by `g_factor` and the minimum image on or off, registered in
    place of the solver for one run (the config accepts only the built-in
    names): a planted fault on the card, or, at (1, True) on the CPU, K4's
    plain arithmetic (the witness)."""
    def build(config):
        from lambda_cdm_tpu_torch.ops import direct
        box, soft = config.particles.box_size, config.forces.softening_length
        g = config.units.G * g_factor

        def accel_fn(state):
            return direct.pairwise_accelerations(
                state.positions, state.masses, box, soft, g,
                periodic=periodic)
        return accel_fn
    return build


def stateless_reference_check(device):
    """A 4096-particle direct run of 8 steps on the card (K4) against the
    CPU (the solver's row-blocked sum) from three seeds' states, in chunks
    of one step (the positions after every step find the pairs whose
    image flips) and, bit for bit the same on the card, in chunks of 4
    fused steps; where pairs flip, K4's plain arithmetic on the CPU as the
    witness; two planted K4 faults that the check must see; then pm and
    treepm accelerations of one state on both."""
    import torch
    from lambda_cdm_tpu_torch import Observer, SimulationBuilder, forces
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.forces import create_force_computer, \
        register_force_computer
    from lambda_cdm_tpu_torch.physics.initial_conditions import \
        generate_state
    cfg = SimulationConfig.from_dict({
        "forces": {"type": "direct", "softening_length": 0.1,
                   "pm_grid_size": 32},
        "particles": {"num_particles": 4096, "box_size": 50.0},
        "cosmology": {"initial_redshift": 9.0},
        "time": {"initial_timestep": 2e-5},
        "simulation": {"output_frequency": 1, "checkpoint_frequency": 0},
        "profiling": {"output_file": ""},
        "logging": {"performance_logging": False}})
    box = cfg.particles.box_size
    faults = {"G 0.1% high": (1.001, True), "no minimum image": (1.0, False)}

    class Trajectory(Observer):
        """The positions at the end of every chunk."""

        def __init__(self):
            self.positions = []

        def on_step_end(self, engine, step):
            self.positions.append(engine.state.positions.detach().cpu())

    def run(dev, st0, chunk=1, solver=None):
        traj = Trajectory()
        cfg.simulation.output_frequency = chunk
        default = forces._REGISTRY["direct"]
        if solver is not None:
            register_force_computer("direct")(solver)
        try:
            eng = (SimulationBuilder(device=dev).with_config(cfg)
                   .with_initial_state(st0).with_observer(traj).build())
            st = eng.run(num_steps=8)
        finally:
            register_force_computer("direct")(default)
        return st.positions.cpu(), st.velocities.cpu(), traj.positions

    def errs(got, ref):
        """(positions, velocities, velocities with no row left out, the
        pairs whose image flips) of a run against the CPU's."""
        (gp, gv, gt), (cp, cv, ct) = got, ref
        pairs = image_flip_pairs(gt, ct, box)
        keep = torch.ones(gp.shape[0], dtype=torch.bool)
        keep[[k for pair in pairs for k in pair]] = False
        keep = keep[:, None]
        d = torch.remainder(gp - cp + box / 2, box) - box / 2
        vmax = cv.abs().max()
        return (float(torch.where(keep, d.abs(), 0.0).max()) / box,
                float(torch.where(keep, (gv - cv).abs(), 0.0).max() / vmax),
                float((gv - cv).abs().max() / vmax), pairs)

    def within(p, v, _, pairs):
        rows = len({k for pair in pairs for k in pair})
        return (p <= REF_TOL["pos"] and v <= REF_TOL["vel"]
                and rows <= REF_MAX_FLIP_ROWS)

    ic = cfg.particles.initial_conditions
    ic.type, ic.grid_size = "2lpt", 16
    sound, fused, witness, planted = {}, {}, {}, {}
    for seed in REF_SEEDS:
        ic.random_seed = seed
        st0 = generate_state(cfg, device="cpu")
        ref = run("cpu", st0)
        card = run(device, st0)
        sound[seed] = errs(card, ref)
        four = run(device, st0, chunk=4)
        fused[seed] = (torch.equal(four[0], card[0])
                       and torch.equal(four[1], card[1]))
        if sound[seed][3]:
            witness[seed] = errs(run("cpu", st0, solver=_k4_solver(1.0, True)),
                                 ref)
        if seed == REF_SEEDS[0]:
            first = st0
            for name, args in faults.items():
                planted[name] = errs(run(device, st0,
                                         solver=_k4_solver(*args)), ref)
    acc = {}
    for kind in ("pm", "treepm"):
        cfg.forces.type = kind
        fn = create_force_computer(cfg)
        a_g = fn(first.replace(positions=first.positions.to(device),
                               velocities=first.velocities.to(device),
                               masses=first.masses.to(device))).cpu()
        acc[kind] = rel_err(a_g, fn(first))[1]
    print("stateless reference check (4096 particles, direct, 8 steps, "
          "card K4 vs CPU row-blocked sum): " + "; ".join(
              f"seed {k}: positions {p:.3e} of the box, velocities {v:.3e} "
              f"of max |v| ({vall:.4e} with no row left out; the pairs whose "
              f"image differs, their rows left out: {pairs}); chunks of 4 "
              f"bit for bit those of 1: {fused[k]}"
              for k, (p, v, vall, pairs) in sound.items())
          + f" (tol {REF_TOL['pos']:g} / {REF_TOL['vel']:g}, at most "
          f"{REF_MAX_FLIP_ROWS} rows left out)")
    for k, (p, v, vall, pairs) in witness.items():
        print(f"stateless reference witness, seed {k}: K4's plain arithmetic "
              f"on the CPU against the CPU sum: velocities {vall:.4e} of max "
              f"|v| with no row left out, {v:.3e} without the rows of its "
              f"flipped pairs {pairs}, positions {p:.3e}; the card's "
              f"flipped pairs {sound[k][3]}")
    print("stateless reference planted K4 faults: " + "; ".join(
              f"{k}: positions {p:.3e}, velocities {v:.3e}, "
              f"{len(pairs)} flipped pairs"
              for k, (p, v, _, pairs) in planted.items())
          + f"; one state's accelerations card vs CPU: pm {acc['pm']:.3e}, "
          f"treepm {acc['treepm']:.3e} (tol 1e-4)")
    check("stateless reference", all(within(*r) for r in sound.values()),
          "card and CPU direct runs disagree")
    check("stateless reference", all(fused.values()),
          f"chunks of 4 steps differ from chunks of 1 on the card: {fused}")
    check("stateless reference", all(
        within(*witness[k]) and set(sound[k][3]) <= set(witness[k][3])
        for k in witness),
        "the card's flipped pairs are not K4's arithmetic's on the CPU")
    check("stateless reference", not any(
        within(*r) for r in planted.values()),
        "a planted K4 fault passes the check")
    check("stateless reference", max(acc.values()) <= 1e-4,
          "pm/treepm card and CPU accelerations disagree")


# the lensing phase. K6/K7 against their plain version, relative to the
# plain result's largest |value| (the kernel combines the weights in the
# plain version's order without FMAs, so it reads 0 where both round
# alike); the card's windowed trace against the CPU's at the BASELINE
# lensing bar (`acc_lens`, 1e-3 of the largest |kappa|)
LENS_TOL = 1e-5
LENS_MAPS_TOL = 1e-3
# float operations counted from csrc/lens_sample.cu: per ray (the grid
# coordinates' two quotients and two products, two shifts, two floors,
# four weight differences), per ray and channel (8 products, 3 sums); the
# trace's per ray and plane (the impact position's two products, the
# sampler's 12, the deflection's two quotients and two sums, kappa's
# three operations; the Jacobian's 16 products and sums) besides its
# samples
LENS_FLOPS = (12, 11)
TRACE_FLOPS = (21, 16)
LENS_BOX = 100.0
# the most device launches (kernels, copies, fills) a lens plane of a
# trace may take, given its plane fields
TRACE_LAUNCHES_A_PLANE = 3


def graph_ms(fn, reps: int = 50) -> float:
    """Device milliseconds per call of fn(), from one CUDA graph of `reps`
    calls replayed (no host launch gaps: these calls take microseconds,
    less than PyTorch's eager launch path)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lens_counts() -> dict:
    from lambda_cdm_tpu_torch.ops import lens_sample
    return dict(lens_sample.launches)


def device_launches(fn, tries: int = 4) -> int:
    """Device activities (kernels, copies, fills) of one fn() call as
    torch.profiler records them; a window in which it recorded none is
    taken again, up to `tries` times (0: none recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        if n:
            return n
    return 0


def touched_cells(xy, extent, ng: int) -> int:
    """The distinct cells among the four corners of every point's bilinear
    sample: what a gather at xy must read of each [ng, ng] channel."""
    import torch
    from lambda_cdm_tpu_torch.ops import lens_sample as ls
    i0 = torch.floor(ls.grid_coords(xy, extent, ng) - 0.5).long()
    ids = [torch.remainder(i0[:, 0] + a, ng) * ng
           + torch.remainder(i0[:, 1] + b, ng) for a in (0, 1) for b in (0, 1)]
    return int(torch.unique(torch.cat(ids)).numel())


def trace_touched(fl, theta0, chis, weights, box, window: int) -> int:
    """The cells a trace must read, summed over its planes: each plane's
    touched_cells at the impact positions of the plain trace."""
    import torch
    from lambda_cdm_tpu_torch.ops import lens_sample as ls
    theta, kap = theta0, torch.zeros_like(theta0[:, 0])
    total = 0
    for idx in range(fl.shape[0]):
        xy = theta * chis[idx]
        if window == 0:
            xy = torch.remainder(xy, box)
        total += touched_cells(xy, box, fl.shape[-1])
        theta, kap, _ = ls.plane_step_plain(fl[idx], theta, kap, None,
                                            chis[idx], weights[idx], 100.0,
                                            box, wrap=window == 0)
    return total


def lens_bench_geometry(ng: int, n_planes: int, n_side: int, chis, a_l,
                        seed: int, device):
    """bench.py's lensing geometry: planes of 0.2 unit normals (numpy from
    `seed`), plane distances and scale factors, and a grid-ordered bundle
    of n_side^2 rays over box / 2000 radians."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy((0.2 * rng.standard_normal(
        (n_planes, ng, ng))).astype(np.float32)).to(device)
    ang = ((np.arange(n_side) + 0.5) * (LENS_BOX / 2000.0) / n_side) \
        .astype(np.float32)
    theta0 = np.stack(np.meshgrid(ang, ang, indexing="ij"),
                      -1).reshape(-1, 2)
    return (planes, torch.tensor(np.asarray(chis, np.float32), device=device),
            torch.tensor(np.asarray(a_l, np.float32), device=device),
            torch.from_numpy(theta0).to(device))


def grid_sample_inputs(fields, xy, extent):
    """The library yardstick's inputs: the stack padded by one wrapped row
    and column [1, F, ng+1, ng+1], and the points' wrapped cell-centred
    coordinates mapped to grid_sample's align_corners=False frame (x of
    grid_sample runs along the last, y axis of field[ix, iy])."""
    import torch
    ng = fields.shape[-1]
    pad = torch.cat([fields, fields[:, :1]], dim=1)
    pad = torch.cat([pad, pad[:, :, :1]], dim=2)[None].contiguous()
    ext = torch.tensor(float(extent), device=xy.device)
    v = torch.remainder(xy / ext * ng - 0.5, ng)
    norm = (2.0 * v + 1.0) / (ng + 1) - 1.0
    grid = torch.stack([norm[:, 1], norm[:, 0]], -1)[None, None].contiguous()
    return pad, grid


def lens_kernel_phase(fields_by_shape, device, card):
    """K6 and K7 against their plain version at the bench's shapes (R =
    65,536 grid-ordered rays at F = 3 and 6 on 256^2, F = 3 on 512^2), a
    ragged R of 700 with points on the periodic edges, and an unwrapped
    coherent bundle through the windowed entry; one device launch a call;
    each timed as one CUDA graph of calls and eagerly, with grid_sample
    beside it; the bound reads the cells the points touch."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from lambda_cdm_tpu_torch.ops import lens_sample as ls
    ext = torch.tensor(LENS_BOX, device=device)
    failures = []
    err = {"lens_sample": 0.0, "lens_sample_xwin": 0.0}
    rec = {}
    rng = np.random.default_rng(51)
    for (ng, n_f), (fields, xy) in fields_by_shape.items():
        n_rays = xy.shape[0]
        cases = [("lens_sample", torch.remainder(xy, LENS_BOX),
                  lambda f, p: ls.bilinear_sample_fields(f, p, ext)),
                 ("lens_sample_xwin", xy,
                  lambda f, p: ls.bilinear_sample_fields_xwin(
                      f, p, ext, window=ng // 2))]
        for name, pts, fn in cases:
            got = fn(fields, pts)
            ref = ls.bilinear_sample_fields_plain(fields, pts, ext)
            e, rel = rel_err(got, ref)
            err[name] = max(err[name], e)
            check(name, rel <= LENS_TOL, f"{ng}^2 F={n_f}: rel err {rel}",
                  failures)
            n_launch = device_launches(lambda: fn(fields, pts))
            check(name, n_launch == 1, f"{n_launch} device launches a call",
                  failures)
            ms = graph_ms(lambda: fn(fields, pts))
            pms = graph_ms(lambda: ls.bilinear_sample_fields_plain(
                fields, pts, ext), reps=10)
            pad, grid = grid_sample_inputs(fields, pts, LENS_BOX)
            lib = F.grid_sample(pad, grid, mode="bilinear",
                                padding_mode="border",
                                align_corners=False)[0, :, 0]
            _, lib_rel = rel_err(lib, ref)
            lms = graph_ms(lambda: F.grid_sample(
                pad, grid, mode="bilinear", padding_mode="border",
                align_corners=False))
            eager = cuda_ms(lambda: fn(fields, pts), 50)
            b_ms, b_by = bound(n_rays * (8 + 4 * n_f)
                               + 4 * n_f * touched_cells(pts, ext, ng),
                               n_rays * (LENS_FLOPS[0] + LENS_FLOPS[1]
                                         * n_f))
            print(f"{name} ({ng}^2, F={n_f}, R={n_rays}): max_abs_err "
                  f"{e:.3e} (rel {rel:.3e}, tol {LENS_TOL:g}); kernel "
                  f"{ms:.5f} ms a call (graph; eager {eager:.5f}; "
                  f"{n_launch} device launch), plain "
                  f"{pms:.5f}, grid_sample {lms:.5f} (rel {lib_rel:.1e} "
                  f"off), bound {b_ms:.5f} ms ({b_by}) on {card}")
            if (ng, n_f) == (256, 3):
                rec[name] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                                 bound_ms=b_ms, bound_by=b_by)
    # a ragged R with points on the periodic edges (K6), and a coherent
    # bundle whose x runs unwrapped from -0.25 to 1.1 box (K7)
    fields = fields_by_shape[(256, 3)][0]
    edge = np.array([[0.0, 0.0], [LENS_BOX - 1e-3, LENS_BOX - 1e-3],
                     [0.01, LENS_BOX - 0.01], [LENS_BOX / 2, 0.0],
                     [LENS_BOX, LENS_BOX / 3]])
    pts = np.concatenate([edge, rng.uniform(0, LENS_BOX, (695, 2))])
    n = 40_000
    x = (-0.25 + 1.35 * np.arange(n) / n) * LENS_BOX \
        + rng.uniform(0, 0.01 * LENS_BOX, n)
    coh = np.stack([x, rng.uniform(0, LENS_BOX, n)], 1)
    for name, p, fn in (
            ("lens_sample", pts, ls.bilinear_sample_fields),
            ("lens_sample_xwin", coh, lambda f, q, e: (
                ls.bilinear_sample_fields_xwin(f, q, e, window=96)))):
        p = torch.from_numpy(p.astype(np.float32)).to(device)
        e, rel = rel_err(fn(fields, p, ext),
                         ls.bilinear_sample_fields_plain(fields, p, ext))
        err[name] = max(err[name], e)
        print(f"{name} (256^2, F=3, R={p.shape[0]}, "
              f"{'edge points' if name == 'lens_sample' else 'x unwrapped'}"
              f"): max_abs_err {e:.3e} (rel {rel:.3e})")
        check(name, rel <= LENS_TOL, f"R={p.shape[0]}: rel err {rel}",
              failures)
    if failures:
        raise AssertionError("lens kernel phase: " + "; ".join(failures))
    for name in rec:
        rec[name]["max_abs_err"] = err[name]
    return rec


def trace_kernel_phase(traces, params, device, card):
    """The trace kernel (lens_sample.trace_planes on the card: both routes,
    wrapped impact positions as K6 takes them and unwrapped as K7 does) at
    each of the lensing bench's geometries against its plain version run
    on the card from the same arrays (trace_planes_plain: PyTorch's own
    elementwise ops, so every output is held bit for bit), each timed as
    a CUDA graph of calls; its bound reads the cells its rays touch
    (trace_touched) and writes the bundle. Returns the kernels line's
    records of the two routes (256^2, Jacobian off)."""
    import torch
    from lambda_cdm_tpu_torch.ops import lens_sample as ls
    from lambda_cdm_tpu_torch.raytracing import lensing
    box = torch.tensor(LENS_BOX, device=device)
    chi_s = torch.tensor(2500.0, device=device)
    failures = []
    rec = {}
    for (ng, jac), (fl, chis, a_l, theta0, w) in traces.items():
        weights = lensing.lensing_efficiency(params, chis, chi_s, a_l)
        n_planes, n_f = fl.shape[0], fl.shape[1]
        n_rays = theta0.shape[0]
        routes = (("lens_trace", 0),) + ((("lens_trace_xwin", w),) if w
                                         else ())
        for name, window in routes:
            def fused():
                return ls.trace_planes(fl, theta0, chis, weights, 100.0,
                                       LENS_BOX, chi_s, jacobian=jac,
                                       window=window)

            def plain():
                return ls.trace_planes_plain(fl, theta0, chis, weights,
                                             100.0, box, chi_s,
                                             jacobian=jac, window=window)
            got, ref = fused(), plain()
            diff = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
            same = all(torch.equal(got[k], ref[k]) for k in ref)
            check(name, same, f"{ng}^2 jacobian={jac}: differs from its "
                  f"plain version {json.dumps(diff)}", failures)
            ms = graph_ms(fused, reps=20)
            pms = graph_ms(plain, reps=3)
            n_out = 20 + (20 if jac else 0)
            used = 6 if jac else 3
            cells = trace_touched(fl, theta0, chis, weights, box, window)
            b_ms, b_by = bound(
                n_rays * (8 + n_out) + 4 * used * cells,
                n_rays * n_planes * (TRACE_FLOPS[0] + LENS_FLOPS[1] * used
                                     + (TRACE_FLOPS[1] if jac else 0)))
            print(f"{name} ({ng}^2, {n_planes} planes, F={n_f}, jacobian "
                  f"{jac}, R={n_rays}, window {window}): "
                  f"{'equal to' if same else 'differs from'} its plain "
                  f"version on the card; kernel {ms:.5f} ms a trace "
                  f"(graph), plain {pms:.5f}, bound {b_ms:.5f} ms ({b_by}) "
                  f"on {card}")
            if (ng, jac) == (256, False):
                rec[name] = dict(ms=ms, plain_ms=pms, library_ms=None,
                                 bound_ms=b_ms, bound_by=b_by,
                                 max_abs_err=max(diff.values()))
    if failures:
        raise AssertionError("trace kernel phase: " + "; ".join(failures))
    return rec


def lens_bench_phase(params, device, card):
    """bench.py section_lensing: lens_plane_fields then trace_rays at 16
    planes and 65,536 rays, 256^2 with the Jacobian off and on, and 512^2,
    with auto_sample_window's window; rays/s on the host clock, one launch
    of the trace kernel a trace, and the trace's device launches a plane.
    Returns (the launches of one trace of each, each configuration's last
    plane and its impact positions: the K6/K7 inputs of the kernel phase,
    and each configuration's trace inputs)."""
    import torch
    from lambda_cdm_tpu_torch.ops import lens_sample
    from lambda_cdm_tpu_torch.raytracing import lensing
    n_planes = 16
    total = dict.fromkeys(lens_sample.launches, 0)
    kernel_inputs, traces = {}, {}
    for ng, jac in ((256, False), (256, True), (512, False)):
        planes, chis, a_l, theta0 = lens_bench_geometry(
            ng, n_planes, 256, torch.linspace(400.0, 1900.0, n_planes),
            torch.linspace(0.9, 0.55, n_planes), 2, device)
        fl = lensing.lens_plane_fields(params, planes, chis, a_l, 100.0,
                                       LENS_BOX, 2500.0, ng=ng, jacobian=jac)
        w = lensing.auto_sample_window(fl, chis, theta0, LENS_BOX, ng=ng)

        def trace():
            return lensing.trace_rays(params, planes, chis, a_l, 100.0,
                                      LENS_BOX, theta0, 2500.0, ng=ng,
                                      jacobian=jac, window=w, fields_l=fl)
        b = trace()
        torch.cuda.synchronize()
        lens_sample.reset_launch_counts()
        trace()
        torch.cuda.synchronize()
        counts = lens_counts()
        for k in total:
            total[k] += counts[k]
        n_dev = device_launches(trace)
        t0 = time.perf_counter()
        for _ in range(10):
            trace()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 10
        n_rays = theta0.shape[0]
        name = "lens_trace_xwin" if w > 0 else "lens_trace"
        print(f"lensing bench {ng}^2 jacobian={jac} ({n_rays} rays x "
              f"{n_planes} planes, window {w}): {1e3 * dt:.3f} ms a trace "
              f"= {n_rays / dt:.4e} rays/s on {card}; {n_dev} device "
              f"launches a trace ({n_dev / n_planes:.3f} a plane); launches "
              f"{json.dumps(counts)}")
        check("lensing bench", counts[name] == 1
              and sum(counts.values()) == 1,
              "not one trace kernel launch a trace")
        check("lensing bench",
              0 < n_dev <= TRACE_LAUNCHES_A_PLANE * n_planes,
              f"{n_dev} device launches a trace of {n_planes} planes")
        check("lensing bench", bool(torch.all(torch.isfinite(b.kappa))),
              "non-finite kappa")
        kernel_inputs[(ng, fl.shape[1])] = (fl[-1], theta0 * chis[-1])
        traces[(ng, jac)] = (fl, chis, a_l, theta0, w)
    return total, kernel_inputs, traces


def _lens_accuracy_inputs(device):
    """bench.py's accuracy geometry (8 planes of 0.2 normals, 256^2, 128^2
    rays, chis 400 -> 1100)."""
    import torch
    return lens_bench_geometry(256, 8, 128, torch.linspace(400.0, 1100.0, 8),
                               torch.linspace(0.9, 0.7, 8), 3, device)


def lens_accuracy_phase(params, device):
    """The card's windowed trace against the port's CPU trace from the same
    arrays, at the BASELINE bar; then the same card trace with a planted
    fault (every impact position half a cell off in x inside the trace
    kernel) that the check must see. Returns the sound trace's
    launches."""
    import torch
    from lambda_cdm_tpu_torch.ops import lens_sample
    from lambda_cdm_tpu_torch.raytracing import lensing
    planes, chis, a_l, theta0 = _lens_accuracy_inputs(device)
    ng = planes.shape[-1]
    lens_sample.reset_launch_counts()
    fl = lensing.lens_plane_fields(params, planes, chis, a_l, 100.0,
                                   LENS_BOX, 2500.0, ng=ng)
    w = lensing.auto_sample_window(fl, chis, theta0, LENS_BOX, ng=ng)

    def card_kappa():
        return lensing.trace_rays(params, planes, chis, a_l, 100.0, LENS_BOX,
                                  theta0, 2500.0, ng=ng, window=w,
                                  fields_l=fl).kappa.cpu()
    kap = card_kappa()
    counts = lens_counts()
    ref = lensing.trace_rays(params, planes.cpu(), chis.cpu(), a_l.cpu(),
                             100.0, LENS_BOX, theta0.cpu(), 2500.0,
                             ng=ng).kappa
    _, err = rel_err(kap, ref)

    sound = lens_sample.trace_planes

    def half_cell(*args, **kw):
        return sound(*args, **dict(kw, x_offset=0.5 * LENS_BOX / ng))
    lens_sample.trace_planes = half_cell
    try:
        _, fault = rel_err(card_kappa(), ref)
    finally:
        lens_sample.trace_planes = sound
    print(f"lensing accuracy (8 planes, 256^2, 128^2 rays, window {w}): "
          f"card kappa vs the CPU trace {err:.3e} of max |kappa| (tol "
          f"{LENS_MAPS_TOL:g}); planted fault (impact positions half a cell "
          f"off in x): {fault:.3e}; launches {json.dumps(counts)}")
    check("lensing accuracy", w > 0, "no window: the windowed route was "
          "not taken")
    check("lensing accuracy", err <= LENS_MAPS_TOL,
          "card and CPU traces disagree")
    check("lensing accuracy", fault > LENS_MAPS_TOL,
          "the planted sampler fault passes the check")
    return counts


def lens_limber_phase(params, device, card):
    """tests/test_lensing_limber.py::test_traced_cl_matches_limber on the
    card: 8 planes (ng 256, 300 Mpc/h) drawn from the linear P(k) with
    numpy white noise, traced on 128^2 rays, three realisations, against
    the discretized Limber sum and the continuous Limber C_ell, at that
    test's bars. Returns the traces' launches."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.analysis.power_spectrum import \
        angular_power_spectrum
    from lambda_cdm_tpu_torch.ops import lens_sample
    from lambda_cdm_tpu_torch.physics.cosmology import scale_factor_at_chi
    from lambda_cdm_tpu_torch.physics.power_spectra import linear_power
    from lambda_cdm_tpu_torch.raytracing import lensing
    ng, box, n_planes, n_side, n_real = 256, 300.0, 8, 128, 3
    chis = torch.linspace(600.0, 2000.0, n_planes, device=device)
    d_chi = float(chis[1] - chis[0])
    a_l = scale_factor_at_chi(params, chis / params.h)
    z_l = 1.0 / a_l - 1.0
    chi_s, fov = 2330.0, 0.15
    ang = (torch.arange(n_side, dtype=torch.float32, device=device)
           + 0.5) * fov / n_side
    theta0 = torch.stack(torch.meshgrid(ang, ang, indexing="ij"),
                         -1).reshape(-1, 2)
    q_nyq = math.pi * ng / box
    ell_max = 0.25 * q_nyq * float(chis[0])
    ell_min = 3.0 * 2.0 * math.pi / fov
    kw = dict(num_bins=4, ell_min=ell_min, ell_max=ell_max)
    qx = 2.0 * math.pi * torch.fft.fftfreq(ng, d=box / ng, device=device)
    qy = 2.0 * math.pi * torch.fft.rfftfreq(ng, d=box / ng, device=device)
    q = torch.sqrt(qx[:, None] ** 2 + qy[None, :] ** 2)
    lens_sample.reset_launch_counts()
    cl_sum = 0.0
    for r in range(n_real):
        rng = np.random.default_rng(100 + r)
        planes = []
        for li in range(n_planes):
            p2d = linear_power(params, torch.clamp(q, min=1e-8),
                               z=float(z_l[li])) / d_chi
            amp = torch.where(q > 0, torch.sqrt(p2d), 0.0)
            white = torch.from_numpy(rng.standard_normal((ng, ng)).astype(
                np.float32)).to(device)
            planes.append(torch.fft.irfftn(torch.fft.rfftn(white) * amp
                                           * (ng / box), s=(ng, ng)))
        b = lensing.trace_rays(params, torch.stack(planes), chis, a_l, d_chi,
                               box, theta0, chi_s, ng=ng)
        ell, cl, counts = angular_power_spectrum(
            b.kappa.reshape(n_side, n_side), fov, **kw)
        cl_sum = cl_sum + cl.double()
    launches = lens_counts()
    cl_meas = (cl_sum / n_real).cpu().numpy()
    counts = counts.cpu().numpy()
    w = lensing.lensing_efficiency(params, chis, chi_s, a_l)
    k_grid = (ell[:, None] + 0.5) / chis[None, :]
    p = linear_power(params, k_grid, z=z_l[None, :])
    cl_theory = (torch.sum((w / chis)[None, :] ** 2 * p, dim=1)
                 * d_chi).cpu().numpy()
    ratio = cl_meas / cl_theory
    sig = np.sqrt(2.0 / np.maximum(counts * n_real, 1.0))
    band = float(np.exp(np.mean(np.log(ratio))))
    cl_cont = lensing.limber_convergence_cl(params, ell, 1.0).cpu().numpy()
    r2 = cl_cont / cl_theory
    print(f"lensing Limber (ng {ng}, {n_planes} planes, {n_side}^2 rays, "
          f"{n_real} realisations) on {card}: ell "
          f"{np.array2string(ell.cpu().numpy(), precision=1)}, measured / "
          f"discrete Limber {np.array2string(ratio, precision=3)} (bars "
          f"max(5 sigma, 0.35): {np.array2string(np.maximum(5 * sig, 0.35), precision=3)}), "
          f"band ratio {band:.4f} (bar 0.15), continuous / discrete "
          f"{np.array2string(r2, precision=3)} (0.6-1.6); launches "
          f"{json.dumps(launches)}")
    check("lensing Limber", bool(np.all(np.abs(ratio - 1.0)
                                        < np.maximum(5.0 * sig, 0.35))),
          "a bin off the Limber C_ell")
    check("lensing Limber", abs(band - 1.0) < 0.15, f"band ratio {band}")
    check("lensing Limber", bool(np.all((r2 > 0.6) & (r2 < 1.6))),
          "continuous and discrete Limber C_ell disagree")
    return launches


def weak_field(maps) -> dict:
    """The weak-field readings of tests/test_lensing.py on ray-traced maps:
    kappa's rms `ks`, the bar 0.05 ks + 1e-7, |kappa_jac - kappa|,
    |omega| (its bar 0.1 ks), and |mu - mu_n| with mu = 1 / det(A) to
    first order (1 + 2k) and to second order (+ 3k^2 + |gamma|^2 -
    omega^2) in kappa_jac, gamma and omega."""
    import torch
    kap, kj = maps["kappa"], maps["kappa_jac"]
    ks = float(torch.std(kap, correction=0)) + 1e-12
    mu1 = 1.0 + 2.0 * kj
    mu2 = mu1 + 3.0 * kj * kj + maps["gamma1"] ** 2 + maps["gamma2"] ** 2 \
        - maps["omega"] ** 2
    return {"ks": ks, "bar": 0.05 * ks + 1e-7,
            "kmax": float(kap.abs().max()),
            "jac": float((kj - kap).abs().max()),
            "omega": float(maps["omega"].abs().max()),
            "mu1": float((maps["mu"] - mu1).abs().max()),
            "mu2": float((maps["mu"] - mu2).abs().max())}


def lens_user_phase(eng, device, card):
    """The user's path at full size on the treepm_1m state after the
    stepper path's 32 steps: raytraced_maps_from_state at its defaults
    with the weak-field checks of tests/test_lensing.py (mu held to
    second order: on this state kappa peaks at ~7 rms, where 3 kappa^2
    exceeds the first-order bar; the first-order checks are held on that
    test's own uniform box), the E/B null test on the shear of the Born
    map (tests/test_angular_power.py's bars), and the LensingObserver
    that fired inside the stepper run. Returns the traces' launches."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.analysis.power_spectrum import (
        angular_power_spectrum, shear_eb_spectra)
    from lambda_cdm_tpu_torch.core.analysis_observers import LensingObserver
    from lambda_cdm_tpu_torch.core.state import make_state
    from lambda_cdm_tpu_torch.ops import lens_sample
    from lambda_cdm_tpu_torch.physics.cosmology import comoving_distance
    from lambda_cdm_tpu_torch.raytracing import lensing
    st, params = eng.state, eng.config.cosmology_params()
    box = eng.config.particles.box_size
    lens_sample.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = lensing.raytraced_maps_from_state(st, params, box)
    torch.cuda.synchronize()
    t_maps = time.perf_counter() - t0
    # tests/test_lensing.py::test_maps_from_state's uniform box on the card
    rng = np.random.default_rng(61)
    small = make_state(rng.uniform(0, box, (4096, 3)).astype(np.float32),
                       np.zeros((4096, 3), np.float32),
                       np.ones(4096, np.float32), device=device)
    small_maps = lensing.raytraced_maps_from_state(
        small, params, box, ng=32, n_planes=4, n_rays_side=16)
    launches = lens_counts()
    n = maps["kappa"].shape[0]
    finite = all(bool(torch.all(torch.isfinite(v))) for v in
                 list(maps.values()) + list(small_maps.values()))
    wf, ws = weak_field(maps), weak_field(small_maps)
    for label, w in ((f"the treepm_1m state (N={st.num_particles}, a "
                      f"{float(st.scale_factor):.5f}; ng 256, 8 planes, "
                      f"{n}^2 rays, z_s 1; {t_maps:.3f} s)", wf),
                     ("the uniform 4096-particle box (ng 32, 4 planes, "
                      "16^2 rays)", ws)):
        print(f"lensing user path on {label}: kappa rms {w['ks']:.4e}, max "
              f"|kappa| {w['kmax']:.4e}; |kappa_jac - kappa| {w['jac']:.3e} "
              f"(bar {w['bar']:.3e}), |omega| {w['omega']:.3e} (bar "
              f"{0.1 * w['ks']:.3e}), |mu - (1 + 2 kappa_jac)| "
              f"{w['mu1']:.3e}, to second order {w['mu2']:.3e} (bar "
              f"{w['bar']:.3e}) on {card}")
    print(f"lensing user path: launches {json.dumps(launches)}")
    check("lensing user path", finite and all(
        v.shape == (n, n) for v in maps.values()), "maps not finite")
    check("lensing user path", all(
        w["jac"] < w["bar"] and w["omega"] < 0.1 * w["ks"]
        and w["mu2"] < w["bar"] for w in (wf, ws)) and ws["mu1"] < ws["bar"],
        "weak-field checks fail")

    # the E/B null test on the Born map's shear, below the axis Nyquist;
    # the map spans the angle the box subtends at its centre, chi_s / 2
    ng = 256
    kappa = lensing.convergence_map_from_state(st, params, box, ng=ng)
    fov = box / (0.5 * float(comoving_distance(params, 1.0)) * params.h)
    g = lensing.shear_from_kappa(kappa, fov, ng=ng)
    lmax = 0.95 * math.pi * ng / fov
    ell, cee, cbb, ceb, counts = shear_eb_spectra(g[0], g[1], fov,
                                                  num_bins=12, ell_max=lmax)
    _, ckk, _ = angular_power_spectrum(kappa, fov, num_bins=12, ell_max=lmax)
    ok = counts > 0
    ee_err = float(((cee - ckk).abs() / ckk.abs())[ok].max())
    bb = float((cbb / cee)[ok].max())
    eb = float((ceb.abs() / cee)[ok].max())
    print(f"lensing E/B on the Born map's shear ({ng}^2, fov {fov:.5f} rad, "
          f"ell_max {lmax:.1f}): C_EE vs C_kappa {ee_err:.3e} (rtol 1e-4), "
          f"max C_BB/C_EE {bb:.3e} (< 1e-8), max |C_EB|/C_EE {eb:.3e} "
          f"(< 1e-4)")
    check("lensing E/B", ee_err <= 1e-4 and bb < 1e-8 and eb < 1e-4,
          "E/B null test fails")

    obs = [o for o in eng.observers if isinstance(o, LensingObserver)]
    t = eng.profiler.summary().get("analysis.lensing", {})
    check("LensingObserver", len(obs) == 1 and len(obs[0].maps) >= 1
          and t.get("count", 0) >= 1, "the observer did not fire")
    rec = obs[0].maps[-1]
    print(f"LensingObserver in the stepper run: {len(obs[0].maps)} map(s), "
          f"step {rec['step']}, {rec['kappa'].shape[0]}^2, kappa_rms "
          f"{rec['kappa_rms']:.4e}; analysis.lensing {t['count']} x "
          f"{1e3 * t['mean_s']:.2f} ms on {card}")
    check("LensingObserver", math.isfinite(rec["kappa_rms"])
          and rec["kappa_rms"] > 0, "bad kappa_rms")
    return launches


def lensing_phase(eng, device, card):
    """Paths 2-5 of the lensing phase (each with the launch counts reset
    just before it and read just after), then K6/K7 and the trace kernel
    against their plain versions at the shapes of path 2. Returns (kernel
    records, launches summed over the paths)."""
    params = eng.config.cosmology_params()
    total, inputs, traces = timed("lensing bench", lens_bench_phase, params,
                                  device, card)
    for counts in (timed("lensing accuracy", lens_accuracy_phase, params,
                         device),
                   timed("lensing Limber", lens_limber_phase, params, device,
                         card),
                   timed("lensing user path", lens_user_phase, eng, device,
                         card)):
        for k in total:
            total[k] += counts[k]
    print(f"lensing launches on paths 2-5: {json.dumps(total)}")
    check("lensing", total["lens_trace"] > 0 and total["lens_trace_xwin"] > 0,
          "the trace kernel did not run on both routes on the lensing paths")
    rec = timed("lensing kernels K6/K7", lens_kernel_phase, inputs, device,
                card)
    rec.update(timed("lensing trace kernel", trace_kernel_phase, traces,
                     params, device, card))
    return rec, total


# the fast stepper's other options (phases 13-18). Row 7: K3 in the
# factored-r (vpu2) and x-space (vpu, mxu) split forms on the stepper's
# live-first counts. Against their plain version the kernels read 3.3e-6
# and 3.4e-6 of the max on this state (H100), while two split forms differ
# by 3.7e-5 or more (vpu2 against vpu3), so the 2e-5 bar fails a launch of
# the wrong form. vpu2 against vpu3 holds the JAX package's bar between
# those kernels (tests/test_fast_treepm.py); vpu against mxu is one
# function on two TPU routes, so the port computes it once. Given no
# counts (the TPU kernels' contract: mass 0 dead, any slot order) the same
# buckets give the same result bit for bit, and a shuffled, non-live-first
# copy gives each particle the same result up to its pair sum's order.
ROW7 = ("vpu", "vpu2", "mxu")
ROW7_TOL = {"plain": 2e-5, "vpu2_vs_vpu3": 5e-4, "vpu_vs_mxu": 1e-5,
            "shuffled": 1e-5}
# the row-7 path: 16 steps from the treepm_1m initial state with a rebucket
# after 8, in each variant against vpu3. The bar on the largest position
# difference (by persistent id, relative to the box) was set from a CPU
# rehearsal at a cut size (16^3 particles in a 16 Mpc/h box on a 32^3
# mesh, the same steps: 3.6e-7 of the box for vpu and mxu, 6.0e-8 for
# vpu2) and the tests' parity bar between two split fits (1e-5 of the box,
# tests/test_torch_fast_options.py)
ROW7_STEPS, ROW7_REBUCKET, ROW7_POS_TOL = 16, 8, 1e-5
# row 13 at benchmarks/bench_short_range_rd.py's geometry
RD_N, RD_NCELL, RD_BOX, RD_PM, RD_SOFT = 1_000_000, 24, 100.0, 192, 0.01
RD_ORACLE_ROWS, RD_ORACLE_TOL = 256, 1e-3


def _shuffled(bpos, bmass, seed):
    """A copy of the buckets with each cell's slots permuted (live slots
    among the dead ones) and the permutation."""
    import torch
    gen = torch.Generator(device=bmass.device).manual_seed(seed)
    perm = torch.argsort(torch.rand(bmass.shape, generator=gen,
                                    device=bmass.device), dim=1)
    p3 = perm[None].expand(3, -1, -1)
    return (torch.gather(bpos, 2, p3).contiguous(),
            torch.gather(bmass, 1, perm).contiguous(), p3)


def row7_kernel_phase(fs, kw, device, card):
    """Phase 13: K3 in each row-7 split form at the main-path state
    against its plain version on sampled rows, vpu2 against vpu3, vpu
    against mxu, a shuffled copy, and the times."""
    import torch
    from lambda_cdm_tpu_torch.ops import short_range
    from lambda_cdm_tpu_torch.ops.bucketed_pm import live_counts
    sr = dict(ncell=kw["ncell"], capacity=kw["capacity"],
              box_size=kw["box_size"], rs=kw["rs"], softening=kw["softening"])
    counts = live_counts(fs.bmass)
    live = (fs.bmass > 0)[None]
    pairs = stencil_pairs(counts, kw["ncell"])
    n_live = float(counts.sum())
    out = {v: short_range.short_range(fs.bpos, fs.bmass, counts, variant=v,
                                      **sr) for v in ("vpu3",) + ROW7}
    sb, sm, p3 = _shuffled(fs.bpos, fs.bmass, seed=7)
    rec, failures = {}, []
    rows = sample_rows(counts, kw["capacity"], 4096, seed=8)
    for v in ROW7:
        name = f"short_range_{v}"
        ref = short_range.short_range_plain(fs.bpos, fs.bmass, counts,
                                            variant=v, rows=rows, **sr)
        err, rel = rel_err(out[v].reshape(3, -1)[:, rows], ref)
        same = torch.equal(short_range.short_range(
            fs.bpos, fs.bmass, None, variant=v, **sr), out[v])
        shuffled = short_range.short_range(sb, sm, None, variant=v, **sr)
        back = torch.empty_like(shuffled).scatter_(2, p3, shuffled)
        _, srel = rel_err(back, out[v], live)
        dead = float(torch.where(live, 0.0, out[v]).abs().max())
        ms = cuda_ms(lambda: short_range.short_range(
            fs.bpos, fs.bmass, counts, variant=v, **sr), 20)
        pms = cuda_ms(lambda: short_range.short_range_plain(
            fs.bpos, fs.bmass, counts, variant=v, **sr), 1)
        # as K3: live slots read and written once, the counts read once
        b_ms, b_by = bound(28.0 * n_live + 4.0 * counts.numel(),
                           FLOPS[name] * pairs)
        rec[name] = (err, rel, ms, pms, b_ms, b_by)
        print(f"K3 {v} (main-path state, 4096 rows): max_abs_err {err:.3e} "
              f"(rel {rel:.3e}, tol {ROW7_TOL['plain']:g}); no counts "
              f"{'equal' if same else 'DIFFERENT'}; shuffled layout "
              f"{srel:.3e} (tol {ROW7_TOL['shuffled']:g}); dead-slot max "
              f"{dead:g}; kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {pairs:.4e} live pair tests) on "
              f"{card}")
        check(f"K3 {v}", rel <= ROW7_TOL["plain"], f"rel err {rel} > tol",
              failures)
        check(f"K3 {v}", same, "no counts differs from counts", failures)
        check(f"K3 {v}", srel <= ROW7_TOL["shuffled"],
              f"shuffled layout differs by {srel}", failures)
        check(f"K3 {v}", dead == 0.0, "dead slots not zero", failures)
    _, r23 = rel_err(out["vpu2"], out["vpu3"], live)
    _, rvm = rel_err(out["vpu"], out["mxu"], live)
    print(f"K3 vpu2 vs vpu3 on live slots: {r23:.3e} (tol "
          f"{ROW7_TOL['vpu2_vs_vpu3']:g}); vpu vs mxu: {rvm:.3e} (tol "
          f"{ROW7_TOL['vpu_vs_mxu']:g})")
    check("K3 vpu2", r23 <= ROW7_TOL["vpu2_vs_vpu3"], "vpu2 vs vpu3",
          failures)
    check("K3 mxu", rvm <= ROW7_TOL["vpu_vs_mxu"], "vpu vs mxu", failures)
    if failures:
        raise AssertionError("row-7 kernel phase: " + "; ".join(failures))
    return rec


def _by_id(fs, n: int, x=None):
    """[n, 3] float64 of a FastState's SoA field `x` (default its
    positions) in persistent-id order."""
    import torch
    x = fs.bpos if x is None else x
    ids = fs.ids.reshape(-1)
    live = ids >= 0
    out = torch.zeros((n, 3), dtype=torch.float64, device=ids.device)
    out[ids[live].long()] = x.reshape(3, -1).T[live].double()
    return out


def row7_path_phase(fs0, kw, params, dt, device, card):
    """Phase 14: fast_run from the treepm_1m initial state in each row-7
    variant and in vpu3, 16 steps with a rebucket after 8, the counts
    reset just before each run and read just after. Returns the row-7
    kernels' launches."""
    import torch
    from lambda_cdm_tpu_torch.ops import short_range
    from lambda_cdm_tpu_torch.ops.fast_treepm import fast_run
    n = int((fs0.ids >= 0).sum())
    m_total = float(fs0.bmass.double().sum())
    box = kw["box_size"]
    ref = None
    launches = {}
    for v in ("vpu3",) + ROW7:
        reset_counts()
        t0 = time.perf_counter()
        fs = fast_run(fs0, params, dt, n_steps=ROW7_STEPS,
                      rebucket_every=ROW7_REBUCKET, **dict(kw, variant=v))
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        counts = read_counts()
        key = short_range.counter(v)
        pos = _by_id(fs, n)
        mass = float(fs.bmass.double().sum())
        finite = bool(torch.all(torch.isfinite(fs.bpos)))
        msg = ""
        if ref is None:
            ref = pos
        else:
            d = torch.remainder(pos - ref + box / 2, box) - box / 2
            diff = float(d.abs().max()) / box
            msg = (f"; max position difference against vpu3 {diff:.3e} of "
                   f"the box (tol {ROW7_POS_TOL:g})")
            check(f"row-7 path {v}", diff <= ROW7_POS_TOL,
                  "positions differ from vpu3")
            launches[key] = counts[key]
        print(f"row-7 path {v}: {ROW7_STEPS} steps in {t:.3f} s "
              f"({1e3 * t / ROW7_STEPS:.3f} ms/step with one rebucket) on "
              f"{card}; K3 {key} launches {counts[key]}, K1 "
              f"{counts['cic_deposit']}, K2 {counts['fd4_gather']}; overflow "
              f"{int(fs.overflow)} dropped {int(fs.dropped)}; live mass "
              f"{mass:.6e} (start {m_total:.6e}){msg}")
        check(f"row-7 path {v}", counts[key] == ROW7_STEPS
              and counts["cic_deposit"] == ROW7_STEPS,
              "the variant's kernel was not launched once a step")
        check(f"row-7 path {v}", finite and int(fs.overflow) == 0
              and int(fs.dropped) == 0, "non-finite, overflow or drops")
        check(f"row-7 path {v}", abs(mass - m_total) <= 1e-9 * m_total,
              "live mass not conserved")
    return launches


# phase 18: fast_treepm._rebucket's two forms on the treepm_1m particles,
# bucketed at the capacities grow-and-retry gives (doubling from the
# plan's) and moved by 0.2 of a cell (rms): the gather form sorts and
# gathers all C*K slots, the compact form (chosen where C*K > 4 n_rows)
# compacts the live slots to n_rows first. Both are timed on each layout
# and must give the same state.
REBUCKET_CAPS = (64, 128, 256, 512)


def rebucket_phase(fs, kw, device, card):
    """Phase 18: the gather and compact rebucket forms timed on the same
    layouts, and the states they give compared field by field."""
    import torch
    from lambda_cdm_tpu_torch.ops.fast_treepm import (
        _rebucket, _rebucket_compact, build_fast_state)
    ids = fs.ids.reshape(-1)
    live = ids >= 0
    n = int(live.sum())
    ncell, box = kw["ncell"], kw["box_size"]
    gen = torch.Generator(device=device).manual_seed(12)
    pos = fs.bpos.reshape(3, -1).T[live]
    pos = pos + (0.2 * box / ncell) * torch.randn(
        pos.shape, generator=gen, device=device)
    vel = fs.bvel.reshape(3, -1).T[live].contiguous()
    mass = fs.bmass.reshape(-1)[live].contiguous()
    acc = fs.acc.reshape(3, -1)[:, live]
    fields = ("bpos", "bvel", "acc", "bmass", "ids", "overflow")
    for cap in REBUCKET_CAPS:
        # bucketed where the particles were, then moved: a rebucket's input
        g = build_fast_state(fs.bpos.reshape(3, -1).T[live].contiguous(),
                             vel, mass, fs.scale_factor, box_size=box,
                             plan={"ncell": ncell, "capacity": cap},
                             ids=ids[live])
        slot_live = g.ids.reshape(-1) >= 0
        order = g.ids.reshape(-1)[slot_live].long()
        bpos = g.bpos.reshape(3, -1).clone()
        bpos[:, slot_live] = pos[order].T
        bacc = g.acc.reshape(3, -1).clone()
        bacc[:, slot_live] = acc[:, order]
        g = g.replace(bpos=bpos.reshape(g.bpos.shape),
                      acc=bacc.reshape(g.acc.shape))
        rb = dict(box_size=box, ncell=ncell, capacity=cap)
        gather_ms = cuda_ms(lambda: _rebucket(g, **rb), 5)
        compact_ms = cuda_ms(lambda: _rebucket_compact(g, n_rows=n, **rb), 5)
        a = _rebucket(g, **rb)
        b = _rebucket_compact(g, n_rows=n, **rb)
        same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
        s = ncell ** 3 * cap
        print(f"rebucket at capacity {cap} ({s} slots, n_rows {n}, chosen "
              f"form {'compact' if s > 4 * n else 'gather'}): gather "
              f"{gather_ms:.4f} ms, compact {compact_ms:.4f} ms; overflow "
              f"{int(a.overflow)}; states {'equal' if same else 'DIFFER'} "
              f"on {card}")
        check(f"rebucket at capacity {cap}", same,
              "the compact form's state differs from the gather form's")
        del g, a, b


def rd_oracle(pos, mass, targets, box, rs, soft):
    """The exact-erfc short-range sum over all N particles (minimum image,
    float64) at the target rows -> [T, 3]."""
    import torch
    p = pos.double()
    m = mass.double()
    out = []
    for t in targets.split(16):
        d = p[None, :, :] - p[t][:, None, :]
        d = d - box * torch.round(d / box)
        r2 = (d * d).sum(-1) + soft * soft
        r = torch.sqrt(r2)
        x = r / (2 * rs)
        s = torch.special.erfc(x) + (r / (rs * math.sqrt(math.pi))) \
            * torch.exp(-x * x)
        w = m[None] * s / (r2 * r)
        w[torch.arange(t.numel()), t] = 0.0
        out.append((w[..., None] * d).sum(1))
    return torch.cat(out)


def rd_bound(rmass, counts, tables, k_rod: int):
    """(K8's bound ms, what bounds it, the pair tests this data needs):
    each live row against the slots its chunk's 27 entries cover, 44 float
    operations a test, against the rods' and tables' bytes."""
    import torch
    from lambda_cdm_tpu_torch.ops import short_range_rd as rd
    _, nt, _ = rd._decode(tables)
    live_rows = torch.clamp(counts[:, None] - rd.CH * torch.arange(
        k_rod // rd.CH, device=counts.device)[None], 0, rd.CH)
    pairs = float((live_rows.double() * nt.sum(-1).double() * 128).sum())
    b_ms, b_by = bound(28.0 * rmass.numel() + 4.0 * tables.numel(),
                       FLOPS["short_range_rd"] * pairs)
    return b_ms, b_by, pairs


def rd_phase(device, card):
    """Phase 15: row 13 at bench_short_range_rd.py's geometry: rd_pack and
    rd_window_tables on the card, then the path short_range_rd (counts
    reset just before, read just after); K8 against its plain version on
    sampled rows, K8 and K3 vpu3 (on the cell buckets of the same
    particles) against the exact-erfc sum over all N, and the times.
    Returns (record, launches)."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.ops import short_range, short_range_rd as rd
    from lambda_cdm_tpu_torch.ops.bucketed_pm import live_counts
    from lambda_cdm_tpu_torch.ops.fast_treepm import build_fast_state
    n, ncell, box = RD_N, RD_NCELL, RD_BOX
    rs = 1.25 * box / RD_PM
    r_cut = 4.5 * rs
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.uniform(0.0, box, (n, 3)).astype(
        np.float32)).to(device)
    mass = torch.ones(n, device=device)
    k_rod = rd.rd_geometry(n, ncell)
    geo = dict(ncell=ncell, k_rod=k_rod, box_size=box, rs=rs,
               softening=RD_SOFT)
    pack_ms = cuda_ms(lambda: rd.rd_pack(pos, mass, box, ncell=ncell,
                                         k_rod=k_rod), 5)
    rpos, rmass, counts, rzq, ovf, src = rd.rd_pack(pos, mass, box,
                                                    ncell=ncell, k_rod=k_rod)
    tab_ms = cuda_ms(lambda: rd.rd_window_tables(
        rzq, counts, ncell=ncell, k_rod=k_rod, box_size=box,
        window=r_cut), 5)
    tables = rd.rd_window_tables(rzq, counts, ncell=ncell, k_rod=k_rod,
                                 box_size=box, window=r_cut)
    check("K8", int(ovf) == 0, "rod overflow")
    reset_counts()
    acc = rd.short_range_rd(rpos, rmass, counts, tables, **geo)
    torch.cuda.synchronize()
    launches = {"short_range_rd": read_counts()["short_range_rd"]}
    check("K8", launches["short_range_rd"] == 1, "K8 was not launched")
    again = rd.short_range_rd(rpos, rmass, counts, tables, **geo)
    same = bool(torch.equal(acc, again))
    live = torch.arange(k_rod, device=device)[None] < counts[:, None]
    dead_zero = bool(torch.all(acc[~live] == 0))
    plan = rd.rd_plan(counts, k_rod=k_rod)
    n_items = int(plan[0])
    plan_ok = torch.equal(torch.sort(plan[2:2 + n_items].long()).values,
                          torch.sort(rd.rd_plan_plain(counts,
                                                      k_rod=k_rod)).values)

    rows = sample_rows(counts, k_rod, 4096, seed=9)
    ref = rd.short_range_rd_plain(rpos, rmass, counts, tables, rows=rows,
                                  **geo)
    err, rel = rel_err(acc.reshape(-1, 3)[rows], ref)
    b_ms, b_by, pairs = rd_bound(rmass, counts, tables, k_rod)
    ms = cuda_ms(lambda: rd.short_range_rd(rpos, rmass, counts, tables,
                                           **geo), 10)
    pms = cuda_ms(lambda: rd.short_range_rd_plain(
        rpos, rmass, counts, tables, chunk=512, **geo), 1, warmup=0)

    # the cell-bucket layout of the same particles, capacity as the bench
    # script builds it, and K3 vpu3 there
    cap = max(128, int(np.ceil(1.75 * n / ncell ** 3 / 128)) * 128)
    plan = {"ncell": ncell, "capacity": cap, "margin": 1, "rs": rs}
    fs = build_fast_state(pos, torch.zeros_like(pos), mass, 1.0,
                          box_size=box, plan=plan)
    check("K8", int(fs.overflow) == 0, "cell buckets overflow")
    bcounts = live_counts(fs.bmass)
    sr = dict(ncell=ncell, capacity=cap, box_size=box, rs=rs,
              softening=RD_SOFT)
    k3 = short_range.short_range(fs.bpos, fs.bmass, bcounts, **sr)
    k3_ms = cuda_ms(lambda: short_range.short_range(fs.bpos, fs.bmass,
                                                    bcounts, **sr), 10)
    k3_pairs = stencil_pairs(bcounts, ncell)

    # 256 live particles (through src) against the exact sum over all N
    gen = torch.Generator(device=device).manual_seed(10)
    slots = rows[torch.randperm(rows.numel(), generator=gen,
                                device=device)[:RD_ORACLE_ROWS]]
    targets = src[slots]
    exact = rd_oracle(pos, mass, targets, box, rs, RD_SOFT)
    scale = float(exact.abs().max())
    k8_err = float((acc.reshape(-1, 3)[slots].double() - exact).abs().max()
                   ) / scale
    slot_of = torch.full((n,), -1, dtype=torch.long, device=device)
    ids = fs.ids.reshape(-1)
    slot_of[ids[ids >= 0].long()] = torch.nonzero(ids >= 0)[:, 0]
    k3_at = k3.reshape(3, -1)[:, slot_of[targets]].T.double()
    k3_err = float((k3_at - exact).abs().max()) / scale
    k8_k3 = float((acc.reshape(-1, 3)[slots].double() - k3_at).abs().max()
                  ) / scale
    print(f"row 13 (bench_short_range_rd.py geometry: N={n}, box {box}, "
          f"ncell {ncell}, rods {ncell * ncell}, k_rod {k_rod}, rs {rs:.4f}, "
          f"window r_cut {r_cut:.4f}): rd_pack {pack_ms:.3f} ms, "
          f"rd_window_tables {tab_ms:.3f} ms on {card}")
    print(f"K8 plan: {n_items} work items of {rd.GROUP} chunks, "
          f"{'equal to' if plan_ok else 'differs from'} rd_plan_plain's; two "
          f"calls {'equal' if same else 'differ'}; dead slots "
          f"{'0' if dead_zero else 'not 0'}")
    print(f"K8 short_range_rd (4096 rows): max_abs_err {err:.3e} (rel "
          f"{rel:.3e}, tol {TOL['short_range']:g}); kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {pairs:.4e} "
          f"pair tests, {pairs / n:.0f} a particle); K3 vpu3 at capacity "
          f"{cap}: {k3_ms:.4f} ms ({k3_pairs:.4e} pair tests)")
    print(f"K8 vs the exact-erfc sum over all N at {RD_ORACLE_ROWS} "
          f"particles: {k8_err:.3e} of the max (tol {RD_ORACLE_TOL:g}); K3 "
          f"vpu3 {k3_err:.3e} (tol {RD_ORACLE_TOL:g}); K8 vs K3 {k8_k3:.3e} "
          f"(they take different pairs between r_cut and 6 rs)")
    failures = []
    check("K8", rel <= TOL["short_range"], f"rel err {rel} > tol", failures)
    check("K8", same, "two calls differ", failures)
    check("K8", dead_zero, "a dead slot is not 0", failures)
    check("K8", plan_ok, "its plan differs from rd_plan_plain's", failures)
    check("K8", k8_err <= RD_ORACLE_TOL, f"oracle error {k8_err}", failures)
    check("K3 vpu3", k3_err <= RD_ORACLE_TOL, f"oracle error {k3_err}",
          failures)
    if failures:
        raise AssertionError("row-13 phase: " + "; ".join(failures))
    return (err, rel, ms, pms, b_ms, b_by), launches


def fast_force_errors(eng, n_sample: int, seed: int = 0) -> dict:
    """The fast stepper's own accelerations (its FastState's acc, by
    persistent id) against the min-image direct sum at the targets that
    validate_force_accuracy draws, normalised as it normalises them:
    {"avg_err", "max_err"} of |a - a_direct| over the rms |a_direct|."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.forces.direct import \
        direct_accelerations_chunked
    cfg, st, fs = eng.config, eng.state, eng._fstate
    acc = _by_id(fs, st.num_particles, fs.acc).float()
    idx_all = np.nonzero((st.masses > 0).cpu().numpy())[0]
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.choice(idx_all, size=min(n_sample,
                                                       idx_all.size),
                                     replace=False),
                          device=st.positions.device)
    a_ref = direct_accelerations_chunked(
        st.positions, st.masses, float(cfg.particles.box_size),
        float(cfg.forces.softening_length), float(cfg.units.G), 0.0,
        chunk_size=64, targets=idx)
    diff = torch.linalg.norm(acc[idx] - a_ref, dim=-1)
    scale = torch.sqrt(torch.mean(torch.linalg.norm(a_ref, dim=-1) ** 2))
    return {"avg_err": float(torch.mean(diff) / scale),
            "max_err": float(torch.max(diff) / scale)}


# pm_fast's own force error against the stateless pm's (phase 11, the same
# config and steps): both are the unsplit PM on one 256^3 mesh, so each of
# avg_err and max_err may exceed pm's by at most this factor. The oracle is
# blunt on this near-uniform z = 49 state (the H100 read avg 1.6 for pm; a
# CPU rehearsal at 32^3 particles on a 64^3 mesh 0.75 for pm_fast and 0.81
# with the planted fault below), so pm_fast's force is also held against
# the stateless pm force on a clustered box of the same geometry (clumps of
# 1000 particles, 3 mesh cells rms), by the rms-normalised mean |difference|:
# CPU rehearsals at 64^3 and 128^3 read 0.085-0.088 (fd4 against spectral
# gradient), and 0.26-0.28 for a planted fault, the long-range force of
# split_scale = rs, which this bar must fail.
PM_FAST_ERR_FACTOR = 1.25
PM_FAST_VS_PM_TOL = 0.15
PM_FAST_CLUMP = (1000, 3.0)


def pm_fast_clustered(box: float, ng: int, n: int, device):
    """pm_fast's force (initialize_fast(pm_only=True)) on a clustered box
    against the stateless pm force on the same particles, and the same for
    the planted fault -> (mean |a - a_pm| / rms |a_pm| of each, ncell,
    capacity)."""
    import torch
    from lambda_cdm_tpu_torch.forces.pm import pm_accelerations
    from lambda_cdm_tpu_torch.ops.bucketed_pm import \
        pm_accelerations_bucketed
    from lambda_cdm_tpu_torch.ops.fast_treepm import fast_plan, \
        initialize_fast
    per, sigma = PM_FAST_CLUMP
    gen = torch.Generator(device=device).manual_seed(13)
    pos = torch.rand((n, 3), generator=gen, device=device) * box
    ncl = n // per * per
    centres = torch.rand((ncl // per, 3), generator=gen, device=device) * box
    pos[:ncl] = centres.repeat_interleave(per, 0) + (sigma * box / ng) \
        * torch.randn((ncl, 3), generator=gen, device=device)
    pos = torch.remainder(pos, box)
    mass = torch.ones(n, device=device)
    ncell = fast_plan(n, box, ng)["ncell"]
    cid = torch.clamp((pos / box * ncell).long(), 0, ncell - 1)
    occ = torch.bincount((cid[:, 0] * ncell + cid[:, 1]) * ncell + cid[:, 2],
                         minlength=ncell ** 3)
    cap = 1 << int(occ.max() - 1).bit_length()
    fs, kw = initialize_fast(pos, torch.zeros_like(pos), mass, 1.0,
                             box_size=box, pm_grid=ng, softening=0.01,
                             g_const=1.0, capacity=cap, pm_only=True)
    check("pm_fast clustered", int(fs.overflow) == 0, "overflow")
    a_pm = pm_accelerations(pos, mass, ng, box).double()
    fault, _ = pm_accelerations_bucketed(
        fs.bpos, fs.bmass, ncell=kw["ncell"], ng=ng, box_size=box,
        g_const=1.0, split_scale=kw["rs"], margin=kw["margin"],
        gradient=kw["gradient"])
    scale = torch.sqrt(torch.mean(torch.sum(a_pm ** 2, dim=-1)))
    real, planted = (
        float(torch.mean(torch.linalg.norm(_by_id(fs, n, a) - a_pm, dim=-1))
              / scale) for a in (fs.acc, fault))
    return real, planted, kw["ncell"], cap


def pm_fast_phase(device, card, pm_ms, pm_res):
    """Phase 16: pm_128_256.json with forces.type=pm_fast through the
    CLI's engine for 10 steps, then validate_force_accuracy (through the
    stateless pm solver) and pm_fast's own force at the same targets,
    held against the stateless pm run's (phase 11) errors; then pm_fast's
    force against the stateless pm force on a clustered box, beside a
    planted fault."""
    import torch
    from lambda_cdm_tpu_torch import cli
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    tmp = tempfile.mkdtemp(prefix="lcdm_chip_smoke_pm_fast_")
    try:
        cfg = SimulationConfig.from_file(PM_CONFIG)
        rest = cfg.apply_cli_overrides([
            "--forces.type=pm_fast", "--time.max_steps=10",
            "--io.diagnostics.energy_conservation=false",
            f"--simulation.output_directory={tmp}",
            f"--profiling.output_file={os.path.join(tmp, 'profile.json')}"])
        check("pm_fast", not rest, f"overrides not taken: {rest}")
        cfg.validate()
        reset_counts()
        t0 = time.perf_counter()
        eng = cli._build_engine(cfg, device=device)
        eng.initialize()
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        eng.run()
        torch.cuda.synchronize()
        launches = read_counts()
        stats = eng.statistics
        n = eng.state.num_particles
        ms_step = 1e3 * stats.compute_time_s / max(stats.total_steps, 1)
        kw = eng._fast_kw
        res = eng.validate_force_accuracy(n_sample=1024)
        own = fast_force_errors(eng, n_sample=1024)
        bar = {k: PM_FAST_ERR_FACTOR * pm_res[k]
               for k in ("avg_err", "max_err")}
        vs_pm, fault_vs_pm, cl_ncell, cl_cap = pm_fast_clustered(
            kw["box_size"], kw["ng"], n, device)
        print(f"pm_fast (pm_128_256.json, --forces.type=pm_fast): N={n} "
              f"ng={kw['ng']} ncell {kw['ncell']} capacity "
              f"{kw['capacity']}; init {t_init:.2f} s; {stats.total_steps} "
              f"steps {ms_step:.3f} ms/step (stateless pm, phase 11: "
              f"{pm_ms:.3f} ms/step) on {card}; launches "
              f"{json.dumps(launches)}; overflow {int(eng._fstate.overflow)} "
              f"dropped {int(eng._fstate.dropped)}; force validation "
              f"({res['solver']}, 1024 targets): avg {res['avg_err']:.4e} "
              f"max {res['max_err']:.4e}; pm_fast's own force: avg "
              f"{own['avg_err']:.4e} max {own['max_err']:.4e} (bar "
              f"{PM_FAST_ERR_FACTOR:g} x the stateless pm run's avg "
              f"{pm_res['avg_err']:.4e} max {pm_res['max_err']:.4e}); "
              f"against the stateless pm force on a clustered box (clumps "
              f"of {PM_FAST_CLUMP[0]}, {PM_FAST_CLUMP[1]:g} cells rms; ncell "
              f"{cl_ncell}, capacity {cl_cap}) {vs_pm:.4e}, the planted "
              f"fault (split_scale = rs) {fault_vs_pm:.4e} (tol "
              f"{PM_FAST_VS_PM_TOL:g})")
        check("pm_fast", stats.total_steps == 10, "steps not taken")
        check("pm_fast", kw["pm_only"] and launches["short_range"] == 0
              and launches["cic_deposit"] >= 10
              and launches["fd4_gather"] >= 10, "kernel launches")
        check("pm_fast", bool(torch.all(torch.isfinite(eng.state.positions)))
              and int(eng._fstate.overflow) == 0, "non-finite or overflow")
        check("pm_fast", res["solver"] == "pm" and math.isfinite(
            res["max_err"]), "force validation failed")
        check("pm_fast", all(own[k] <= bar[k] for k in bar),
              f"pm_fast's force error {own} above {bar}")
        check("pm_fast", vs_pm <= PM_FAST_VS_PM_TOL < fault_vs_pm,
              f"pm_fast against pm {vs_pm}, the planted fault "
              f"{fault_vs_pm} (tol {PM_FAST_VS_PM_TOL})")
        return ms_step
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 17: card runs against CPU runs of one small state, each gradient
GRAD_REF_TOL = {"pos": 1e-5, "vel": 1e-4}


def gradient_phase(cfg, device, card):
    """Phase 17: treepm_1m with forces.gradient = spectral and interp for
    8 steps each (plain PyTorch gathers in place of K2), then the card
    against the CPU on one small state for each."""
    import copy
    import torch
    from lambda_cdm_tpu_torch import SimulationBuilder
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.physics.initial_conditions import \
        generate_state
    out = {}
    for grad in ("spectral", "interp"):
        c = copy.deepcopy(cfg)
        c.forces.gradient = grad
        reset_counts()
        eng = SimulationBuilder(device=device).with_config(c).build()
        eng.run(num_steps=8)
        torch.cuda.synchronize()
        launches = read_counts()
        stats = eng.statistics
        ms_step = 1e3 * stats.compute_time_s / max(stats.total_steps, 1)
        st = eng.state
        n = st.num_particles
        ok = (bool(torch.all(torch.isfinite(st.positions)))
              and int(torch.sum(st.masses > 0)) == n
              and int(eng._fstate.overflow) == 0
              and int(eng._fstate.dropped) == 0)
        del eng
        small = SimulationConfig.from_dict({
            "forces": {"type": "treepm_fast", "pm_grid_size": 32,
                       "softening_length": 0.1, "rebucket_every": 4,
                       "gradient": grad},
            "particles": {"num_particles": 4096, "box_size": 50.0},
            "cosmology": {"initial_redshift": 9.0},
            "time": {"initial_timestep": 2e-5},
            "simulation": {"output_frequency": 4, "checkpoint_frequency": 0},
            "profiling": {"output_file": ""},
            "logging": {"performance_logging": False}})
        ic = small.particles.initial_conditions
        ic.type, ic.grid_size, ic.random_seed = "2lpt", 16, 5
        st0 = generate_state(small, device="cpu")
        runs = {}
        for dev in (device, "cpu"):
            e = (SimulationBuilder(device=dev).with_config(small)
                 .with_initial_state(st0).build())
            s = e.run(num_steps=8)
            runs[dev] = (s.positions.cpu(), s.velocities.cpu())
        (gp, gv), (cp, cv) = runs[device], runs["cpu"]
        d = torch.remainder(gp - cp + 25.0, 50.0) - 25.0
        pos_err = float(d.abs().max()) / 50.0
        vel_err = float((gv - cv).abs().max() / cv.abs().max())
        print(f"treepm_1m gradient={grad}: 8 steps {ms_step:.3f} ms/step on "
              f"{card}; launches {json.dumps(launches)}; card vs CPU (4096 "
              f"particles, 8 steps): positions {pos_err:.3e} of the box, "
              f"velocities {vel_err:.3e} of max |v| (tol "
              f"{GRAD_REF_TOL['pos']:g} / {GRAD_REF_TOL['vel']:g})")
        check(f"gradient {grad}", ok and stats.total_steps == 8,
              "run failed: steps, finiteness, mass, overflow or drops")
        check(f"gradient {grad}", launches["fd4_gather"] == 0
              and launches["cic_deposit"] > 0 and launches["short_range"] > 0,
              "kernel launches")
        check(f"gradient {grad}", pos_err <= GRAD_REF_TOL["pos"]
              and vel_err <= GRAD_REF_TOL["vel"], "card and CPU disagree")
        out[grad] = ms_step
    return out


# -- this slice: the JAX package's random streams, its Ewald oracle, merger
# trees, the profiler trace, warmup and CompiledForceEngine ---------------

# bench.py's accuracy section on the TPU (BENCH_r05.json, TPU v5e, the same
# particles): force RMS and max against Ewald, min-image against Ewald
TPU_ACCURACY = {"rms": 2.844e-3, "max": 2.1704e-2, "minimage": 8.3371e-2}
ACCURACY_BAR = 5e-3
TENM_CONFIG = os.path.join(ROOT, "examples", "configs", "treepm_10m.json")
TRACE_OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke_trace")
# CompiledForceEngine's profiles and the sizes held against K4 in them
# (direct_10k's 10,648 and bench.py's direct 100k)
AOT_PROFILES = (16_384, 131_072)
AOT_SIZES = (10_648, 100_000)


def prng_phase(device, card):
    """(a) utils/prng on the card: treepm_10m.json's IC noise (216^3
    normals from its seed's split key, the grid the loader raises to
    n_side) and 1M x 3 uniforms, each bit for bit the CPU's draw from the
    same key; the noise draw timed with CUDA events."""
    import torch
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.utils import prng
    cfg = SimulationConfig.from_file(TENM_CONFIG)
    ng = round(cfg.particles.num_particles ** (1.0 / 3.0))
    key = prng.split(prng.PRNGKey(cfg.particles.initial_conditions
                                  .random_seed))[1]
    draws = {"normal": (prng.normal, (ng, ng, ng)),
             "uniform": (prng.uniform, (1_000_000, 3))}
    for name, (fn, shape) in draws.items():
        got = fn(key, shape, device=device)
        ref = fn(key, shape, device="cpu")
        same = torch.equal(got.cpu().view(torch.int32),
                           ref.view(torch.int32))
        print(f"prng {name} {shape}: card == CPU bit for bit: {same}; mean "
              f"{float(got.double().mean()):.3e} std "
              f"{float(got.double().std()):.6f}")
        check("prng", same, f"{name} on the card differs from the CPU")
    ms = cuda_ms(lambda: prng.normal(key, (ng, ng, ng), device=device), 5)
    print(f"prng: {ng}^3 normals ({ng ** 3:,}) in {ms:.3f} ms on {card}")


def accuracy_phase(device, card):
    """(b) bench.py's accuracy geometry: the 2LPT snapshot at a = 0.35 from
    PRNGKey(7) (ng 200, n_side 100, box 100), the treepm_fast forces of
    initialize_fast on the card (pm_grid 192, softening 0.05, capacity
    pre-sized to the snapshot's fullest cell), 512 live targets chosen by
    default_rng(0), against the float64 Ewald and min-image oracles on the
    card. Fails above the 5e-3 RMS bar or with any overflow or drop.
    Returns the snapshot (positions, velocities, mass, capacity)."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.forces import ewald
    from lambda_cdm_tpu_torch.ops.fast_treepm import (fast_plan,
                                                      flatten_fast_state,
                                                      initialize_fast)
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    from lambda_cdm_tpu_torch.physics.initial_conditions import \
        lpt_displacements
    from lambda_cdm_tpu_torch.utils.prng import PRNGKey
    box = 100.0
    pos, vel = lpt_displacements(
        PRNGKey(7), CosmologyParams(), ng=200, n_side=100, box_size=box,
        a_init=0.35, kick_mode="comoving", device=device)
    n = pos.shape[0]
    mass = torch.full((n,), 27.7536 * 0.31 * box ** 3 / n,
                      dtype=torch.float32, device=device)
    cap_req = 0
    for _ in range(6):
        plan = fast_plan(n, box, 192, capacity=cap_req)
        nc = plan["ncell"]
        cid = torch.clamp((pos / box * nc).long(), 0, nc - 1)
        need = int(torch.bincount((cid[:, 0] * nc + cid[:, 1]) * nc
                                  + cid[:, 2], minlength=nc ** 3).max())
        if need <= plan["capacity"]:
            break
        cap_req = 128 * ((need + 127) // 128)
    fs, kw = initialize_fast(pos, torch.zeros_like(pos), mass, 0.35,
                             box_size=box, pm_grid=192, softening=0.05,
                             capacity=cap_req)
    overflow, dropped = int(fs.overflow), int(fs.dropped)
    fpos, _, fmass = flatten_fast_state(fs)
    facc = fs.acc.reshape(3, -1).T
    live = (fmass > 0).cpu().numpy()
    rows = np.random.default_rng(0).choice(np.nonzero(live)[0], size=512,
                                           replace=False)
    # the oracles over the live rows only (dead slots are inert, mass 0)
    live_idx = torch.nonzero(fmass > 0)[:, 0]
    where = torch.full((fmass.numel(),), -1, dtype=torch.int64,
                       device=device)
    where[live_idx] = torch.arange(live_idx.numel(), device=device)
    tgt = where[torch.from_numpy(rows).to(device)]
    src_pos, src_mass = fpos[live_idx], fmass[live_idx]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_ref = ewald.ewald_accelerations(src_pos, src_mass, tgt, box, 0.05,
                                      kw["g_const"])
    torch.cuda.synchronize()
    t_ewald = time.perf_counter() - t0
    a_mi = ewald.min_image_accelerations(src_pos, src_mass, tgt, box, 0.05,
                                         kw["g_const"])
    torch.cuda.synchronize()
    t_mi = time.perf_counter() - t0 - t_ewald
    a_sol = facc[torch.from_numpy(rows).to(device)].double()
    scale = torch.sqrt(torch.mean(torch.sum(a_ref ** 2, dim=-1)))

    def rms(x, y):
        return float(torch.sqrt(torch.mean(torch.sum((x - y) ** 2, -1)))
                     / scale)

    force_rms = rms(a_sol, a_ref)
    force_max = float(torch.max(torch.linalg.norm(a_sol - a_ref, dim=-1))
                      / scale)
    mi_rms = rms(a_mi, a_ref)
    print(f"accuracy (bench.py's geometry: 2LPT a=0.35 from PRNGKey(7), "
          f"1M, pm 192, softening 0.05; plan ncell {kw['ncell']} capacity "
          f"{kw['capacity']} variant {kw['variant']}, fullest cell {need}): "
          f"overflow {overflow} dropped {dropped}")
    print(f"accuracy: force vs Ewald rms {force_rms:.4e} (TPU "
          f"{TPU_ACCURACY['rms']:.4e}), max {force_max:.4e} (TPU "
          f"{TPU_ACCURACY['max']:.4e}) [bar {ACCURACY_BAR:g}]; min-image vs "
          f"Ewald rms {mi_rms:.4e} (TPU {TPU_ACCURACY['minimage']:.4e}); "
          f"oracles on the card: Ewald {t_ewald:.3f} s, min-image "
          f"{t_mi:.3f} s (512 targets, {int(live_idx.numel()):,} sources) "
          f"on {card}")
    check("accuracy", overflow == 0 and dropped == 0,
          f"overflow {overflow} dropped {dropped}")
    check("accuracy", force_rms <= ACCURACY_BAR,
          f"force rms {force_rms:.3e} above {ACCURACY_BAR:g}")
    check("accuracy", 0.01 < mi_rms < 1.0,
          f"min-image vs Ewald {mi_rms:.3e}: not the periodic systematic")
    return pos, vel, mass, kw["capacity"]


def merger_phase(snapshot, device, card):
    """(c) the accuracy snapshot evolved by treepm_fast through the
    engine (adaptive dt, 8 steps a chunk), FoF catalogues (K5) at three
    chunk ends and the merger forest over them; match_halos on the card
    against numpy's bincount of the same labels. Returns the launches."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.analysis.halo_finder import find_halos
    from lambda_cdm_tpu_torch.analysis.merger_trees import (MergerForest,
                                                            match_halos)
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.core.engine import SimulationEngine
    from lambda_cdm_tpu_torch.core.state import make_state
    pos, vel, mass, capacity = snapshot
    box, n = 100.0, pos.shape[0]
    cfg = SimulationConfig()
    cfg.particles.num_particles = n
    cfg.particles.box_size = box
    cfg.forces.type = "treepm_fast"
    cfg.forces.softening_length = 0.05
    cfg.forces.pm_grid_size = 192
    cfg.forces.bucket_capacity = capacity
    cfg.cosmology.initial_redshift = 1.0 / 0.35 - 1.0
    cfg.cosmology.final_redshift = 0.0
    cfg.integration.kick_mode = "comoving"
    cfg.integration.adaptive_timestep = True
    cfg.integration.max_dloga = 0.03
    cfg.integration.min_timestep = 1e-9
    cfg.integration.max_timestep = 1e-3
    cfg.time.initial_timestep = 1e-4
    cfg.time.final_time = 1e9
    cfg.simulation.output_frequency = 8
    cfg.simulation.checkpoint_frequency = 0
    cfg.profiling.output_file = ""
    reset_counts()
    t0 = time.perf_counter()
    eng = SimulationEngine(cfg, device=device)
    eng.initialize(state=make_state(pos, vel, mass, scale_factor=0.35,
                                    device=device))
    cats, a_snap = [], []
    for _ in range(3):
        eng.run(num_steps=8)
        st = eng.state
        cats.append(find_halos(st.positions, st.velocities, st.masses, box))
        a_snap.append(float(st.scale_factor))
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = read_counts()
    h = max(int(c.n_particles.shape[0]) for c in cats)
    forest = MergerForest.build(cats, a_snap, max_halos=h)
    la = cats[1].particle_label.cpu().numpy().astype(np.int64)
    lb = cats[2].particle_label.cpu().numpy().astype(np.int64)
    shared = match_halos(cats[1].particle_label, cats[2].particle_label,
                         max_halos=h)
    keep = (la >= 0) & (lb >= 0)
    ref = np.bincount(la[keep] * h + lb[keep], minlength=h * h)
    same = np.array_equal(shared.cpu().numpy().reshape(-1), ref)
    halos = [int(c.num_halos) for c in cats]
    links = [int(np.sum(lk.descendant >= 0)) for lk in forest.links]
    branches = [len(forest.main_branch(i)) for i in range(min(5, halos[-1]))]
    mergers = int(sum(np.sum(lk.n_progenitors > 1) for lk in forest.links))
    print(f"merger trees: {eng.statistics.total_steps} steps a = 0.35 -> "
          f"{a_snap[-1]:.4f}, FoF at a = "
          f"{', '.join(f'{a:.4f}' for a in a_snap)}: halos {halos}, links "
          f"{links}, halos with mergers {mergers}, main branches of the 5 "
          f"largest {branches}; match_halos == numpy bincount: {same}; "
          f"{t_run:.2f} s on {card}; launches {json.dumps(launches)}")
    check("merger", same, "match_halos differs from numpy's bincount")
    check("merger", min(halos) > 0 and sum(links) > 0,
          f"no halos or links: {halos}, {links}")
    check("merger", launches["fof_hook"] > 0 and launches["short_range"] > 0,
          "a kernel of the path was not launched")
    return launches


def trace_phase(device, card):
    """(d) profiling.trace_dir on the engine's run loop: treepm_1m.json (8
    steps untraced, then 8 traced) and direct_10k.json (10 untraced, then
    50 traced), each trace read back by trace_summary: the device's busy
    share of the traced window and its top 5 kernels. The untraced run's
    ms/step beside the traced one's is the trace's own cost."""
    import torch
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.core.engine import SimulationEngine
    from lambda_cdm_tpu_torch.utils.profiling import trace_summary
    shutil.rmtree(TRACE_OUT, ignore_errors=True)
    out = {}
    for name, path, warm, steps in (("treepm_1m", CONFIG, 8, 8),
                                    ("direct_10k", DIRECT_CONFIG, 10, 50)):
        cfg = SimulationConfig.from_file(path)
        cfg.profiling.output_file = ""
        eng = SimulationEngine(cfg, device=device)
        eng.initialize()
        eng.run(num_steps=warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(num_steps=steps)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0) / steps
        cfg.profiling.enabled = True
        cfg.profiling.trace_dir = os.path.join(TRACE_OUT, name)
        t0 = time.perf_counter()
        eng.run(num_steps=steps)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0) / steps
        s = trace_summary(cfg.profiling.trace_dir, top=5)
        out[name] = s
        print(f"trace {name}: {steps} steps, {plain_ms:.4f} ms/step "
              f"untraced, {traced_ms:.4f} traced; window "
              f"{s['window_ms']:.3f} ms, device busy {s['device_busy_ms']:.3f}"
              f" ms = {s['device_busy_share']:.4f} of it "
              f"({s['device_events']} device events) on {card}")
        for k in s["top_kernels"]:
            print(f"  trace {name} kernel {k['ms']:.4f} ms x{k['count']}: "
                  f"{k['name'][:120]}")
        check("trace", s["device_events"] > 0 and s["top_kernels"],
              f"{name}: the trace holds no device activity")
    return out


def warmup_aot_phase(device, card):
    """(e) SimulationEngine.warmup on a fresh treepm_1m.json engine (its
    programs and seconds, then the first chunk's time), a fresh process
    that finds the kernel library built (no nvcc); CompiledForceEngine at
    profiles (16,384, 131,072): its CUDA graphs against K4 through
    ops/direct on the same padded inputs (bit for bit), a save/load round
    trip (bit for bit); each replay writes into an output filled with NaN
    first, so an equal result is the replay's."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.core.engine import SimulationEngine
    from lambda_cdm_tpu_torch.ops import direct
    from lambda_cdm_tpu_torch.utils.aot import CompiledForceEngine
    cfg = SimulationConfig.from_file(CONFIG)
    cfg.profiling.output_file = ""
    eng = SimulationEngine(cfg, device=device)
    eng.initialize()
    before = eng._fstate.bpos.clone()
    w = eng.warmup()
    same = torch.equal(eng._fstate.bpos, before) \
        and int(eng.state.step) == 0 and eng.statistics.total_steps == 0
    chunk = cfg.simulation.output_frequency
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(num_steps=chunk)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    print(f"warmup (treepm_1m.json): {w['programs']} programs in "
          f"{w['seconds']:.3f} s, state untouched: {same}; first chunk "
          f"({chunk} steps) after it {first:.3f} s on {card}")
    check("warmup", w["programs"] >= 2 and same,
          f"{w} (state untouched: {same})")
    probe = subprocess.run(
        [sys.executable, "-c",
         "import os, sys; sys.path.insert(0, sys.argv[1]); "
         "from lambda_cdm_tpu_torch.ops import cuda_build as c; "
         "built = os.path.exists(c.library_path()); c.library(); "
         "print(built, repr(c.build_log))", ROOT],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    fresh = probe.stdout.strip()
    print(f"warmup: a fresh process finds the library built, compiling "
          f"nothing: {fresh}")
    check("warmup", probe.returncode == 0 and fresh == "True ''",
          f"fresh process: {fresh} {probe.stderr[-500:]}")
    box, soft = 100.0, 0.05
    aot = CompiledForceEngine(box, softening=soft, profiles=AOT_PROFILES,
                              solver="cuda", device=device)
    aot.build()
    rng = np.random.default_rng(12)
    results = {}
    for n in AOT_SIZES:
        pos = torch.from_numpy(rng.uniform(0, box, (n, 3)).astype(
            np.float32)).to(device)
        mass = torch.ones(n, device=device)
        prof = next(p for p in aot.profiles if n <= p)
        # NaN in the graph's output buffer: an equal result is the replay's
        aot._programs[prof].out.fill_(math.nan)
        got = aot.compute_forces(pos, mass)
        ppos = torch.zeros((prof, 3), device=device)
        pmass = torch.zeros(prof, device=device)
        ppos[:n], pmass[:n] = pos, mass
        ref = direct.pairwise_accelerations(ppos, pmass, box, soft)[:n]
        ms = cuda_ms(lambda: aot.compute_forces(pos, mass), 10)
        eager = cuda_ms(lambda: direct.pairwise_accelerations(
            ppos, pmass, box, soft), 10)
        results[n] = (pos, mass, got)
        print(f"CompiledForceEngine n={n:,} (profile {prof:,}): replay "
              f"into a NaN-filled output == K4 on the padded input: "
              f"{torch.equal(got, ref)}; a call (copy in, replay, range "
              f"check, copy out) {ms:.4f} ms, eager K4 on the padded input "
              f"{eager:.4f} ms on {card}")
        check("aot", torch.equal(got, ref), f"n={n}: graph differs from K4")
    path = aot.save(os.path.join(TRACE_OUT, "compiled_force_engine.json"))
    again = CompiledForceEngine.load(path, device=device)
    for program in again._programs.values():
        program.out.fill_(math.nan)
    same = all(torch.equal(again.compute_forces(p, m), g)
               for p, m, g in results.values())
    print(f"CompiledForceEngine save/load: the loaded graphs' replays into "
          f"NaN-filled outputs bit for bit the first engine's: {same}")
    check("aot", same, "save/load round trip differs")
    return w



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from lambda_cdm_tpu_torch.core.config import SimulationConfig
        from lambda_cdm_tpu_torch.ops import cuda_build
        from lambda_cdm_tpu_torch.utils.precision import disable_tf32
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 1
    disable_tf32()
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    lib = cuda_build.build()
    print(f"[build: kernels in {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(lib, ROOT)}]")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    cfg = SimulationConfig.from_file(CONFIG)
    cfg.profiling.output_file = ""
    fs, kw = timed("main-path state", main_path_state, cfg, device)
    rec = timed("kernel phase K1-K3", kernel_phase, fs, kw, device, card)
    rec.update(timed("row-7 kernel phase", row7_kernel_phase, fs, kw, device,
                     card))
    row7_launches = timed("row-7 path", row7_path_phase, fs, kw,
                          cfg.cosmology_params(),
                          float(cfg.time.initial_timestep), device, card)
    timed("rebucket phase", rebucket_phase, fs, kw, device, card)
    del fs
    _, eng = timed("stepper path", main_path, cfg, device, card)
    lens, lens_launches = timed("lensing phase", lensing_phase, eng, device,
                                card)
    del eng
    k5 = timed("K5 phase", fof_phase, device, card)
    launches = timed("CLI phase", cli_phase, device, card)
    timed("reference check", reference_check, device)
    timed("K9 phase", pair_potential_phase, device, card)
    k4, k4s_launches = timed("K4 phase", k4_phase, device, card)
    k4_launches, k4_10k = timed("direct_10k phase", direct_phase, device,
                                card)
    stateless_ms = timed("stateless pm/treepm phase", stateless_phase, device,
                         card)
    timed("stateless reference check", stateless_reference_check, device)
    rec["short_range_rd"], rd_launches = timed("row-13 phase", rd_phase,
                                               device, card)
    timed("pm_fast phase", pm_fast_phase, device, card,
          *stateless_ms[PM_CONFIG])
    timed("gradient phase", gradient_phase, cfg, device, card)
    alias_rec, alias_launches = timed("K10 phase", alias_probe_phase, device,
                                      card)
    rec.update(alias_rec)
    timed("prng phase", prng_phase, device, card)
    snapshot = timed("accuracy phase", accuracy_phase, device, card)
    timed("merger phase", merger_phase, snapshot, device, card)
    del snapshot
    timed("trace phase", trace_phase, device, card)
    timed("warmup/aot phase", warmup_aot_phase, device, card)
    science_launches, rec["pair_potential"] = timed(
        "science phase", science_phase, device, card)

    rec["fof_hook"] = (k5["max_abs_err"], 0.0, k5["ms"], k5["plain_ms"],
                       k5["bound_ms"], k5["bound_by"])
    rec["direct"] = k4_10k
    rec["direct_sym"] = k4["sym"]
    for name, r in lens.items():
        rec[name] = (r["max_abs_err"], 0.0, r["ms"], r["plain_ms"],
                     r["bound_ms"], r["bound_by"])
    sources = {"cic_deposit": ("csrc/cic_deposit.cu",
                               "lambda_cdm_tpu/ops/pallas_pm_rods.py:550"),
               "fd4_gather": ("csrc/fd4_gather.cu",
                              "lambda_cdm_tpu/ops/pallas_pm_rods.py:384"),
               "short_range": ("csrc/short_range.cu",
                               "lambda_cdm_tpu/ops/pallas_short_range.py:169"),
               "fof_hook": ("csrc/fof_hook.cu",
                            "lambda_cdm_tpu/ops/pallas_fof.py:46"),
               "direct": ("csrc/direct.cu",
                          "lambda_cdm_tpu/ops/pallas_direct.py:253"),
               "direct_sym": ("csrc/direct.cu",
                              "lambda_cdm_tpu/ops/pallas_direct.py:47"),
               "lens_sample": ("csrc/lens_sample.cu",
                               "lambda_cdm_tpu/ops/pallas_lens_sample.py:84"),
               "lens_sample_xwin": (
                   "csrc/lens_sample.cu",
                   "lambda_cdm_tpu/ops/pallas_lens_sample.py:165"),
               # trace_rays's loop on the card: the K6 route (wrapped
               # impact positions) and the K7 route (unwrapped)
               "lens_trace": ("csrc/lens_sample.cu",
                              "lambda_cdm_tpu/ops/pallas_lens_sample.py:84"),
               "lens_trace_xwin": (
                   "csrc/lens_sample.cu",
                   "lambda_cdm_tpu/ops/pallas_lens_sample.py:165"),
               "short_range_vpu": (
                   "csrc/short_range.cu",
                   "lambda_cdm_tpu/ops/pallas_short_range.py:944"),
               "short_range_vpu2": (
                   "csrc/short_range.cu",
                   "lambda_cdm_tpu/ops/pallas_short_range.py:841"),
               "short_range_mxu": (
                   "csrc/short_range.cu",
                   "lambda_cdm_tpu/ops/pallas_short_range.py:500"),
               "short_range_rd": (
                   "csrc/short_range_rd.cu",
                   "lambda_cdm_tpu/ops/pallas_short_range_rd.py:238"),
               # no TPU kernel: K9 replaces the XLA row-block scan of the
               # JAX package's potential_energy
               "pair_potential": ("csrc/direct.cu",
                                  "lambda_cdm_tpu/forces/direct.py:96"),
               "alias_probe": ("csrc/alias_probe.cu",
                               "benchmarks/probe_alias.py:26")}
    # launches: K1-K3 and K5 on the CLI run of treepm_1m, K4 on the
    # direct_10k run, K4s on its own path (sym and sym2 at 100k in the K4
    # phase; no engine path runs it, the JAX package drives its kernel only
    # from bench.py); K4 and K4s report their v1 and sym variants; K6/K7's public entries and the trace
    # kernel's two routes summed over the lensing paths 2-5 (trace_rays
    # takes the trace kernel, so no path calls the public entries);
    # K3's row-7 split forms on the row-7 path (phase 14), K8 on the
    # row-13 path (phase 15), K9 on the science run (its ledger samples),
    # K10 on its own entry point (phase 19). No single PyTorch call
    # computes K1-K5's, K8-K10's or the trace's functions (library_ms
    # null); K6/K7's yardstick is grid_sample on the wrapped, padded
    # stack
    launches = dict(launches, direct=k4_launches["direct"],
                    direct_sym=k4s_launches["direct_sym"], **lens_launches,
                    **row7_launches, **rd_launches, **alias_launches,
                    pair_potential=science_launches["pair_potential"])
    kernels = [{"name": name, "route": "cuda",
                "source": f"lambda_cdm_tpu_torch/{src}", "replaces": rep,
                "launches": launches[name], "max_abs_err": rec[name][0],
                "ms": rec[name][2], "plain_ms": rec[name][3],
                "bound_ms": rec[name][4], "bound_by": rec[name][5],
                "library_ms": lens[name]["library_ms"] if name in lens
                else None}
               for name, (src, rep) in sources.items()]
    print(f"direct_sym (K4s): {launches['direct_sym']} launches on its path "
          f"(the K4 phase), {k4_launches['direct_sym']} in the direct_10k "
          f"run")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
