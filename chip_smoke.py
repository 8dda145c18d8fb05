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
     its plain version and time both with CUDA events; K3 again on a
     clustered state whose largest cell holds several thousand particles;
  3. stepper path: reset the launch counters, build the engine from
     treepm_1m.json through SimulationBuilder (2LPT ICs from a seeded
     torch.Generator) and run 32 steps; K1-K3 must have launched,
     positions must be finite and the live mass must equal N * m;
  4. K5 phase: a 1M-particle clustered box (clumps, two periodic chains,
     uniform rest): fof_plan on the card, one FoF hook sweep of K5 against
     its plain version on sampled rows (exactly equal labels), fof_labels
     on a 131,072-particle subset against a scipy cKDTree + connected-
     components oracle (exactly equal labels), fof_labels and find_halos
     at 1M (converged before max_rounds);
  5. CLI phase: treepm_1m.json through the CLI's _build_engine ->
     initialize -> run for 40 steps with every observer the config asks
     for (P(k) every 20 steps, FoF halos, snapshot and checkpoint at 40;
     energy off: its O(N^2) pair sum); K1-K5 must have launched, K5
     through the halo-finder observer; then `resume` from the checkpoint
     and `analyze` of the snapshot through cli.main;
  6. reference check: a small run with every observer on (energy too) on
     the card against the same run on the CPU (the kernels' plain
     versions) from one initial state;
  7. energy timing: one potential_energy at 131,072 particles, and its
     N^2 extrapolation to 1M;
  8. K4 phase: 100,000 particles uniform in a 100 Mpc/h box (unit
     masses, softening 0.05: the JAX package's bench.py direct figure),
     K4 (v1, v2) and K4s (sym, sym2) against their plain versions and
     timed; K4 also at two and three ragged tiles and without the
     minimum image (no path of the port runs K4s: its launches are read
     from the direct_10k run, and are 0);
  9. direct_10k phase: examples/configs/direct_10k.json at full size
     (10,648 particles, direct solver) through the CLI's engine for its
     500 steps with its energy and momentum observers; K4 must have
     launched once at the start, once a step and twice for the
     force-fraction timing; then validate_force_accuracy on the final
     state;
 10. stateless pm/treepm phase (plain PyTorch, no TPU kernel on their
     path): pm_128_256.json (2,097,152 particles, 256^3) and
     basic_lambda_cdm.json (262,144 particles, treepm on 128^3) at full
     size for 10 steps each, with validate_force_accuracy;
 11. stateless reference check: a 4096-particle direct run of 8 steps on
     the card (K4) against the CPU (the solver's row-blocked sum) from
     three seeds' 2LPT states, the same card run with two planted K4
     faults (which the check must see), and pm and treepm accelerations
     of one state on both.

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
# plain result (float32 sums taken in another order: the deposit's
# atomics, the gather's per-corner differences, the pair sums' order)
TOL = {"cic_deposit": 1e-5, "fd4_gather": 1e-4, "short_range": 1e-4}

# H100 SXM peaks (NVIDIA's data sheet, at 700 W): float32 outside the
# tensor cores, and HBM bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float operations per unit of work, counted from each kernel's source (an
# FMA counts 2): per live particle for K1 and K2, per pair test for K3
# (rsqrt as 1) and K5
FLOPS = {"cic_deposit": 47, "fd4_gather": 175, "short_range": 44,
         "fof_hook": 8}

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
# cadence that fires inside them, energy off (an O(N^2) pair sum at 1M)
CLI_OVERRIDES = ["--time.max_steps=40",
                 "--io.analysis.power_spectrum.frequency=20",
                 "--io.analysis.halo_finder.frequency=40",
                 "--io.snapshots.frequency=40",
                 "--simulation.checkpoint_frequency=40",
                 "--io.diagnostics.energy_conservation=false"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    c3 = counts.reshape(ncell, ncell, ncell).double()
    nbr = c3
    for ax in range(3):
        nbr = nbr + torch.roll(nbr, 1, ax) + torch.roll(nbr, -1, ax)
    return float((c3 * nbr).sum())


def reset_counts() -> None:
    from lambda_cdm_tpu_torch.ops import direct, fof_hook, pm_rods, \
        short_range
    for mod in (pm_rods, short_range, fof_hook, direct):
        mod.reset_launch_counts()


def read_counts() -> dict:
    from lambda_cdm_tpu_torch.ops import direct, fof_hook, pm_rods, \
        short_range
    return dict(pm_rods.launches, **short_range.launches,
                **fof_hook.launches, **direct.launches)


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
    ms = cuda_ms(lambda: pm_rods.cic_deposit(bpos, fs.bmass, counts, **geo),
                 20)
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
    for name, (e, r, k_ms, p_ms, b_ms, b_by) in rec.items():
        print(f"{name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) at the 1M/192^3 plan (ncell {ncell}, "
              f"capacity {cap}) on {card}")
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
    """The user's path: SimulationBuilder -> build -> run(32 steps)."""
    import torch
    from lambda_cdm_tpu_torch import SimulationBuilder
    reset_counts()
    t0 = time.perf_counter()
    eng = SimulationBuilder(device=device).with_config(cfg).build()
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
    return launches


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
    return {"ms": ms, "plain_ms": pms, "max_abs_err": float(mism),
            "bound_ms": b_ms, "bound_by": b_by, "rounds": rounds["rounds"]}


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
              f"{' '.join(CLI_OVERRIDES)} (energy off at 1M: O(N^2))")
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
            "cic_deposit", "fd4_gather", "short_range", "fof_hook")),
            "a kernel of the path was not launched")
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


def energy_timing(device, card):
    """One potential_energy (the O(N^2) plain PyTorch pair sum) at
    131,072 particles on the card, and its N^2 extrapolation to 1M."""
    import torch
    from lambda_cdm_tpu_torch.forces.direct import potential_energy
    n, box = 131_072, 100.0
    gen = torch.Generator(device=device).manual_seed(31)
    pos = torch.rand((n, 3), generator=gen, device=device) * box
    mass = torch.ones(n, device=device)
    potential_energy(pos[:4096], mass[:4096], box, 0.02)     # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pe = float(potential_energy(pos, mass, box, 0.02))
    t = time.perf_counter() - t0
    print(f"energy: potential_energy at N={n} {t:.2f} s on {card} "
          f"(PE {pe:.6e}); N^2 extrapolation to 1M: "
          f"{t * (1e6 / n) ** 2:.0f} s a call")
    check("energy", pe < 0 and pe == pe, "bad potential energy")


def direct_inputs(n: int, box: float, seed: int, device):
    """n particles uniform in the box (torch generator on the card), unit
    masses."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    pos = torch.rand((n, 3), generator=gen, device=device) * box
    return pos, torch.ones(n, device=device)


def k4_phase(device, card):
    """K4 (v1, v2) and K4s (sym, sym2) at 100k against their plain
    versions, timed; K4 at ragged tiles and without the minimum image."""
    from lambda_cdm_tpu_torch.ops import direct
    n, box, soft = 100_000, 100.0, 0.05
    pos, mass = direct_inputs(n, box, 41, device)
    failures = []
    out = {}
    for variant in direct.VARIANTS:
        kw = dict(periodic=True, variant=variant)
        name = "direct_sym" if variant.startswith("sym") else "direct"
        got = direct.pairwise_accelerations(pos, mass, box, soft, **kw)
        ref = direct.pairwise_accelerations_plain(pos, mass, box, soft, **kw)
        err, rel = rel_err(got, ref)
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
    # ragged tiles (two and three of K4's 128) and no minimum image
    for m_n, periodic in ((200, True), (333, True), (4096, False)):
        p, m = direct_inputs(m_n, 20.0, m_n, device)
        for variant in ("v1", "sym"):
            kw = dict(periodic=periodic, variant=variant)
            _, rel = rel_err(direct.pairwise_accelerations(p, m, 20.0, soft,
                                                           **kw),
                             direct.pairwise_accelerations_plain(
                                 p, m, 20.0, soft, **kw))
            print(f"K4 {variant} N={m_n} periodic={periodic}: rel "
                  f"{rel:.3e} (tol {DIRECT_TOL[variant]:g})")
            check(f"K4 {variant} N={m_n}", rel <= DIRECT_TOL[variant],
                  f"rel err {rel} > tol", failures)
    if failures:
        raise AssertionError("K4 phase: " + "; ".join(failures))
    return out


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
        # the step's split: one K4 launch at this N against the step
        from lambda_cdm_tpu_torch.ops import direct
        k_ms = cuda_ms(lambda: direct.pairwise_accelerations(
            st.positions, st.masses, cfg.particles.box_size,
            cfg.forces.softening_length, cfg.units.G), 20)
        b_ms, b_by = bound(28.0 * n, DIRECT_FLOPS["direct"] * float(n) * n)
        print(f"direct_10k: K4 at N={n} {k_ms:.4f} ms a launch (CUDA "
              f"events, mean of 20; bound {b_ms:.4f} ms, {b_by}): "
              f"{100 * k_ms / ms_step:.1f}% of the step; the rest is the "
              f"fused KDK's elementwise launches and its host-side "
              f"scale-factor arithmetic")
        res = eng.validate_force_accuracy(n_sample=1024)
        print(f"direct_10k force validation (1024 targets): scale-normalized"
              f" avg {res['avg_err']:.4e} max {res['max_err']:.4e} against "
              f"the plain min-image oracle")
        check("direct_10k", res["max_err"] < 1e-4, "K4 forces disagree")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def stateless_phase(device, card):
    """pm_128_256.json and basic_lambda_cdm.json at full size, 10 steps
    each, through SimulationBuilder; plain PyTorch (no TPU kernel on
    these paths), with validate_force_accuracy and peak memory."""
    import torch
    from lambda_cdm_tpu_torch import SimulationBuilder
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.forces import auto_pm_grid
    from lambda_cdm_tpu_torch.forces.treepm import treepm_plan
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
        del eng


# the stateless reference check: the card's 8-step direct run against the
# CPU's, positions relative to the box and velocities to max |v|. On the
# H100 sound runs read at most 1.5e-6 in velocity (1.2e-4 while K4 took
# the image of d * (1/box), which differs from the CPU's d / box for some
# pairs half a box apart); a planted K4 fault of G 0.1% high reads 3.0e-4
# and one without the minimum image 1.7
REF_SEEDS = (6, 7, 8)
REF_TOL = {"pos": 1e-5, "vel": 1e-5}


def _planted_fault(g_factor: float, periodic: bool):
    """A `direct` solver builder whose K4 call carries a planted fault
    (registered in place of the solver for one run: the config accepts
    only the built-in names)."""
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
    CPU (the solver's row-blocked sum) from three seeds' states, and two
    planted K4 faults that the check must see; then pm and treepm
    accelerations of one state on both."""
    import torch
    from lambda_cdm_tpu_torch import SimulationBuilder, forces
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
        "simulation": {"output_frequency": 4, "checkpoint_frequency": 0},
        "profiling": {"output_file": ""},
        "logging": {"performance_logging": False}})
    box = cfg.particles.box_size
    faults = {"G 0.1% high": (1.001, True), "no minimum image": (1.0, False)}

    def run(dev, st0):
        eng = (SimulationBuilder(device=dev).with_config(cfg)
               .with_initial_state(st0).build())
        st = eng.run(num_steps=8)
        return st.positions.cpu(), st.velocities.cpu()

    def errs(got, ref):
        (gp, gv), (cp, cv) = got, ref
        d = torch.remainder(gp - cp + box / 2, box) - box / 2
        return (float(d.abs().max()) / box,
                float((gv - cv).abs().max() / cv.abs().max()))

    ic = cfg.particles.initial_conditions
    ic.type, ic.grid_size = "2lpt", 16
    sound, planted = {}, {}
    for seed in REF_SEEDS:
        ic.random_seed = seed
        st0 = generate_state(cfg, device="cpu")
        ref = run("cpu", st0)
        sound[seed] = errs(run(device, st0), ref)
        if seed == REF_SEEDS[0]:
            first = st0
            solver = forces._REGISTRY["direct"]
            for name, args in faults.items():
                register_force_computer("direct")(_planted_fault(*args))
                try:
                    planted[name] = errs(run(device, st0), ref)
                finally:
                    register_force_computer("direct")(solver)
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
              f"of max |v|" for k, (p, v) in sound.items())
          + f" (tol {REF_TOL['pos']:g} / {REF_TOL['vel']:g}); planted K4 "
          "faults: " + "; ".join(
              f"{k}: positions {p:.3e}, velocities {v:.3e}"
              for k, (p, v) in planted.items())
          + f"; one state's accelerations card vs CPU: pm {acc['pm']:.3e}, "
          f"treepm {acc['treepm']:.3e} (tol 1e-4)")
    check("stateless reference", all(
        p <= REF_TOL["pos"] and v <= REF_TOL["vel"]
        for p, v in sound.values()), "card and CPU direct runs disagree")
    check("stateless reference", all(
        p > REF_TOL["pos"] or v > REF_TOL["vel"]
        for p, v in planted.values()), "a planted K4 fault passes the check")
    check("stateless reference", max(acc.values()) <= 1e-4,
          "pm/treepm card and CPU accelerations disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from lambda_cdm_tpu_torch.core.config import SimulationConfig
        from lambda_cdm_tpu_torch.ops import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    del fs
    timed("stepper path", main_path, cfg, device, card)
    k5 = timed("K5 phase", fof_phase, device, card)
    launches = timed("CLI phase", cli_phase, device, card)
    timed("reference check", reference_check, device)
    timed("energy timing", energy_timing, device, card)
    k4 = timed("K4 phase", k4_phase, device, card)
    k4_launches = timed("direct_10k phase", direct_phase, device, card)
    timed("stateless pm/treepm phase", stateless_phase, device, card)
    timed("stateless reference check", stateless_reference_check, device)

    rec["fof_hook"] = (k5["max_abs_err"], 0.0, k5["ms"], k5["plain_ms"],
                       k5["bound_ms"], k5["bound_by"])
    rec["direct"] = k4["v1"]
    rec["direct_sym"] = k4["sym"]
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
                              "lambda_cdm_tpu/ops/pallas_direct.py:47")}
    # launches: K1-K3 and K5 on the CLI run of treepm_1m, K4 and K4s on
    # the direct_10k run (0 for K4s: no path of the port runs it; the JAX
    # package drives its kernel only from bench.py); K4 and K4s report
    # their v1 and sym variants. No single PyTorch call computes any of
    # these kernels' functions, so library_ms is null
    launches = dict(launches, direct=k4_launches["direct"],
                    direct_sym=k4_launches["direct_sym"])
    kernels = [{"name": name, "route": "cuda",
                "source": f"lambda_cdm_tpu_torch/{src}", "replaces": rep,
                "launches": launches[name], "max_abs_err": rec[name][0],
                "ms": rec[name][2], "plain_ms": rec[name][3],
                "bound_ms": rec[name][4], "bound_by": rec[name][5],
                "library_ms": None}
               for name, (src, rep) in sources.items()]
    print(f"direct_sym (K4s): {launches['direct_sym']} launches in the "
          f"direct_10k run: no path of the port runs it; its times and error "
          f"are the K4 phase's")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
