#!/usr/bin/env python3
"""Drive the PyTorch port's treepm_fast main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (it imports
lambda_cdm_tpu_torch from the directory this script sits in). Phases, each
fatal on failure:

  1. build the CUDA kernels from lambda_cdm_tpu_torch/csrc (nvcc, sm_90a)
     into lambda_cdm_tpu_torch/_build/;
  2. kernel phase: at the shapes of the examples/configs/treepm_1m.json
     plan (1M particles, 192^3 mesh, 32^3 cells of capacity 64), run K1
     (CIC deposit), K2 (fd4 gather) and K3 (short-range pairs) and their
     plain PyTorch versions on the same inputs, hold each kernel against
     its plain version and time both with CUDA events; K3 again on a
     clustered state whose largest cell holds several thousand particles;
  3. main path: reset the launch counters, build the engine from
     treepm_1m.json through SimulationBuilder (2LPT ICs from a seeded
     torch.Generator) and run 32 steps; every kernel must have launched,
     positions must be finite and the live mass must equal N * m;
  4. reference check: a small engine run on the card against the same run
     on the CPU (the kernels' plain versions) from one initial state.

Prints the card, the errors and times, one JSON line of kernel records,
the `nvidia-smi` name and power limit, and last one JSON status line.
Exits nonzero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "examples", "configs", "treepm_1m.json")
N_STEPS = 32

# kernel-vs-plain tolerances, relative to the largest magnitude of the
# plain result (float32 sums taken in another order: the deposit's
# atomics, the gather's per-corner differences, the pair sums' order)
TOL = {"cic_deposit": 1e-5, "fd4_gather": 1e-4, "short_range": 1e-4}


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
    rec["cic_deposit"] = (err, rel, ms, pms)

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
    rec["fd4_gather"] = (err, rel, ms, pms)

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
    rec["short_range"] = (err, rel, ms, pms)

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
    for name, (e, r, k_ms, p_ms) in rec.items():
        print(f"{name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms at the "
              f"1M/192^3 plan (ncell {ncell}, capacity {cap}) on {card}")
    if failures:
        raise AssertionError("kernel phase: " + "; ".join(failures))
    return rec


def k3_compare(bpos, bmass, counts, sr, n_rows, seed, heavy=False):
    """K3's full output against the plain rows= form on sampled live rows
    (with heavy=True half of them from the fullest cell)."""
    import torch
    from lambda_cdm_tpu_torch.ops import short_range
    cap = sr["capacity"]
    out = short_range.short_range(bpos, bmass, counts, **sr)
    live_rows = torch.nonzero((torch.arange(cap, device=bpos.device)[None]
                               < counts[:, None]).reshape(-1))[:, 0]
    gen = torch.Generator(device=bpos.device).manual_seed(seed)
    pick = torch.randint(0, live_rows.numel(), (n_rows,), generator=gen,
                         device=bpos.device)
    rows = live_rows[pick]
    if heavy:
        top = int(torch.argmax(counts))
        k = min(n_rows // 2, int(counts[top]))
        rows = torch.cat([rows[:n_rows - k],
                          top * cap + torch.arange(k, device=bpos.device)])
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
    from lambda_cdm_tpu_torch.ops import pm_rods, short_range
    pm_rods.reset_launch_counts()
    short_range.reset_launch_counts()
    t0 = time.perf_counter()
    eng = SimulationBuilder(device=device).with_config(cfg).build()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    eng.run(num_steps=N_STEPS)
    torch.cuda.synchronize()
    launches = dict(pm_rods.launches, **short_range.launches)

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
    check("main path", all(v > 0 for v in launches.values()),
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


def reference_check(device):
    """A small engine run through the kernels against the same run through
    the plain versions on the CPU, from one initial state."""
    import torch
    from lambda_cdm_tpu_torch import SimulationBuilder
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.physics.initial_conditions import \
        generate_state
    cfg = SimulationConfig.from_dict({
        "forces": {"type": "treepm_fast", "pm_grid_size": 32,
                   "softening_length": 0.1, "rebucket_every": 4},
        "particles": {"num_particles": 4096, "box_size": 50.0},
        "cosmology": {"initial_redshift": 9.0},
        "time": {"initial_timestep": 2e-5},
        "simulation": {"output_frequency": 8},
        "profiling": {"enabled": False},
        "logging": {"performance_logging": False}})
    # set on the object: the loader reads only the reference layout's
    # initial-conditions block
    ic = cfg.particles.initial_conditions
    ic.type, ic.grid_size, ic.random_seed = "2lpt", 32, 5
    st0 = generate_state(cfg, device="cpu")
    out = {}
    for dev in (device, "cpu"):
        eng = (SimulationBuilder(device=dev).with_config(cfg)
               .with_initial_state(st0).build())
        st = eng.run(num_steps=8)
        out[dev] = (st.positions.cpu(), st.velocities.cpu(),
                    int(eng._fstate.overflow), int(eng._fstate.dropped))
    (pg, vg, og, dg), (pc, vc, oc, dc) = out[device], out["cpu"]
    box = cfg.particles.box_size
    d = torch.remainder(pg - pc + box / 2, box) - box / 2
    pos_err = float(d.abs().max()) / box
    vel_err = float((vg - vc).abs().max() / vc.abs().max())
    print(f"reference check (4096 particles, 8 steps, card vs CPU plain): "
          f"positions {pos_err:.3e} of the box, velocities {vel_err:.3e} of "
          f"max |v|; overflow {og}/{oc} dropped {dg}/{dc}")
    check("reference", pos_err <= 1e-5 and vel_err <= 1e-4,
          "card and CPU runs disagree")
    check("reference", (og, dg) == (oc, dc), "counters differ")


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
    print(f"kernels built in {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(lib, ROOT)}")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    cfg = SimulationConfig.from_file(CONFIG)
    cfg.profiling.output_file = ""
    fs, kw = main_path_state(cfg, device)
    rec = kernel_phase(fs, kw, device, card)
    del fs
    launches = main_path(cfg, device, card)
    reference_check(device)

    sources = {"cic_deposit": ("csrc/cic_deposit.cu",
                               "lambda_cdm_tpu/ops/pallas_pm_rods.py:550"),
               "fd4_gather": ("csrc/fd4_gather.cu",
                              "lambda_cdm_tpu/ops/pallas_pm_rods.py:384"),
               "short_range": ("csrc/short_range.cu",
                               "lambda_cdm_tpu/ops/pallas_short_range.py:169")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"lambda_cdm_tpu_torch/{src}", "replaces": rep,
                "launches": launches[name], "max_abs_err": rec[name][0],
                "ms": rec[name][2], "plain_ms": rec[name][3]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
