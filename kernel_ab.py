#!/usr/bin/env python3
"""Time K1-K9 of several checkouts of the PyTorch port on one card, on
the same inputs, in turns (for a before/after comparison).

    python3 kernel_ab.py --root OLD --root . --root . --root OLD \\
        [--record RECORD.npz] [--only pm,k9,k4,k5,lens,k8]

Needs one CUDA card and nvcc. The inputs are made once, with the port in
this script's directory, and written to a temporary directory as npz
(live slots and each state's potential, about 250 MB; removed at the
end):

  treepm_1m    examples/configs/treepm_1m.json's initial buckets (1M
               particles, plan ncell 32, capacity 64);
  clustered    chip_smoke.py's clustered K3 state (10,000 particles in a
               1 Mpc/h clump, the rest uniform, on the same cells);
  science_z24  the science run's initial buckets (1M 2LPT particles at
               z = 24, plan ncell 16, capacity 8192);
  science_z0   with --record: the science run's final state, bucketed the
               same way (afresh: particles past a full cell's capacity
               are left out, as chip_smoke.py's science K3 line counts);
               without one, the benchmark's science_1m.z0 start state
               (nbody_bench/inputs.py, z = 0.5, seed Z0_SEED) on that plan;
  *_last       clustered and science_z0 with the cell grid rolled so that
               the fullest cell has the last cell id;
  k9_131k      131,072 uniform particles in 100 Mpc/h, softening 0.02;
  k9_1m        the record's final 1M positions (else 1M uniform),
               softening 0.1;
  k4_10k       examples/configs/direct_10k.json's state after
               initialize() (10,648 particles: K4's j slices);
  k4_100k      chip_smoke.direct_inputs(100_000, 100.0, 41), softening
               0.05 (K4 at one slice; bench.py's direct geometry, which
               times K4s);
  k5_first     chip_smoke.fof_state(1_000_000, seed=21) bucketed on its
               fof_plan, labels the particle indices, every cell active:
               fof_labels' first sweep;
  k5_late      the same buckets with the labels and active mask after
               four rounds of halo_finder._fof_round (made here once);
  fof_1m       the same positions (and seeded velocities) for fof_labels
               and find_halos;
  fof_science  with --record: the science run's final state for
               find_halos on the science run's own FoF plan;
  lens_256,    chip_smoke.py's lensing bench geometry (bench.py's: 16
  lens_256_jac planes of 0.2 unit normals from seed 2, chi 400 -> 1900,
  lens_512     65,536 grid-ordered rays), 256^2 with the Jacobian off and
               on, and 512^2;
  rd_1m        row 13's geometry (benchmarks/bench_short_range_rd.py: 1M
               uniform particles from seed 0 in 100 Mpc/h, 24^2 rods).

--only keeps some groups: pm (the bucket states: K1-K3 and the fast
stepper's KDK updates), k9, k4, k5 (K5
states, fof_1m and fof_science), lens (K6/K7 and trace_rays), k8 (K8
and its packing and tables).

Each bucket state also carries the potential of its plain deposit (at
its plan's 192^3 mesh and split scale) for K2.

Then one process a --root, in the order given, imports that root's
lambda_cdm_tpu_torch (building its kernels there) and times, on every
bucket state: K3 (vpu3; vpu, vpu2 and mxu on treepm_1m) with CUDA
events, and in a root whose K3 culls, the share of candidate j it kept
(its counters under profiling.tracing()); K1 and K2 twice, as eager
wrapper calls between CUDA events (what the stepper pays, host work
included) and as device time from a CUDA
graph of the same calls (each call's memset included); K9, K4 (v1 and
v2), K4s (sym and sym2) and K5 (one sweep) with CUDA events; fof_labels and find_halos with
the host clock around calls that end in a synchronise; on the lens
inputs K6 and K7 (the last plane's fields at its impact positions,
wrapped for K6) as eager wrapper calls between CUDA events and as a CUDA
graph of calls, beside one grid_sample of the same points (the wrapped,
padded stack), and trace_rays (lens_plane_fields and auto_sample_window
made once) on the host clock around 20 traces that end in a synchronise,
with the device launches of one trace (torch.profiler); on rd_1m rd_pack,
rd_window_tables and K8 (short_range_rd) with CUDA events, two K8 calls
compared byte for byte; on the bucket states, in a root that has them,
the fast stepper's KDK updates (ops/kdk_update.py: the open into new
and its own buffers, the kick as closing half kick and as the force's
combine) eagerly and as a CUDA
graph, each held bit for bit to its plain version, with the bytes of
the live rows as their bound, beside the plain versions' eager times;
and on each bucket state, its rows moved, the rebucket pass
(fast_treepm._rebucket: in a root with ops/rebucket.py the card's pass
over live rows, with its kernels' device time by name; else the plain
form it chooses) beside the plain gather and compact forms, each held
bit for bit to the gather form's state, with 88 B a live row and 44 B a
dead slot as its bound.
It prints one JSON line with each result's
SHA-256 (K2 and K3: the raw bytes of the
[3, C, K] output; K9: U as a float64; K1: its grid where two calls give
equal bytes, else none; K4: the [N, 3] accelerations; K5: the [C, K]
labels; fof_labels and find_halos: the particle labels; K6/K7: the
samples; trace_rays: kappa; rd_window_tables: the tables; K8: its
output) and the static instruction mix of K1's, K2's, K3's, K4's, K5's,
K6/K7's, K8's and K9's functions in its library (cuobjdump -sass: FRND and MUFU against FADD, FMUL and FFMA;
global reductions and atomics, shared atomics, shared and global loads,
shuffles, FSET / FSEL / LOP3). --sass-out DIR writes those functions'
whole SASS, one file a root (ROOT's path with / as _, .sass), to read a
loop body by hand.
A line a result then says which roots gave the first root's bytes (K5:
and whether they are the plain version's, fof_hook_plain on the whole
state), with the bound of K4 and K5 beside their times; the last line
holds every root's numbers and the card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
K3_REPS = {"treepm_1m": 20, "clustered": 3, "clustered_last": 3,
           "science_z24": 3, "science_z0": 3, "science_z0_last": 3}
ROW7 = ("vpu", "vpu2", "mxu")
K9_REPS = {"k9_131k": 3, "k9_1m": 1}
Z0_SEED = 2026        # science_z0's start state without a --record
K4_REPS = {"k4_10k": 50, "k4_100k": 5}
K5_REPS = 10
PM_REPS = 20
GROUPS = ("pm", "k9", "k4", "k5", "lens", "k8")
LENS_REPS = 20
K8_REPS = 10
# the kernel functions whose instruction mix each root reports
SASS_KERNELS = ("pair_potential_kernel", "short_range_kernel",
                "direct_kernel", "direct_sym", "cic_deposit_kernel", "fd4_gather_kernel",
                "fof_hook_kernel", "short_range_rd_kernel", "lens_sample",
                "lens_trace")
# SASS mnemonics counted together
SASS_FAMILIES = {"FADD": "FP32", "FMUL": "FP32", "FFMA": "FP32",
                 "FRND": "FRND", "MUFU": "MUFU", "RED": "RED", "REDG": "RED",
                 "ATOM": "ATOM", "ATOMG": "ATOM", "ATOMS": "ATOMS",
                 "LDS": "LDS", "LDG": "LDG", "SHFL": "SHFL",
                 "FSET": "FSET", "FSEL": "FSEL", "LOP3": "LOP3"}


def sass_mix(lib: str, dump: str | None = None) -> dict:
    """{function: {FRND, MUFU, FP32 (FADD + FMUL + FFMA), RED (global
    reductions), ATOM (global atomics), ATOMS (shared atomics), LDS, LDG,
    SHFL, FSET, FSEL, LOP3, all: static instruction counts}} of the
    SASS_KERNELS functions in the shared library `lib` (cuobjdump -sass),
    or {} without cuobjdump; their SASS also goes to the file `dump`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, cur, kept = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if any(k in m.group(1) for k in SASS_KERNELS) \
                else None
            if cur:
                out[cur] = dict.fromkeys(sorted(set(SASS_FAMILIES.values()))
                                         + ["all"], 0)
        if cur:
            kept.append(line)
        if m:
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                     line)
        if cur and m:
            key = SASS_FAMILIES.get(m.group(1))
            if key:
                out[cur][key] += 1
            out[cur]["all"] += 1
    if dump:
        with open(dump, "w") as f:
            f.write("\n".join(kept) + "\n")
    return out


def _sha(t) -> str:
    """SHA-256 of a tensor's raw bytes."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def _k3_state(fs, kw, path):
    """Save a live-first bucket state's live slots, counts and geometry,
    and the potential of its plain deposit (K2's input)."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.ops import bucketed_pm, pm_rods
    counts = bucketed_pm.live_counts(fs.bmass)
    cap = fs.bmass.shape[1]
    live = torch.arange(cap, device=counts.device)[None] < counts[:, None]
    ng, box = kw["ng"], float(kw["box_size"])
    pm = dict(ncell=kw["ncell"], ng=ng, box_size=box, margin=kw["margin"])
    grid, _ = pm_rods.cic_deposit_plain(fs.bpos, fs.bmass, counts, **pm)
    green = bucketed_pm._greens(ng, box, float(kw["rs"]),
                                str(fs.bpos.device))
    phi = torch.fft.irfftn(green * torch.fft.rfftn(grid / (box / ng) ** 3),
                           s=(ng, ng, ng))
    np.savez(path, counts=counts.cpu().numpy(),
             pos=fs.bpos[:, live].cpu().numpy(),
             mass=fs.bmass[live].cpu().numpy(), phi=phi.cpu().numpy(),
             pm=json.dumps(pm),
             geo=json.dumps({"ncell": kw["ncell"], "capacity": cap,
                             "box_size": box, "rs": float(kw["rs"]),
                             "softening": float(kw["softening"])}))


def _fullest_last(fs, kw):
    """The same state with its cell grid rolled periodically so that the
    fullest cell has the last cell id (positions moved with their cells):
    the last units of a plan in cell order are then the heaviest."""
    import torch
    from lambda_cdm_tpu_torch.ops.bucketed_pm import live_counts
    nc, box = kw["ncell"], float(kw["box_size"])
    cap = fs.bmass.shape[1]
    c = int(torch.argmax(live_counts(fs.bmass)))
    shift = [nc - 1 - c // (nc * nc), nc - 1 - (c // nc) % nc,
             nc - 1 - c % nc]
    p = fs.bpos.reshape(3, nc, nc, nc, cap).clone()
    idx = torch.arange(nc, device=p.device)
    for ax in range(3):
        p[ax] += shift[ax] * (box / nc)
    p = torch.roll(p, shift, (1, 2, 3))
    for ax in range(3):         # cells that crossed the box edge
        wrapped = (idx < shift[ax]).reshape(
            [nc if d == ax else 1 for d in range(3)] + [1])
        p[ax] -= torch.where(wrapped, box, 0.0)
    m = torch.roll(fs.bmass.reshape(nc, nc, nc, cap), shift, (0, 1, 2))
    return fs.replace(bpos=p.reshape(fs.bpos.shape),
                      bmass=m.reshape(fs.bmass.shape))


def _k4_state(path, pos, mass, box, soft, g):
    """Save a direct-sum input and the bounds of K4 (n^2 ordered pairs)
    and K4s (n^2 / 2 unordered pairs)."""
    import numpy as np
    import chip_smoke
    n = pos.shape[0]
    bounds = {name: chip_smoke.bound(28.0 * n, chip_smoke.DIRECT_FLOPS[name]
                                     * float(n) * n / div)
              for name, div in (("direct", 1), ("direct_sym", 2))}
    np.savez(path, pos=pos.cpu().numpy(), mass=mass.cpu().numpy(),
             geo=json.dumps(dict(box_size=box, softening=soft, g_const=g)),
             bound=json.dumps(bounds))


def _k5_state(path, bxyz, lab, counts, active, geo):
    """Save a K5 input (live slots only), the SHA-256 of fof_hook_plain's
    sweep of it and K5's bound: the pair tests of the active cells' live
    rows, 8 float operations each, against their bytes."""
    import numpy as np
    import torch
    import chip_smoke
    from lambda_cdm_tpu_torch.ops import fof_hook
    from lambda_cdm_tpu_torch.ops.short_range import neighbour_load
    cap = geo["capacity"]
    live = torch.arange(cap, device=counts.device)[None] < counts[:, None]
    kw = dict(ncell=geo["ncell"], capacity=cap, n_sentinel=geo["n"],
              box_size=geo["box_size"], linking_length=geo["b"])
    ref = fof_hook.fof_hook_plain(*bxyz, lab, counts, active, **kw)
    swept = torch.where(active != 0, counts, 0).to(torch.float64)
    pairs = float((swept * neighbour_load(counts, geo["ncell"])).sum())
    b_ms, b_by = chip_smoke.bound(20 * float(swept.sum())
                                  + 8 * counts.numel(),
                                  chip_smoke.FLOPS["fof_hook"] * pairs)
    np.savez(path, counts=counts.cpu().numpy(), active=active.cpu().numpy(),
             xyz=torch.stack([t[live] for t in bxyz]).cpu().numpy(),
             lab=lab[live].cpu().numpy(), geo=json.dumps(geo),
             plain_sha256=_sha(ref), bound=json.dumps([b_ms, b_by, pairs]))


def make_inputs(out: str, record: str | None, groups) -> list:
    """Write every input of the given groups to `out`; returns their
    names."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lambda_cdm_tpu_torch import science_run
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    device = torch.device("cuda", 0)
    os.makedirs(out, exist_ok=True)
    names = []
    g = science_run.geometry(False)
    final = science_run.load_record(record) if record else None
    if "pm" in groups:
        cfg = SimulationConfig.from_file(chip_smoke.CONFIG)
        cfg.profiling.output_file = ""
        fs, kw = chip_smoke.main_path_state(cfg, device)
        _k3_state(fs, kw, os.path.join(out, "treepm_1m.npz"))
        bpos, bmass, _, cap = chip_smoke.clustered_state(kw, device)
        cfs = fs.replace(bpos=bpos, bmass=bmass)
        _k3_state(cfs, kw, os.path.join(out, "clustered.npz"))
        _k3_state(_fullest_last(cfs, kw), kw,
                  os.path.join(out, "clustered_last.npz"))
        names += ["treepm_1m", "clustered", "clustered_last"]
        del fs
        pos, vel, m_p = science_run.initial_conditions(g, device)
        mass = torch.full((pos.shape[0],), m_p, device=device)
        eng = science_run.plan_engine(g, pos, vel, mass,
                                      1.0 / (1.0 + science_run.Z_INIT),
                                      device)
        _k3_state(eng._fstate, eng._fast_kw,
                  os.path.join(out, "science_z24.npz"))
        names.append("science_z24")
        del eng
        if final is not None:
            eng = science_run.plan_engine(
                g, *(torch.from_numpy(final[k]).to(device) for k in
                     ("pos_f", "vel_f", "masses")), float(final["a_f"]),
                device)
        else:
            from nbody_bench import harness, inputs
            cell = harness.Cell("science_1m.z0")
            st = inputs.start_state(cell.config, cell.traffic, Z0_SEED,
                                    device)
            mass = torch.full((st["pos"].shape[0],), st["mass"],
                              device=device)
            eng = science_run.plan_engine(g, st["pos"], st["vel"], mass,
                                          st["a"], device)
        _k3_state(eng._fstate, eng._fast_kw,
                  os.path.join(out, "science_z0.npz"))
        _k3_state(_fullest_last(eng._fstate, eng._fast_kw), eng._fast_kw,
                  os.path.join(out, "science_z0_last.npz"))
        names += ["science_z0", "science_z0_last"]
        del eng
    if "k9" in groups:
        gen = torch.Generator(device=device).manual_seed(31)
        k9 = {"k9_131k": (torch.rand((131_072, 3), generator=gen,
                                     device=device) * 100.0, 0.02)}
        if final is not None:
            k9["k9_1m"] = (torch.from_numpy(final["pos_f"]), g["softening"])
        else:
            k9["k9_1m"] = (torch.rand((1_000_000, 3), generator=gen,
                                      device=device) * 100.0,
                           g["softening"])
        for name, (p, soft) in k9.items():
            np.savez(os.path.join(out, f"{name}.npz"), pos=p.cpu().numpy(),
                     mass=np.ones(p.shape[0], np.float32),
                     geo=json.dumps(dict(box_size=100.0, softening=soft)))
            names.append(name)
    if "k4" in groups:
        from lambda_cdm_tpu_torch.core.engine import SimulationEngine
        cfg = SimulationConfig.from_file(chip_smoke.DIRECT_CONFIG)
        cfg.profiling.output_file = ""
        eng = SimulationEngine(cfg, device=device)
        eng.initialize()
        _k4_state(os.path.join(out, "k4_10k.npz"), eng.state.positions,
                  eng.state.masses, float(cfg.particles.box_size),
                  float(cfg.forces.softening_length), float(cfg.units.G))
        pos, mass = chip_smoke.direct_inputs(100_000, 100.0, 41, device)
        _k4_state(os.path.join(out, "k4_100k.npz"), pos, mass, 100.0, 0.05,
                  1.0)
        names += ["k4_10k", "k4_100k"]
        del eng
    if "k5" in groups:
        names += _fof_inputs(out, final, g, device)
    if "lens" in groups:
        names += _lens_inputs(out, device)
    if "k8" in groups:
        names += _k8_inputs(out, device)
    torch.cuda.empty_cache()
    return names


LENS_INPUTS = {"lens_256": (256, False), "lens_256_jac": (256, True),
               "lens_512": (512, False)}


def _lens_inputs(out, device) -> list:
    """chip_smoke.py's lensing bench geometry at each LENS_INPUTS shape."""
    import numpy as np
    import torch
    import chip_smoke
    for name, (ng, jac) in LENS_INPUTS.items():
        planes, chis, a_l, theta0 = chip_smoke.lens_bench_geometry(
            ng, 16, 256, torch.linspace(400.0, 1900.0, 16),
            torch.linspace(0.9, 0.55, 16), 2, device)
        np.savez(os.path.join(out, f"{name}.npz"),
                 planes=planes.cpu().numpy(), chis=chis.cpu().numpy(),
                 a_l=a_l.cpu().numpy(), theta0=theta0.cpu().numpy(),
                 geo=json.dumps(dict(ng=ng, jacobian=jac,
                                     box_size=chip_smoke.LENS_BOX,
                                     d_chi=100.0, chi_source=2500.0)))
    return list(LENS_INPUTS)


def _k8_inputs(out, device) -> list:
    """Row 13's particles and K8's bound there: the pair tests of each live
    row against its chunk's covered slots, 44 float operations each,
    against the rods' and tables' bytes (chip_smoke.py's rd_phase)."""
    import numpy as np
    import torch
    import chip_smoke
    from lambda_cdm_tpu_torch.ops import short_range_rd as rd
    n, ncell, box = chip_smoke.RD_N, chip_smoke.RD_NCELL, chip_smoke.RD_BOX
    rs = 1.25 * box / chip_smoke.RD_PM
    pos = np.random.default_rng(0).uniform(0.0, box, (n, 3)).astype(
        np.float32)
    k_rod = rd.rd_geometry(n, ncell)
    _, rmass, counts, rzq, _, _ = rd.rd_pack(
        torch.from_numpy(pos).to(device), torch.ones(n, device=device), box,
        ncell=ncell, k_rod=k_rod)
    tables = rd.rd_window_tables(rzq, counts, ncell=ncell, k_rod=k_rod,
                                 box_size=box, window=4.5 * rs)
    b_ms, b_by, pairs = chip_smoke.rd_bound(rmass, counts, tables, k_rod)
    np.savez(os.path.join(out, "rd_1m.npz"), pos=pos,
             geo=json.dumps(dict(ncell=ncell, k_rod=k_rod, box_size=box,
                                 rs=rs, softening=chip_smoke.RD_SOFT,
                                 window=4.5 * rs)),
             bound=json.dumps([b_ms, b_by, pairs]))
    return ["rd_1m"]


def _fof_inputs(out, final, g, device) -> list:
    """The K5 states (first sweep, after four rounds) and the fof_labels /
    find_halos inputs at 1M clustered, and on the science run's final
    state with a record."""
    import numpy as np
    import torch
    import chip_smoke
    from lambda_cdm_tpu_torch.analysis import halo_finder as hf
    from lambda_cdm_tpu_torch.ops import fof_hook
    box, b = 100.0, 0.2
    pos_np, _ = chip_smoke.fof_state(1_000_000, seed=21, box=box)
    n = len(pos_np)
    pos = torch.from_numpy(pos_np).to(device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    plan = hf.fof_plan(n, box, b, positions=pos, live=live)
    ncell, cap = plan["ncell"], plan["capacity"]
    bxyz, _, counts, pslot, _, _ = hf._fof_setup(pos, live, box, ncell, cap)
    geo = dict(ncell=ncell, capacity=cap, box_size=box, b=b, n=n)
    nslots = ncell ** 3 * cap

    def slot_labels(lab_p):
        lab = torch.full((nslots + 1,), n, dtype=torch.int32, device=device)
        lab[torch.where(pslot >= 0, pslot, nslots)] = lab_p.to(torch.int32)
        return lab[:nslots].reshape(ncell ** 3, cap)

    lab_p = torch.arange(n, device=device)
    active = torch.ones(ncell ** 3, dtype=torch.int32, device=device)
    _k5_state(os.path.join(out, "k5_first.npz"), bxyz, slot_labels(lab_p),
              counts, active, geo)
    for _ in range(4):
        lab_p, _, active = hf._fof_round(
            lab_p, bxyz, counts, pslot, box_size=box, linking_length=b,
            ncell=ncell, capacity=cap, hook_fn=fof_hook.fof_hook,
            active=active)
    _k5_state(os.path.join(out, "k5_late.npz"), bxyz, slot_labels(lab_p),
              counts, active, geo)
    del bxyz, pslot
    gen = torch.Generator(device=device).manual_seed(23)
    vel = torch.randn((n, 3), generator=gen, device=device)
    np.savez(os.path.join(out, "fof_1m.npz"), pos=pos_np,
             vel=vel.cpu().numpy(), mass=np.ones(n, np.float32),
             geo=json.dumps(dict(box_size=box, factor=b * n ** (1 / 3) / box,
                                 plan=None)))
    names = ["k5_first", "k5_late", "fof_1m"]
    if final is not None:
        pos_f = torch.from_numpy(final["pos_f"]).to(device)
        mass = torch.from_numpy(final["masses"]).to(device)
        nf = pos_f.shape[0]
        b_link = 0.2 * g["box"] / nf ** (1.0 / 3.0)
        splan = hf.fof_plan(nf, float(g["box"]), float(b_link),
                            positions=pos_f, live=mass > 0)
        np.savez(os.path.join(out, "fof_science.npz"), pos=final["pos_f"],
                 vel=final["vel_f"], mass=final["masses"],
                 geo=json.dumps(dict(box_size=float(g["box"]), factor=0.2,
                                     plan=splan)))
        names.append("fof_science")
    return names


def _chip_smoke():
    """This script's checkout's chip_smoke module: its timers (graph_ms:
    device milliseconds a call from one CUDA graph of calls, for calls
    that take less than their wrappers' host time) and yardsticks."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lens_calls(res, name, z, geo, device) -> None:
    """trace_rays on one lensing bench input (and at 256^2 K6, K7 and
    grid_sample at its last plane) into res."""
    import time
    import torch
    import torch.nn.functional as F
    from lambda_cdm_tpu_torch.ops import cuda_build
    from lambda_cdm_tpu_torch.ops import lens_sample as ls
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    from lambda_cdm_tpu_torch.raytracing import lensing
    cs = _chip_smoke()
    params = CosmologyParams()
    planes, chis, a_l, theta0 = (torch.from_numpy(z[k]).to(device)
                                 for k in ("planes", "chis", "a_l",
                                           "theta0"))
    ng, jac, box = geo["ng"], geo["jacobian"], geo["box_size"]
    fl = lensing.lens_plane_fields(params, planes, chis, a_l, geo["d_chi"],
                                   box, geo["chi_source"], ng=ng,
                                   jacobian=jac)
    w = lensing.auto_sample_window(fl, chis, theta0, box, ng=ng)

    def trace():
        return lensing.trace_rays(params, planes, chis, a_l, geo["d_chi"],
                                  box, theta0, geo["chi_source"], ng=ng,
                                  jacobian=jac, window=w, fields_l=fl)
    kappa = trace().kappa
    launches = cs.device_launches(trace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LENS_REPS):
        trace()
    torch.cuda.synchronize()
    res[f"{name}/trace_rays"] = {
        "ms": 1e3 * (time.perf_counter() - t0) / LENS_REPS, "window": w,
        "launches": launches, "planes": planes.shape[0],
        "sha256": _sha(kappa)}
    if name != "lens_256":
        return
    ext = torch.tensor(box, device=device)
    f3, xy = fl[-1], theta0 * chis[-1]
    wrapped = torch.remainder(xy, ext)
    calls = {"K6": lambda: ls.bilinear_sample_fields(f3, wrapped, ext),
             "K7": lambda: ls.bilinear_sample_fields_xwin(
                 f3, xy, ext, window=ng // 2)}
    pad, grid = cs.grid_sample_inputs(f3, wrapped, box)
    calls["grid_sample"] = lambda: F.grid_sample(
        pad, grid, mode="bilinear", padding_mode="border",
        align_corners=False)
    for key, fn in calls.items():
        res[f"{name}/{key}"] = {
            "ms": cuda_build.cuda_ms(fn, 50), "graph_ms": cs.graph_ms(fn),
            "launches": cs.device_launches(fn),
            "sha256": None if key == "grid_sample" else _sha(fn())}


def k8_calls(res, name, z, geo, device) -> None:
    """rd_pack, rd_window_tables and K8 at row 13 into res."""
    import torch
    from lambda_cdm_tpu_torch.ops import cuda_build
    from lambda_cdm_tpu_torch.ops import short_range_rd as rd
    pos = torch.from_numpy(z["pos"]).to(device)
    mass = torch.ones(pos.shape[0], device=device)
    ncell, k_rod, box = geo["ncell"], geo["k_rod"], geo["box_size"]

    def pack():
        return rd.rd_pack(pos, mass, box, ncell=ncell, k_rod=k_rod)
    rpos, rmass, counts, rzq, _, _ = pack()

    def tables_of():
        return rd.rd_window_tables(rzq, counts, ncell=ncell, k_rod=k_rod,
                                   box_size=box, window=geo["window"])
    tables = tables_of()
    kw = dict(ncell=ncell, k_rod=k_rod, box_size=box, rs=geo["rs"],
              softening=geo["softening"])

    def k8():
        return rd.short_range_rd(rpos, rmass, counts, tables, **kw)
    acc, again = k8(), k8()
    res[f"{name}/rd_pack"] = {"ms": cuda_build.cuda_ms(pack, 5),
                              "sha256": None}
    res[f"{name}/rd_window_tables"] = {
        "ms": cuda_build.cuda_ms(tables_of, 5), "sha256": _sha(tables)}
    res[f"{name}/K8"] = {"ms": cuda_build.cuda_ms(k8, K8_REPS),
                         "sha256": _sha(acc),
                         "two_calls_equal": bool(torch.equal(acc, again)),
                         "bound": json.loads(str(z["bound"]))}


def pm_kernels(res, name, z, bpos, bmass, counts, device) -> None:
    """Time K1 and K2 on one bucket state into res, PM_REPS calls each,
    eagerly (`ms`) and as a CUDA graph (`graph_ms`); hash K2's output and
    K1's where two calls agree."""
    import torch
    from lambda_cdm_tpu_torch.ops import cuda_build, pm_rods
    graph_ms = _chip_smoke().graph_ms
    pm = json.loads(str(z["pm"]))
    phi = torch.from_numpy(z["phi"]).to(device)

    def k1():
        return pm_rods.cic_deposit(bpos, bmass, counts, **pm)

    def k2():
        return pm_rods.fd4_gather(phi, bpos, counts, **pm)

    grid, again = k1()[0], k1()[0]
    res[f"{name}/K1"] = {"ms": cuda_build.cuda_ms(k1, PM_REPS),
                         "graph_ms": graph_ms(k1, PM_REPS),
                         "sha256": _sha(grid)
                         if torch.equal(grid, again) else None}
    acc = k2()
    res[f"{name}/K2"] = {"ms": cuda_build.cuda_ms(k2, PM_REPS),
                         "graph_ms": graph_ms(k2, PM_REPS),
                         "sha256": _sha(acc)}


def kdk_calls(res, name, bpos, bmass, counts, device) -> None:
    """Time the fast stepper's KDK updates (ops/kdk_update.py; a root
    without them is skipped) on one bucket state into res, eagerly and
    as a CUDA graph: the open into zeroed new buffers and in place, the
    closing kick and the combine, each held bit for bit to its plain
    version; and the plain versions, the chain of PyTorch kernels they
    replace, over every slot."""
    import torch
    try:
        from lambda_cdm_tpu_torch.ops import kdk_update as ku
    except ImportError:
        return
    from lambda_cdm_tpu_torch.ops import cuda_build
    smoke = _chip_smoke()
    live = (bmass > 0)[None]
    gen = torch.Generator(device=device).manual_seed(5)
    bvel, acc, acc_short = (torch.where(live, torch.randn(
        bpos.shape, generator=gen, device=device), 0.0) for _ in range(3))
    sc = dict(half_dt=2.5e-3, kf=1.7, dt=5e-3, df=0.6)
    g = 43.0071057317063
    rows = float(counts.sum())
    dead = bmass.numel() - rows
    pos_p, vel_p = ku.kdk_open_plain(bpos, bvel, acc, counts, *sc.values())
    kick_p = ku.kdk_kick_plain(vel_p, acc, sc["half_dt"], sc["kf"])
    comb_p = acc + g * acc_short

    def in_place(fn, *bufs):
        bufs = [b.clone() for b in bufs]
        return lambda: fn(*bufs)

    calls = {
        "open_new": (lambda: ku.kdk_open(bpos, bvel, acc, counts, **sc),
                     60 * rows + 24 * dead, (pos_p, vel_p)),
        "open_in_place": (in_place(lambda p, v: ku.kdk_open(
            p, v, acc, counts, owned=True, **sc), bpos, bvel), 60 * rows,
            (pos_p, vel_p)),
        "kick": (in_place(lambda v: ku.kdk_kick(
            v, acc, counts, s1=sc["half_dt"], s2=sc["kf"]), vel_p),
            36 * rows, kick_p),
        "combine": (in_place(lambda a: ku.kdk_kick(
            a, acc_short, counts, s1=g, s2=1.0), acc), 36 * rows, comb_p),
    }
    for key, (fn, n_bytes, want) in calls.items():
        got = fn()          # the first call: the in-place forms' inputs
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got if isinstance(got, tuple) else
                                   (got,), want if isinstance(want, tuple)
                                   else (want,)))
        res[f"{name}/kdk_{key}"] = {
            "ms": cuda_build.cuda_ms(fn, PM_REPS),
            "graph_ms": smoke.graph_ms(fn, PM_REPS), "sha256": None,
            "plain": same, "bound": smoke.bound(n_bytes, 0.0)}
    plains = {
        "open": lambda: ku.kdk_open_plain(bpos, bvel, acc, counts,
                                          *sc.values()),
        "kick": lambda: ku.kdk_kick_plain(vel_p, acc, sc["half_dt"],
                                          sc["kf"]),
        "combine": lambda: acc + g * acc_short}
    for key, fn in plains.items():
        res[f"{name}/kdk_{key}_plain"] = {
            "ms": cuda_build.cuda_ms(fn, PM_REPS), "sha256": None}


def rebucket_calls(res, name, bpos, bmass, counts, box, device) -> None:
    """Time the rebucket pass on one bucket state, its live rows moved by
    0.2 of a cell (rms), into res: fast_treepm._rebucket with n_rows the
    live count (in a root with ops/rebucket.py the card's pass; in one
    without, the plain form it chooses), its kernels' device time by
    name, and in a root with the pass the plain chains it replaces (the
    gather and compact forms), each state held bit for bit to the plain
    gather form's."""
    import torch
    from lambda_cdm_tpu_torch.ops import cuda_build
    from lambda_cdm_tpu_torch.ops import fast_treepm as ft
    try:
        from lambda_cdm_tpu_torch.ops import rebucket as rb
    except ImportError:
        rb = None
    smoke = _chip_smoke()
    ncell, cap = round(bmass.shape[0] ** (1 / 3)), bmass.shape[1]
    live = bmass > 0
    gen = torch.Generator(device=device).manual_seed(7)
    rows = int(counts.sum())
    moved = bpos + torch.randn(bpos.shape, generator=gen, device=device) * (
        0.2 * box / ncell)
    ids = torch.full(bmass.shape, -1, dtype=torch.int32, device=device)
    ids[live] = torch.arange(rows, dtype=torch.int32, device=device)
    fs = ft.FastState(
        bpos=torch.where(live[None], moved, 0.0),
        bvel=torch.where(live[None], torch.randn(
            bpos.shape, generator=gen, device=device), 0.0),
        bmass=bmass, ids=ids,
        acc=torch.where(live[None], torch.randn(
            bpos.shape, generator=gen, device=device), 0.0),
        scale_factor=torch.tensor(0.5), time=torch.tensor(0.0),
        step=torch.tensor(0, dtype=torch.int32),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device))
    kw = dict(box_size=box, ncell=ncell, capacity=cap)

    def bits(st):
        return [getattr(st, f).view(torch.int32)
                if getattr(st, f).dtype == torch.float32
                else getattr(st, f) for f in ("bpos", "bvel", "acc", "bmass",
                                              "ids", "overflow")]

    gather = getattr(ft, "_rebucket_gather", None) or (
        lambda st, **k: ft._rebucket(st, **k))
    want = bits(gather(fs, **kw))
    bound = smoke.bound(88.0 * rows + 44.0 * (bmass.numel() - rows), 0.0)
    calls = {"rebucket_pass": lambda: ft._rebucket(fs, n_rows=rows, **kw)}
    if rb is not None:
        calls["rebucket_gather_plain"] = lambda: gather(fs, **kw)
        calls["rebucket_compact_plain"] = lambda: ft._rebucket_compact(
            fs, n_rows=rows, **kw)
    for key, fn in calls.items():
        same = all(torch.equal(x, y) for x, y in zip(bits(fn()), want))
        res[f"{name}/{key}"] = {
            "ms": cuda_build.cuda_ms(fn, PM_REPS), "sha256": None,
            "plain": same, "bound": bound,
            "kernels_us": _kernel_split(fn)}


def k4_kernels(res, name, z, geo, device) -> None:
    """Time K4 (v1, v2) and K4s (sym, sym2) on one direct-sum input into
    res and hash it."""
    import torch
    from lambda_cdm_tpu_torch.ops import cuda_build, direct
    pos = torch.from_numpy(z["pos"]).to(device)
    mass = torch.from_numpy(z["mass"]).to(device)
    bounds = json.loads(str(z["bound"]))
    for v in ("v1", "v2", "sym", "sym2"):
        acc = direct.pairwise_accelerations(pos, mass, variant=v, **geo)
        ms = cuda_build.cuda_ms(lambda: direct.pairwise_accelerations(
            pos, mass, variant=v, **geo), K4_REPS[name])
        res[f"{name}/{v}"] = {"ms": ms, "sha256": _sha(acc), "bound": bounds[
            "direct_sym" if v.startswith("sym") else "direct"]}
        if v.startswith("sym"):
            res[f"{name}/{v}"]["kernels_us"] = _kernel_split(
                lambda: direct.pairwise_accelerations(pos, mass, variant=v,
                                                      **geo))


def _kernel_split(fn, tries: int = 4) -> dict:
    """{kernel name: device microseconds} of one fn() call, as
    torch.profiler records them (a window that recorded nothing is taken
    again, up to `tries` times; {} if none recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            if us > 0:
                out[e.key[:60]] = out.get(e.key[:60], 0.0) + float(us)
        if out:
            return out
    return {}


def k5_kernel(res, name, z, geo, device) -> None:
    """Time one K5 sweep on a saved state into res; hash it and say
    whether it is fof_hook_plain's."""
    import torch
    from lambda_cdm_tpu_torch.ops import cuda_build, fof_hook
    counts = torch.from_numpy(z["counts"]).to(device)
    active = torch.from_numpy(z["active"]).to(device)
    nc, cap = geo["ncell"], geo["capacity"]
    live = torch.arange(cap, device=device)[None] < counts[:, None]
    xyz = torch.from_numpy(z["xyz"]).to(device)
    bxyz = []
    for c in range(3):
        t = torch.zeros((nc ** 3, cap), device=device)
        t[live] = xyz[c]
        bxyz.append(t)
    lab = torch.full((nc ** 3, cap), geo["n"], dtype=torch.int32,
                     device=device)
    lab[live] = torch.from_numpy(z["lab"]).to(device)
    kw = dict(ncell=nc, capacity=cap, n_sentinel=geo["n"],
              box_size=geo["box_size"], linking_length=geo["b"])
    got = fof_hook.fof_hook(*bxyz, lab, counts, active, **kw)
    ms = cuda_build.cuda_ms(lambda: fof_hook.fof_hook(
        *bxyz, lab, counts, active, **kw), K5_REPS)
    sha = _sha(got)
    res[name] = {"ms": ms, "sha256": sha,
                 "plain": sha == str(z["plain_sha256"]),
                 "bound": json.loads(str(z["bound"]))}


def fof_calls(res, name, z, geo, device) -> None:
    """fof_labels and find_halos on one particle set, two calls each,
    host clock around calls that end in a synchronise: seconds, rounds,
    the labels' SHA-256."""
    import time
    import torch
    from lambda_cdm_tpu_torch.analysis import halo_finder as hf
    pos = torch.from_numpy(z["pos"]).to(device)
    vel = torch.from_numpy(z["vel"]).to(device)
    mass = torch.from_numpy(z["mass"]).to(device)
    n, box = pos.shape[0], geo["box_size"]
    b = geo["factor"] * box / n ** (1.0 / 3.0)
    live = mass > 0
    plan = geo["plan"] or hf.fof_plan(n, box, b, positions=pos, live=live)
    fof_s, halo_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels, _ = hf.fof_labels(pos, box, b, **plan, live=live)
        torch.cuda.synchronize()
        fof_s.append(time.perf_counter() - t0)
        rounds = hf.last_fof["rounds"]
        t0 = time.perf_counter()
        cat = hf.find_halos(pos, vel, mass, box, min_particles=20,
                            linking_length_factor=geo["factor"],
                            plan=geo["plan"])
        torch.cuda.synchronize()
        halo_s.append(time.perf_counter() - t0)
    res[name] = {"ms": 1e3 * fof_s[-1], "fof_labels_s": fof_s,
                 "find_halos_s": halo_s, "rounds": rounds, "plan": plan,
                 "num_halos": int(cat.num_halos), "sha256": _sha(labels)}


def worker(root: str, out: str, names: list, sass_out=None) -> dict:
    """Time the kernels of the port under `root` on the inputs in
    `out` (and write its kernels' SASS under `sass_out`)."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from lambda_cdm_tpu_torch.ops import cuda_build, direct, short_range
    from lambda_cdm_tpu_torch.utils import profiling
    device = torch.device("cuda", 0)
    dump = None
    if sass_out:
        os.makedirs(sass_out, exist_ok=True)
        tag = os.path.normpath(root).replace(os.sep, "_").strip("_.") or "root"
        dump = os.path.join(sass_out, f"{tag}.sass")
    res = {"root": root, "sass": sass_mix(cuda_build.build(), dump)}
    for name in names:
        z = np.load(os.path.join(out, f"{name}.npz"))
        geo = json.loads(str(z["geo"]))
        if name in K4_REPS:
            k4_kernels(res, name, z, geo, device)
            continue
        if name.startswith("k5_"):
            k5_kernel(res, name, z, geo, device)
            continue
        if name.startswith("fof_"):
            fof_calls(res, name, z, geo, device)
            continue
        if name.startswith("lens_"):
            lens_calls(res, name, z, geo, device)
            continue
        if name == "rd_1m":
            k8_calls(res, name, z, geo, device)
            continue
        if name in K9_REPS:
            pos = torch.from_numpy(z["pos"]).to(device)
            mass = torch.from_numpy(z["mass"]).to(device)
            u = direct.pair_potential(pos, mass, **geo)
            ms = cuda_build.cuda_ms(lambda: direct.pair_potential(
                pos, mass, **geo), K9_REPS[name], warmup=0)
            res[name] = {"ms": ms, "U": float(u), "sha256": _sha(u)}
            continue
        counts = torch.from_numpy(z["counts"]).to(device)
        nc, cap = geo["ncell"], geo["capacity"]
        live = torch.arange(cap, device=device)[None] < counts[:, None]
        bpos = torch.zeros((3, nc ** 3, cap), device=device)
        bmass = torch.zeros((nc ** 3, cap), device=device)
        bpos[:, live] = torch.from_numpy(z["pos"]).to(device)
        bmass[live] = torch.from_numpy(z["mass"]).to(device)
        for v in ("vpu3",) + (ROW7 if name == "treepm_1m" else ()):
            acc = short_range.short_range(bpos, bmass, counts, variant=v,
                                          **geo)
            ms = cuda_build.cuda_ms(lambda: short_range.short_range(
                bpos, bmass, counts, variant=v, **geo), K3_REPS[name])
            res[f"{name}/{v}"] = {"ms": ms, "sha256": _sha(acc)}
            if hasattr(profiling, "device_counters"):     # K3 culls
                profiling.reset_trace()
                with profiling.tracing():
                    short_range.short_range(bpos, bmass, counts, variant=v,
                                            **geo)
                tally = profiling.trace_totals()["counters"]
                profiling.reset_trace()
                res[f"{name}/{v}"]["kept_share"] = (
                    100.0 * tally["k3_j_kept"] / tally["k3_j_tested"])
        del acc
        pm_kernels(res, name, z, bpos, bmass, counts, device)
        kdk_calls(res, name, bpos, bmass, counts, device)
        rebucket_calls(res, name, bpos, bmass, counts, geo["box_size"],
                       device)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[])
    ap.add_argument("--record", default=None)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups of inputs: pm, k9, k4, "
                    "k5, lens, k8")
    ap.add_argument("--sass-out", default=None,
                    help="directory for each root's kernel SASS")
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--names", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.worker, args.out,
                                args.names.split(","), args.sass_out)),
              flush=True)
        return 0
    if not args.root:
        ap.error("give --root at least once")
    runs = []
    with tempfile.TemporaryDirectory() as out:
        groups = args.only.split(",")
        if not set(groups) <= set(GROUPS):
            ap.error(f"--only takes {', '.join(GROUPS)}")
        names = make_inputs(out, args.record, groups)
        for root in args.root:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 "--out", out, "--names", ",".join(names)]
                + (["--sass-out", args.sass_out] if args.sass_out else []),
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for r in runs:
        for fn, mix in sorted(r["sass"].items()):
            print(f"sass {r['root']} {fn}: {json.dumps(mix)}")
    keys = [k for r in runs for k in r if k not in ("root", "sass")]
    for key in dict.fromkeys(keys):
        have = [r for r in runs if key in r]
        ms = ", ".join(f"{r['root']} {r[key]['ms']:.4f}" for r in have)
        line = f"{key}: ms {ms}"
        if "graph_ms" in have[0][key]:
            ms = ", ".join(f"{r['root']} {r[key]['graph_ms']:.4f}"
                           for r in have)
            line += f"; as a CUDA graph, ms {ms}"
        if have[0][key]["sha256"]:
            same = ", ".join(r["root"] for r in have
                             if r[key]["sha256"] == have[0][key]["sha256"])
            line += f"; bytes equal to the first root's: {same}"
        if "plain" in have[0][key]:
            same = ", ".join(r["root"] for r in have if r[key]["plain"])
            line += f"; the plain version's bytes: {same}"
        if "launches" in have[0][key]:
            line += "; device launches a call " + ", ".join(
                f"{r['root']} {r[key]['launches']}" for r in have)
            if "planes" in have[0][key]:
                line += (f" ({have[0][key]['planes']} planes, window "
                         f"{have[0][key]['window']})")
        shares = [f"{r['root']} {r[key]['kept_share']:.3f}%" for r in have
                  if "kept_share" in r[key]]
        if shares:
            line += "; K3 kept " + ", ".join(shares)
        if "two_calls_equal" in have[0][key]:
            line += "; two calls equal: " + ", ".join(
                f"{r['root']} {r[key]['two_calls_equal']}" for r in have)
        if "bound" in have[0][key]:
            line += (f"; bound {have[0][key]['bound'][0]:.4f} ms "
                     f"({have[0][key]['bound'][1]})")
        if "rounds" in have[0][key]:
            line += "; " + ", ".join(
                f"{r['root']} rounds {r[key]['rounds']}, fof_labels s "
                f"{r[key]['fof_labels_s']}, find_halos s "
                f"{r[key]['find_halos_s']}" for r in have)
        if "kernels_us" in have[0][key]:
            line += "; device us a call by kernel: " + "; ".join(
                f"{r['root']} {json.dumps(r[key]['kernels_us'])}"
                for r in have)
        if "U" in have[0][key]:
            ref = have[0][key]["U"]
            dev = max(abs(r[key]["U"] - ref) / abs(ref) for r in have)
            line += f"; largest relative U difference {dev:.3e}"
        print(f"{line} on {card}")
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
