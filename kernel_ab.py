#!/usr/bin/env python3
"""Time K3 and K9 of several checkouts of the PyTorch port on one card, on
the same inputs, in turns (for a before/after comparison).

    python3 kernel_ab.py --root OLD --root . --root . --root OLD \\
        [--record RECORD.npz]

Needs one CUDA card and nvcc. The inputs are made once, with the port in
this script's directory, and written to a temporary directory as npz
(live slots only, about 80 MB; removed at the end):

  treepm_1m    examples/configs/treepm_1m.json's initial buckets (1M
               particles, plan ncell 32, capacity 64);
  clustered    chip_smoke.py's clustered K3 state (10,000 particles in a
               1 Mpc/h clump, the rest uniform, on the same cells);
  science_z24  the science run's initial buckets (1M 2LPT particles at
               z = 24, plan ncell 16, capacity 8192);
  science_z0   with --record: the science run's final state, bucketed the
               same way (afresh: particles past a full cell's capacity
               are left out, as chip_smoke.py's science K3 line counts);
  *_last       clustered and science_z0 with the cell grid rolled so that
               the fullest cell has the last cell id;
  k9_131k      131,072 uniform particles in 100 Mpc/h, softening 0.02;
  k9_1m        the record's final 1M positions (else 1M uniform),
               softening 0.1.

Then one process a --root, in the order given, imports that root's
lambda_cdm_tpu_torch (building its kernels there) and times K3 (vpu3 on
every state; vpu, vpu2 and mxu on treepm_1m) and K9 with CUDA events, and
prints one JSON line with each result's SHA-256 (K3: the raw bytes of the
[3, C, K] output; K9: U as a float64) and the static instruction mix of
K9's, K3's and K4's functions in its library (cuobjdump -sass: FRND and
MUFU against FADD, FMUL and FFMA). A line a result then says which roots
gave the first root's bytes; the last line holds every root's numbers and
the card.
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
# the kernel functions whose instruction mix each root reports
SASS_KERNELS = ("pair_potential_kernel", "short_range_kernel",
                "direct_kernel")


def sass_mix(lib: str) -> dict:
    """{function: {FRND, MUFU, FP32 (FADD + FMUL + FFMA), all: static
    instruction counts}} of the SASS_KERNELS functions in the shared
    library `lib` (cuobjdump -sass), or {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if any(k in m.group(1) for k in SASS_KERNELS) \
                else None
            if cur:
                out[cur] = {"FRND": 0, "MUFU": 0, "FP32": 0, "all": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                     line)
        if cur and m:
            op = m.group(1)
            key = "FP32" if op in ("FADD", "FMUL", "FFMA") else op
            if key in out[cur]:
                out[cur][key] += 1
            out[cur]["all"] += 1
    return out


def _sha(t) -> str:
    """SHA-256 of a tensor's raw bytes."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def _k3_state(fs, kw, path):
    """Save a live-first bucket state's live slots, counts and geometry."""
    import numpy as np
    import torch
    from lambda_cdm_tpu_torch.ops.bucketed_pm import live_counts
    counts = live_counts(fs.bmass)
    cap = fs.bmass.shape[1]
    live = torch.arange(cap, device=counts.device)[None] < counts[:, None]
    np.savez(path, counts=counts.cpu().numpy(),
             pos=fs.bpos[:, live].cpu().numpy(),
             mass=fs.bmass[live].cpu().numpy(),
             geo=json.dumps({"ncell": kw["ncell"], "capacity": cap,
                             "box_size": float(kw["box_size"]),
                             "rs": float(kw["rs"]),
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


def make_inputs(out: str, record: str | None) -> list:
    """Write every input to `out`; returns their names."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lambda_cdm_tpu_torch import science_run
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    device = torch.device("cuda", 0)
    os.makedirs(out, exist_ok=True)
    names = []
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
    g = science_run.geometry(False)
    pos, vel, m_p = science_run.initial_conditions(g, device)
    mass = torch.full((pos.shape[0],), m_p, device=device)
    eng = science_run.plan_engine(g, pos, vel, mass,
                                  1.0 / (1.0 + science_run.Z_INIT), device)
    _k3_state(eng._fstate, eng._fast_kw, os.path.join(out,
                                                      "science_z24.npz"))
    names.append("science_z24")
    del eng
    gen = torch.Generator(device=device).manual_seed(31)
    k9 = {"k9_131k": (torch.rand((131_072, 3), generator=gen,
                                 device=device) * 100.0, 0.02)}
    if record:
        final = science_run.load_record(record)
        eng = science_run.plan_engine(
            g, *(torch.from_numpy(final[k]).to(device) for k in
                 ("pos_f", "vel_f", "masses")), float(final["a_f"]), device)
        _k3_state(eng._fstate, eng._fast_kw,
                  os.path.join(out, "science_z0.npz"))
        _k3_state(_fullest_last(eng._fstate, eng._fast_kw), eng._fast_kw,
                  os.path.join(out, "science_z0_last.npz"))
        names += ["science_z0", "science_z0_last"]
        del eng
        k9["k9_1m"] = (torch.from_numpy(final["pos_f"]), g["softening"])
    else:
        k9["k9_1m"] = (torch.rand((1_000_000, 3), generator=gen,
                                  device=device) * 100.0, g["softening"])
    for name, (p, soft) in k9.items():
        np.savez(os.path.join(out, f"{name}.npz"), pos=p.cpu().numpy(),
                 mass=np.ones(p.shape[0], np.float32),
                 geo=json.dumps(dict(box_size=100.0, softening=soft)))
        names.append(name)
    torch.cuda.empty_cache()
    return names


def worker(root: str, out: str, names: list) -> dict:
    """Time the K3 and K9 of the port under `root` on the inputs in
    `out`."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from lambda_cdm_tpu_torch.ops import cuda_build, direct, short_range
    device = torch.device("cuda", 0)
    res = {"root": root, "sass": sass_mix(cuda_build.build())}
    for name in names:
        z = np.load(os.path.join(out, f"{name}.npz"))
        geo = json.loads(str(z["geo"]))
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
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[])
    ap.add_argument("--record", default=None)
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
                                args.names.split(","))), flush=True)
        return 0
    if not args.root:
        ap.error("give --root at least once")
    runs = []
    with tempfile.TemporaryDirectory() as out:
        names = make_inputs(out, args.record)
        for root in args.root:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 "--out", out, "--names", ",".join(names)],
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
    for key in runs[0]:
        if key in ("root", "sass"):
            continue
        ms = ", ".join(f"{r['root']} {r[key]['ms']:.4f}" for r in runs)
        same = ", ".join(r["root"] for r in runs
                         if r[key]["sha256"] == runs[0][key]["sha256"])
        line = f"{key}: ms {ms}; bytes equal to the first root's: {same}"
        if "U" in runs[0][key]:
            ref = runs[0][key]["U"]
            dev = max(abs(r[key]["U"] - ref) / abs(ref) for r in runs)
            line += f"; largest relative U difference {dev:.3e}"
        print(f"{line} on {card}")
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
