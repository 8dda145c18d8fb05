"""Approximate-solver accuracy: TreePM and PM against direct summation
(counterpart of examples/solver_accuracy.py), then each against the
float64 Ewald oracle (forces/ewald.py) on a sample of targets, which
measures what the JAX example's closing note names: the min-image oracle's
systematic against true periodic forces.

    python -m lambda_cdm_tpu_torch.examples.solver_accuracy [N]
        [--ewald-targets 256] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from lambda_cdm_tpu_torch.forces.direct import direct_accelerations_chunked
from lambda_cdm_tpu_torch.forces.ewald import ewald_accelerations
from lambda_cdm_tpu_torch.forces.pm import pm_accelerations
from lambda_cdm_tpu_torch.forces.treepm import treepm_accelerations
from lambda_cdm_tpu_torch.utils import prng
from lambda_cdm_tpu_torch.utils.precision import disable_tf32
from lambda_cdm_tpu_torch.utils.profiling import synchronize


def _errors(out, ref, scale) -> np.ndarray:
    return (torch.sqrt(torch.sum((out - ref) ** 2, -1)) / scale).cpu() \
        .numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=16_384)
    ap.add_argument("--ewald-targets", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    disable_tf32()
    n, box, soft = args.n, 100.0, 0.05
    # jax.random.uniform(PRNGKey(0), (n, 3), maxval=box): the JAX
    # example's particles
    pos = prng.uniform(prng.PRNGKey(0), (n, 3), 0.0, box,
                       device=args.device)
    m = torch.ones((n,), device=pos.device)

    t0 = time.perf_counter()
    ref = direct_accelerations_chunked(pos, m, box, soft)
    synchronize(ref)
    t_direct = time.perf_counter() - t0
    scale = float(torch.sqrt(torch.mean(torch.sum(ref ** 2, -1))))
    print(f"direct O(N^2): {t_direct * 1e3:.1f} ms (oracle)")

    rng = np.random.default_rng(0)
    tgt = torch.as_tensor(rng.choice(n, size=min(args.ewald_targets, n),
                                     replace=False), device=pos.device)
    ewald = ewald_accelerations(pos, m, tgt, box, soft).to(torch.float32)
    e_scale = float(torch.sqrt(torch.mean(torch.sum(ewald ** 2, -1))))
    out = {"direct_ms": t_direct * 1e3, "solvers": {}}
    for name, fn in [
        ("treepm(ng=64)", lambda: treepm_accelerations(
            pos, m, box, pm_grid=64, softening=soft)),
        ("pm(ng=128)", lambda: pm_accelerations(pos, m, 128, box)),
    ]:
        synchronize(fn())               # warm: kernels built, caches made
        t0 = time.perf_counter()
        acc = fn()
        synchronize(acc)
        dt = time.perf_counter() - t0
        err = _errors(acc, ref, scale)
        print(f"{name}: {dt * 1e3:.1f} ms  speedup {t_direct / dt:.1f}x  "
              f"rel err avg {err.mean():.4f} max {err.max():.4f}")
        ew = _errors(acc[tgt], ewald, e_scale)
        out["solvers"][name] = {"ms": dt * 1e3, "avg": float(err.mean()),
                                "max": float(err.max()),
                                "ewald_avg": float(ew.mean()),
                                "ewald_max": float(ew.max())}
    mi = _errors(ref[tgt], ewald, e_scale)
    out["minimage_vs_ewald"] = float(mi.mean())
    print("note: ~2% systematic = min-image oracle vs true periodic "
          "forces (tests/test_solvers.py docstring)")
    print(f"against the Ewald oracle ({tgt.numel()} targets): min-image "
          f"avg {mi.mean():.4f}; " + "; ".join(
              f"{k} avg {v['ewald_avg']:.4f} max {v['ewald_max']:.4f}"
              for k, v in out["solvers"].items()))
    return out


if __name__ == "__main__":
    main()
