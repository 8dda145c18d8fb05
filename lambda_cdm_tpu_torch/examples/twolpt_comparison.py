"""1LPT against 2LPT initial conditions from one realization (counterpart
of examples/twolpt_comparison.py): RMS displacement and velocity ratios,
the second-order displacement and the 1LPT x 2LPT cross-correlation.

    python -m lambda_cdm_tpu_torch.examples.twolpt_comparison [--ng 64]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lambda_cdm_tpu_torch.forces.direct import min_image
from lambda_cdm_tpu_torch.physics import initial_conditions as ics
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
from lambda_cdm_tpu_torch.utils import prng


def _rms(x) -> float:
    return float(torch.sqrt(torch.mean(torch.sum(x ** 2, -1))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ng", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ng, box, z_init = args.ng, 200.0, 24.0
    params = CosmologyParams()
    a = 1.0 / (1.0 + z_init)
    key = prng.PRNGKey(7)

    kw = dict(ng=ng, n_side=ng, box_size=box, a_init=a, device=args.device)
    p1, v1 = ics.lpt_displacements(key, params, use_2lpt=False, **kw)
    p2, v2 = ics.lpt_displacements(key, params, use_2lpt=True, **kw)

    q = ics.lattice_positions(ng, box, device=p1.device)
    d1 = min_image(p1 - q, box)
    d2 = min_image(p2 - q, box)
    rms1, rms2 = _rms(d1), _rms(d2)
    vrms1, vrms2 = _rms(v1), _rms(v2)
    corr = float(np.corrcoef(d1.cpu().numpy().ravel(),
                             d2.cpu().numpy().ravel())[0, 1])
    rms_2nd = _rms(min_image(p2 - p1, box))

    print(f"z={z_init}  {ng}^3 particles  box {box} Mpc/h")
    print(f"rms displacement: 1LPT {rms1:.4f}  2LPT {rms2:.4f}  "
          f"ratio {rms2 / rms1:.4f}")
    print(f"rms velocity:     1LPT {vrms1:.2f}  2LPT {vrms2:.2f}  "
          f"ratio {vrms2 / vrms1:.4f}")
    print(f"2nd-order displacement rms: {rms_2nd:.4f} "
          f"({rms_2nd / rms1 * 100:.2f}% of 1LPT)")
    print(f"1LPT x 2LPT cross-correlation: {corr:.6f}")
    return {"rms1": rms1, "rms2": rms2, "vrms1": vrms1, "vrms2": vrms2,
            "rms_2nd": rms_2nd, "corr": corr}


if __name__ == "__main__":
    main()
