"""Zel'dovich initial conditions with statistical validation (counterpart
of examples/zeldovich_demo.py): displacement and velocity statistics and
the measured P(k) against linear theory.

    python -m lambda_cdm_tpu_torch.examples.zeldovich_demo [--ng 64]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from lambda_cdm_tpu_torch.analysis.power_spectrum import \
    measure_power_spectrum
from lambda_cdm_tpu_torch.physics import initial_conditions as ics
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams, \
    growth_factor
from lambda_cdm_tpu_torch.physics.power_spectra import linear_power
from lambda_cdm_tpu_torch.utils import prng


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ng", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ng, box, z_init = args.ng, 250.0, 49.0
    params = CosmologyParams()
    a = 1.0 / (1.0 + z_init)

    pos, vel = ics.lpt_displacements(
        prng.PRNGKey(42), params, ng=ng, n_side=ng, box_size=box,
        a_init=a, use_2lpt=False, device=args.device)
    print(f"generated {ng ** 3} particles at z={z_init} in ({box} Mpc/h)^3")

    stats = ics.displacement_statistics(pos, box, ng)
    vrms = float(torch.sqrt(torch.mean(torch.sum(vel ** 2, -1))))
    print(f"rms displacement: {float(stats['rms_displacement']):.4f} Mpc/h "
          f"(cell = {box / ng:.3f})")
    print(f"max displacement: {float(stats['max_displacement']):.4f}")
    print(f"rms velocity: {vrms:.2f} km/s")

    data = measure_power_spectrum(pos, box, ng=ng, num_bins=16,
                                  subtract_shot_noise=False)
    d = float(growth_factor(params, a))
    k = data.k.cpu().numpy()
    p = data.power.cpu().numpy()
    c = data.counts.cpu().numpy()
    rows = []
    print(f"\n{'k':>8} {'P_meas':>10} {'P_lin(z)':>10} {'ratio':>7}")
    for i in range(len(k)):
        if c[i] > 20 and k[i] < 0.3:
            pl = float(linear_power(params, float(k[i]))) * d * d
            rows.append((float(k[i]), float(p[i]), pl))
            print(f"{k[i]:8.4f} {p[i]:10.3f} {pl:10.3f} {p[i] / pl:7.3f}")
    return {"rms": float(stats["rms_displacement"]),
            "max": float(stats["max_displacement"]), "vrms": vrms,
            "pk": rows}


if __name__ == "__main__":
    main()
