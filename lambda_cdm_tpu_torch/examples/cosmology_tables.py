"""Background-cosmology tables: H(z), ages, distances, growth and the
linear P(k) (counterpart of examples/cosmology_tables.py).

    python -m lambda_cdm_tpu_torch.examples.cosmology_tables
        [--device cuda|cpu]

The background functions run on host scalars; the P(k) wavenumbers are
tensors on `--device`.
"""

from __future__ import annotations

import argparse

import torch

from lambda_cdm_tpu_torch.physics import cosmology as cos
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
from lambda_cdm_tpu_torch.physics.power_spectra import linear_power

REDSHIFTS = (0.0, 0.5, 1.0, 2.0, 5.0, 10.0, 49.0)
WAVENUMBERS = (0.01, 0.05, 0.1, 0.5, 1.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    p = CosmologyParams()
    age = float(cos.age_of_universe(p))
    print(f"Omega_m={p.omega_m} Omega_L={p.omega_lambda} h={p.h} "
          f"sigma8={p.sigma8} ns={p.n_s}")
    print(f"age of universe: {age:.3f} Gyr\n")

    print(f"{'z':>6} {'H(z)':>9} {'D_C[Mpc]':>10} {'D_A':>9} {'D_L':>10} "
          f"{'D(z)':>7} {'f(z)':>7}")
    rows = []
    for z in REDSHIFTS:
        a = 1.0 / (1.0 + z)
        row = (z, float(cos.hubble(p, a)),
               float(cos.comoving_distance(p, z)),
               float(cos.angular_diameter_distance(p, z)),
               float(cos.luminosity_distance(p, z)),
               float(cos.growth_factor(p, a)), float(cos.growth_rate(p, a)))
        rows.append(row)
        print(f"{row[0]:6.1f} {row[1]:9.2f} {row[2]:10.1f} {row[3]:9.1f} "
              f"{row[4]:10.1f} {row[5]:7.4f} {row[6]:7.4f}")

    print(f"\n{'k [h/Mpc]':>10} {'P(k,z=0)':>12}")
    pk = linear_power(p, torch.tensor(WAVENUMBERS, dtype=torch.float32,
                                      device=args.device))
    for k, v in zip(WAVENUMBERS, pk.tolist()):
        print(f"{k:10.3f} {v:12.2f}")
    return {"age": age, "rows": rows, "pk": pk.tolist()}


if __name__ == "__main__":
    main()
