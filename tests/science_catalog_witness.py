"""The science run's halo mass function from exact FoF labels through the
JAX package's catalogue, on the CPU: a witness for the port's science
certificate that needs neither package's FoF.

The exact FoF components of a science record's final particles (the
cKDTree oracle of chip_smoke.py, b = 0.2 mean separations) go through the
JAX package's `catalog_from_labels`, and the science run's HMF rule (FoF
masses n * m_p, 8 log bins from 32 m_p, bins of >= 8 halos, the ratio to
Sheth-Tormen and its geometric mean) is applied to its catalogue. The
script prints that beside the record's own certificate (SCIENCE.json in
the record's directory) and the JAX package's TPU certificate
(SCIENCE.json at the repository root). Its FoF skips overflow adoption,
so it reads the exact components where the run's FoF plan overflows.

    JAX_PLATFORMS=cpu python tests/science_catalog_witness.py \\
        [chiprun_out/chip_smoke_science/science_record.npz]

One line of JSON on stdout. About a minute and 10 GB at 1M particles.
"""

import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def hmf(sizes, m_p: float, box: float, a_f: float, params) -> dict:
    """The science run's HMF rule (science_run.analyze_phase) on FoF group
    sizes."""
    import jax.numpy as jnp
    from lambda_cdm_tpu.analysis.theory import mass_function
    sizes = np.sort(np.asarray(sizes))[::-1]
    h_masses = sizes.astype(np.float64) * m_p
    edges = np.logspace(np.log10(32.0 * m_p),
                        np.log10(float(h_masses[0]) * (1 + 1e-5)), 9)
    counts, _ = np.histogram(h_masses, bins=edges)
    centers = np.sqrt(edges[:-1] * edges[1:])
    measured = counts / (box ** 3 * np.log10(edges[1] / edges[0]))
    theory = np.asarray(mass_function(
        params, jnp.asarray(centers), z=max(1.0 / a_f - 1.0, 0.0))) \
        * math.log(10.0)
    ok = counts >= 8
    r = measured[ok] / theory[ok]
    return {"counts": counts[ok].tolist(),
            "ratio_vs_st": [round(float(x), 4) for x in r],
            "gmean": float(np.exp(np.mean(np.log(r))))}


def bands(sizes) -> dict:
    sizes = np.asarray(sizes)
    return {"halos": int(np.sum(sizes >= 20)),
            "n20_31": int(np.sum((sizes >= 20) & (sizes <= 31))),
            "n32_63": int(np.sum((sizes >= 32) & (sizes <= 63)))}


def certificate(path: str) -> dict:
    with open(path) as f:
        cert = json.load(f)
    counts = cert["hmf"]["counts"]
    n_h = cert["checks"]["num_halos"]["value"]
    # outside the bins: the halos of up to 32 particles (32 m_p rounds
    # below the first edge) and those of bins of < 8 halos
    return {"halos": n_h, "outside_bins": n_h - int(sum(counts)),
            "counts": counts,
            "gmean": cert["checks"]["hmf_band_gmean_vs_st"]["value"]}


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from chip_smoke import fof_oracle
    from lambda_cdm_tpu.analysis.halo_finder import catalog_from_labels, \
        catalog_window_plan
    from lambda_cdm_tpu.physics.cosmology import CosmologyParams
    path = argv[0] if argv else os.path.join(
        ROOT, "chiprun_out", "chip_smoke_science", "science_record.npz")
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        pos, vel, mass = z["pos_f"], z["vel_f"], z["masses"]
    box, n = meta["geometry"]["box"], meta["n"]
    labels, links, _ = fof_oracle(pos, box, 0.2 * box / n ** (1.0 / 3.0))
    sizes = np.unique(labels, return_counts=True)[1]
    n_groups = int(np.sum(sizes >= 20))
    pos_j = jnp.asarray(pos)
    cat = catalog_from_labels(
        pos_j, jnp.asarray(vel), jnp.asarray(mass),
        jnp.asarray(labels.astype(np.int32)), box,
        max_halos=max(256, 1 << max(n_groups - 1, 0).bit_length()),
        min_particles=20,
        window=catalog_window_plan(pos_j, box, live=jnp.asarray(mass) > 0))
    cat_sizes = np.asarray(cat.n_particles)[:int(cat.num_halos)]
    out = {"record": os.path.relpath(path, ROOT), "fof_links": links,
           "jax_catalogue_of_exact_fof": dict(
               bands(cat_sizes), **hmf(cat_sizes, meta["m_p"], box,
                                       meta["a_f"], CosmologyParams())),
           "record_certificate": certificate(
               os.path.join(os.path.dirname(path), "SCIENCE.json")),
           "tpu_certificate": certificate(os.path.join(ROOT,
                                                       "SCIENCE.json"))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
