"""Lensing raytracer demo (counterpart of examples/lensing_demo.py):
evolve a box, make its Born convergence and shear maps, trace a ray
bundle through its density planes with the distortion Jacobians (the
trace kernel on the card), and print the maps' flat-sky spectra beside
Limber's.

    python -m lambda_cdm_tpu_torch.examples.lensing_demo [--n-side 32]
        [--steps 40] [--ng 64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

import lambda_cdm_tpu_torch as lt
from lambda_cdm_tpu_torch.analysis.power_spectrum import (
    angular_power_spectrum, shear_eb_spectra)
from lambda_cdm_tpu_torch.physics.cosmology import comoving_distance
from lambda_cdm_tpu_torch.raytracing import lensing as lz
from lambda_cdm_tpu_torch.utils.precision import disable_tf32

N_PLANES, N_RAYS_SIDE = 8, 16


def analyze(st, params, box: float, ng: int) -> dict:
    """The demo's maps, trace and spectra on state `st`; prints them and
    returns the printed numbers."""
    dev = st.positions.device
    kappa = lz.convergence_map_from_state(st, params, box, ng=ng,
                                          n_planes=N_PLANES, z_source=1.0)
    out = {"kappa_rms": float(torch.std(kappa, correction=0)),
           "kappa_min": float(kappa.min()), "kappa_max": float(kappa.max())}
    print(f"kappa map {ng}x{ng}: rms={out['kappa_rms']:.3e} "
          f"min={out['kappa_min']:.3e} max={out['kappa_max']:.3e}")
    gamma = lz.shear_from_kappa(kappa, box, ng=ng)
    out["shear_rms"] = float(torch.sqrt(torch.mean(torch.sum(gamma ** 2,
                                                             0))))
    print(f"shear rms: {out['shear_rms']:.3e}")

    planes, d_chi = lz.snapshot_lightcone_planes(
        st.positions, st.masses, box, ng=ng, n_planes=N_PLANES)
    chi_s = float(comoving_distance(params, 1.0) * params.h)
    chis = torch.linspace(0.3 * chi_s, 0.7 * chi_s, N_PLANES, device=dev)
    a_l = torch.full((N_PLANES,), float(st.scale_factor), device=dev)
    side = torch.linspace(0.2, 0.8, N_RAYS_SIDE, device=dev) * box / chis[0]
    th = torch.stack(torch.meshgrid(side, side, indexing="ij"),
                     -1).reshape(-1, 2)
    bundle = lz.trace_rays(params, planes, chis, a_l, d_chi, box, th,
                           chi_s, ng=ng, jacobian=True)
    defl = torch.sqrt(torch.sum((bundle.theta - th) ** 2, -1))
    out.update(mean_deflection=float(torch.mean(defl)),
               ray_kappa_rms=float(torch.std(bundle.kappa, correction=0)),
               ray_shear_rms=float(torch.sqrt(torch.mean(torch.sum(
                   bundle.gamma ** 2, -1)))),
               mu_rms=float(torch.std(bundle.mu, correction=0)),
               omega_rms=float(torch.std(bundle.omega, correction=0)))
    print(f"traced {th.shape[0]} rays through {N_PLANES} planes: "
          f"mean |deflection| = {out['mean_deflection']:.3e} rad, "
          f"ray kappa rms = {out['ray_kappa_rms']:.3e}")
    print(f"ray-traced shear rms = {out['ray_shear_rms']:.3e}, "
          f"mu rms-1 = {out['mu_rms']:.3e}, "
          f"omega rms = {out['omega_rms']:.3e}")

    fov = box / chi_s
    ell, cl, counts = angular_power_spectrum(kappa, fov, num_bins=8)
    _, cee, cbb, _, _ = shear_eb_spectra(gamma[0], gamma[1], fov,
                                         num_bins=8)
    cl_th = lz.limber_convergence_cl(params, ell, 1.0)
    print("ell        C_ell(kappa)  C_EE          C_BB          "
          "Limber(linear)")
    rows = []
    for i in range(len(ell)):
        if float(counts[i]) > 0:
            row = tuple(float(x[i]) for x in (ell, cl, cee, cbb, cl_th))
            rows.append(row)
            print(f"{row[0]:9.1f}  {row[1]:.4e}  {row[2]:.4e}  "
                  f"{row[3]:.4e}  {row[4]:.4e}")
    print("(C_EE == C_ell(kappa) and C_BB ~ 0: shear here derives from "
          "that same kappa map.\n The Limber column assumes a fully "
          "evolved z~0 lightcone -- this demo's 40-step\n 32^3 box is "
          "deliberately tiny; tests/test_lensing_limber.py validates "
          "the\n absolute normalization against theory.)")
    out["spectra"] = rows
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-side", type=int, default=32)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ng", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    disable_tf32()
    engine = (lt.SimulationBuilder(device=args.device)
              .with_particles(args.n_side ** 3)
              .with_box_size(200.0)
              .with_time_step(5e-6)
              .with_force_computer("treepm", pm_grid_size=2 * args.n_side,
                                   softening_length=0.1)
              .with_cosmology(initial_redshift=24.0)
              .with_initial_conditions("2lpt", grid_size=args.n_side,
                                       random_seed=5)
              .build())
    engine.run(num_steps=args.steps)
    return analyze(engine.state, engine.config.cosmology_params(),
                   engine.config.particles.box_size, args.ng)


if __name__ == "__main__":
    main()
