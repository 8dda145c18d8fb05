"""2D-pencil sharded fast-stepper demo (counterpart of
examples/pencil2d_demo.py): the fast stepper's buckets sharded over a
(2, ranks / 2) rank grid as (cx, cy) rods of cells with z whole
(parallel/fast_mesh2d), driven directly, then through the engine with
compute.mesh.axes {shx, shy}. 8192 particles in a 64 Mpc/h box, PM 48,
8 steps each.

    torchrun --nproc-per-node 8 -m lambda_cdm_tpu_torch.examples.pencil2d_demo
    python -m lambda_cdm_tpu_torch.examples.pencil2d_demo [--ranks 8]
        [--device cuda|cpu] [--backend gloo|nccl]

The rank count must be even and at least 4 (under torchrun, or spawned
with --ranks; the launcher is multichip_demo's).
"""

from __future__ import annotations

import torch


def run(mesh) -> dict:
    """The demo on this rank; prints on rank 0 and returns the printed
    numbers (equal on every rank)."""
    from lambda_cdm_tpu_torch import SimulationConfig, SimulationEngine
    from lambda_cdm_tpu_torch.parallel.fast_mesh2d import (
        initialize_mesh_fast2d, mesh_fast_run2d)
    from lambda_cdm_tpu_torch.parallel.mesh import make_mesh2d
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    from lambda_cdm_tpu_torch.utils import prng

    def say(msg):
        if mesh.rank == 0:
            print(msg, flush=True)

    n_dev = mesh.size
    if n_dev < 4 or n_dev % 2:
        raise ValueError(f"needs an even rank count >= 4, have {n_dev}")
    shape = (2, n_dev // 2)
    grid = make_mesh2d(shape, device=mesh.device)
    say(f"2D mesh {shape} over {grid.device.type} ranks ({grid.transport})")

    n, box, ng = 8192, 64.0, 48
    # jax.random.uniform(PRNGKey(0), (n, 3), maxval=box), on every rank
    pos = prng.uniform(prng.PRNGKey(0), (n, 3), 0.0, box, device=grid.device)
    vel = torch.zeros((n, 3), device=grid.device)
    mass = torch.full((n,), 13.0, device=grid.device)
    params = CosmologyParams()

    fs, kw = initialize_mesh_fast2d(pos, vel, mass, 0.5, mesh=grid,
                                    box_size=box, pm_grid=ng, softening=0.3)
    out = {"ncell": kw["ncell"], "capacity": kw["capacity"], "rs": kw["rs"]}
    say(f"plan: ncell={kw['ncell']} capacity={kw['capacity']} "
        f"rs={kw['rs']:.3f}")
    fs = mesh_fast_run2d(fs, params, 2e-4, mesh=grid, n_steps=8,
                         rebucket_every=4, **kw)
    out.update(steps=int(fs.step), a=float(fs.scale_factor),
               overflow=int(fs.overflow), dropped=int(fs.dropped))
    say(f"ran {out['steps']} steps: a={out['a']:.4f} "
        f"overflow={out['overflow']} dropped={out['dropped']}")

    # the same thing through the engine/config surface
    cfg = SimulationConfig()
    cfg.particles.num_particles = n
    cfg.particles.box_size = box
    cfg.particles.initial_conditions.type = "uniform_random"
    cfg.forces.type = "treepm_fast"
    cfg.forces.pm_grid_size = ng
    cfg.forces.softening_length = 0.3
    cfg.time.initial_timestep = 2e-4
    cfg.cosmology.initial_redshift = 1.0
    cfg.simulation.checkpoint_frequency = 0
    cfg.profiling.output_file = ""
    cfg.compute.mesh.enabled = True
    cfg.compute.mesh.axes = {"shx": shape[0], "shy": shape[1]}
    eng = SimulationEngine(cfg, device=grid.device)
    eng.initialize()
    eng.run(num_steps=8)
    out.update(engine_steps=eng.statistics.total_steps,
               engine_a=float(eng.state.scale_factor),
               engine_pencils=eng._stepper is not None
               and eng._stepper.ndim == 2)
    say(f"engine (2D mesh): {out['engine_steps']} steps, "
        f"a={out['engine_a']:.4f}")
    return out


def main(argv=None) -> dict:
    from lambda_cdm_tpu_torch.examples._launch import main as launch
    return launch("lambda_cdm_tpu_torch.examples.pencil2d_demo", argv,
                  description=__doc__.splitlines()[0], default_ranks=8)


if __name__ == "__main__":
    main()
