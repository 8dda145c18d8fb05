"""3D block-decomposition demo (counterpart of examples/mesh3d_demo.py)
on a (2, 2, 2) rank grid, in four sections: the particles migrated to
their owning blocks (one all_to_all over the flattened grid); the
stateless TreePM with the block halo exchange (parallel/sharded_treepm:
faces, edges and corners in six dimension-ordered shifts); the
persistent 3D block fast stepper (parallel/fast_mesh3d); and the engine
with treepm_fast on compute.mesh.axes {shx: 2, shy: 2, shz: 2}.

    torchrun --nproc-per-node 8 -m lambda_cdm_tpu_torch.examples.mesh3d_demo
    python -m lambda_cdm_tpu_torch.examples.mesh3d_demo [--ranks 8]
        [--device cuda|cpu] [--backend gloo|nccl]

It needs 8 ranks (under torchrun, or spawned with --ranks; the launcher
is multichip_demo's).
"""

from __future__ import annotations

import torch


def run(mesh) -> dict:
    """The demo on this rank; prints on rank 0 and returns the printed
    numbers (equal on every rank)."""
    from lambda_cdm_tpu_torch import SimulationConfig, SimulationEngine
    from lambda_cdm_tpu_torch.parallel import sharded_treepm as stp
    from lambda_cdm_tpu_torch.parallel.exchange import (migrate_particles,
                                                        pad_particles)
    from lambda_cdm_tpu_torch.parallel.fast_mesh3d import (
        initialize_mesh_fast3d, mesh_fast_run3d)
    from lambda_cdm_tpu_torch.parallel.mesh import make_mesh3d, shard_rows
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    from lambda_cdm_tpu_torch.utils import prng

    def say(msg):
        if mesh.rank == 0:
            print(msg, flush=True)

    if mesh.size != 8:
        raise ValueError(f"the (2, 2, 2) grid needs 8 ranks, have "
                         f"{mesh.size}")
    grid = make_mesh3d((2, 2, 2), device=mesh.device)
    say(f"3D rank mesh: {grid.shape} ({grid.transport})")

    n, box, ng = 4096, 100.0, 64
    pos = prng.uniform(prng.PRNGKey(0), (n, 3), 0.0, box, device=grid.device)
    vel = torch.zeros((n, 3), device=grid.device)
    m = torch.ones((n,), device=grid.device)

    # 1) migrate the particles to their owning (i, j, k) blocks
    pos, vel, m = pad_particles(pos, vel, m, n_dev=8, factor=1.5)
    pos, vel, m = (shard_rows(x, grid) for x in (pos, vel, m))
    pos, vel, m, ovf = migrate_particles(pos, vel, m, box_size=box,
                                         capacity=pos.shape[0], mesh=grid)
    live = int(grid.all_reduce(torch.sum(m > 0).reshape(1))[0])
    out = {"migration_overflow": ovf, "live": live}
    say(f"3D migration: overflow={ovf} (live rows per block: {live})")

    # 2) the stateless TreePM: the sharded PM long range + the
    # 26-neighbour halo short range
    acc, diag = stp.sharded_treepm_accelerations(
        pos, m, box_size=box, pm_grid=ng, softening=0.5, g_const=43.007,
        mesh=grid, return_diagnostics=True)
    norms = grid.all_gather(torch.linalg.norm(acc, dim=1))
    # jnp.median over the global rows (the mean of the middle two)
    mid = torch.sort(norms).values[norms.shape[0] // 2 - 1:
                                   norms.shape[0] // 2 + 1]
    out.update(halo_nc=diag["plan"]["nc"], halo_cap=diag["plan"]["capacity"],
               halo_overflow=diag["overflow"],
               acc_p50=float(torch.mean(mid)))
    say(f"block-halo TreePM: plan nc={out['halo_nc']} "
        f"cap={out['halo_cap']} overflow={out['halo_overflow']} "
        f"|acc| p50={out['acc_p50']:.3e}")

    # 3) the persistent 3D block fast stepper: every rank hands it the
    # global rows (the JAX demo's sharded global array, in rank order)
    fs3, kw3 = initialize_mesh_fast3d(
        grid.all_gather(pos), grid.all_gather(vel), grid.all_gather(m), 0.1,
        mesh=grid, box_size=box, pm_grid=ng, softening=0.5)
    fs3 = mesh_fast_run3d(fs3, CosmologyParams(), 2e-5, mesh=grid,
                          n_steps=4, rebucket_every=2, **kw3)
    out.update(fast_ncell=kw3["ncell"], fast_cap=kw3["capacity"],
               fast_step=int(fs3.step), fast_overflow=int(fs3.overflow),
               fast_dropped=int(fs3.dropped))
    say(f"persistent 3D fast stepper: ncell={out['fast_ncell']} "
        f"cap={out['fast_cap']} step={out['fast_step']} "
        f"overflow={out['fast_overflow']} dropped={out['fast_dropped']}")

    # 4) the same grid behind the engine: treepm_fast takes the block
    # stepper above
    cfg = SimulationConfig()
    cfg.particles.num_particles = 4096
    cfg.particles.box_size = box
    cfg.forces.type = "treepm_fast"
    cfg.forces.pm_grid_size = ng
    cfg.forces.softening_length = 0.5
    cfg.compute.mesh.enabled = True
    cfg.compute.mesh.axes = {"shx": 2, "shy": 2, "shz": 2}
    cfg.cosmology.initial_redshift = 24.0
    cfg.cosmology.final_redshift = 0.0
    eng = SimulationEngine(cfg, device=grid.device)
    eng.initialize()
    eng.run(num_steps=4)
    e = eng.compute_energy()
    st = eng.state
    out.update(engine_step=int(st.step),
               engine_blocks=eng._stepper is not None
               and eng._stepper.ndim == 3,
               **{f"engine_{k}": float(v) for k, v in e.items()},
               engine_state=[x.cpu().tolist() for x in (
                   st.positions, st.velocities, st.masses)])
    say(f"engine on the 3D mesh (treepm_fast): step={out['engine_step']} "
        f"E_total={out['engine_total']:.4e}")
    return out


def main(argv=None) -> dict:
    from lambda_cdm_tpu_torch.examples._launch import main as launch
    return launch("lambda_cdm_tpu_torch.examples.mesh3d_demo", argv,
                  description=__doc__.splitlines()[0], default_ranks=8)


if __name__ == "__main__":
    main()
