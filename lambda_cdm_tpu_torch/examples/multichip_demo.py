"""Multi-rank sharded simulation demo (counterpart of
examples/multichip_demo.py): the ring direct forces, the all_to_all
migration, the load imbalance and the ring energy over the rank mesh
(parallel/), 512 particles a rank, 10 KDK steps with a migration every 5.

    torchrun --nproc-per-node 4 -m lambda_cdm_tpu_torch.examples.multichip_demo
    python -m lambda_cdm_tpu_torch.examples.multichip_demo [--ranks 4]
        [--device cuda|cpu] [--backend gloo|nccl]

Under torchrun it joins the process group torchrun describes; otherwise
it spawns --ranks processes itself. The backend defaults to nccl when
every rank has a card of its own, else gloo (several ranks on one card:
their exchanges are staged through host memory, Mesh.transport).

As in the JAX example, the acceleration carried into the step after a
migration is the one computed before it, in the old row order: the demo
shows the exchange and the collectives, not a physics run.
"""

from __future__ import annotations

import torch


def run(mesh) -> dict:
    """The demo on this rank of `mesh`; prints on rank 0 and returns the
    printed numbers (equal on every rank)."""
    from lambda_cdm_tpu_torch.core.state import make_state
    from lambda_cdm_tpu_torch.parallel.exchange import (load_imbalance,
                                                        migrate_particles,
                                                        pad_particles)
    from lambda_cdm_tpu_torch.parallel.mesh import shard_state
    from lambda_cdm_tpu_torch.parallel.sharded import (
        ring_direct_accelerations, sharded_energy)
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    from lambda_cdm_tpu_torch.physics.integrators import kdk_step_fused
    from lambda_cdm_tpu_torch.utils import prng

    def say(msg):
        if mesh.rank == 0:
            print(msg, flush=True)

    n_dev = mesh.size
    say(f"mesh: {n_dev} x {mesh.device.type} ({mesh.transport})")
    n, box, soft, dt = 512 * n_dev, 100.0, 0.5, 1e-5
    params = CosmologyParams()
    # jax.random.uniform(PRNGKey(0), (n, 3), maxval=box), on every rank
    pos = prng.uniform(prng.PRNGKey(0), (n, 3), 0.0, box,
                       device=mesh.device)
    vel = torch.zeros((n, 3), device=mesh.device)
    mass = torch.ones((n,), device=mesh.device)
    pos, vel, mass = pad_particles(pos, vel, mass, n_dev=n_dev, factor=1.5)
    state = shard_state(make_state(pos, vel, mass, scale_factor=0.1), mesh)

    def accel(st):
        return ring_direct_accelerations(st.positions, st.masses,
                                         box_size=box, softening=soft,
                                         mesh=mesh)

    out = {"migrations": []}
    acc = accel(state)
    for i in range(10):
        state, acc = kdk_step_fused(state, acc, accel, params, dt, box,
                                    h0_internal=100.0)
        if i % 5 == 4:
            # the self bucket must hold every stayer after an earlier
            # homing, so the capacity is the rows a rank holds
            n_loc = state.positions.shape[0]
            p2, v2, m2, ovf = migrate_particles(
                state.positions, state.velocities, state.masses,
                box_size=box, capacity=n_loc, mesh=mesh)
            state = state.replace(positions=p2, velocities=v2, masses=m2)
            imb = load_imbalance(state.masses, mesh=mesh)
            out["migrations"].append({"step": i + 1, "overflow": ovf,
                                      "imbalance": imb})
            say(f"step {i + 1}: migrated (overflow={ovf}), "
                f"load imbalance {imb:.3f}")

    e = sharded_energy(state.positions, state.velocities, state.masses,
                       box_size=box, softening=soft, g_const=1.0, mesh=mesh)
    out.update(kinetic=float(e["kinetic"]), potential=float(e["potential"]),
               live=int(mesh.all_reduce(torch.sum(state.masses > 0)
                                        .reshape(1))[0]),
               transport=mesh.transport)
    say(f"final energy (sum over {n_dev} ranks): "
        f"KE={out['kinetic']:.4e} PE={out['potential']:.4e}")
    return out


def main(argv=None) -> dict:
    from lambda_cdm_tpu_torch.examples._launch import main as launch
    return launch("lambda_cdm_tpu_torch.examples.multichip_demo", argv,
                  description=__doc__.splitlines()[0], default_ranks=4)


if __name__ == "__main__":
    main()
