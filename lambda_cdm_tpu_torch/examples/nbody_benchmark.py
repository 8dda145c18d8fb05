"""N-body throughput and energy conservation (counterpart of
examples/nbody_benchmark.py): N particles, direct summation (K4 on the
card), KDK leapfrog in box units, the relative energy drift (EnergyMonitor,
K9 on the card) and particle-updates/s.

    python -m lambda_cdm_tpu_torch.examples.nbody_benchmark [N] [steps]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import lambda_cdm_tpu_torch as lt
from lambda_cdm_tpu_torch.utils import prng
from lambda_cdm_tpu_torch.utils.precision import disable_tf32
from lambda_cdm_tpu_torch.utils.profiling import synchronize


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=10_000)
    ap.add_argument("steps", nargs="?", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    disable_tf32()
    n, steps = args.n, args.steps

    monitor = lt.EnergyMonitor()
    engine = (lt.SimulationBuilder(device=args.device)
              .with_particles(n)
              .with_box_size(100.0)
              .with_time_step(1e-4)
              .with_force_computer("direct", softening_length=0.1)
              .with_cosmology(initial_redshift=9.0, model="Newtonian")
              .with_initial_conditions("uniform_random")
              .with_units("box", G=1.0, H0_internal=0.1)
              .with_observer(lt.ProgressObserver(every=max(steps // 10, 1)))
              .with_observer(monitor)
              .build())

    # small random velocities: jax.random.normal(PRNGKey(1)), as the JAX
    # example draws them
    st = engine.state
    vel = 0.05 * prng.normal(prng.PRNGKey(1), tuple(st.velocities.shape),
                             device=st.velocities.device)
    engine.state = st.replace(velocities=vel)

    t0 = time.perf_counter()
    engine.run(num_steps=steps)
    synchronize(engine.state.positions)
    wall = time.perf_counter() - t0

    err = monitor.history[-1]["relative_error"] if monitor.history else 0.0
    print(f"\nN={n}  steps={steps}  wall={wall:.2f}s")
    print(f"particle-updates/s: {n * steps / wall:.3e}")
    print(f"relative energy drift: {err:.3e} "
          f"({'PASS' if err < 1e-3 else 'CHECK'} vs 0.1% target, "
          f"reference CLAUDE.md:256)")
    return {"n": n, "steps": steps, "wall": wall,
            "updates_per_s": n * steps / wall, "drift": float(err)}


if __name__ == "__main__":
    main()
