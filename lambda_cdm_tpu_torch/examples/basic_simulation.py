"""Config-driven end-to-end simulation through SimulationBuilder
(counterpart of examples/basic_simulation.py): 60 steps of the stateless
TreePM with P(k), conservation and progress observers, then the last
P(k) and the profiler's summary.

    python -m lambda_cdm_tpu_torch.examples.basic_simulation [config.json]
        [--steps 60] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import lambda_cdm_tpu_torch as lt
from lambda_cdm_tpu_torch.utils.precision import disable_tf32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", help="a config file (JSON/YAML/"
                    "TOML); default: 32^3 particles, TreePM on 64^3")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    disable_tf32()
    builder = lt.SimulationBuilder(device=args.device)
    if args.config:
        builder.with_config_file(args.config)
    else:
        (builder
         .with_particles(32 ** 3)
         .with_box_size(100.0)
         .with_time_step(5e-6)
         .with_force_computer("treepm", pm_grid_size=64,
                              softening_length=0.05)
         .with_cosmology(initial_redshift=49.0, final_redshift=20.0)
         .with_initial_conditions("2lpt", grid_size=32, random_seed=1))

    ps_obs = lt.PowerSpectrumObserver(frequency=20, grid_size=64,
                                      num_bins=24)
    engine = (builder
              .with_observer(lt.ProgressObserver(every=10))
              .with_observer(ps_obs)
              .with_observer(lt.ConservationObserver())
              .build())
    engine.run(num_steps=args.steps)

    out = {"pk": []}
    if ps_obs.results:
        last = ps_obs.results[-1]
        out.update(step=last["step"], scale_factor=last["scale_factor"])
        print(f"\nP(k) at step {last['step']} "
              f"(a={last['scale_factor']:.4f}):")
        for k, p, c in zip(last["k"], last["power"], last["counts"]):
            if c > 10:
                print(f"  k={k:.3f}  P={p:.3f}")
                out["pk"].append((float(k), float(p)))
    engine.profiler.print_summary()
    return out


if __name__ == "__main__":
    main()
