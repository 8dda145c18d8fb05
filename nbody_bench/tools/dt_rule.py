"""The time step a cell holds fixed, beside the one the port's engine
takes by the same rule: the benchmark's rule_dt (nbody_bench/inputs.py,
|a|max from the reference over its sample) and the engine's adaptive
step at the start state (|a|max over every particle by the program's
forces), with the start state's fullest search cell and the scale
factor after one segment at the benchmark's dt.

    python3 nbody_bench/tools/dt_rule.py <cell> [--seeds 0 1 2]

The engine's step is read from its private `_dt`, which no run of the
benchmark reads.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from nbody_bench import harness, inputs, reference  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.core.engine import SimulationEngine
    from lambda_cdm_tpu_torch.core.state import make_state
    cell = harness.Cell(args.cell)
    g = cell.geometry
    for seed in args.seeds:
        st = inputs.start_state(cell.config, cell.traffic, seed, "cuda")
        cid = reference.cell_ids(st["pos"], g["box"],
                                 reference.search_grid(g["box"], g["rs"]))
        occ = torch.bincount(cid)
        mass = torch.full((cell.n,), st["mass"], device="cuda")
        eng = SimulationEngine(SimulationConfig.from_dict(cell.config),
                               device="cuda")
        eng.initialize(state=make_state(st["pos"], st["vel"], mass,
                                        scale_factor=st["a"]))
        eng._update_dt()
        engine_dt = float(eng._dt)
        del eng
        eng = SimulationEngine(cell.engine_config(st["dt"]), device="cuda")
        eng.initialize(state=make_state(st["pos"], st["vel"], mass,
                                        scale_factor=st["a"]))
        a_end = float(eng.run(num_steps=cell.steps).scale_factor)
        print(f"{args.cell} seed {seed}: a {st['a']!r} dt {st['dt']!r} "
              f"engine dt {engine_dt!r} a after {cell.steps} steps "
              f"{a_end!r} fullest search cell {int(occ.max())} of mean "
              f"{float(occ.float().mean())!r}", flush=True)
        del eng
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
