"""Command-line interface: run / resume / analyze / validate / info
(counterpart of lambda_cdm_tpu/cli.py), on the CUDA card:

    python -m lambda_cdm_tpu_torch run examples/configs/treepm_1m.json \\
        --time.max_steps=40
    python -m lambda_cdm_tpu_torch run examples/configs/direct_10k.json
    python -m lambda_cdm_tpu_torch resume output/checkpoint_000200.npz
    python -m lambda_cdm_tpu_torch analyze snap.npz --pk-out pk.txt \\
        --halos-out halos.npz                     # offline P(k)+halos
    python -m lambda_cdm_tpu_torch validate cfg.json   # schema check
    python -m lambda_cdm_tpu_torch info                # device banner

Any --dotted.path=value argument overrides the config; LCDM_* environment
variables override too. `main(argv, device="cpu")` runs the same commands
on the CPU (the kernels' plain versions), as the tests do.
"""

from __future__ import annotations

import argparse
import sys


def _build_engine(config, with_observers=True, device="cuda"):
    from .core.analysis_observers import build_observers_from_config
    from .core.engine import SimulationEngine
    from .core.observers import ProgressObserver

    observers = [ProgressObserver(every=config.simulation.output_frequency)]
    if with_observers:
        observers += build_observers_from_config(config)
    return SimulationEngine(config, observers=observers, device=device)


def cmd_run(argv, device="cuda") -> int:
    from .core.config import SimulationConfig

    if not argv or argv[0].startswith("--"):
        config = SimulationConfig()
        rest = list(argv)
    else:
        config = SimulationConfig.from_file(argv[0])
        rest = argv[1:]
    config.apply_env_overrides()
    rest = config.apply_cli_overrides(rest)
    if rest:
        print(f"warning: unrecognized arguments {rest}", file=sys.stderr)
    config.validate()

    engine = _build_engine(config, device=device)
    engine.initialize()
    engine.run()
    stats = engine.statistics
    print(f"final: steps={stats.total_steps} "
          f"z={stats.current_redshift:.4f} "
          f"{stats.particle_updates_per_second:.3e} particle-steps/s")
    return 0


def cmd_resume(argv, device="cuda") -> int:
    from .core.config import SimulationConfig
    from .utils.checkpoint import load_checkpoint

    if not argv:
        print("usage: resume <checkpoint.npz> [--overrides]",
              file=sys.stderr)
        return 2
    path, rest = argv[0], argv[1:]
    state, cfg_dict, _ = load_checkpoint(path, device)
    config = SimulationConfig.from_dict(cfg_dict) if cfg_dict \
        else SimulationConfig()
    config.apply_env_overrides()
    config.apply_cli_overrides(rest)
    engine = _build_engine(config, device=device)
    engine.initialize(state=state)
    engine.run()
    print(f"resumed from step {int(state.step)} -> "
          f"{engine.statistics.total_steps} more steps")
    return 0


def cmd_info(argv, device="cuda") -> int:
    """Versions, the CUDA card and what the port has."""
    import torch

    from . import __version__
    from .forces import available_force_computers

    print(f"lambda_cdm_tpu_torch {__version__}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    if torch.cuda.is_available():
        print(f"devices: {torch.cuda.device_count()} x cuda "
              f"({torch.cuda.get_device_name(0)})")
    else:
        print("devices: no CUDA device (the CPU runs the kernels' plain "
              "versions)")
    print(f"force computers: {', '.join(available_force_computers())}, "
          f"treepm_fast")
    print("capabilities: cosmology, zeldovich/2lpt/glass ICs, KDK leapfrog,")
    print("  direct gravity (CUDA kernels K4/K4s), PM/TreePM, treepm_fast")
    print("  gravity (CUDA kernels K1-K3), P(k), FoF+SO halos (CUDA kernel")
    print("  K5), diagnostics, force validation, npz/ascii snapshots,")
    print("  checkpoint/resume")
    return 0


def cmd_validate(argv, device="cuda") -> int:
    from .core.config import SimulationConfig

    if not argv:
        print("usage: validate <config.json>", file=sys.stderr)
        return 2
    config = SimulationConfig.from_file(argv[0])
    config.validate()
    print(f"{argv[0]}: valid "
          f"(N={config.particles.num_particles}, "
          f"box={config.particles.box_size}, "
          f"solver={config.forces.type})")
    return 0


def cmd_analyze(argv, device="cuda") -> int:
    """Offline analysis of a saved npz snapshot: P(k) + FoF/SO halos."""
    p = argparse.ArgumentParser(prog="analyze")
    p.add_argument("snapshot", help="snapshot/checkpoint file (npz)")
    p.add_argument("--box-size", type=float, default=None,
                   help="box size if the snapshot lacks config")
    p.add_argument("--ng", type=int, default=256,
                   help="P(k) mesh resolution")
    p.add_argument("--num-bins", type=int, default=64)
    p.add_argument("--max-halos", type=int, default=None,
                   help="catalog capacity (default: auto-size from the "
                        "qualifying group count)")
    p.add_argument("--min-particles", type=int, default=20)
    p.add_argument("--linking-length", type=float, default=0.2,
                   help="FoF b in units of the mean separation")
    p.add_argument("--pk-out", default=None,
                   help="write P(k) table (ascii) here")
    p.add_argument("--halos-out", default=None,
                   help="write halo catalog (npz) here")
    args = p.parse_args(argv)

    import numpy as np

    from .analysis.halo_finder import find_halos, mass_function
    from .analysis.power_spectrum import (measure_power_spectrum,
                                          save_power_spectrum,
                                          sigma8_from_power)
    from .utils.checkpoint import load_snapshot

    state, meta = load_snapshot(args.snapshot, device)
    box = args.box_size
    if box is None:
        box = ((meta or {}).get("config", {})
               .get("particles", {}).get("box_size"))
    if box is None:
        print("snapshot carries no config: pass --box-size",
              file=sys.stderr)
        return 2
    n_live = int((state.masses > 0).sum())
    print(f"{args.snapshot}: N={n_live} box={box} "
          f"a={float(state.scale_factor):.4f} step={int(state.step)}")

    pk = measure_power_spectrum(state.positions, float(box), ng=args.ng,
                                weights=state.masses,
                                num_bins=args.num_bins, deconvolve=True,
                                subtract_shot_noise=True)
    s8 = float(sigma8_from_power(pk))
    kk = pk.k.cpu().numpy()
    good = pk.counts.cpu().numpy() > 0
    print(f"P(k): {int(good.sum())} bins, "
          f"k=[{kk[good].min():.3f}, {kk[good].max():.3f}], "
          f"sigma8(snapshot)={s8:.4f}")
    if args.pk_out:
        save_power_spectrum(args.pk_out, pk)
        print(f"wrote {args.pk_out}")

    cat = find_halos(state.positions, state.velocities, state.masses,
                     float(box),
                     linking_length_factor=args.linking_length,
                     min_particles=args.min_particles,
                     max_halos=args.max_halos)
    nh = int(cat.num_halos)
    host = {k: getattr(cat, k).cpu().numpy()
            for k in ("n_particles", "center", "velocity", "mass", "radius",
                      "v_max", "angular_momentum", "spin",
                      "particle_label")}
    print(f"halos: {nh} with >= {args.min_particles} particles")
    if nh:
        for i in np.argsort(-host["mass"][:nh])[:5]:
            print(f"  M={float(host['mass'][i]):.3e} "
                  f"R200={float(host['radius'][i]):.3f} "
                  f"vmax={float(host['v_max'][i]):.1f} "
                  f"np={int(host['n_particles'][i])} "
                  f"at {np.round(host['center'][i], 2)}")
        _, _, counts = mass_function(cat, float(box))
        print(f"mass function: {int((counts > 0).sum())} occupied bins")
    if args.halos_out:
        np.savez(args.halos_out, num_halos=nh,
                 **{k: (v if k == "particle_label" else v[:nh])
                    for k, v in host.items()})
        print(f"wrote {args.halos_out}")
    return 0


COMMANDS = {"run": cmd_run, "resume": cmd_resume, "info": cmd_info,
            "validate": cmd_validate, "analyze": cmd_analyze}


def main(argv=None, device="cuda") -> int:
    """Run one command; `device` is where the particles live ("cuda" by
    default, "cpu" for the kernels' plain versions). TF32 is turned off
    first."""
    from .utils.precision import disable_tf32
    disable_tf32()
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; choose from {sorted(COMMANDS)}",
              file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:], device=device)


if __name__ == "__main__":
    raise SystemExit(main())
