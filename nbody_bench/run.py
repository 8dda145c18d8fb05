"""Run one cell of BENCHMARK.json on this machine's card and print its
result as the last line of standard output.

    python3 nbody_bench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Exits non-zero, printing no result, when no CUDA card is present, when
the cell asks for more cards than there are, or when JAX or the JAX
package was loaded. The compared numbers and their limits are the last
lines of standard error and the result's last key ("checks").
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from nbody_bench import harness
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
