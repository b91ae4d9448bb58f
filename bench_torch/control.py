"""Readings for the limits of a cell's check: the program, or the cell's
control path in its place, over many seeds in one process.

    python3 bench_torch/control.py --workload <cell> --seeds 11,12,13 --seconds 2 [--control]

Each seed makes a short run of the cell at its own size and load (the
window as the benchmark drives it, then the check) and prints one JSON
line: the seed, whether the control ran, ``correct``, the calls made and
each number compared beside its limit. The benchmark's own runs never run
the control; the program's lower readings and the control's upper ones
that the limits rest on come from here.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", action="store_true",
                        help="drive the configuration's control path")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from bench_torch import harness

    harness.prepare_process()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    t_start = T0
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t_start,
                             control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"], "setup_s": r["metrics"]["setup_s"]["value"],
                          "compared": r["compared"]}), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
