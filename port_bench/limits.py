"""Read the numbers that a cell's correctness limits are set from.

    python3 port_bench/limits.py --workload <name> --seeds 12 --control-seeds 3 \\
        [--seconds 3] [--first-seed N]

On a CUDA card, in one process: the compared numbers of sound runs of the
program on `--seeds` seeds (a short window each, then the cell's check)
and of the control, the reference one precision down in the program's
place, on `--control-seeds` seeds; with `--fault NAME`, the program's
runs with that fault of `faults.py` planted. Prints one JSON line per
reading and a summary: each number's largest program reading (the lower
reading, or the fault's) and smallest control reading (the upper one).
The benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--fault", default="",
                    help="a fault of port_bench/faults.py planted in the program's runs")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import faults, harness
    from port_bench.run import cache_dirs

    cache_dirs()
    if not torch.cuda.is_available():
        print("limits.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    patches = faults.Patches()
    if args.fault:
        faults.SERVING[args.fault](patches.setattr)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    control = [args.first_seed + 104729 * (i + 1) for i in range(args.control_seeds)]
    low, high = {}, {}
    for who, seed, numbers in cell.generator().limit_readings(torch, cell, seeds, control,
                                                               args.seconds):
        who = f"{who} with {args.fault}" if args.fault and who == "program" else who
        print(json.dumps({"who": who, "seed": seed, **numbers}), flush=True)
        for k, v in numbers.items():
            if who.startswith("program"):
                low[k] = max(low.get(k, float("-inf")), v)
            else:
                high[k] = min(high.get(k, float("inf")), v)
    patches.undo()
    print(json.dumps({"workload": args.workload, "fault": args.fault, "lower": low,
                      "upper": high}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
