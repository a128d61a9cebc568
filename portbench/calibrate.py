"""Readings that set a cell's limits: the program's numbers over many
seeds, and the control's, in one process.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--control] [--out FILE]

Each seed is one run of the cell (``run.run_cell``) at its own sizes and
load with a short window; with ``--control`` the run also judges the
lower-precision control in the program's place on the same inputs. One
JSON line a seed: the numbers compared, the limits they were held to, and
the control's numbers. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        run = run_cell(args.workload, seed, args.seconds, False, "cuda:0",
                       control=args.control)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "correct": run["result"]["correct"],
                           "numbers": {n: v for n, (v, _) in run["checks"].items()},
                           "limits": {n: lim for n, (_, lim) in run["checks"].items()},
                           "control": run["control"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
