"""Find an open-loop cell's knee: the highest offered rate at which the
answers keep pace with the arrivals and no backlog grows.

    python -m portbench.knee --workload <cell> --seed <n> --seconds <s> \\
        --rates 600,800,1000 [--out FILE]

One set-up, then one window at each rate in turn (the cell's own traffic
with ``rate_per_s`` replaced). Each window prints one JSON line: the rate
offered, the answers per second, the p50 and p95, the backlog's drain (the
seconds from the window's last due time to its last answer), and the p95
of the window's last quarter beside its first quarter's. A rate keeps pace
when the drain stays within a few dispatches and the last quarter's p95
within 1.5x the first's; the knee is the highest such rate. The cell's
file takes 0.8x it as a number.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import registry
from portbench.trace import Tracer


def reading(rate: float, seconds: float, win) -> dict:
    lat = win.latencies_s
    n = len(lat)
    q = max(1, n // 4)
    first, last = np.sort(lat[:q]), np.sort(lat[-q:])

    def p(a, pct):
        return float(a[min(len(a) - 1, int(np.ceil(pct / 100 * len(a))) - 1)] * 1e3)

    srt = np.sort(lat)
    drain = win.window_s - 0.005 - seconds
    return {"rate_per_s": rate, "answered_per_s": (n - win.failed) / win.window_s,
            "p50_ms": p(srt, 50), "p95_ms": p(srt, 95), "first_quarter_p95_ms": p(first, 95),
            "last_quarter_p95_ms": p(last, 95), "drain_s": drain, "failed": win.failed,
            "counts": win.counts,
            "keeps_pace": bool(win.failed == 0 and drain < 0.05
                               and p(last, 95) <= 1.5 * p(first, 95))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s, ascending")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.knee: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    entry = registry.entry(cell["mix"]["entry"]).Entry(
        registry.config(cell["config"]), dict(cell["mix"]), args.seed, torch.device("cuda:0"))
    entry.setup()
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        entry.mix["rate_per_s"] = rate
        line = reading(rate, args.seconds, entry.window(args.seconds, Tracer(False)))
        if line["keeps_pace"]:
            knee = rate
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    entry.release()
    print(json.dumps({"workload": args.workload, "knee_per_s": knee,
                      "rate_0.8x": None if knee is None else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
