"""The sweep that finds a cell's knee, the highest offered rate its
system serves without a growing backlog (run once on the card; the
cell's ``rate_per_s`` is then written in as a number).

    python3 portbench/sweep.py --workload <cell> --seed <n> \\
        --seconds 30 --rates 1.5 2 2.5 3

One engine, warmed once, serves a window at each rate.  A JSON line a
rate: the time to first token (median, p90), the decode time per token
(p90), how long the last requests took to drain after arrivals stopped,
and the median wait of the last quarter of arrivals against the
first's, which grows with the backlog.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def summary(record, seconds: float) -> dict:
    reqs = sorted(record["requests"], key=lambda r: r["due"])
    ttft = np.array([r["first_token"] - r["due"] for r in reqs])
    tpot = np.array([(r["done"] - r["first_token"]) / (r["tokens"] - 1)
                     for r in reqs])
    q = max(1, len(reqs) // 4)
    return {"requests": len(reqs), "ttft_p50_ms": float(np.median(ttft)) * 1e3,
            "ttft_p90_ms": float(np.percentile(ttft, 90)) * 1e3,
            "tpot_p90_ms": float(np.percentile(tpot, 90)) * 1e3,
            "drain_s": record["wall_s"] - seconds,
            "ttft_first_quarter_ms": float(np.median(ttft[:q])) * 1e3,
            "ttft_last_quarter_ms": float(np.median(ttft[-q:])) * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness, spec
    cell = spec.load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    system = harness.build(cell, args.seed, device)
    harness.warm_up(system, harness.offered(cell, args.seed, args.seconds,
                                            max(args.rates)), args.seed)
    for rate in args.rates:
        reqs = harness.offered(cell, args.seed, args.seconds, rate)
        win = harness.serve_window(system, reqs, args.seconds)
        line = {"rate_per_s": rate,
                **summary(harness.run_record(cell, win), args.seconds)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
