#!/usr/bin/env python3
"""Compare the serve cell of two checkouts of this repository on one card.

    python3 scripts/serve_ab_torch.py PARENT_DIR CHANGE_DIR

Runs ``chip_smoke.phase_serve_main`` of each checkout (full-width
RecurrentGemma-9B behind ``ServeEngine``, 16 requests; see
``chip_smoke.py`` phase 12) in a process of its own, in the order
parent, change, change, parent, so that both sides see the same card and
host.  Each process builds its checkout's kernels before the timed run.
Prints each run's phase-12 line, then one summary line per run: the
``run_server`` wall, tokens/s and mean TTFT, the summed prefill ms of all
requests and of all but the first admitted one (whose prefill also pays
one-time set-up: cuBLAS heuristics, first loads), the decode step
median, and the profiled 2990-token prefill window's wall, device ms and
flash-attention ms.  Exits non-zero if a run fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

RUN = ("import sys, torch, numpy as np; sys.path.insert(0, '.'); "
       "import chip_smoke as c; c.phase_build(); "
       "c.phase_serve_main(torch, np, torch.device('cuda'))")
ORDER = ("parent", "change", "change", "parent")
# phase_serve_main draws the 16 prompt lengths so, and admits the first
# one first.
FIRST_PROMPT_TOKENS = int(
    np.random.default_rng(0).integers(256, 3073, 16)[0])


def summary(side: str, line: dict) -> dict:
    prefill = line["prefill_ms_by_prompt_len"]
    first = next(ms for n, ms in prefill if n == FIRST_PROMPT_TOKENS)
    window = line["prefill_window"]
    return {"side": side, "wall_s": line["wall_s"],
            "tokens_per_s": line["run_server"]["tokens_per_s"],
            "mean_ttft_s": line["run_server"]["mean_ttft_s"],
            "prefill_ms_sum": sum(ms for _, ms in prefill),
            "prefill_ms_sum_after_first": sum(ms for _, ms in prefill)
            - first,
            "decode_step_ms_median": line["decode_step_ms_median"],
            "prefill_window_wall_ms": window["wall_ms"],
            "prefill_window_device_ms": window["device_ms"],
            "prefill_window_flash_ms": sum(
                op["ms"] for op in window["top_device_ops"]
                if "flash_attention" in op["name"]),
            "launches": line["launches"],
            "nvidia_smi_clocks_power": line["nvidia_smi_clocks_power"]}


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"parent": Path(sys.argv[1]), "change": Path(sys.argv[2])}
    rows = []
    for side in ORDER:
        out = subprocess.run([sys.executable, "-c", RUN], cwd=dirs[side],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": side, **line}), flush=True)
        rows.append(summary(side, line))
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
