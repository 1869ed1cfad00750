#!/usr/bin/env python3
"""Compare the serve cells' prefill of two checkouts of this repository
on one card.

    python3 scripts/prefill_ab_torch.py PARENT_DIR CHANGE_DIR [PHASE ...]

Runs each serve phase of ``chip_smoke.py`` (default: phases 12, 20, 23,
26 and 28: RecurrentGemma-9B, DeepSeekMoE-16B, Command-R-35B,
Whisper-medium and InternVL2-26B behind ``ServeEngine``) for each
checkout, in a process of its own, in the order parent, change, change,
parent, so that both sides see the same card and host; each process
builds its checkout's kernels first.  Prints one summary line per run:
the profiled prefill window's device events, device ms and flash
attention's ms per launch, ``run_server``'s tokens/s and the decode
step median; then, per phase, each side's mean and the spread between
the two runs of each side.  Exits non-zero if a run fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

PHASES = {"12": "phase_serve_main", "20": "phase_moe_serve_main",
          "23": "phase_command_r_serve_main",
          "26": "phase_whisper_serve_main",
          "28": "phase_internvl_serve_main"}
ORDER = ("parent", "change", "change", "parent")
RUN = ("import sys, torch, numpy as np; sys.path.insert(0, '.'); "
       "import chip_smoke as c; c.phase_build(); "
       "c.{fn}(torch, np, torch.device('cuda'))")


def summary(line: dict) -> dict:
    window = line["prefill_window"]
    flash = [op for op in window["top_device_ops"]
             if "flash_attention" in op["name"]]
    count = sum(op["count"] for op in flash)
    return {"prefill_device_events": window["device_events"],
            "prefill_device_ms": window["device_ms"],
            "flash_ms_per_launch": (sum(op["ms"] for op in flash) / count
                                    if count else None),
            "tokens_per_s": line["run_server"]["tokens_per_s"],
            "decode_step_ms_median": line["decode_step_ms_median"]}


def run(side_dir: Path, fn: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN.format(fn=fn)],
                          cwd=side_dir, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{side_dir} {fn} failed:\n{proc.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{") and '"prefill_window"' in ln]
    return summary(lines[-1])


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"parent": Path(sys.argv[1]).resolve(),
            "change": Path(sys.argv[2]).resolve()}
    phases = sys.argv[3:] or list(PHASES)
    for phase in phases:
        runs = []
        for side in ORDER:
            s = {"phase": int(phase), "side": side,
                 **run(dirs[side], PHASES[phase])}
            print(json.dumps(s), flush=True)
            runs.append(s)
        out = {"phase": int(phase)}
        for key in ("prefill_device_events", "prefill_device_ms",
                    "flash_ms_per_launch", "tokens_per_s",
                    "decode_step_ms_median"):
            for side in ("parent", "change"):
                vals = [r[key] for r in runs if r["side"] == side]
                out[f"{key}_{side}"] = sum(vals) / len(vals)
                out[f"{key}_{side}_spread"] = max(vals) - min(vals)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
