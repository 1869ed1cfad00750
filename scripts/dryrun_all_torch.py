#!/usr/bin/env python3
"""Run the production dry run over every (arch x shape) cell, one
process per cell, several at once.

    python3 scripts/dryrun_all_torch.py [--mesh single|multi|both]
                                        [--jobs N] [--out DIR]

Each cell runs ``python -m repro_torch.launch.dryrun --arch A --shape S
--mesh M --out DIR`` (``DIR/<mesh>/<arch>__<shape>__<mesh>.json``); the
slowest cells (the eager time walks of RecurrentGemma's and xLSTM's
training and xLSTM's prefill) start first.  Prints one line per cell
(its exit code and wall seconds), then a table of every artifact in
``DIR``: per-card peak against the card's 80 GB, FLOPs, collective
bytes by kind and ``trace_s``.  Exits non-zero if a cell fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
SLOW = {("xlstm-125m", "prefill_32k"), ("xlstm-125m", "train_4k"),
        ("recurrentgemma-9b", "train_4k")}
CARD_BYTES = 80e9


def cells(meshes):
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch import shapes
    out = [(a, s, m) for m in meshes for a in list_archs()
           for s, spec in shapes.SHAPES.items()
           if shapes.applicable(get_config(a), spec)[0]]
    return sorted(out, key=lambda c: (c[:2] not in SLOW, c[2] != "single"))


def run(cell, out_dir):
    arch, shape, mesh = cell
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", out_dir],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                           OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True)
    line = {"arch": arch, "shape": shape, "mesh": mesh,
            "rc": proc.returncode, "wall_s": round(time.time() - t0, 1)}
    if proc.returncode:
        line["error"] = proc.stdout[-1500:] + proc.stderr[-1500:]
    print(json.dumps(line), flush=True)
    return line


def table(out_dir) -> None:
    print("| arch | shape | mesh | peak GB / card (of 80) | TFLOP / card "
          "| all-gather GB | all-reduce GB | reduce-scatter GB "
          "| all-to-all GB | trace_s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for path in sorted(Path(out_dir).glob("*/*.json")):
        r = json.loads(path.read_text())
        c = r["collectives_per_device"]
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
              f"{r['memory']['peak_estimate_bytes'] / 1e9:.2f} | "
              f"{r['cost']['flops_per_device'] / 1e12:.2f} | "
              f"{c['all-gather'] / 1e9:.2f} | {c['all-reduce'] / 1e9:.3f} | "
              f"{c['reduce-scatter'] / 1e9:.2f} | "
              f"{c['all-to-all'] / 1e9:.2f} | {r['trace_s']} |")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default=str(ROOT / "artifacts" / "torch" /
                                         "dryrun"))
    args = ap.parse_args()
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    with ThreadPoolExecutor(args.jobs) as pool:
        lines = list(pool.map(lambda c: run(c, args.out), cells(meshes)))
    table(args.out)
    return 1 if any(ln["rc"] for ln in lines) else 0


if __name__ == "__main__":
    sys.exit(main())
