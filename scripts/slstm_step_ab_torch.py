#!/usr/bin/env python3
"""Time an xLSTM-125M train step four ways on one card: the sLSTM cell as
one autograd node (``xlstm._SLSTMCellStep``, the package's) or as the
plain cell's autograd graph, each under the 256-step chunked remat (the
package's walk) and with the walk over all T called without it.

    python3 scripts/slstm_step_ab_torch.py [--reps 4]

xLSTM-125M at its published widths and depth, 4 x 512 tokens (phase 33's
job A), float32 masters drawn from seed 0 on the card, one batch.  Each
rep runs the four variants in turn, each on a fresh copy of the same
state; a variant's step time is the median of its reps after the first.
The variants are chosen here by patching the module in process, not by
any switch of the package.  The first step's loss must be the same in
every variant (the forward is).  Prints one JSON line per variant (step
seconds, peak device bytes above the state), then the card's name and
power limit.  Exits non-zero without a card or if the losses differ.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("slstm_step_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    dev = torch.device("cuda")
    cfg = get_config("xlstm-125m")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(gen, cfg, dev)
    step = make_train_step(cfg, OptimizerConfig(
        learning_rate=1e-3, warmup_steps=2, total_steps=6))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        cfg, DataConfig(batch_size=4, seq_len=512, seed=0)).batch(0).items()}

    def plain_cell(gates, c, n, m):
        return xlstm._slstm_cell_parts(gates, c, n, m)[0]

    def whole_walk(gx, r_h, bias, cfg):
        st = xlstm.slstm_decode_init(cfg, gx.shape[0], gx.device)
        return xlstm._walk_steps(gx, r_h, bias,
                                 *(st[k] for k in ("c", "n", "m", "h")))

    package = (xlstm._SLSTMCellStep.apply, xlstm._walk)
    variants = {"one_node_cell+remat": package,
                "plain_cell+remat": (plain_cell, package[1]),
                "one_node_cell+whole_walk": (package[0], whole_walk),
                "plain_cell+whole_walk": (plain_cell, whole_walk)}
    secs = {k: [] for k in variants}
    peak = {}
    loss = {}
    try:
        for _ in range(args.reps):
            for name, (cell, walk) in variants.items():
                xlstm._SLSTMCellStep.apply, xlstm._walk = cell, walk
                s = copy.deepcopy(state)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                s, metrics = step(s, batch)
                loss.setdefault(name, float(metrics["loss"]))
                torch.cuda.synchronize()
                secs[name].append(time.perf_counter() - t0)
                peak[name] = torch.cuda.max_memory_allocated() - base
                del s, metrics
    finally:
        xlstm._SLSTMCellStep.apply, xlstm._walk = package
    for name in variants:
        print(json.dumps({"variant": name, "step_s": secs[name],
                          "step_s_median": statistics.median(
                              secs[name][1:] or secs[name]),
                          "peak_above_state_bytes": peak[name],
                          "first_loss": loss[name]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if len(set(loss.values())) != 1:
        print(f"slstm_step_ab_torch: losses differ: {loss}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
