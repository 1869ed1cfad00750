#!/usr/bin/env python3
"""How far the parallel mLSTM kernel's bfloat16 operands move the cell at
xLSTM-125M's prefill shape, and why they go in as hi/lo pairs.

    python3 scripts/mlstm_parallel_rounding_torch.py [T ...]

For each prefill length T (default 256, 1024 and 3072) it makes
``chip_smoke.py``'s inputs for ``MLSTM_XLSTM_CASE`` cut to T (bfloat16
q, k, v and gates, (1, 4, T, 384)) and runs on the CPU, against
``mlstm_chunkwise_plain``, ``mlstm_chunkwise_parallel_plain`` with the
three float32 operands of the kernel's tensor-core products (k exp(w -
m), C_{c-1} and P: ``mlstm.PARALLEL_OPERANDS``) rounded to one bfloat16
value (``bf16``) and to a pair hi + lo (``bf16x2``, as the kernel does),
each of the three alone and all together.  It prints one JSON line per
T: the largest error of h and of the final state as a share of
``MLSTM_TOL["bfloat16"]`` (1 = at the tolerance).  Takes ~7 s.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import mlstm_chunkwise as mlstm  # noqa: E402

OPERANDS = mlstm.PARALLEL_OPERANDS


def share(got, want, tol) -> float:
    return float(((got.float() - want.float()).abs()
                  / (tol["atol"] + tol["rtol"] * want.float().abs())).max())


def main(lengths) -> None:
    tol = chip_smoke.MLSTM_TOL["bfloat16"]
    torch.set_num_threads(4)
    for T in lengths:
        case = (1, 4, T) + chip_smoke.MLSTM_XLSTM_CASE[3:]
        inputs, _ = chip_smoke._mlstm_inputs(torch, np, case, "cpu")
        want_h, want_s = mlstm.mlstm_chunkwise_plain(*inputs)
        line = {"shape": list(case[:5]), "dtype": case[6],
                "tolerance": tol}
        for rounding in ("bf16", "bf16x2"):
            for only in OPERANDS + (None,):
                h, s = mlstm.mlstm_chunkwise_parallel_plain(
                    *inputs, rounding=rounding,
                    operands=OPERANDS if only is None else (only,))
                line[f"{rounding}/{only or 'all'}"] = {
                    "h_share_of_tol": share(h, want_h, tol),
                    "state_share_of_tol": max(
                        share(a, b, tol) for a, b in zip(s, want_s))}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main([int(t) for t in sys.argv[1:]] or [256, 1024, 3072])
