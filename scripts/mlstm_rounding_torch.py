#!/usr/bin/env python3
"""How far float32 rounding alone moves the mLSTM cell at the
forecaster's shape.

    python3 scripts/mlstm_rounding_torch.py

Runs ``mlstm_chunkwise_plain`` on the CPU on ``chip_smoke.py``'s inputs
for its first ``MLSTM_CASES`` entry (8668, 2, 16, 32, 32), once in
float32 (as it is) and once with every intermediate in float64, and
prints one JSON line: the largest |h|, the float32 version's largest
error against the float64 one, that error over what ``MLSTM_TOL``
allows at the element, and at the worst element the normaliser
|sum_j P_ij| beside sum_j |P_ij| (their ratio is how much the sum's
cancellation magnifies rounding).  A kernel held to the float32 plain
version at this shape can differ from it by about as much again.
"""
from __future__ import annotations

import inspect
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


def _plain_float64():
    """``mlstm_chunkwise_plain`` with its float32 intermediates made
    float64 (the same source, one name changed)."""
    src = inspect.getsource(mlstm.mlstm_chunkwise_plain).replace(
        "f32 = torch.float32", "f32 = torch.float64")
    namespace = dict(vars(mlstm))
    exec(src, namespace)  # noqa: S102
    return namespace["mlstm_chunkwise_plain"]


def main() -> int:
    case = chip_smoke.MLSTM_CASES[0]
    chunk = case[5]
    inputs, _ = chip_smoke._mlstm_inputs(torch, np, case,
                                         torch.device("cpu"))
    h32, _ = mlstm.mlstm_chunkwise_plain(*inputs, chunk=chunk,
                                         return_state=False)
    wide = [x.double() for x in inputs]
    h64, _ = _plain_float64()(*wide, chunk=chunk, return_state=False)
    err = (h32.double() - h64).abs()
    tol = chip_smoke.MLSTM_TOL["float32"]
    share = err / (tol["atol"] + tol["rtol"] * h64.abs())
    b, hd, t, _ = np.unravel_index(int(err.argmax()), err.shape)
    q, k, _, i_raw, f_raw = (x[b, hd] for x in wide)
    cum = torch.cumsum(torch.nn.functional.logsigmoid(f_raw), -1)
    L = min(chunk, case[2])
    t0 = t - t % L                       # the row's chunk starts here
    D = cum[t] - cum[t0:t + 1] + i_raw[t0:t + 1]
    P = torch.exp(D - D.max()) * (k[t0:t + 1] @ q[t])
    print(json.dumps({
        "shape": list(case[:5]), "chunk": L,
        "max_abs_h": float(h64.abs().max()),
        "plain_f32_vs_f64_max_abs_err": float(err.max()),
        "at": [int(b), int(hd), int(t)],
        "abs_h_there": float(h64[b, hd, t].abs().max()),
        "worst_share_of_tol": float(share.max()),
        "normaliser_there": float(P.sum().abs()),
        "sum_abs_P_there": float(P.abs().sum())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
