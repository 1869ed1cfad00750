#!/usr/bin/env python3
"""Where the parallel mLSTM kernel's time goes, kernel by kernel, on one
H100.

    python3 scripts/mlstm_parallel_split_torch.py [T ...]

Builds ``src/repro_torch/kernels/csrc/mlstm_parallel.cu`` as it is and
three copies whose launcher stops early or skips a kernel (text
replacements in the launcher only): ``gate`` (the gate kernel alone),
``gate+state`` (the gate and state kernels) and ``output`` (the output
kernel alone, on the scratch that a whole launch left), each with
``repro_torch._build.NVCC_FLAGS`` into ``build/mlstm_parallel_split/``
and called through ctypes as the wrapper calls the kernel.  At
xLSTM-125M's prefill shape (1, 4, T, 384) bfloat16 with the state out,
for each T (default 256 and 3072), it times each build by CUDA events
with the launches queued behind a device sleep (``chip_smoke._queued_ms``)
in the order whole, parts, parts reversed, whole, and prints one JSON
line per T with each build's two times in microseconds and the whole
build's largest error against ``mlstm_chunkwise_plain`` as a share of
``MLSTM_TOL["bfloat16"]``; then the card's name and power limit.
About 40 s.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels import mlstm_chunkwise as mlstm  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / \
    "mlstm_parallel.cu"
OUT = ROOT / "build" / "mlstm_parallel_split"
STATE = "  mlstm_state_kernel<<<"
OUTPUT = "  const auto blocks = static_cast<unsigned>(output_blocks);"
GATE = "  mlstm_gate_kernel<<<"
BUILDS = {
    "whole": [],
    "gate": [(STATE, "  return 0;\n" + STATE)],
    "gate+state": [(OUTPUT, "  return 0;\n" + OUTPUT)],
    "output": [(STATE, "  if (0) " + STATE.lstrip()),
               (GATE, "  if (0) " + GATE.lstrip())],
}


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name, reps in BUILDS.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        stem = name.replace("+", "_")
        (OUT / f"{stem}.cu").write_text(text)
        procs[name] = (stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{stem}.so"),
             str(OUT / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{stem}.so")).mlstm_parallel_launch
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int64] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(lengths) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    fns = build()
    dev = torch.device("cuda")
    tol = chip_smoke.MLSTM_TOL["bfloat16"]
    for T in lengths:
        case = (1, 4, T) + chip_smoke.MLSTM_XLSTM_CASE[3:]
        B, H, _, dk, dv = case[:5]
        NC = T // 64
        inputs, _ = chip_smoke._mlstm_inputs(torch, np, case, dev)
        h = torch.empty((B, H, T, dv), dtype=torch.bfloat16, device=dev)
        state = (torch.empty((B, H, dk, dv), device=dev),
                 torch.empty((B, H, dk), device=dev),
                 torch.empty((B, H), device=dev))
        scratch = (torch.empty(B * H * NC * dv * 2 * dk,
                               dtype=torch.bfloat16, device=dev),
                   torch.empty(B * H * NC * dk, device=dev),
                   torch.empty(B * H * NC, device=dev),
                   torch.empty(B * H * (T + 2 * NC), device=dev))

        def call(fn):
            return lambda: fn(
                *(t.data_ptr() for t in inputs), None, None, None,
                h.data_ptr(), *(t.data_ptr() for t in state),
                *(t.data_ptr() for t in scratch), B * H, T, dk, dv,
                torch.cuda.current_stream().cuda_stream)

        if call(fns["whole"])() != 0:
            raise SystemExit("launch failed")
        torch.cuda.synchronize()
        want, _ = mlstm.mlstm_chunkwise_plain(*inputs)
        err = float(((h.float() - want.float()).abs()
                     / (tol["atol"] + tol["rtol"] * want.float().abs()))
                    .max())
        order = list(fns) + list(fns)[::-1]
        us = {name: [] for name in fns}
        for name in order:
            us[name].append(chip_smoke._queued_ms(
                torch, call(fns[name]), 50, warmup=5)["ms"] * 1e3)
        print(json.dumps({"shape": list(case[:5]), "dtype": case[6],
                          "state_out": True, "us": us,
                          "whole_worst_share_of_tol": err}), flush=True)
    print(chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]), flush=True)


if __name__ == "__main__":
    main([int(t) for t in sys.argv[1:]] or [256, 3072])
