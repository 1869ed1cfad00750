#!/usr/bin/env python3
"""Compare the RG-LRU and mLSTM kernels of two checkouts on one card.

    python3 scripts/kernel_ab_torch.py PARENT_DIR CHANGE_DIR

Builds each checkout's ``src/repro_torch/kernels/csrc/rglru_scan.cu`` and
``mlstm_chunkwise.cu`` with this checkout's ``nvcc`` flags into
``build/kernel_ab/<side>/`` and times, in one process, the C entry point
each side's wrapper launches at the main path's shapes (RG-LRU: B 1,
R 4096, float32 in, bfloat16 out, at T 3072, 1674 and 512; mLSTM: the
forecaster's (8668, 2, 16, 32, 32) in float32), in the order parent,
change, change, parent, by CUDA events with the launches queued behind a
device sleep (``chip_smoke._queued_ms``).  Each call's output is checked
against the plain version first.  Prints one JSON line per timing, then
the card's name and power limit.  Exits non-zero without a card or on a
mismatch.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

ORDER = ("parent", "change", "change", "parent")
RGLRU_T = (3072, 1674, 512)


def build(side: str, checkout: Path) -> dict:
    """{kernel name: ctypes library} of one checkout's two sources."""
    from repro_torch import _build
    out = ROOT / "build" / "kernel_ab" / side
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("rglru_scan", "mlstm_chunkwise"):
        src = checkout / "src" / "repro_torch" / "kernels" / "csrc"
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(src / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{side} {name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def rglru_call(torch, lib, a, b, h):
    # The kernel each side's wrapper takes at this size: the change's
    # wrapper picks by takes_chunked_kernel where the library has both.
    from repro_torch.kernels import rglru_scan as rglru
    name = ("rglru_chunked_launch" if hasattr(lib, "rglru_chunked_launch")
            and rglru.takes_chunked_kernel(a) else "rglru_scan_launch")
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    B, T, R = a.shape

    def call():
        rc = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, T, R, 0, 1,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"{name} failed: {rc}")
    return call, name


def mlstm_call(torch, lib, inputs, h, L):
    # The kernel each side's wrapper takes at this shape: the row kernel
    # where the library has one.
    name = ("mlstm_rows_launch" if hasattr(lib, "mlstm_rows_launch")
            else "mlstm_chunkwise_launch")
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int64] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    B, H, T, dk = inputs[0].shape
    dv = inputs[2].shape[-1]

    def call():
        rc = fn(*[t.data_ptr() for t in inputs], None, None, None,
                h.data_ptr(), None, None, None, B * H, T, L, dk, dv, 0,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"{name} failed: {rc}")
    return call, name


def main() -> int:
    import numpy as np
    import torch
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab_torch: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    from repro_torch.kernels import rglru_scan as rglru
    dev = torch.device("cuda")
    libs = {side: build(side, Path(d))
            for side, d in zip(("parent", "change"), sys.argv[1:])}
    bf16 = torch.bfloat16
    for T in RGLRU_T:
        B, _, R = chip_smoke.RGLRU_CASES[0][:3]
        a, b = chip_smoke._rglru_inputs(torch, np, (B, T, R, "float32",
                                                    "bfloat16"), dev)
        want = rglru.rglru_scan_plain(a, b, out_dtype=bf16)
        for side in ORDER:
            h = torch.empty((B, T, R), dtype=bf16, device=dev)
            call, entry = rglru_call(torch, libs[side]["rglru_scan"], a,
                                     b, h)
            call()
            torch.cuda.synchronize()
            if not torch.allclose(h.float(), want.float(),
                                  **chip_smoke.RGLRU_TOL["bfloat16"]):
                raise SystemExit(f"{side} {entry} disagrees at T {T}")
            timed = chip_smoke._queued_ms(torch, call, 200)
            print(json.dumps({"kernel": "rglru_scan", "entry": entry,
                              "side": side,
                              "shape": [B, T, R], **timed}), flush=True)
    case = chip_smoke.MLSTM_CASES[0]
    B, H, T, dk, dv, chunk = case[:6]
    L = min(chunk, T)
    inputs, _ = chip_smoke._mlstm_inputs(torch, np, case, dev)
    want, _ = mlstm.mlstm_chunkwise_plain(*inputs, chunk=chunk,
                                          return_state=False)
    for side in ORDER:
        h = torch.empty((B, H, T, dv), device=dev)
        call, entry = mlstm_call(torch, libs[side]["mlstm_chunkwise"],
                                 inputs, h, L)
        call()
        torch.cuda.synchronize()
        if not torch.allclose(h, want, **chip_smoke.MLSTM_TOL["float32"]):
            raise SystemExit(f"{side} {entry} disagrees")
        timed = chip_smoke._queued_ms(torch, call, 200)
        print(json.dumps({"kernel": "mlstm_chunkwise", "entry": entry,
                          "side": side, "shape": [B, H, T, dk, dv],
                          **timed}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
