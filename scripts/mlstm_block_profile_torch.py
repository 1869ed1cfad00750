#!/usr/bin/env python3
"""Where the mLSTM block kernel's cycles go, phase by phase, on the card.

    python3 scripts/mlstm_block_profile_torch.py

Copies ``src/repro_torch/kernels/csrc/mlstm_chunkwise.cu`` into
``build/mlstm_block_profile/``, inserts a ``__syncthreads()`` and a
``clock64()`` reading at each phase boundary of the block kernel's chunk
loop (so every reading waits for the slowest warp of the block), builds
it with the port's ``nvcc`` flags and runs it through the wrapper at
xLSTM-125M's prefill shape (q, k, v (1, 4, 3072, 384) bfloat16, chunk
64, the final state out) and at the forecaster's shape (8668, 2, 16, 32,
32) in float32.  Block (0, 0) prints its cycles summed over the chunks
for: gates and v slice; q and k panel loads (with the q.k work of every
panel but the last); the last panel's q.k, q.C and q.n; the row phase;
h; the k panel reloads of the state update (with the update of the
panel before each); the update of the first panel.  The extra barriers
slow the kernel a little; the split, not the total, is the result.
Prints the card's name and power limit last.  Exits non-zero without a
card, or if the source no longer has the phase boundaries it looks for.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / \
    "mlstm_chunkwise.cu"
NAMES = ("start", "gates+v", "panel loads", "last panel q.k/q.C", "row",
         "h", "k reloads", "first panel update")
# (anchor in the block kernel, text inserted after it); each anchor must
# occur, and its first occurrence is instrumented.
TICKS = (
    ("    __syncthreads();  // the previous chunk is done with every buffer\n",
     "    TICK(0)\n"),
    ("      carry = __shfl_sync(0xffffffffu, x, 31);\n      }\n    }\n",
     "    TICK(1)\n"),
    ("      load_panel(sk, k, t0, d0, w);\n      __syncthreads();\n",
     "      TICK(2)\n"),
    ("      if (tj == 0) sqn[i] = qn[a];\n    }\n    __syncthreads();\n",
     "    TICK(3)\n"),
    ("      snorm[i] = fmaxf(fabsf(den), expf(-m_i));\n    }\n"
     "    __syncthreads();\n", "    TICK(4)\n"),
    ("    if (!update) break;\n", ""),
    ("        load_panel(sk, k, t0, d0, w);\n        __syncthreads();\n",
     "        TICK(6)\n"),
    ("    have_state = true;\n", "    TICK(7)\n"),
)
PRELUDE = """
  long long tacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long tclk = clock64();
#define TICK(k) { __syncthreads(); const long long now = clock64(); \\
                  tacc[k] += now - tclk; tclk = now; }
"""
REPORT = """
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    printf("PROFILE %d %d %d %lld %lld %lld %lld %lld %lld %lld %lld\\n",
           L, dk, n_chunks, tacc[0], tacc[1], tacc[2], tacc[3], tacc[4],
           tacc[5], tacc[6], tacc[7]);
"""


def instrumented() -> str:
    src = SOURCE.read_text()
    src = src.replace("#include <cstdint>", "#include <cstdint>\n#include <cstdio>", 1)
    for anchor, text in TICKS:
        if anchor not in src:
            raise SystemExit(f"mlstm_block_profile: anchor not found:\n{anchor}")
        if anchor == "    if (!update) break;\n":
            src = src.replace(anchor, "    TICK(5)\n" + anchor, 1)
        else:
            src = src.replace(anchor, anchor + text, 1)
    loop = "  const int n_chunks = T_len / L;\n"
    end = "    have_state = true;\n    TICK(7)\n  }\n"
    if loop not in src or end not in src:
        raise SystemExit("mlstm_block_profile: the chunk loop has changed")
    src = src.replace(loop, loop + PRELUDE, 1)
    return src.replace(end, end + REPORT, 1)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mlstm_block_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch import _build
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    out = ROOT / "build" / "mlstm_block_profile"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mlstm_chunkwise.cu").write_text(instrumented())
    lib_path = out / "libmlstm_profile.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out / "mlstm_chunkwise.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    _build.load = lambda name: lib        # the wrapper's library, this run
    mlstm._kernel.cache_clear()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, H, T, dk, dtype in ((1, 4, 3072, 384, torch.bfloat16),
                               (8668, 2, 16, 32, torch.float32)):
        def rand(*shape, shift=0.0, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale
                    + shift).to(dtype)
        q, k, v = rand(B, H, T, dk), rand(B, H, T, dk, scale=dk ** -0.5), \
            rand(B, H, T, dk)
        i, f = rand(B, H, T), rand(B, H, T, shift=2.0)
        sys.stdout.flush()
        mlstm._mlstm_chunkwise_cuda(q, k, v, i, f, None, 64, True,
                                    kernel="block")
        torch.cuda.synchronize()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print("columns: L dk chunks " + " | ".join(NAMES), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
