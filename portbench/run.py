"""Run one cell of ``BENCHMARK.json`` once, on the card this process
sees, and print the result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled sub-window.  Every run checks the
served tokens against the plain reference and prints each number
compared beside its limit, last on standard error and last in the
result (``checks``).  Without enough CUDA cards it prints no result and
exits 2; if JAX or the JAX package is loaded by the window's close it
exits 1.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Kernel and compiler caches at fixed paths inside the checkout, so only
# the first run of a cell in a checkout builds (the program's own nvcc
# builds go to build/repro_torch under the checkout).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
# One host thread for PyTorch's and NumPy's CPU work: the window's host
# side is one loop that issues device work, and idle worker threads
# beside it only add noise on a shared host.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness, spec

    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded at start: {loaded}", file=sys.stderr)
        return 1
    cell = spec.load_cell(ROOT, args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this process "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    for name, v in result["setup_parts_s"].items():
        print(f"setup {name} {v!r} s", file=sys.stderr)
    for name, v in result["kv_bytes"].items():
        print(f"kv_bytes {name} {v}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
