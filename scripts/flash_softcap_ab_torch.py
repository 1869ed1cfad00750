#!/usr/bin/env python3
"""The soft-capped flash kernel beside the uncapped one, and the uncapped
kernel of two checkouts, on one card.

    python3 scripts/flash_softcap_ab_torch.py PARENT_DIR CHANGE_DIR

Builds each checkout's ``src/repro_torch/kernels/csrc/flash_attention.cu``
with this checkout's ``nvcc`` flags into ``build/flash_ab/<side>/``,
prints each side's ptxas registers and spills by instantiation, and
whether each uncapped kernel's SASS (``cuobjdump -sass``, instructions
without their addresses and encodings) is the same in both.  At the
bf16 model shapes of ``PERF.md`` §6 (RecurrentGemma's serving shape,
DeepSeekMoE's, Command-R's, Whisper's encoder, cross attention at T 4
and 384 and causal decoder, InternVL2's T 3072) it then times, by CUDA
events with the launches queued behind a device sleep
(``chip_smoke._queued_ms``):
* the uncapped kernel of both sides in the order parent, change, change,
  parent, after checking that the two give the same bits;
* the change's capped kernel (``softcap=2`` on logits ~N(0, 16), held to
  the plain version with the cap within ``chip_smoke.FLASH_TOL``) beside
  its uncapped one, with the capped call's bound
  (``chip_smoke._flash_capped_bound``: the largest of its tensor-core,
  special-function and bytes times).
Prints one JSON line per shape, then the card's name and power limit.
Exits non-zero without a card, on a failed build, on an uncapped kernel
whose SASS differs from the parent's, or on a mismatch.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

ORDER = ("parent", "change", "change", "parent")
SHAPES = {
    "serve_T3072": cs.FLASH_CASES[0][:8],
    "moe_T3072": cs.FLASH_MOE_CASE[:8],
    "command_r_T3072": cs.FLASH_COMMAND_R_CASE[:8],
    **{f"whisper_{k}": c[:8] for k, c in cs.FLASH_WHISPER_CASES.items()},
    "internvl_T3072": cs.FLASH_INTERNVL_CASES["T3072"][:8],
}


def uncapped_sass(library: Path) -> dict:
    """{"<dtype>/hd<HD>": [instruction, ...]} of a library's uncapped
    flash kernels."""
    from repro_torch import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        head, body = func.split("\n", 1)
        hit = re.search(r"flash_attention_(bf16|f32)(_softcap)?ILi(\d+)E"
                        r"(Lb([01])E)?", head)
        if hit and not hit.group(2) and hit.group(5) != "1":
            out[f"{hit.group(1)}/hd{hit.group(3)}"] = [
                re.sub(r"/\*[0-9a-fx]+\*/", "", ln.split(";")[0]).strip()
                for ln in body.splitlines() if "/*" in ln and ";" in ln]
    return out


def build(side: str, checkout: Path):
    """(ctypes entry point, whether it takes a softcap, ptxas by
    instantiation, uncapped SASS) of one checkout's flash source."""
    from repro_torch import _build
    out = ROOT / "build" / "flash_ab" / side
    out.mkdir(parents=True, exist_ok=True)
    src = checkout / "src" / "repro_torch" / "kernels" / "csrc" / \
        "flash_attention.cu"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out / "flash_attention.so"), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(f"{side}: nvcc failed\n{log}")
    fn = ctypes.CDLL(str(out / "flash_attention.so")).flash_attention_launch
    capped = "float softcap" in src.read_text()
    floats = [ctypes.c_float] * (2 if capped else 1)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int]
                   + floats + [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return (fn, capped, cs._ptxas_by_kernel(log),
            uncapped_sass(out / "flash_attention.so"))


def caller(torch, side, q, k, v, causal, window, softcap=0.0):
    fn, capped = side[:2]
    B, Hq, T, hd = q.shape
    _, Hkv, S, _ = k.shape
    out = torch.empty_like(q)
    floats = (hd ** -0.5, softcap) if capped else (hd ** -0.5,)

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                Hq, Hkv, T, S, hd, *floats, int(causal), window, 1,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"flash_attention_launch failed: {rc}")
    return call, out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as flash
    dev = torch.device("cuda")
    sides = {name: build(name, Path(arg).resolve())
             for name, arg in zip(("parent", "change"), sys.argv[1:])}
    parent_sass, change_sass = (sides[n][3] for n in ("parent", "change"))
    same_sass = {k: change_sass.get(k) == v for k, v in parent_sass.items()}
    print(json.dumps({"ptxas": {n: s[2] for n, s in sides.items()},
                      "uncapped_sass_equal": same_sass,
                      "uncapped_sass_instructions": {
                          k: len(v) for k, v in parent_sass.items()}}),
          flush=True)
    if not sides["change"][1] or not all(same_sass.values()):
        raise SystemExit("the change's kernel takes no softcap, or an "
                         "uncapped kernel is not the parent's code")
    for label, shape in SHAPES.items():
        B, Hq, Hkv, T, S, hd, causal, window = shape
        q, k, v = cs._capped_inputs(torch, np, (*shape, "bfloat16"), dev)
        calls = {n: caller(torch, s, q, k, v, causal, window)
                 for n, s in sides.items()}
        for fn, _ in calls.values():
            fn()
        torch.cuda.synchronize()
        same_bits = torch.equal(calls["parent"][1], calls["change"][1])
        uncapped = {n: [] for n in sides}
        for n in ORDER:
            uncapped[n].append(cs._queued_ms(torch, calls[n][0], 50)["ms"])
        capped_fn, capped_out = caller(torch, sides["change"], q, k, v,
                                       causal, window, cs.FLASH_SOFTCAP)
        capped_fn()
        want = flash.flash_attention_plain(q, k, v, causal=causal,
                                           window=window,
                                           softcap=cs.FLASH_SOFTCAP)
        err = float((capped_out.float() - want.float()).abs().max())
        ok = torch.allclose(capped_out.float(), want.float(),
                            **cs.FLASH_TOL["bfloat16"])
        capped_ms = cs._queued_ms(torch, capped_fn, 50)["ms"]
        times, bound_ms, bound_by = cs._flash_capped_bound(
            flash, shape, cs.FLASH_SOFTCAP)
        change_ms = min(uncapped["change"])
        print(json.dumps({
            "shape": label, "bhhtsd": [B, Hq, Hkv, T, S, hd],
            "causal": causal, "window": window,
            "uncapped_same_bits": same_bits,
            "uncapped_ms": uncapped, "capped_ms": capped_ms,
            "capped_over_uncapped": capped_ms / change_ms,
            "capped_max_abs_err": err, "capped_match": ok,
            "bound_ms_by_resource": times, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "capped_share_of_bound": bound_ms / capped_ms}),
            flush=True)
        if not (same_bits and ok):
            raise SystemExit(f"{label}: the uncapped kernels differ, or the "
                             "capped kernel disagrees with the plain version")
        del q, k, v, calls, capped_out, want
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
