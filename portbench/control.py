"""The correctness check's readings for one cell, over many seeds in one
process (run on the card; the benchmark's own runs do not run it).

    python3 portbench/control.py --workload <cell> --seconds 12 \\
        --seeds 1 2 3 ... [--kv-int8] [--router-flips]

For each seed: fresh weights from it, a short window at the cell's own
load, the cell's requests picked before the window, then

* ``program``: the numbers ``run.py`` may compare (the widest and the
  mean gap of a served token below the float32 reference's best logit,
  the mean KL divergence of the decode logits from the reference's);
* ``fp8``: the same reference computed in fp8 (``precision="fp8"``) in
  the program's place: at each position of the same prompts and served
  tokens, the gap of the token the fp8 reference puts first, and the KL
  divergence of its distribution;
* with ``--kv-int8``, ``kv_int8``: the program's own lower-precision
  path (its int8 KV cache) served over the same requests and read as
  the program is, with the verdict of the cell's limits on it;
* with ``--router-flips`` (a MoE), ``router``: the float32 reference
  with only its router logits taken in bfloat16, as the program takes
  them, read as the program is, and the share of positions where that
  changes some MoE layer's top-k set.

One JSON line a seed; a limit lies between the largest sound reading of
its number and the smallest control one.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def fp8_readings(config, params, picks, refs, device) -> dict:
    """The widest and the mean gap under the float32 reference ``refs``
    of the tokens the fp8 reference puts first, and the mean KL
    divergence of the fp8 reference's decode distributions from it."""
    import torch
    from portbench import harness
    low = harness.reference_logits(config, params, picks, device, "fp8")
    gaps = torch.cat([harness.logit_gaps(r, lo.argmax(-1).cpu())
                      for r, lo in zip(refs, low)])
    kl = torch.cat([harness.decode_kl(r, list(lo[1:]))
                    for r, lo in zip(refs, low)])
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean()),
            "decode_kl_mean": float(kl.mean())}


def router_bf16(config, params, picks, refs, device) -> dict:
    """The float32 reference with only its router logits taken as the
    program takes them (input and weights in bfloat16, the logits
    rounded to bfloat16), against the float32 reference ``refs``: the
    widest and the mean gap of the tokens it puts first, the mean KL
    divergence of its decode distributions, and the share of positions
    (from each prompt's last on) where some MoE layer's top-k set
    differs from the float32 router's."""
    import numpy as np
    import torch
    from portbench import harness
    from portbench.reference import deepseek

    class Bf16Router(deepseek._Math):
        def __init__(self):
            super().__init__(config, "float32")
            self.calls, self.flips = 0, [None] * len(picks)

        def router_logits(self, h, w):
            K = self.cfg["experts_per_token"]
            exact = h @ w["w_router"]
            lo = (h.bfloat16() @ w["w_router"].bfloat16()).float()
            top = [torch.sort(x, dim=-1, descending=True, stable=True)
                   .indices[:, :K].sort(-1).values for x in (exact, lo)]
            i = self.calls % len(picks)
            f = (top[0] != top[1]).any(-1)
            self.flips[i] = f if self.flips[i] is None else self.flips[i] | f
            self.calls += 1
            return lo

    calc = Bf16Router()
    seqs = [torch.as_tensor(np.concatenate([r.prompt, r.tokens[:-1]]),
                            dtype=torch.int64, device=device) for r in picks]
    first = [len(r.prompt) - 1 for r in picks]
    low = deepseek.logits(config, params, seqs, [len(r.prompt) for r in picks],
                          first, calc=calc)
    gaps = torch.cat([harness.logit_gaps(r, lo.argmax(-1).cpu())
                      for r, lo in zip(refs, low)])
    kl = torch.cat([harness.decode_kl(r, list(lo[1:]))
                    for r, lo in zip(refs, low)])
    flips = torch.cat([f[s:] for f, s in zip(calc.flips, first)])
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean()),
            "decode_kl_mean": float(kl.mean()),
            "flip_share": float(flips.float().mean())}


def served(cell, seed, seconds, device, warm, flips=False, **overrides):
    """(program readings, fp8 readings or None, router witness or None,
    timings) of one seed's window."""
    import torch
    from portbench import harness
    reqs = harness.offered(cell, seed, seconds)
    picks = harness.sample(reqs, cell.params["check"]["requests"], seed)
    system = harness.build(cell, seed, device, **overrides)
    if warm:
        harness.warm_up(system, reqs, seed)
    t = time.perf_counter()
    win = harness.serve_window(system, reqs, seconds, picks=picks)
    wall = time.perf_counter() - t
    t = time.perf_counter()
    chosen = harness.checked(win)
    harness.release(system)
    refs = harness.reference_logits(cell.config, system.params, chosen,
                                    device)
    readings = harness.compare(win, chosen, refs)
    ref_s = time.perf_counter() - t
    low = witness = None
    if not overrides:
        low = fp8_readings(cell.config, system.params, chosen, refs, device)
    if flips:
        witness = router_bf16(cell.config, system.params, chosen, refs,
                              device)
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return readings, low, witness, {"window_s": wall, "reference_s": ref_s,
                                    "requests": len(win.requests)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--router-flips", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from portbench import harness, spec
    cell = spec.load_cell(ROOT, args.workload)
    limits = cell.params["check"]["limits"]
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        readings, low, witness, info = served(
            cell, seed, args.seconds, device, warm=i == 0,
            flips=args.router_flips)
        line = {"seed": seed, "program": readings, "fp8": low, **info}
        if witness:
            line["router"] = witness
        if args.kv_int8:
            kv, _, _, _ = served(cell, seed, args.seconds, device,
                                 warm=i == 0, kv_quant=True)
            line["kv_int8"] = kv
            line["kv_int8_correct"] = harness.judge(kv, limits)[0]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
