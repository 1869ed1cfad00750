"""Replaying the xLSTM serve fixture
``tests/data/torch_xlstm_serve_golden/expected.npz``: a float32 twin at
xLSTM-125M's widths (d_model 768, 4 heads, mLSTM heads 384 wide) cut to
8 layers (two stacked (mLSTM ×3, sLSTM) superblocks) and a vocab of 512,
with parameters drawn by ``numpy_params(model_specs(cfg), seed)``.  The
fixture holds the seed and the parameters' digest (not the parameters),
JAX's logits for a 128-token prefill (two chunks) and 8 decode steps of
2 sequences, and a JAX ``ServeEngine`` run's greedy tokens, stamps and
metrics on a virtual clock.

``tests/test_torch_xlstm.py`` builds it with the JAX package from the
same helpers; the CPU tests, the card tests and ``chip_smoke.py``
replay it through :func:`replay` and compare with :data:`TOL`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.models.params import (numpy_params, params_from_numpy,
                                       tree_digest)
from repro_torch.serve import engine as serve

SEED = 0
LAYERS, VOCAB = 8, 512
PREFILL, DECODE = 128, 8
# The engine run: (prompt length, max_new_tokens, submitted_at) on 2 slots.
REQUESTS = ((12, 5, 0.0), (64, 4, 0.0), (7, 6, 1.0))
SLOTS, CACHE_LEN = 2, 256
METRIC_KEYS = ("elapsed_s", "mean_ttft_s", "requests", "tokens",
               "tokens_per_s")
# float32 logits against JAX's: sums over 384-wide heads and 8 layers in
# other orders (the RecurrentGemma serve fixture's bound).
TOL = dict(atol=1e-4, rtol=1e-3)


def config(cfg=None):
    """The fixture's model: xLSTM-125M (``cfg``, the port's by default)
    at 8 layers, vocab 512, float32."""
    cfg = get_config("xlstm-125m") if cfg is None else cfg
    return dataclasses.replace(cfg, num_layers=LAYERS, vocab_size=VOCAB,
                               dtype="float32")


def parameters(seed: int = SEED) -> Dict:
    """The fixture's parameters as float32 numpy arrays."""
    return numpy_params(tf.model_specs(config()), seed)


def inputs(seed: int = SEED) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The token ids: (2, 136) for prefill and decode, and the engine's
    prompts."""
    tokens = np.random.default_rng(seed + 1).integers(
        0, VOCAB, (2, PREFILL + DECODE)).astype(np.int32)
    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
               for n, _, _ in REQUESTS]
    return tokens, prompts


def logits(prefill: Callable, decode_step: Callable, params, cfg,
           tokens: np.ndarray, wrap: Callable) -> List:
    """Prefill ``PREFILL`` tokens, then ``DECODE`` steps: the logit rows,
    through either package's ``prefill`` / ``decode_step``."""
    lg, st = prefill(params, {"tokens": wrap(tokens[:, :PREFILL])}, cfg,
                     CACHE_LEN)
    out = [lg]
    for i in range(PREFILL, PREFILL + DECODE):
        lg, st = decode_step(params, wrap(tokens[:, i:i + 1]), st, cfg)
        out.append(lg)
    return out


def virtual_clock(tick: float = 0.25):
    now = [0.0]

    def clock():
        now[0] += tick
        return now[0]

    def sleep(dt):
        now[0] += dt
    return clock, sleep


def requests(module, prompts: Sequence[np.ndarray]) -> List:
    """The engine run's requests, as ``module.Request`` (either
    package's engine)."""
    return [module.Request(uid=i, prompt=prompts[i], max_new_tokens=new,
                           submitted_at=at)
            for i, (_, new, at) in enumerate(REQUESTS)]


def replay(fx: Dict[str, np.ndarray], device) -> Dict:
    """The port on ``device`` against the fixture ``fx``: the parameters'
    digest, the logits' largest error and worst share of :data:`TOL`
    (at most 1 where they agree), and whether the engine's tokens,
    stamps and metrics equal JAX's."""
    tree = parameters(int(fx["seed"]))
    digest_ok = tree_digest(tree) == str(fx["params_digest"])
    cfg = config()
    params = params_from_numpy(tree, device, dtype=tf.serving_dtype(cfg))
    del tree
    tokens = fx["tokens"]
    got = logits(tf.prefill, tf.decode_step, params, cfg, tokens,
                 lambda a: torch.from_numpy(a).long().to(device))
    errs, shares = [], []
    for g, w in zip(got, [fx["prefill_logits"], *fx["decode_logits"]]):
        g = g.float().cpu().numpy()
        errs.append(float(np.abs(g - w).max()))
        shares.append(float((np.abs(g - w)
                             / (TOL["atol"] + TOL["rtol"] * np.abs(w))).max()))
    splits = np.cumsum([n for n, _, _ in REQUESTS])[:-1]
    prompts = np.split(fx["engine_prompts"], splits)
    clock, sleep = virtual_clock()
    eng = serve.ServeEngine(cfg, params, serve.EngineConfig(
        num_slots=SLOTS, cache_len=CACHE_LEN), clock=clock, device=device)
    reqs = requests(serve, prompts)
    metrics = serve.run_server(eng, reqs, log=lambda s: None, clock=clock,
                               sleep=sleep)
    tokens_equal = all(r.tokens == [int(t) for t in want if t >= 0]
                       for r, want in zip(reqs, fx["engine_tokens"]))
    stamps_equal = np.array_equal(np.asarray(
        [(r.first_token_at, r.done_at) for r in reqs]), fx["engine_stamps"])
    metrics_equal = [metrics[k] for k in METRIC_KEYS] == \
        fx["engine_metrics"].tolist()
    return {"digest_ok": digest_ok, "logits_max_abs_err": max(errs),
            "worst_share_of_tol": max(shares), "tolerance": TOL,
            "engine_tokens_equal": tokens_equal,
            "engine_stamps_equal": stamps_equal,
            "engine_metrics_equal": metrics_equal,
            "ok": bool(digest_ok and max(shares) <= 1.0 and tokens_equal
                       and stamps_equal and metrics_equal)}
