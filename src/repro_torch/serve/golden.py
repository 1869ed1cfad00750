"""Replaying the serve fixtures whose parameters are drawn from a seed:

* ``tests/data/torch_xlstm_serve_golden/expected.npz`` (:data:`XLSTM`):
  a float32 twin at xLSTM-125M's widths (d_model 768, 4 heads, mLSTM
  heads 384 wide) cut to 8 layers (two stacked (mLSTM ×3, sLSTM)
  superblocks), a 128-token prefill (two chunks);
* ``tests/data/torch_moe_serve_golden/expected.npz`` (:data:`MOE`): a
  float32 twin at DeepSeekMoE-16B's widths (d_model 2048, 16 heads of
  128, 64 routed experts 1408 wide, top-6, 2 shared experts, a first
  dense layer 10944 wide) cut to 3 layers (1 dense + 2 MoE), a
  1024-token prefill (two groups of 512 at capacity 60, so some choices
  are dropped);
* ``tests/data/torch_dense_serve_golden/expected.npz`` (:data:`DENSE`):
  a float32 twin at Command-R-35B's widths (d_model 8192, 64 query heads
  over 8 kv heads of 128, d_ff 22528, LayerNorm, parallel blocks, tied
  embeddings, RoPE theta 8e6) cut to 2 layers, a 512-token prefill;
* ``tests/data/torch_whisper_serve_golden/expected.npz``
  (:data:`WHISPER`): a float32 twin at Whisper-medium's widths (d_model
  1024, 16 heads of 64, d_ff 4096, LayerNorm, GeLU, biases, tied
  embeddings, sinusoidal positions) cut to 2 encoder + 2 decoder layers,
  the encoder over all 1500 frames, a 64-token prefill;
* ``tests/data/torch_softcap_serve_golden/expected.npz``
  (:data:`SOFTCAP`): the Whisper fixture's model, parameters, frames and
  tokens with the attention logits soft-capped at :data:`SOFTCAP_CAP`;
* ``tests/data/torch_vlm_serve_golden/expected.npz`` (:data:`VLM`): a
  float32 twin at InternVL2-26B's widths (d_model 6144, 48 query heads
  over 8 kv heads of 128, d_ff 16384) cut to 2 layers, its vision prefix
  cut from 1024 to 256 patches (a length cut, so that the CPU replay
  fits its time), a 32-token prefill after the patches.

Each has a vocab of :data:`VOCAB` and parameters drawn by
``numpy_params(model_specs(cfg), seed)``; the Whisper and InternVL2
fixtures also draw their modality input (:func:`extra_inputs`) from the
seed, and hold its digest, and every prefill of the fixture reads it. A
fixture holds the seed and the parameters' digest (not the parameters),
JAX's logits for the prefill and 8 decode steps of 2 sequences, and a
JAX ``ServeEngine`` run's greedy tokens, stamps and metrics on a virtual
clock; the MoE fixture also holds JAX's chosen experts in each MoE layer
of the prefill and the decode steps.

``tests/test_torch_xlstm.py``, ``tests/test_torch_moe.py``,
``tests/test_torch_dense.py``, ``tests/test_torch_whisper.py``,
``tests/test_torch_softcap.py`` and ``tests/test_torch_vlm.py`` build them with the JAX package from these
helpers; the CPU tests, the card tests and ``chip_smoke.py`` replay them
through :func:`replay` and compare with :data:`TOL`.  The MoE fixture's
callers read the port's chosen experts by wrapping ``moe.route`` around
the replay and compare them with :func:`routing_report`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as tf
from repro_torch.models.params import (numpy_params, numpy_params_on,
                                       tree_digest)
from repro_torch.serve import engine as serve

METRIC_KEYS = ("elapsed_s", "mean_ttft_s", "requests", "tokens",
               "tokens_per_s")
# float32 logits against JAX's: sums over wide heads and several layers
# in other orders (the RecurrentGemma serve fixture's bound).
TOL = dict(atol=1e-4, rtol=1e-3)
VOCAB = 512


@dataclasses.dataclass(frozen=True)
class Fixture:
    """A fixture's model (``arch`` cut to ``layers``, vocab
    :data:`VOCAB`, float32) and runs: a ``prefill``-token prefill of 2 sequences then
    ``decode`` steps, and an engine run of ``requests`` (prompt length,
    max_new_tokens, submitted_at) on ``slots`` slots, both with caches
    of ``cache_len``."""
    arch: str
    layers: int
    prefill: int
    decode: int
    requests: Tuple[Tuple[int, int, float], ...]
    slots: int
    cache_len: int
    seed: int = 0
    overrides: Tuple[Tuple[str, Any], ...] = ()


XLSTM = Fixture("xlstm-125m", layers=8, prefill=128, decode=8,
                requests=((12, 5, 0.0), (64, 4, 0.0), (7, 6, 1.0)),
                slots=2, cache_len=256)
MOE = Fixture("deepseek-moe-16b", layers=3, prefill=1024, decode=8,
              requests=((12, 5, 0.0), (512, 4, 0.0), (7, 6, 1.0)),
              slots=2, cache_len=1040)
DENSE = Fixture("command-r-35b", layers=2, prefill=512, decode=8,
                requests=((12, 5, 0.0), (300, 4, 0.0), (7, 6, 1.0)),
                slots=2, cache_len=528)
WHISPER = Fixture("whisper-medium", layers=2, prefill=64, decode=8,
                  requests=((12, 5, 0.0), (64, 4, 0.0), (7, 6, 1.0)),
                  slots=2, cache_len=80,
                  overrides=(("encoder_layers", 2),))
# The cap at the scale of the fixture's own attention logits: with its
# random float32 weights and frames every logit lies within 0.19 of 0
# (rms 0.03), so a cap of 0.05 bends them and moves JAX's output logits
# by ~20x TOL from the Whisper fixture's, where a cap of 50 would leave
# them as they are.
SOFTCAP_CAP = 0.05
SOFTCAP = dataclasses.replace(
    WHISPER, overrides=WHISPER.overrides + (("attn_logit_softcap",
                                             SOFTCAP_CAP),))
VLM = Fixture("internvl2-26b", layers=2, prefill=32, decode=8,
              requests=((12, 5, 0.0), (32, 4, 0.0), (7, 6, 1.0)),
              slots=2, cache_len=304,
              overrides=(("vision_prefix_len", 256),))


def config(fixture: Fixture, cfg=None):
    """The fixture's model, from ``cfg`` (the port's config of its arch
    by default)."""
    cfg = get_config(fixture.arch) if cfg is None else cfg
    return dataclasses.replace(cfg, num_layers=fixture.layers,
                               vocab_size=VOCAB, dtype="float32",
                               **dict(fixture.overrides))


def extra_inputs(fixture: Fixture) -> Dict[str, np.ndarray]:
    """The fixture's modality input (none for a text-only arch), drawn as
    the serve CLI draws it but from ``seed + 3``."""
    return serve_cli.extra_inputs(config(fixture), fixture.seed + 3)


def parameters(fixture: Fixture) -> Dict:
    """The fixture's parameters as float32 numpy arrays."""
    return numpy_params(tf.model_specs(config(fixture)), fixture.seed)


def inputs(fixture: Fixture) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The token ids: (2, prefill + decode) for prefill and decode, and
    the engine's prompts."""
    seed = fixture.seed
    tokens = np.random.default_rng(seed + 1).integers(
        0, VOCAB, (2, fixture.prefill + fixture.decode)
    ).astype(np.int32)
    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
               for n, _, _ in fixture.requests]
    return tokens, prompts


def logits(fixture: Fixture, prefill: Callable, decode_step: Callable,
           params, cfg, tokens: np.ndarray, wrap: Callable,
           extra: Optional[Dict] = None) -> List:
    """Prefill ``fixture.prefill`` tokens (and ``extra``, the modality
    inputs with their batch axis, in either package's arrays), then
    ``fixture.decode`` steps: the logit rows, through either package's
    ``prefill`` / ``decode_step``."""
    P = fixture.prefill
    lg, st = prefill(params, {"tokens": wrap(tokens[:, :P]),
                              **(extra or {})}, cfg, fixture.cache_len)
    out = [lg]
    for i in range(P, P + fixture.decode):
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


def requests(fixture: Fixture, module, prompts: Sequence[np.ndarray]
             ) -> List:
    """The engine run's requests, as ``module.Request`` (either
    package's engine)."""
    return [module.Request(uid=i, prompt=prompts[i], max_new_tokens=new,
                           submitted_at=at)
            for i, (_, new, at) in enumerate(fixture.requests)]


def routing_rows(seen: Sequence, B: int) -> np.ndarray:
    """Recorded choices (either package's, each (B, G, Sg, K)), call
    after call along the token axis: (B, sum of the calls' T, K) int32."""
    return np.concatenate([np.asarray(g).reshape(B, -1, g.shape[-1])
                           for g in seen], axis=1).astype(np.int32)


def routing_report(fixture: Fixture, fx: Dict[str, np.ndarray],
                   seen: Sequence) -> Dict:
    """The port's routing in a :func:`replay` of ``fixture`` against
    JAX's in ``fx``: ``seen`` holds every ``moe.Routing`` of the replay
    in call order, of which the first are its prefill's and decode
    steps' (one a MoE layer each).  Whether the chosen experts equal
    JAX's, and how many choices capacity dropped."""
    cfg = config(fixture)
    run = seen[:(fixture.layers - cfg.first_k_dense) * (1 + fixture.decode)]
    return {"routing_equal": np.array_equal(
                routing_rows([r.gate_idx.cpu() for r in run], 2),
                fx["routing"]),
            "dropped_choices": sum(int((~r.keep).sum()) for r in run)}


def replay(fixture: Fixture, fx: Dict[str, np.ndarray], device) -> Dict:
    """The port on ``device`` against the fixture ``fx``: the parameters'
    digest (and the modality input's), the logits' largest error and
    worst share of :data:`TOL` (at most 1 where they agree), and whether
    the engine's tokens, stamps and metrics equal JAX's."""
    cfg = config(fixture)
    params, digest = numpy_params_on(tf.model_specs(cfg), int(fx["seed"]),
                                     device, dtype=tf.serving_dtype(cfg))
    extra = extra_inputs(fixture)
    digest_ok = digest == str(fx["params_digest"]) and (
        not extra or tree_digest(extra) == str(fx["extra_digest"]))
    got = logits(fixture, tf.prefill, tf.decode_step, params, cfg,
                 fx["tokens"], lambda a: torch.from_numpy(a).long().to(device),
                 {k: torch.from_numpy(np.repeat(v[None], 2, 0)).to(device)
                  for k, v in extra.items()})
    errs, shares = [], []
    for g, w in zip(got, [fx["prefill_logits"], *fx["decode_logits"]]):
        g = g.float().cpu().numpy()
        errs.append(float(np.abs(g - w).max()))
        shares.append(float((np.abs(g - w)
                             / (TOL["atol"] + TOL["rtol"] * np.abs(w))).max()))
    del got
    splits = np.cumsum([n for n, _, _ in fixture.requests])[:-1]
    prompts = np.split(fx["engine_prompts"], splits)
    clock, sleep = virtual_clock()
    eng = serve.ServeEngine(cfg, params, serve.EngineConfig(
        num_slots=fixture.slots, cache_len=fixture.cache_len),
        extra_inputs=extra, clock=clock, device=device)
    reqs = requests(fixture, serve, prompts)
    metrics = serve.run_server(eng, reqs, log=lambda s: None, clock=clock,
                               sleep=sleep)
    del eng, params
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
