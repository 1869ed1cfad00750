"""Serving engine: prefill/decode + slot-based continuous batching, as
``repro/serve/engine.py``.

``ServeEngine`` is the long-running service the orchestrator deploys (an
LLM endpoint).  Design, as the reference's:

* a fixed decode batch of ``num_slots``: every step decodes every slot,
  free ones included;
* per-request prefill (B = 1) whose state rows are written into the
  batched decode state (continuous batching at slot granularity);
* per-example cache positions, so slots at different depths coexist in
  one decode step;
* ``snapshot()`` / ``restore()``: the moveable-service contract;
* ``extra_inputs``: modality inputs every request's prefill reads
  (``audio_embeds`` (encoder_seq, D) for Whisper, ``pixel_embeds``
  (P, D) for InternVL2), each given once without a batch axis and kept
  on the engine's device as a (1, ...) tensor.

The engine runs eagerly (no ``jit``): a decode step is ``decode_step``
on the card, the sample, and one read of the new tokens to the host.
Its device is explicit: ``None`` is the card, and the CPU runs only when
the caller passes ``device="cpu"``.  Timestamps come from an injectable
clock, so a test can drive a virtual one.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.params import leaves_with_paths, map_tree
from repro_torch.serve.sampling import SamplingConfig, sample


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (P,) int32
    max_new_tokens: int = 16
    submitted_at: float = 0.0
    # filled by the engine:
    tokens: List[int] = dataclasses.field(default_factory=list)
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 4
    cache_len: int = 256
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    eos_id: int = -1                   # -1: only stop on max_new_tokens


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig,
                 extra_inputs: Optional[Dict[str, Any]] = None,
                 clock: Callable[[], float] = time.time, device=None):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.clock = clock
        self.device = resolve_device(device)
        self.extra = {k: torch.as_tensor(np.asarray(v))[None].to(self.device)
                      for k, v in (extra_inputs or {}).items()}
        B = ecfg.num_slots
        self.states = tf.init_decode_state(cfg, B, ecfg.cache_len,
                                           dtype=getattr(torch, cfg.dtype),
                                           device=self.device)
        self.last_tokens = torch.zeros((B, 1), dtype=torch.int64,
                                       device=self.device)
        self.active: List[Optional[Request]] = [None] * B
        self.remaining = np.zeros((B,), np.int32)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        self._sampling = dataclasses.replace(ecfg.sampling,
                                             vocab_size=cfg.vocab_size)

    # -- slot management -----------------------------------------------------
    def _insert_slot(self, slot: int, row_states, first_token: int) -> None:
        """Write a B = 1 prefill's state rows into slot ``slot`` (each
        leaf's batch axis found by :func:`_batch_axis`), widening to the
        decode state's dtype."""
        for (_, b), (_, r) in zip(leaves_with_paths(self.states),
                                  leaves_with_paths(row_states)):
            b.narrow(_batch_axis(b, r), slot, 1).copy_(r)
        self.last_tokens[slot, 0] = first_token

    def admit(self, req: Request) -> bool:
        """Prefill the request and place it into a free slot."""
        free = [i for i, r in enumerate(self.active) if r is None]
        if not free:
            return False
        slot = free[0]
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                 device=self.device)[None, :]
        logits, row_states = tf.prefill(self.params,
                                        {"tokens": tokens, **self.extra},
                                        self.cfg, self.ecfg.cache_len)
        first = int(torch.argmax(logits[0, :self.cfg.vocab_size].float()))
        self._insert_slot(slot, row_states, first)
        req.tokens.append(first)
        req.first_token_at = self.clock()
        self.active[slot] = req
        self.remaining[slot] = req.max_new_tokens - 1
        return True

    def step(self) -> List[Request]:
        """One batched decode step; returns requests finished this step."""
        if not any(r is not None for r in self.active):
            return []
        logits, self.states = tf.decode_step(self.params, self.last_tokens,
                                             self.states, self.cfg)
        nxt = sample(self.generator, logits, self._sampling)
        self.last_tokens = nxt[:, None].to(torch.int64)
        out = nxt.cpu().numpy()
        finished: List[Request] = []
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(out[slot])
            req.tokens.append(tok)
            self.remaining[slot] -= 1
            if self.remaining[slot] <= 0 or tok == self.ecfg.eos_id:
                req.done_at = self.clock()
                finished.append(req)
                self.active[slot] = None
        return finished

    # -- the moveable-service contract ---------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Host copies of the engine's state (the decode state is updated
        in place, so the copies must not share its memory)."""
        return {
            "states": map_tree(lambda _, t: t.cpu().numpy().copy(),
                               self.states),
            "last_tokens": self.last_tokens.cpu().numpy().copy(),
            "active": copy.deepcopy(self.active),   # frozen in-flight state
            "remaining": self.remaining.copy(),
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        self.states = map_tree(
            lambda _, a: torch.as_tensor(a).clone().to(self.device),
            snap["states"])
        self.last_tokens = torch.as_tensor(snap["last_tokens"]).to(
            self.device)
        self.active = list(snap["active"])
        self.remaining = snap["remaining"].copy()


def _batch_axis(batched: torch.Tensor, row: torch.Tensor) -> int:
    """The batch axis: the first axis where the row has size 1 and the
    batched state is larger (a leading layer axis matches in size)."""
    for ax in range(batched.dim()):
        if row.shape[ax] == 1 and batched.shape[ax] > 1:
            return ax
        if row.shape[ax] != batched.shape[ax]:
            raise ValueError(f"incompatible state shapes "
                             f"{tuple(batched.shape)} vs {tuple(row.shape)}")
    raise ValueError(f"no batch axis in {tuple(batched.shape)} vs "
                     f"{tuple(row.shape)}")


def run_server(engine: ServeEngine, requests: List[Request],
               log: Callable[[str], None] = print,
               clock: Optional[Callable[[], float]] = None,
               sleep: Callable[[float], None] = time.sleep
               ) -> Dict[str, float]:
    """Drive the engine over a request list (arrival times respected via
    submitted_at ordering); returns latency/throughput metrics.

    ``clock``/``sleep`` default to wall time; a test can pass a virtual
    clock (and a sleep that advances it) for a deterministic run — the
    engine's own timestamps follow ``engine.clock``, which takes the same
    ``clock`` when one is given here."""
    if clock is None:
        clock = engine.clock
    else:
        engine.clock = clock
    pending = sorted(requests, key=lambda r: r.submitted_at)
    t0 = clock()
    done: List[Request] = []
    qi = 0
    while len(done) < len(requests):
        now = clock() - t0
        while qi < len(pending) and pending[qi].submitted_at <= now:
            if engine.admit(pending[qi]):
                qi += 1
            else:
                break
        finished = engine.step()
        done.extend(finished)
        if not finished and qi < len(pending) and \
           not any(engine.active):
            # idle: jump to next arrival
            sleep(max(0.0, pending[qi].submitted_at - (clock() - t0)))
    total_tokens = sum(len(r.tokens) for r in done)
    dt = clock() - t0
    ttfts = [r.first_token_at - t0 - r.submitted_at for r in done
             if r.first_token_at]
    return {"requests": len(done), "tokens": total_tokens,
            "elapsed_s": dt, "tokens_per_s": total_tokens / max(dt, 1e-9),
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0}
