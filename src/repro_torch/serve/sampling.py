"""Token sampling: greedy / temperature / top-k, as
``repro/serve/sampling.py``.

Random draws come from an explicit ``torch.Generator``; they are not
JAX's draws for the same seed (the generators differ), so only greedy
decoding reproduces the reference token for token.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> full softmax
    vocab_size: Optional[int] = None   # mask padded columns


def sample(generator: Optional[torch.Generator], logits: torch.Tensor,
           cfg: SamplingConfig) -> torch.Tensor:
    """logits: (B, Vp) -> (B,) int32.  Padded columns (``>= vocab_size``)
    are never drawn; with ``top_k`` only the k largest logits (and ties
    with the k-th) are."""
    lf = logits.float()
    if cfg.vocab_size is not None and cfg.vocab_size < lf.shape[-1]:
        col = torch.arange(lf.shape[-1], device=lf.device)
        lf = torch.where(col[None, :] < cfg.vocab_size, lf, -1e30)
    if cfg.temperature <= 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    lf = lf / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(lf, cfg.top_k, dim=-1).values[:, -1:]
        lf = torch.where(lf >= kth, lf, -1e30)
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
