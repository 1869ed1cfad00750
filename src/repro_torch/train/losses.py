"""Cross-entropy over a padded vocabulary, as ``repro/train/losses.py``.

Padded vocab columns (``transformer.padded_vocab``) are masked to
``-1e30``.  There is no stop-gradient on the max: its ``+m`` and ``-m``
cancel, giving the exact softmax gradient.  The label logit is a gather,
which equals the reference's one-hot contraction bit for bit (one nonzero
term), without a (B, T, V) one-hot.

:func:`chunked_ce` fuses the LM head with the loss over sequence chunks:
each chunk's logits are a bfloat16 (activation-dtype) product of the
hidden state and the head, then widened to float32, as the reference
computes them, and each chunk runs under ``torch.utils.checkpoint``
(``use_reentrant=False``), so its backward recomputes the (B, chunk, V)
tile.  That tile is the only logits tensor that ever exists, forward or
backward: at RecurrentGemma-9B's 256k vocabulary the full (B, T, V)
float32 logits of one 2 × 4096 microbatch would be 8.4 GB.  The sums over
chunks are float32, accumulated in chunk order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import argmax_last, is_dtensor

MASKED_LOGIT = -1e30


def _mask_vocab(lf: torch.Tensor, vocab_size: Optional[int]) -> torch.Tensor:
    Vp = lf.shape[-1]
    if vocab_size is None or vocab_size >= Vp:
        return lf
    col = torch.arange(Vp, device=lf.device)
    return torch.where(col < vocab_size, lf, MASKED_LOGIT)


def _nll_terms(lf: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, label logit), both (B, T) float32, over masked f32 logits."""
    m = torch.amax(lf, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    if is_dtensor(lf):
        # vocab-sharded logits: the label column picked by a masked sum
        # over the vocab (one nonzero term), which DTensor reduces across
        # the shards, where a gather would need the whole row.
        col = torch.arange(lf.shape[-1], device=lf.device)
        label_logit = torch.sum(torch.where(
            col == labels.long()[..., None], lf, 0.0), dim=-1)
    else:
        label_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse, label_logit


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  loss_mask: Optional[torch.Tensor] = None,
                  vocab_size: Optional[int] = None,
                  z_loss_coef: float = 0.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits: (B, T, Vp); labels: (B, T) int; loss_mask: (B, T) 0/1."""
    B, T, _ = logits.shape
    lf = _mask_vocab(logits.float(), vocab_size)
    lse, label_logit = _nll_terms(lf, labels)
    nll = lse - label_logit
    if z_loss_coef > 0.0:
        nll = nll + z_loss_coef * torch.square(lse)
    if loss_mask is None:
        loss_mask = torch.ones((B, T), dtype=torch.float32,
                               device=logits.device)
    loss_mask = loss_mask.float()
    denom = torch.clamp_min(torch.sum(loss_mask), 1.0)
    loss = torch.sum(nll * loss_mask) / denom
    hits = (argmax_last(lf) == labels).float() * loss_mask
    acc = torch.sum(hits) / denom
    return loss, {"loss": loss, "accuracy": acc,
                  "tokens": torch.sum(loss_mask)}


def _chunk_sums(x_c: torch.Tensor, head_w: torch.Tensor, y_c: torch.Tensor,
                m_c: torch.Tensor, vocab_size: int):
    """One chunk: (sum of masked nll, hits, tokens), float32 scalars."""
    logits = x_c @ head_w.to(x_c.dtype)
    lf = _mask_vocab(logits.float(), vocab_size)
    lse, label_logit = _nll_terms(lf, y_c)
    nll = (lse - label_logit) * m_c
    hit = (argmax_last(lf) == y_c).float() * m_c
    return torch.sum(nll), torch.sum(hit), torch.sum(m_c)


def chunked_ce(x: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
               loss_mask: Optional[torch.Tensor], vocab_size: int,
               chunk: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused LM head + cross-entropy.  x: (B, T, D) final hidden state;
    head_w: (D, Vp).  Chunks only when ``T > chunk`` and ``T % chunk ==
    0``; otherwise the whole (B, T, Vp) logits go through
    :func:`cross_entropy`."""
    B, T, D = x.shape
    if loss_mask is None:
        loss_mask = torch.ones((B, T), dtype=torch.float32, device=x.device)
    loss_mask = loss_mask.float()
    if not (chunk and T > chunk and T % chunk == 0):
        logits = x @ head_w.to(x.dtype)
        return cross_entropy(logits, labels, loss_mask, vocab_size)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nll_sum, correct, ntok = zero, zero, zero
    for s in range(0, T, chunk):
        sl = slice(s, s + chunk)
        nll, hit, tok = checkpoint(_chunk_sums, x[:, sl], head_w,
                                   labels[:, sl], loss_mask[:, sl],
                                   vocab_size, use_reentrant=False,
                                   preserve_rng_state=False)
        nll_sum, correct, ntok = nll_sum + nll, correct + hit, ntok + tok
    denom = torch.clamp_min(ntok, 1.0)
    loss = nll_sum / denom
    return loss, {"loss": loss, "accuracy": correct / denom, "tokens": ntok}
