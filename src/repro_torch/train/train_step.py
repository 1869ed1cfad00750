"""The train step, as ``repro/train/train_step.py``: loss, gradients,
microbatch accumulation, AdamW update.

``make_train_step(cfg, opt_cfg, accum, remat)`` returns
``train_step(state, batch) -> (state, metrics)``.  The state's tensors
are updated in place (the reference donates its state to ``jax.jit``),
and ``metrics`` holds the reference's float32 scalars: ``loss``,
``accuracy``, ``tokens``, ``aux_loss`` (the mean over microbatches),
``grad_norm`` and ``lr``.

* With ``cfg.ce_chunk`` the loss is the fused chunked LM head +
  cross-entropy over the final hidden state (no full logits).
* For the vlm family the first ``vision_prefix_len`` positions (the
  patches) are dropped before the loss, on either path.
* ``remat`` checkpoints each superblock (``transformer._run_tower_train``).
* With ``accum > 1`` every batch leaf carries a leading (accum,) axis;
  each microbatch runs its own forward and backward, and a hook on each
  parameter divides its gradient by ``accum`` before autograd adds it to
  the float32 ``.grad``, which gives the reference's ``a + g / accum``
  sum in microbatch order without a second gradient tree.

Gradients are taken with respect to ``detach()``-ed aliases of the
parameters that require grad, so the state's own tensors never carry
autograd history, and the aliases (and their ``.grad``) are dropped
after the update.

Sharded: the same step runs on a state of DTensors
(``repro_torch.distributed.sharding.distribute_tree`` at
:func:`train_state_axes`) and a batch at :func:`batch_axes`, under
``sharding_ctx``.  The gradients are pinned to the parameters'
placements before the update (``_constrain_grads``, the reference's:
DTensor's autograd leaves them partial or otherwise placed), so the
moments and the update stay sharded as the parameters are; the metrics
come back as plain (full) tensors.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import is_dtensor, map_axes, shard
from repro_torch.models import transformer as tf
from repro_torch.models.params import (init_params, leaves_with_paths,
                                       map_tree, param_axes)
from repro_torch.train import losses
from repro_torch.train.optimizer import (AdamWState, OptimizerConfig,
                                         adamw_update, init_opt_state)

METRIC_KEYS = ("loss", "accuracy", "tokens", "aux_loss")


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(generator: torch.Generator, cfg: ArchConfig,
                     device=None) -> TrainState:
    """Fresh parameters drawn from ``generator`` (on its own device) in
    ``cfg.param_dtype``, on ``device`` (``None`` is the card), and zero
    AdamW moments."""
    dtype = None if cfg.param_dtype == "float32" else \
        getattr(torch, cfg.param_dtype)
    params = init_params(tf.model_specs(cfg), generator, device, dtype=dtype)
    return TrainState(params=params, opt=init_opt_state(params))


def train_state_axes(cfg: ArchConfig) -> TrainState:
    """The logical-axes tree mirroring a ``TrainState``: the moments
    shard as the parameters do, the step is replicated."""
    axes = param_axes(tf.model_specs(cfg))
    return TrainState(params=axes, opt=AdamWState(step=(), m=axes, v=axes))


def batch_axes(cfg: ArchConfig, accum: int = 1) -> Dict[str, tuple]:
    """The logical axes of a training batch's leaves."""
    lead = ("microbatch",) if accum > 1 else ()
    ax = {"tokens": lead + ("act_batch", None),
          "labels": lead + ("act_batch", None),
          "loss_mask": lead + ("act_batch", None)}
    if cfg.family == "vlm":
        ax["pixel_embeds"] = lead + ("act_batch", None, None)
    if cfg.family == "audio":
        ax["audio_embeds"] = lead + ("act_batch", None, None)
    return ax


def _loss_fn(params, batch: Dict, cfg: ArchConfig, remat: bool
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if cfg.ce_chunk:
        x, aux = tf.forward_hidden(params, batch, cfg, remat=remat)
        if cfg.family == "vlm":
            x = x[:, cfg.vision_prefix_len:]
        loss, metrics = losses.chunked_ce(
            x, tf.head_weights(params, cfg), labels, mask,
            vocab_size=cfg.vocab_size, chunk=cfg.ce_chunk)
    else:
        logits, aux = tf.forward_train(params, batch, cfg, remat=remat)
        if cfg.family == "vlm":
            logits = logits[:, cfg.vision_prefix_len:]
        loss, metrics = losses.cross_entropy(logits, labels, mask,
                                             vocab_size=cfg.vocab_size)
    total = loss + aux
    metrics["aux_loss"] = aux
    return total, metrics


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig,
                    accum: int = 1, remat: bool = True):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    is a dict of tensors on the state's device."""
    grad_axes = param_axes(tf.model_specs(cfg))

    def _constrain_grads(grads):
        return map_axes(lambda ax, g: shard(g, ax), grad_axes, grads)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        train_p = map_tree(lambda _, p: p.detach().requires_grad_(),
                           state.params)
        leaves = [p for _, p in leaves_with_paths(train_p)]
        hooks = [p.register_hook(lambda g: g.float() / accum)
                 for p in leaves] if accum > 1 else []
        micro = [{k: v[i] for k, v in batch.items()} for i in range(accum)] \
            if accum > 1 else [batch]
        per_mb = []
        try:
            for mb in micro:
                total, metrics = _loss_fn(train_p, mb, cfg, remat)
                total.backward()
                per_mb.append({k: metrics[k].detach() for k in METRIC_KEYS})
        finally:
            for h in hooks:
                h.remove()
        metrics = {k: torch.mean(torch.stack([m[k] for m in per_mb]))
                   for k in METRIC_KEYS} if accum > 1 else per_mb[0]
        grads = _constrain_grads(map_tree(
            lambda _, p: p.grad if p.grad is not None
            else torch.zeros_like(p), train_p))
        del train_p, leaves
        _, _, opt_metrics = adamw_update(opt_cfg, state.params, grads,
                                         state.opt)
        metrics.update(opt_metrics)
        return state, {k: v.full_tensor() if is_dtensor(v) else v
                       for k, v in metrics.items()}

    return train_step
