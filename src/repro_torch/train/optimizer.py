"""AdamW with global-norm clipping and a warmup + cosine schedule, as
``repro/train/optimizer.py``.

Plain functions over tensor trees (the port's nested dicts and lists of
parameters).  Where the reference returns new trees (its train step
donates the old buffers), :func:`adamw_update` writes the new
parameters, moments and step into the given tensors under
``torch.no_grad()`` and returns those same objects; it also scales the
gradients in place when it clips them.

The arithmetic is the reference's, in float32: the step is incremented
before the learning rate and the bias corrections are computed
(``lr`` at step 1 is ``learning_rate / warmup_steps``), ``b ** step`` is
a float32 power, the clip scale is ``min(1, max_norm / (norm + 1e-9))``
cast to the gradient's dtype, and the global norm sums each leaf's
squares in float32, then the stack of those sums.  Weight decay is
masked by rank, not by role: every leaf with ``ndim >= 2`` decays, so a
stacked segment's norm scales, of shape ``(repeats, d)``, decay as the
reference's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.params import leaves_with_paths, map_tree


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: Any                   # tree like params
    v: Any


def _leaves(tree):
    return [leaf for _, leaf in leaves_with_paths(tree)]


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``; a float32
    scalar on ``step``'s device."""
    step_f = step.to(torch.float32)
    warm = step_f / max(cfg.warmup_steps, 1)
    denom = max(cfg.total_steps - cfg.warmup_steps, 1)
    progress = torch.clamp((step_f - cfg.warmup_steps) / denom, 0.0, 1.0)
    cosine = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return cfg.learning_rate * torch.where(step_f < cfg.warmup_steps,
                                           warm, cosine)


def init_opt_state(params) -> AdamWState:
    leaves = _leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=map_tree(lambda _, p: torch.zeros_like(p), params),
        v=map_tree(lambda _, p: torch.zeros_like(p), params))


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scales every leaf of ``tree`` in place by ``min(1, max_norm /
    (norm + 1e-9))``; returns ``(tree, norm)``."""
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    for g in _leaves(tree):
        g.mul_(scale.to(g.dtype))
    return tree, norm


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state: AdamWState
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, written into ``params``, ``state.m``, ``state.v``
    and ``state.step``; returns ``(params, state, {"grad_norm", "lr"})``."""
    grads, grad_norm = clip_by_global_norm(grads, cfg.clip_norm)
    state.step.add_(1)
    lr = schedule(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    step_f = state.step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, step_f)
    bc2 = 1 - torch.pow(b2, step_f)
    for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(state.m),
                          _leaves(state.v)):
        # Each op rounds to float32 as the reference's does; a float32
        # leaf is updated in place (x.float() is x), with at most two
        # leaf-sized temporaries.
        g = g.float()
        mf, vf, pf = m.float(), v.float(), p.float()
        mf.mul_(b1).add_((1 - b1) * g)
        vf.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        delta = mf / bc1
        delta.div_(torch.sqrt(vf / bc2).add_(cfg.eps))
        if p.dim() >= 2:      # decay mask: skip 1-D params
            delta.add_(cfg.weight_decay * pf)
        pf.sub_(delta.mul_(lr))
        for leaf, new in ((m, mf), (v, vf), (p, pf)):
            if new is not leaf:
                leaf.copy_(new)
    return params, state, {"grad_norm": grad_norm, "lr": lr}
