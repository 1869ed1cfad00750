"""Elastic scaling: resume a checkpoint on another mesh, as
``repro/distributed/elastic.py``.

Checkpoints hold unsharded leaves (``repro_torch.train.checkpoint``, the
JAX package's format), so moving a job to another mesh is recomputing
the placements for the new mesh from the same logical axes and
distributing each leaf as it is read.  :func:`plan_resize` picks the
(data, model) split for a new device count that keeps the
architecture's model-axis divisibility.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (ShardingCtx, rules_for,
                                              tree_shardings)
from repro_torch.models import transformer as tf
from repro_torch.models.params import param_axes, param_shapes
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import TrainState, train_state_axes


def plan_resize(n_devices: int, cfg: ArchConfig,
                prefer_model: int = 16) -> Tuple[int, int]:
    """(data, model) for a new device count: the largest model-axis size
    up to ``prefer_model`` that divides the device count and one of the
    architecture's shardable dims (heads, d_ff, experts, d_model)."""
    dims = [d for d in (cfg.num_heads, cfg.d_ff or 0, cfg.n_experts or 0,
                        cfg.d_model) if d]
    for model in range(min(prefer_model, n_devices), 0, -1):
        if n_devices % model:
            continue
        if any(dim % model == 0 for dim in dims):
            return n_devices // model, model
    return n_devices, 1


def _param_like(cfg: ArchConfig):
    import torch
    dtype = getattr(torch, cfg.param_dtype)
    return param_shapes(tf.model_specs(cfg), dtype)


def state_like(cfg: ArchConfig) -> TrainState:
    """A ``TrainState`` of meta tensors: the shapes and dtypes a
    checkpoint of ``cfg``'s training state holds."""
    params = _param_like(cfg)
    return TrainState(params=params, opt=init_opt_state(params))


def shardings_for_mesh(mesh, cfg: ArchConfig, *, state: bool = True):
    """The placement tree of a ``TrainState`` (or, with ``state`` off,
    of the bare parameters) on ``mesh`` under ``cfg``'s rules: the
    default rules with its ``rule_overrides``, by which the sharded step
    places the gradients.  The reference places by the default rules
    alone and lets ``jit`` reshard on entry; a DTensor would keep the
    mismatch, so every step would redistribute."""
    ctx = ShardingCtx(mesh, rules_for(cfg))
    if state:
        return tree_shardings(ctx, state_like(cfg), train_state_axes(cfg))
    return tree_shardings(ctx, _param_like(cfg),
                          param_axes(tf.model_specs(cfg)))


def restore_elastic(ckpt: CheckpointManager, cfg: ArchConfig, mesh,
                    step: Optional[int] = None):
    """The latest (or ``step``'s) checkpoint as a ``TrainState`` of
    DTensors on ``mesh``: ``(state, step, extra)``."""
    return ckpt.restore(state_like(cfg), step=step, mesh=mesh,
                        placements=shardings_for_mesh(mesh, cfg))
