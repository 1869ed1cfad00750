"""Int8 gradient compression for the cross-pod all-reduce, as
``repro/distributed/compression.py``.

Across pods the gradient sum rides the slow links, inside a pod the fast
ones: :func:`hierarchical_grad_sync` sums in float32 over the intra-pod
groups, then across pods either in float32 or compressed
(:func:`psum_int8`: a max-abs scale shared through a MAX all-reduce, an
int8 payload summed as int32, times the scale).  The error is at most
half a scale step per pod and element.

The arithmetic is the reference's, in its order: ``amax`` is the
float32 max-abs, the scale ``max(amax, 1e-30) / 127`` in float32, the
payload ``clip(round(x / scale), -127, 127)`` (``torch.round`` and
``jnp.round`` both round half to even), so equal inputs give equal int8
payloads.

:func:`make_compressed_ddp_step` is the pure data-parallel step: the
parameters are replicated (the same tensors on every rank), each rank
takes its rows of the global batch (split over every mesh dimension, in
the mesh's row-major order, as ``shard_map``'s ``P(batch_axes)``), and
the step returns the mean loss over ranks and the synced gradients,
divided by the world size.

:data:`SYNC_STATS` counts the all-reduces these functions start and the
bytes they hand to them (``reset_sync_stats`` clears it).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.params import leaves_with_paths, map_tree

SYNC_STATS: Dict[str, int] = {"all_reduce": 0, "bytes": 0}


def reset_sync_stats() -> None:
    SYNC_STATS.update(all_reduce=0, bytes=0)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    SYNC_STATS["all_reduce"] += 1
    SYNC_STATS["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=op, group=group)
    return t


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8)


def psum_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """Compressed sum over ``group``: a shared max-abs scale and an int8
    payload, summed as int32 (int8 summands over at most 2^24 ranks
    cannot overflow it).  Returns float32; ``x`` is not modified."""
    amax = _all_reduce(torch.amax(torch.abs(x.float())).reshape(()),
                       dist.ReduceOp.MAX, group)
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    total = _all_reduce(quantize_int8(x, scale).to(torch.int32),
                        dist.ReduceOp.SUM, group)
    return total.float() * scale


def hierarchical_grad_sync(grads, intra_groups: Sequence, pod_group,
                           compress: bool = True):
    """Every leaf summed in float32 over the intra-pod groups (one per
    intra-pod mesh axis, in turn), then across ``pod_group`` in int8
    (:func:`psum_int8`) or, with ``compress`` off, in float32.  A new
    tree; ``grads`` is not modified."""
    def sync(_, g):
        g = g.to(torch.float32, copy=True)
        for group in intra_groups:
            _all_reduce(g, dist.ReduceOp.SUM, group)
        if compress:
            return psum_int8(g, pod_group)
        return _all_reduce(g, dist.ReduceOp.SUM, pod_group)
    return map_tree(sync, grads)


def _local_rows(batch, mesh, batch_axes: Tuple[str, ...]):
    """This rank's rows of every leaf of ``batch``: dim 0 split over the
    mesh axes ``batch_axes``, row-major in the mesh's order."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    dims = sorted(names.index(a) for a in batch_axes)
    n = math.prod(mesh.size(d) for d in dims)
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + coord[d]

    def rows(_, x):
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over {n} ranks")
        m = x.shape[0] // n
        return x[idx * m:(idx + 1) * m]
    return map_tree(rows, batch)


def make_compressed_ddp_step(loss_fn: Callable, mesh,
                             batch_axes: Tuple[str, ...] = ("pod", "data",
                                                            "model"),
                             compress: bool = True, pod_axis: str = "pod"):
    """``step(params, batch) -> (mean loss, synced grads)`` on ``mesh``
    (a ``DeviceMesh``): ``params`` (a tensor or a tree of them) the same
    on every rank, ``batch`` (a tensor or a dict of them) the global
    batch, of which each rank differentiates ``loss_fn(params, rows)``
    on its own rows.  The optimizer update happens outside, the same on
    every rank."""
    intra = tuple(a for a in batch_axes if a != pod_axis)
    intra_groups = [mesh.get_group(a) for a in intra]
    pod_group = mesh.get_group(pod_axis)
    world = mesh.size()

    def step(params, batch):
        train_p = map_tree(lambda _, p: p.detach().requires_grad_(), params)
        leaves = [p for _, p in leaves_with_paths(train_p)]
        loss = loss_fn(train_p, _local_rows(batch, mesh, batch_axes))
        grads = dict(zip(range(len(leaves)),
                         torch.autograd.grad(loss, leaves)))
        synced = hierarchical_grad_sync(grads, intra_groups, pod_group,
                                         compress)
        flat = iter([synced[i] / world for i in range(len(leaves))])
        grads = map_tree(lambda _, p: next(flat), params)
        total = loss.detach().float().clone()
        for a in batch_axes:
            _all_reduce(total, dist.ReduceOp.SUM, mesh.get_group(a))
        n = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                      for a in batch_axes)
        return total / n, grads

    return step
