"""Weights drawn from the seed, on the device, in the dtype they are
served in.

The leaves of the program's parameter tree (its shapes and dtypes, from
``transformer.model_specs`` and ``serving_dtype``) are views into one
flat buffer per dtype.  A buffer is filled with standard normals by a
``torch.Generator`` on the device in pieces of ``PIECE`` values (a few
calls for billions of parameters), then each normal leaf is scaled in
place to a standard deviation of ``1 / sqrt(fan_in)``, where ``fan_in``
is the width the leaf reads (the embedding: 1).  Norm scales are ones.

Attention is then shaped as trained models have it, so that what the
KV cache holds shows in the served logits: q and k are widened by
``QK_SCALE``, so a head's logits spread with a standard deviation of
``QK_SCALE ** 2`` and a query attends to few keys; and in each key head
``KEY_OUTLIER_PAIRS`` rotary pairs of k's dimensions (``j`` and
``j + head_dim / 2``, drawn from the seed) are scaled up by
``KEY_OUTLIER_SCALE`` and q's same dimensions down by it.  Every
attention logit is unchanged by the outliers in exact arithmetic, while
k carries the outlier channels of trained keys (KVQuant,
arXiv:2401.18079; KIVI, arXiv:2402.02750).
The same seed gives the same numbers on the same device.  Both the
program and the plain reference read these tensors; neither makes its
own.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

PIECE = 1 << 30
QK_SCALE = 3 ** 0.5
KEY_OUTLIER_PAIRS = 4
KEY_OUTLIER_SCALE = 32.0


def _fan_in(name: str, shape: Tuple[int, ...], axes) -> int:
    """The width a leaf reads: its input axes (the leading ones; an
    expert axis is not one), w_o's heads and head dim."""
    if name == "embed":
        return 1
    if axes and axes[0] == "expert":
        shape = shape[1:]
    if name == "w_o":
        return math.prod(shape[:-1])
    return shape[0]


def draw(specs, dtype_of, seed: int, device) -> Dict:
    """The parameter tree of ``specs`` (a tree of ``ParamSpec``), leaf
    dtypes from ``dtype_of(path)``, drawn from ``seed`` on ``device``."""
    from repro_torch.models.params import leaves_with_paths, map_tree
    leaves = list(leaves_with_paths(specs))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat: Dict = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for path, spec in leaves:
        dt = dtype_of(path)
        if spec.init == "normal":
            by_dtype.setdefault(dt, []).append((path, spec))
        elif spec.init in ("ones", "zeros"):
            fill = torch.ones if spec.init == "ones" else torch.zeros
            flat[path] = fill(spec.shape, dtype=dt, device=device)
        else:
            raise ValueError(f"{path}: no draw for init {spec.init!r}")
    for dt, group in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        total = sum(math.prod(s.shape) for _, s in group)
        buf = torch.empty(total, dtype=dt, device=device)
        for lo in range(0, total, PIECE):
            buf[lo:lo + PIECE].normal_(generator=gen)
        at = 0
        for path, spec in group:
            n = math.prod(spec.shape)
            axes = spec.axes[1:] if spec.axes[:1] == ("layer",) else spec.axes
            shape = spec.shape[1:] if spec.axes[:1] == ("layer",) else \
                spec.shape
            leaf = buf[at:at + n].view(spec.shape)
            leaf.mul_(spec.scale / math.sqrt(_fan_in(path[-1], shape, axes)))
            flat[path] = leaf
            at += n
    _shape_attention(flat, gen, device)
    return map_tree(lambda path, _: flat[path], specs)


def _shape_attention(flat: Dict, gen: torch.Generator, device) -> None:
    """Widen q and k and give k its outlier pairs, in place (module
    docstring).  A leaf is (layer?, embed, heads, head_dim)."""
    for path in [p for p in flat if p[-1] == "w_k"]:
        wk, wq = flat[path], flat[path[:-1] + ("w_q",)]
        heads, hd = wk.shape[-2:]
        pairs = wk.shape[:-3] + (heads, hd // 2)
        pick = torch.rand(pairs, generator=gen, device=device).argsort(-1)
        up = torch.ones(pairs, device=device).scatter_(
            -1, pick[..., :KEY_OUTLIER_PAIRS], KEY_OUTLIER_SCALE)
        up = torch.cat([up, up], -1).unsqueeze(-3)     # (..., 1, heads, hd)
        wk.mul_((QK_SCALE * up).to(wk.dtype))
        down = (QK_SCALE / up).repeat_interleave(wq.shape[-2] // heads, -2)
        wq.mul_(down.to(wq.dtype))
