"""Parameter specs and initialisation, as ``repro/models/params.py``.

A model declares a nested ``{name: ParamSpec}`` tree; the port keeps its
parameters as a nested dict of tensors with the same keys, so a tree of
the JAX package's leaves (as numpy arrays) crosses over with
:func:`params_from_numpy` and a checkpoint's tree-path keys rebuild from
the spec tree (:mod:`repro_torch.train.checkpoint`).

:func:`init_params` draws the reference's initialisers from a
``torch.Generator``; its numbers are not JAX's, since the two generators
differ for one seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0            # stddev multiplier for "normal"
    dtype: Optional[str] = None   # override param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def _fan_in(shape: Tuple[int, ...]) -> int:
    return shape[0] if len(shape) <= 1 else int(np.prod(shape[:-1]))


def leaves_with_paths(tree, path: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """``(keys, leaf)`` for every leaf of a nested dict, keys sorted at each
    level, which is the order JAX flattens a dict in."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], path + (key,))
    else:
        yield path, tree


def map_tree(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(keys, leaf)`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {key: map_tree(fn, val, path + (key,))
                for key, val in tree.items()}
    return fn(path, tree)


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device) -> torch.Tensor:
    dtype = getattr(torch, spec.dtype or "float32")
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init != "normal":
        raise ValueError(f"init {spec.init!r} is not ported")
    std = spec.scale / math.sqrt(max(_fan_in(spec.shape), 1))
    draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32)
    return (std * draw).to(dtype=dtype, device=device)


def init_params(specs, generator: torch.Generator, device=None) -> Dict:
    """Fresh parameters for a spec tree, drawn leaf by leaf in JAX's
    flattening order from ``generator`` (a CPU generator) and moved to
    ``device`` (``None`` is the card)."""
    dev = resolve_device(device)
    flat = {path: _init_leaf(spec, generator, dev)
            for path, spec in leaves_with_paths(specs)}
    return map_tree(lambda path, _: flat[path], specs)


def params_from_numpy(tree, device=None, dtype=torch.float32) -> Dict:
    """A nested dict of numpy arrays (the JAX package's parameters, or a
    checkpoint's leaves) as a nested dict of tensors on ``device``
    (``None`` is the card)."""
    dev = resolve_device(device)
    return map_tree(lambda _, a: torch.tensor(np.asarray(a), dtype=dtype,
                                              device=dev), tree)
