"""Checkpoint reader over the JAX package's on-disk format.

``repro/train/checkpoint.py`` writes one directory per step,
``step_<n:08d>/`` holding ``leaves.npz`` (the leaves keyed by JAX's
tree-path strings, ``"/".join(str(p) for p in path)``, e.g.
``"['block']/['conv']/['w']"``) and ``meta.json``, and names the newest
step in ``LATEST``.  This module reads that format: :func:`latest_step`
and :func:`restore` rebuild the keys from a nested-dict spec tree, so a
checkpoint saved by the JAX package loads unchanged.  A re-save that
crashed between parking the old copy (``.step_<n>.old``) and the swap is
healed on read, as the reference does.  Writing comes with training.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.params import leaves_with_paths, map_tree


def tree_key(path: Tuple[str, ...]) -> str:
    """JAX's tree-path string of a nested-dict leaf."""
    return "/".join(f"[{key!r}]" for key in path)


def _recover(final: str) -> None:
    """Put back a step's parked copy if a crashed re-save left only it."""
    aside = os.path.join(os.path.dirname(final),
                         "." + os.path.basename(final) + ".old")
    if os.path.isdir(aside) and not os.path.isdir(final):
        os.rename(aside, final)


def all_steps(directory: str) -> List[int]:
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    """The step ``LATEST`` names, else the highest step directory, else
    ``None``."""
    path = os.path.join(directory, "LATEST")
    if os.path.exists(path):
        with open(path) as f:
            name = f.read().strip()
        _recover(os.path.join(directory, name))
        if os.path.isdir(os.path.join(directory, name)):
            return int(name[5:])
    if not os.path.isdir(directory):
        return None
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, specs, step: Optional[int] = None,
            dtype=np.float32) -> Tuple[Dict, int, Dict]:
    """Leaves of ``step`` (default: the latest) in the structure of the
    spec tree ``specs``, as numpy arrays cast to ``dtype`` (the reference
    casts to the spec's dtype, float32).  Returns ``(tree, step, extra)``."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    _recover(d)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    leaves = {}
    with np.load(os.path.join(d, "leaves.npz"), allow_pickle=False) as data:
        for path, spec in leaves_with_paths(specs):
            arr = data[tree_key(path)]
            if arr.shape != tuple(spec.shape):
                raise ValueError(f"checkpoint leaf {tree_key(path)} has shape "
                                 f"{arr.shape}, the spec {spec.shape}")
            leaves[path] = arr.astype(dtype)
    tree = map_tree(lambda path, _: leaves[path], specs)
    return tree, meta["step"], meta.get("extra", {})
