"""Checkpoints in the JAX package's on-disk format: writer and reader.

``repro/train/checkpoint.py`` writes one directory per step,
``step_<n:08d>/`` holding ``leaves.npz`` (the leaves keyed by JAX's
tree-path strings, ``"/".join(str(p) for p in path)``) and
``meta.json``, and names the newest step in ``LATEST``, written last by
an atomic rename.  This module writes and reads that format, so each
package restores what the other saved and an evicted trainer can resume
in either one.

Keys (:func:`flatten_with_keys`) are JAX's: a ``NamedTuple`` field gives
``.name``, a dict key ``['key']`` (dicts flatten in sorted key order), a
list item ``[i]``; e.g. ``".params/['embed']"``, ``".opt/.step"``.

:class:`CheckpointManager` is the reference's: ``save`` writes into a
temporary directory and renames it into place; a re-save of an existing
step parks the old copy aside (``.step_<n>.old``) until the new one has
landed, so a crash at any point leaves a restorable copy of the step
``LATEST`` names, and a later reader heals that state; then ``LATEST``,
then keep-N garbage collection.  The writer streams one leaf at a time
from its device into the archive, so a multi-GB training state never
sits in host memory whole.  ``restore`` casts each leaf to the dtype of
the tree it restores into and puts it on that tree's device (or writes
it into that tree's tensors, ``into=True``).

:func:`latest_step` and :func:`restore` read by a nested-dict spec tree,
without a manager (the forecaster's ``load_forecaster``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import leaves_with_paths, map_tree


def tree_key(path: Tuple[str, ...]) -> str:
    """JAX's tree-path string of a nested-dict leaf."""
    return "/".join(f"[{key!r}]" for key in path)


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _walk(tree, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if _is_namedtuple(tree):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], prefix + (f"[{key!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from _walk(val, prefix + (f"[{i}]",))
    elif tree is not None:
        yield prefix, tree


def _placements_by_key(tree) -> Dict[str, Tuple]:
    """``{key: placements}`` of a tree whose leaves are tuples of DTensor
    placements, keyed as :func:`flatten_with_keys` keys a tree of the
    same structure."""
    from torch.distributed.tensor import Placement

    def walk(t, prefix):
        if isinstance(t, tuple) and t and not _is_namedtuple(t) and all(
                isinstance(p, Placement) for p in t):
            yield "/".join(prefix), t
        elif _is_namedtuple(t):
            for name in t._fields:
                yield from walk(getattr(t, name), prefix + (f".{name}",))
        elif isinstance(t, dict):
            for key in sorted(t):
                yield from walk(t[key], prefix + (f"[{key!r}]",))
        elif isinstance(t, (list, tuple)):
            for i, val in enumerate(t):
                yield from walk(val, prefix + (f"[{i}]",))
    return dict(walk(tree, ()))


def flatten_with_keys(tree) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in JAX's flattening order, keyed as JAX keys them."""
    return [("/".join(parts), leaf) for parts, leaf in _walk(tree)]


def map_with_keys(fn: Callable[[str, Any], Any], tree,
                  prefix: Tuple[str, ...] = ()):
    """``fn(key, leaf)`` on every leaf, in a tree of the same structure,
    called in :func:`flatten_with_keys`'s order."""
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_keys(fn, getattr(tree, name),
                                          prefix + (f".{name}",))
                            for name in tree._fields))
    if isinstance(tree, dict):
        return {key: map_with_keys(fn, tree[key], prefix + (f"[{key!r}]",))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_keys(fn, val, prefix + (f"[{i}]",))
                          for i, val in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _write_npz(path: str, items: List[Tuple[str, Any]]) -> None:
    """What ``np.savez(path, **dict(items))`` writes, one leaf at a time."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in items:
            arr = _host_array(leaf)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            del arr


def _aside(final: str) -> str:
    """Parking name for the old copy of a step during a re-save swap;
    dot-prefixed so no step listing counts it."""
    return os.path.join(os.path.dirname(final),
                        "." + os.path.basename(final) + ".old")


def _recover(final: str) -> None:
    """Heal a crash between the aside-rename and the swap of a re-save:
    if the step directory is gone but its parked copy survives, that copy
    is the newest valid one, so put it back."""
    aside = _aside(final)
    if os.path.isdir(aside):
        if os.path.isdir(final):
            shutil.rmtree(aside, ignore_errors=True)
        else:
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


def _step_dir(directory: str, step: Optional[int]) -> Tuple[str, int]:
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    _recover(d)
    return d, step


def restore(directory: str, specs, step: Optional[int] = None,
            dtype=np.float32) -> Tuple[Dict, int, Dict]:
    """Leaves of ``step`` (default: the latest) in the structure of the
    spec tree ``specs``, as numpy arrays cast to ``dtype`` (the reference
    casts to the spec's dtype, float32).  Returns ``(tree, step, extra)``."""
    d, step = _step_dir(directory, step)
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


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> str:
        items = flatten_with_keys(tree)
        final = os.path.join(self.directory, f"step_{step:08d}")
        _recover(final)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        aside = None
        try:
            _write_npz(os.path.join(tmp, "leaves.npz"), items)
            meta = {"step": step, "extra": extra or {}}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                # Re-save of an existing step: park the old copy instead
                # of deleting it, so a crash anywhere in the swap leaves a
                # restorable version of the step LATEST may still name.
                aside = _aside(final)
                os.rename(final, aside)
            try:
                os.rename(tmp, final)
            except BaseException:
                if aside is not None:
                    os.rename(aside, final)
                    aside = None
                raise
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        # LATEST last: readers never see a partial checkpoint.
        latest_tmp = os.path.join(self.directory, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
        os.replace(latest_tmp, os.path.join(self.directory, "LATEST"))
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- load -----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        return all_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, tree_like, step: Optional[int] = None, *,
                into: bool = False, mesh=None, placements=None
                ) -> Tuple[Any, int, Dict]:
        """Restore into the structure of ``tree_like`` (shapes must
        match): each leaf cast to the like leaf's dtype, a tensor on its
        device.  ``into`` copies into ``tree_like``'s tensors and returns
        that tree.  With ``placements`` (a tree like ``tree_like`` of
        DTensor placement tuples, ``sharding.tree_shardings``) each leaf
        is instead ``distribute_tensor``-ed onto ``mesh`` at its
        placements (``tree_like`` may then live on the meta device).
        Returns ``(tree, step, extra)``."""
        if placements is not None and (into or mesh is None):
            raise ValueError("placements= needs a mesh and no into=")
        pl_by_key = {} if placements is None else _placements_by_key(
            placements)
        d, step = _step_dir(self.directory, step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "leaves.npz"),
                     allow_pickle=False) as data:
            def load(key, like):
                arr = data[key]
                if arr.shape != tuple(like.shape):
                    raise ValueError(f"checkpoint leaf {key} has shape "
                                     f"{arr.shape}, the tree "
                                     f"{tuple(like.shape)}")
                if not isinstance(like, torch.Tensor):
                    return arr.astype(like.dtype)
                src = torch.from_numpy(arr)
                if placements is not None:
                    from torch.distributed.tensor import distribute_tensor
                    return distribute_tensor(
                        src.to(device=mesh.device_type, dtype=like.dtype),
                        mesh, pl_by_key[key])
                if into:
                    with torch.no_grad():
                        like.copy_(src)
                    return like
                return src.to(device=like.device, dtype=like.dtype)

            restored = map_with_keys(load, tree_like)
        return (tree_like if into else restored), meta["step"], \
            meta.get("extra", {})
