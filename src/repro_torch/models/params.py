"""Parameter specs and initialisation, as ``repro/models/params.py``.

A model declares a nested ``{name: ParamSpec}`` tree (dicts, and lists
for a model's segments); the port keeps its parameters as a tree of
tensors with the same keys, so a tree of the JAX package's leaves (as
numpy arrays) crosses over with :func:`params_from_numpy` and a
checkpoint's tree-path keys rebuild from the spec tree
(:mod:`repro_torch.train.checkpoint`).  A stacked segment carries a
leading layer axis on every leaf (:func:`stack_specs`), as the
reference's scanned segments do.

:func:`init_params` draws the reference's initialisers from a
``torch.Generator``; its numbers are not JAX's, since the two generators
differ for one seed.  With a CUDA generator it draws on the card, leaf by
leaf, each leaf in the dtype asked for, so a multi-GB model never passes
through host memory as float32.  A leaf of more than
:data:`_INIT_PIECE` values is drawn in pieces along its leading axis,
each cast into the preallocated leaf, so the draw's peak is the
parameters plus one float32 piece (Command-R-35B's stacked MLP leaves
are 29.5 GB in float32 each).

Both builders take ``dtype``: one ``torch.dtype`` for every leaf, or a
function of a leaf's key path that gives its dtype (the serving form,
``repro_torch.models.transformer.serving_dtype``).

:func:`numpy_params` draws the same initialisers with
``numpy.random.default_rng(seed)`` as float32 numpy arrays, which both
packages read: a fixture then carries a seed and :func:`tree_digest` in
place of the parameters themselves.  :func:`numpy_params_on` puts the
same numbers on a device, and gives their digest, without ever holding
the numpy tree whole.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | rglru_lambda
    scale: float = 1.0            # stddev multiplier for "normal"
    dtype: Optional[str] = None   # override param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")

    def stacked(self, n: int) -> "ParamSpec":
        return dataclasses.replace(self, shape=(n,) + self.shape,
                                   axes=("layer",) + self.axes)


Path = Tuple[object, ...]
DType = Union[torch.dtype, Callable[[Path], torch.dtype]]


def _fan_in(shape: Tuple[int, ...]) -> int:
    return shape[0] if len(shape) <= 1 else int(np.prod(shape[:-1]))


def leaves_with_paths(tree, path: Path = ()) -> Iterator[Tuple[Path, object]]:
    """``(keys, leaf)`` for every leaf of a tree of dicts and lists, dict
    keys sorted at each level and list items in order, which is the order
    JAX flattens such a tree in; a list item's key is its index."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], path + (key,))
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            yield from leaves_with_paths(val, path + (i,))
    else:
        yield path, tree


def map_tree(fn, tree, path: Path = ()):
    """``fn(keys, leaf)`` applied to every leaf of a tree of dicts and
    lists."""
    if isinstance(tree, dict):
        return {key: map_tree(fn, val, path + (key,))
                for key, val in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, val, path + (i,)) for i, val in enumerate(tree)]
    return fn(path, tree)


def stack_specs(specs, n: int):
    """Prepend the layer axis of a stacked segment to every spec."""
    return map_tree(lambda _, spec: spec.stacked(n), specs)


def param_shapes(specs, dtype: Optional[DType] = None) -> Dict:
    """The parameters as tensors on the meta device: shapes and dtypes,
    no storage (the torch stand-in for ``jax.ShapeDtypeStruct``)."""
    return map_tree(lambda path, spec: torch.empty(
        spec.shape, dtype=_leaf_dtype(dtype, path, spec.dtype),
        device="meta"), specs)


def param_axes(specs):
    """The tree of each leaf's logical axes (tuples of names), for
    ``repro_torch.distributed.sharding``."""
    return map_tree(lambda _, spec: spec.axes, specs)


def count_params(specs) -> int:
    return sum(math.prod(spec.shape) for _, spec in leaves_with_paths(specs))


def _leaf_dtype(dtype: Optional[DType], path: Path,
                spec_dtype: Optional[str] = None) -> torch.dtype:
    if dtype is None:
        return getattr(torch, spec_dtype or "float32")
    return dtype(path) if callable(dtype) else dtype


# Values of a leaf drawn at once by init_params (4 GB of float32): a
# larger leaf is drawn in pieces along its leading axis.
_INIT_PIECE = 1 << 30


def _draw(spec: ParamSpec, generator: torch.Generator,
          shape: Tuple[int, ...]) -> torch.Tensor:
    """``shape`` values of the leaf's initialiser in float32 on the
    generator's device (the std from the fan-in of the whole leaf)."""
    draw_on = generator.device
    if spec.init == "rglru_lambda":
        # Griffin's Lambda: a = exp(-c softplus(Lambda)) = sqrt(u), with u
        # uniform in [0.9^2, 0.999^2], so a lies in [0.9, 0.999].
        lo, hi = 0.9 ** 2, 0.999 ** 2
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=draw_on) * (hi - lo) + lo
        return torch.log(torch.expm1(-0.5 * torch.log(u) / 8.0))
    if spec.init == "normal":
        std = spec.scale / math.sqrt(max(_fan_in(spec.shape), 1))
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=draw_on).mul_(std)
    raise ValueError(f"init {spec.init!r} is not ported")


def _init_leaf(spec: ParamSpec, generator: torch.Generator, dtype,
               device) -> torch.Tensor:
    """One leaf, drawn in float32 on the generator's device, then cast to
    ``dtype`` on ``device``: whole up to :data:`_INIT_PIECE` values, else
    a run of leading rows at a time into the preallocated leaf."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if math.prod(spec.shape) <= _INIT_PIECE:
        return _draw(spec, generator, spec.shape).to(dtype=dtype,
                                                     device=device)
    lead, rest = spec.shape[0], spec.shape[1:]
    rows = max(1, _INIT_PIECE // max(math.prod(rest), 1))
    leaf = torch.empty(spec.shape, dtype=dtype, device=device)
    for lo in range(0, lead, rows):
        n = min(rows, lead - lo)
        leaf[lo:lo + n].copy_(_draw(spec, generator, (n,) + rest))
    return leaf


def init_params(specs, generator: torch.Generator, device=None,
                dtype: Optional[DType] = None) -> Dict:
    """Fresh parameters for a spec tree, drawn leaf by leaf in JAX's
    flattening order from ``generator`` on its own device (a CUDA
    generator draws on the card) and put on ``device`` (``None`` is the
    card).  ``dtype``: see the module docstring; ``None`` is each spec's
    dtype, else float32."""
    dev = resolve_device(device)
    flat = {path: _init_leaf(spec, generator,
                             _leaf_dtype(dtype, path, spec.dtype), dev)
            for path, spec in leaves_with_paths(specs)}
    return map_tree(lambda path, _: flat[path], specs)


def params_from_numpy(tree, device=None,
                      dtype: DType = torch.float32) -> Dict:
    """A tree of numpy arrays (the JAX package's parameters, or a
    checkpoint's leaves) as a tree of tensors on ``device`` (``None`` is
    the card), each leaf in ``dtype`` (one dtype, or a function of the
    leaf's key path)."""
    dev = resolve_device(device)
    return map_tree(
        lambda path, a: torch.tensor(np.asarray(a)).to(
            dtype=_leaf_dtype(dtype, path), device=dev), tree)


def _numpy_leaf(spec: ParamSpec, rng: np.random.Generator,
                out: np.ndarray) -> np.ndarray:
    """The leaf's next ``out.size`` values as float32, drawn into the
    float64 ``out`` (a whole leaf, or a piece of it: a run of one draw
    taken in pieces gives the same numbers)."""
    if spec.init == "normal":
        rng.standard_normal(out=out)
    return _scaled_leaf(spec, out)


def _scaled_leaf(spec: ParamSpec, out: np.ndarray) -> np.ndarray:
    """The float32 values of a leaf (or a piece of it) whose standard
    normals, for a normal leaf, were drawn into the float64 ``out``,
    which this scales in place."""
    if spec.init == "zeros":
        return np.zeros(out.shape, np.float32)
    if spec.init == "ones":
        return np.ones(out.shape, np.float32)
    if spec.init == "normal":
        out *= spec.scale / math.sqrt(max(_fan_in(spec.shape), 1))
        return out.astype(np.float32)
    raise ValueError(f"init {spec.init!r} has no numpy draw")


def numpy_params(specs, seed: int) -> Dict:
    """Float32 numpy parameters for a spec tree, drawn leaf by leaf in
    JAX's flattening order from ``numpy.random.default_rng(seed)``: a
    normal leaf is a standard normal times ``scale / sqrt(fan_in)``, as
    the reference's initialiser, zeros and ones as they are."""
    rng = np.random.default_rng(seed)
    flat = {path: _numpy_leaf(spec, rng, np.empty(spec.shape))
            for path, spec in leaves_with_paths(specs)}
    return map_tree(lambda path, _: flat[path], specs)


# Values drawn at a time by numpy_params_on (64 MB of float32).
_DRAW_PIECE = 1 << 24


def numpy_params_on(specs, seed: int, device=None,
                    dtype: DType = torch.float32) -> Tuple[Dict, str]:
    """(parameters, digest): the tensors of ``numpy_params(specs, seed)``
    on ``device`` (``None`` is the card), each leaf in ``dtype``, and
    their :func:`tree_digest`, drawn ``_DRAW_PIECE`` values at a time, so
    the float32 numpy tree never exists (4 GB for 10^9 parameters).

    A thread of its own draws the standard normals a piece ahead, into
    one of two buffers, while this one scales, hashes and copies the
    piece before (numpy's draw releases the GIL): the two halves take
    about as long, and overlap."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    leaves = list(leaves_with_paths(specs))
    pieces = [(spec, min(_DRAW_PIECE, n - lo)) for _, spec in leaves
              for n in (math.prod(spec.shape),)
              for lo in range(0, n, _DRAW_PIECE)]
    free, drawn = queue.Queue(), queue.Queue()
    for _ in range(2):
        free.put(np.empty(_DRAW_PIECE))
    stop = threading.Event()

    def draw():
        try:
            for spec, size in pieces:
                buf = free.get()
                if stop.is_set():
                    return
                if spec.init == "normal":
                    rng.standard_normal(out=buf[:size])
                drawn.put(buf)
        except Exception as exc:             # raised again by the caller
            drawn.put(exc)

    drawer = threading.Thread(target=draw, daemon=True)
    drawer.start()
    h = hashlib.sha256()
    flat = {}
    try:
        for path, spec in leaves:
            _digest_head(h, path, spec.shape, np.dtype(np.float32))
            leaf = torch.empty(spec.shape, dtype=_leaf_dtype(dtype, path),
                               device=dev)
            n = math.prod(spec.shape)
            for lo in range(0, n, _DRAW_PIECE):
                buf = drawn.get()
                if isinstance(buf, BaseException):
                    raise buf
                a = _scaled_leaf(spec, buf[:min(_DRAW_PIECE, n - lo)])
                free.put(buf)
                h.update(memoryview(a))
                leaf.view(-1)[lo:lo + a.size] = torch.from_numpy(a)
            flat[path] = leaf
    finally:
        stop.set()
        free.put(None)
        drawer.join()
    return map_tree(lambda path, _: flat[path], specs), h.hexdigest()


def _digest_head(h, path, shape, dtype) -> None:
    """A leaf's key path, shape and dtype into the digest ``h``, before
    its bytes."""
    h.update(f"{path}{tuple(shape)}{dtype}".encode())


def tree_digest(tree) -> str:
    """sha256 over every leaf's key path, shape, dtype and bytes, in
    JAX's flattening order (a tree of numpy arrays)."""
    h = hashlib.sha256()
    for path, leaf in leaves_with_paths(tree):
        a = np.ascontiguousarray(leaf)
        _digest_head(h, path, a.shape, a.dtype)
        h.update(a.tobytes())
    return h.hexdigest()
