"""Logical-axis sharding rules on DTensor, as
``repro/distributed/sharding.py``.

Parameters and activations are annotated with *logical* axis names; the
rules map each name to an ordered list of candidate mesh axes.
:meth:`ShardingCtx.resolve` picks the first candidate whose mesh size
divides the dimension and whose axes no other dimension of the same
tensor holds, else leaves the dimension unsharded, and strips trailing
unsharded entries: the reference's spec, entry for entry, as a tuple.
It reads only the mesh's axis names and sizes, so it runs on a
:class:`MeshShape` with no process group.

:meth:`ShardingCtx.placements_for` turns a spec into DTensor placements,
one per mesh dimension: a dimension resolved to ``("pod", "data")`` is
``Shard(d)`` on both of those mesh dimensions, which DTensor splits in
mesh order, the row-major order of JAX's flattened axes.

:func:`shard` is the model code's constraint: with no context it returns
its argument; under :func:`sharding_ctx` it redistributes a DTensor to
the resolved placements and refuses a plain tensor, so nothing runs
unsharded by accident.  :func:`local_call` runs a hand-written kernel on
each rank's local shard (``local_map``), the torch form of the Pallas
call inside ``shard_map``; :func:`local_offsets` gives a rank's place in
a DTensor, for writes into its own shard (the KV cache), and
:func:`argmax_last` takes a vocab-split argmax shard by shard.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Candidate mesh axes per logical axis, in preference order (the
# reference's table).  ("pod", "data") as one entry shards over the
# flattened pod x data axes.
DEFAULT_RULES: Dict[str, Tuple] = {
    # -- parameters ----------------------------------------------------------
    "vocab": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "expert": ("model",),
    "rnn": ("model",),
    "rnn_blocks": ("model",),
    "embed": (("pod", "data"), "data"),       # ZeRO-3/FSDP over DP axes
    "layer": (),                              # stack dim: never sharded
    "head_dim": (),
    "conv": (),
    # -- activations ---------------------------------------------------------
    "act_batch": (("pod", "data"), "data"),
    # sequence parallelism for the residual stream only: attention and
    # MLP internals gather the sequence and shard heads / mlp instead.
    "act_seq": ("model",),
    # query-sequence dim inside attention (context parallelism)
    "act_q_seq": (),
    "act_embed": (),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_expert": ("model",),
    "act_rnn": ("model",),
    "act_kv_seq": ("model",),                 # decode: the KV cache's seq
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or a process
    group: what :meth:`ShardingCtx.resolve` reads."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a :class:`MeshShape` or a named
    ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names,
                    (mesh.size(i) for i in range(mesh.ndim))))


def rules_for(cfg=None, rules: Optional[Dict[str, Tuple]] = None
              ) -> Dict[str, Tuple]:
    """``rules`` (default :data:`DEFAULT_RULES`) with ``cfg``'s
    ``rule_overrides`` merged over them."""
    out = dict(DEFAULT_RULES if rules is None else rules)
    if cfg is not None:
        out.update(dict(cfg.rule_overrides))
    return out


@dataclasses.dataclass
class ShardingCtx:
    mesh: object
    rules: Dict[str, Tuple]

    def __post_init__(self):
        self.sizes = mesh_sizes(self.mesh)
        self.names = tuple(self.sizes)

    def axis_size(self, entry) -> int:
        if isinstance(entry, tuple):
            return math.prod(self.sizes[a] for a in entry)
        return self.sizes[entry]

    def resolve(self, dims: Sequence[int],
                axes: Sequence[Optional[str]]) -> Spec:
        """Logical axes -> spec with the divisibility fallback."""
        if len(dims) != len(axes):
            raise ValueError(f"dims {tuple(dims)} and axes {tuple(axes)} "
                             "differ in length")
        used: set = set()
        out: List = []
        for dim, name in zip(dims, axes):
            spec = None
            for entry in self.rules.get(name, ()) if name else ():
                flat = entry if isinstance(entry, tuple) else (entry,)
                if any(a in used for a in flat):
                    continue
                if any(a not in self.sizes for a in flat):
                    continue
                if dim % self.axis_size(entry) != 0:
                    continue   # divisibility fallback
                # a one-axis tuple is that axis, as PartitionSpec has it
                spec = flat[0] if len(flat) == 1 else entry
                used.update(flat)
                break
            out.append(spec)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements_for(self, shape: Sequence[int],
                       axes: Sequence[Optional[str]]) -> Tuple:
        """DTensor placements, one per mesh dimension, for a tensor of
        ``shape`` with logical ``axes``."""
        from torch.distributed.tensor import Replicate, Shard
        placements: List = [Replicate()] * len(self.names)
        for d, entry in enumerate(self.resolve(shape, axes)):
            if entry is None:
                continue
            flat = entry if isinstance(entry, tuple) else (entry,)
            dims = [self.names.index(a) for a in flat]
            if dims != sorted(dims):
                raise ValueError(f"{entry} is not in the mesh's axis order "
                                 f"{self.names}")
            for m in dims:
                placements[m] = Shard(d)
        return tuple(placements)


_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx",
                                                      default=None)


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[Dict[str, Tuple]] = None):
    """Turn on the logical-axis constraints inside model code.  Plain
    tensors that meet DTensors inside (positions, masks, scalars) are
    treated as replicated (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    token = _CTX.set(ShardingCtx(mesh, dict(rules or DEFAULT_RULES)))
    try:
        with implicit_replication():
            yield _CTX.get()
    finally:
        _CTX.reset(token)


def current_ctx() -> Optional[ShardingCtx]:
    return _CTX.get()


def bind_ctx(fn: Callable) -> Callable:
    """``fn`` bound to the sharding context current now.  A checkpointed
    function reruns in the backward pass, which on the card runs in
    autograd's device thread: that thread does not inherit the caller's
    context variables."""
    ctx = current_ctx()
    if ctx is None:
        return fn

    def bound(*args, **kwargs):
        token = _CTX.set(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(token)
    return bound


_DTENSOR: Optional[type] = None


def is_dtensor(x) -> bool:
    global _DTENSOR
    if _DTENSOR is None:        # imported once, on the first call
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def shard(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Redistribute ``x`` to its logical axes' placements; ``x`` itself
    with no context, so model code stays mesh-agnostic."""
    ctx = current_ctx()
    if ctx is None:
        return x
    if not is_dtensor(x):
        raise TypeError(f"shard: a plain tensor of shape {tuple(x.shape)} "
                        "under a sharding context; distribute it first")
    return x.redistribute(ctx.mesh, ctx.placements_for(x.shape, axes))


def local_run(fn: Callable, args: Sequence[torch.Tensor],
              in_placements: Sequence[Sequence], out_placements):
    """``fn`` on each rank's local shards of the DTensors ``args``
    (redistributed to ``in_placements`` first); its output (a tensor,
    or a tuple with ``out_placements`` a tuple of placements) becomes
    DTensors at ``out_placements``, which may be ``Partial``.  An input
    replicated over a mesh dim along which an output is split or partial
    gets its gradient back as ``Partial`` there: each rank holds only
    its own part's contribution.  ``ctx.mesh`` is the mesh."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    outs = out_placements if isinstance(out_placements, tuple) \
        else (out_placements,)
    split = [any(not isinstance(o[i], Replicate) for o in outs)
             for i in range(len(outs[0]))]
    grads = tuple([Partial() if isinstance(p, Replicate) and split[i] else p
                   for i, p in enumerate(pl)] for pl in in_placements)
    wrapped = local_map(fn, out_placements=out_placements,
                        in_placements=tuple(list(p) for p in in_placements),
                        in_grad_placements=grads,
                        device_mesh=current_ctx().mesh,
                        redistribute_inputs=True)
    return wrapped(*(_ContiguousGrad.apply(a) if a.requires_grad else a
                     for a in args))


def local_call(fn: Callable, args: Sequence[torch.Tensor],
               in_axes: Sequence[Sequence[Optional[str]]],
               out_axes, out_shapes: Optional[Sequence] = None, **kwargs):
    """``fn(*args, **kwargs)`` on each rank's local shards when ``args``
    are DTensors (:func:`local_run` at ``in_axes``'s placements), else
    ``fn`` itself.  The output is a DTensor at ``out_axes``'s placements
    for ``args[0]``'s shape; with ``out_shapes``, ``fn`` returns a tuple
    and ``out_axes`` holds one axes tuple for each of those global
    shapes.  For a kernel independent along every sharded dimension."""
    ctx = current_ctx()
    if ctx is None or not any(is_dtensor(a) for a in args):
        return fn(*args, **kwargs)
    in_pl = [ctx.placements_for(a.shape, ax) for a, ax in zip(args, in_axes)]
    if out_shapes is None:
        out_pl = list(ctx.placements_for(args[0].shape, out_axes))
    else:
        out_pl = tuple(list(ctx.placements_for(shape, ax))
                       for shape, ax in zip(out_shapes, out_axes))
    return local_run(lambda *xs: fn(*xs, **kwargs), args, in_pl, out_pl)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: the
    gradient of a redistributed kernel input comes back from the
    collectives' backward with strided local shards, which DTensor then
    views as it would contiguous ones."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def lookup_rows(table: torch.Tensor, index: torch.Tensor,
                index_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """``table[index]``.  Under a sharding context, with DTensors, each
    rank gathers its own rows of ``index`` (at ``index_axes``) from the
    table gathered whole (:func:`local_run`): no sharding rule of the
    gather or of its scatter backward is asked for."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(table):
        return table[index]
    idx_pl = list(ctx.placements_for(index.shape, index_axes))
    whole = ctx.placements_for(table.shape, (None,) * table.dim())
    return local_run(lambda t, i: t[i], (table, index), (whole, idx_pl),
                     idx_pl)


def local_offsets(t: torch.Tensor) -> List[int]:
    """The global index of the first element of this rank's shard of the
    DTensor ``t`` along each dim: a dim split over several mesh dims is
    split in mesh order (row-major over their coordinates)."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    local = t.to_local().shape
    index = [0] * t.dim()
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard):
            index[p.dim] = index[p.dim] * mesh.size(m) + coord[m]
    return [i * n for i, n in zip(index, local)]


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(x, -1)``.  Under a sharding context, for a DTensor
    split along its last dim, each rank takes the first largest value of
    its shard and its global index (:func:`local_run`); the (value,
    index) pairs of the shards are gathered and, on each rank, the first
    largest wins, which is the first global maximum.  DTensor's own rule reads its
    shard offsets back from a tensor, which fake tensors cannot give."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(x):
        return torch.argmax(x, -1)
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    split = [isinstance(p, Shard) and p.dim == last for p in x.placements]
    if not any(split):
        return torch.argmax(x, -1)
    offset = local_offsets(x)[last]

    def local(xl):
        val, idx = torch.max(xl, -1, keepdim=True)
        return val, idx + offset

    def pick(val, idx):
        return torch.gather(idx, -1, torch.argmax(val, -1, keepdim=True))[
            ..., 0]

    pl = list(x.placements)
    val, idx = local_run(local, (x.detach(),), (pl,), (pl, pl))
    whole = [Replicate() if s else p for s, p in zip(split, pl)]
    return local_run(pick, (val, idx), (whole, whole), whole)


def splittable(y: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``y``, or, for a DTensor sharded along ``dim`` across more splits
    than ``n`` is a multiple of, ``y`` gathered along ``dim``: DTensor
    can view such a dim as (n, rest) only when each shard holds whole
    rows of n."""
    if current_ctx() is None or not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate, Shard
    dim %= y.dim()
    mesh_dims = [i for i, p in enumerate(y.placements)
                 if isinstance(p, Shard) and p.dim == dim]
    if n % math.prod(y.device_mesh.size(i) for i in mesh_dims) == 0:
        return y
    return y.redistribute(y.device_mesh, [
        Replicate() if i in mesh_dims else p
        for i, p in enumerate(y.placements)])


def unflatten_last(y: torch.Tensor, sizes: Tuple[int, int]) -> torch.Tensor:
    """``y.unflatten(-1, sizes)``, through :func:`splittable`."""
    return splittable(y, -1, sizes[0]).unflatten(-1, sizes)


def merge_dims(w: torch.Tensor, dim: int) -> torch.Tensor:
    """``w.flatten(dim, dim + 1)``; for a DTensor that requires grad, its
    gradient goes through :func:`splittable` before the view's backward
    splits it again (autograd may place it sharded across the merged
    dim at any split)."""
    n = w.shape[dim]
    out = w.flatten(dim, dim + 1)
    if current_ctx() is not None and out.requires_grad and is_dtensor(out):
        out.register_hook(bind_ctx(lambda g: splittable(g, dim, n)))
    return out


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def map_axes(fn: Callable, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree (leaves: tuples of logical
    names) and trees of the same structure (dicts, lists, NamedTuples)."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, a, *(t[k] for t in trees))
                for k, a in axes_tree.items()}
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(map_axes(fn, a, *(t[i] for t in trees))
                                 for i, a in enumerate(axes_tree)))
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, a, *(t[i] for t in trees))
                               for i, a in enumerate(axes_tree))
    raise TypeError(f"not an axes tree: {axes_tree!r}")


def tree_shardings(ctx: ShardingCtx, shapes_tree, axes_tree):
    """A tree of placement tuples mirroring ``shapes_tree`` (leaves with
    a ``.shape``: tensors, meta tensors)."""
    return map_axes(lambda a, s: ctx.placements_for(s.shape, a),
                    axes_tree, shapes_tree)


def distribute_tree(ctx: ShardingCtx, tree, axes_tree):
    """Every tensor of ``tree`` as a DTensor on ``ctx.mesh`` at its
    logical axes' placements (each rank passes the same full values)."""
    from torch.distributed.tensor import distribute_tensor
    return map_axes(
        lambda a, t: distribute_tensor(t, ctx.mesh,
                                       ctx.placements_for(t.shape, a)),
        axes_tree, tree)
