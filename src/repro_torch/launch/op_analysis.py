"""Per-card operation counts of eager PyTorch code, the counterpart of
``repro/launch/hlo_analysis.py`` (which parses XLA's compiled HLO).

:class:`OpCounter` is a ``TorchDispatchMode``.  It steps aside for
DTensor (returns ``NotImplemented``), so it sees what one rank runs:
the ops on its local shards and the ``_c10d_functional`` collectives
with their local shapes.  It works the same on real tensors (a gloo
world) and on fake ones (``FakeTensorMode`` on a fake process group,
where nothing is allocated).  It counts

* ``collectives``: by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``) and
  ``total``, the bytes of each collective's result on this rank, the
  unit of ``hlo_analysis.collective_bytes``;
* ``flops``: at 2 per multiply-accumulate, from
  ``torch.utils.flop_counter``'s formulas, which hold the model
  kernels' own (``repro_torch.kernels._ops``); ``flops_by_op`` splits
  them by op;
* ``bytes``: bytes read and written by every op that is not a view or
  an allocation (each tensor input read once, each output written
  once); a kernel op counts its own formula's;
* ``live`` and ``peak``: the bytes of the storages alive, counted when an
  op first returns one and dropped when Python frees it, and their
  largest value; :meth:`track` adds storages made before the mode (the
  arguments), and ``args_read`` sums those an op other than a view
  reads (jit prunes the arguments a step never reads from its
  executable);  A kernel op on fake inputs runs its fake implementation
  under the mode, so the scratch the card's route allocates counts
  toward the peak;
* ``kernel_calls``: calls of each model kernel op.

What DTensor runs for itself is not counted.  Its sharding propagation
runs each op once on global-shape fake tensors, the first time it meets
the op's signature: the mode skips whatever runs inside it, and on real
tensors (``fake=False``) every op on a fake tensor.  Its bookkeeping
(shard sizes and offsets, redistribution costs) runs on small tensors
made from Python values: with ``fake=True`` the mode counts only ops
that take or give a fake tensor that is not such a constant.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels._ops import KERNELS

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided",
                         "new_empty", "new_empty_strided"})


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _data(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor of the traced program's data: not
    a constant that fake mode made from Python values (DTensor's
    bookkeeping)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor) and t.constant is None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    def __init__(self, fake: bool = True):
        super().__init__()
        self.fake = fake
        self.collectives: Dict[str, float] = dict.fromkeys(COLLECTIVES, 0.0)
        self.flops_by_op: Counter = Counter()
        self.kernel_calls: Counter = Counter()
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._args: Dict[int, int] = {}
        self._read: set = set()
        self._propagating = 0
        self._depth = 0

    @property
    def flops(self) -> int:
        return sum(self.flops_by_op.values())

    def summary(self) -> Dict:
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives.values())
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": coll, "peak": self.peak, "ops": self.ops,
                "flops_by_op": dict(self.flops_by_op),
                "kernel_calls": dict(self.kernel_calls)}

    # -- storages -------------------------------------------------------------

    def track(self, tensors: Iterable[torch.Tensor]) -> int:
        """Count the storages of ``tensors`` as live arguments; returns
        the bytes newly counted."""
        before = self.live
        for t in tensors:
            key = self._add(t)
            self._args[key] = self._storages[key]
        return self.live - before

    @property
    def args_read(self) -> int:
        return sum(n for k, n in self._args.items() if k in self._read)

    def _add(self, t: torch.Tensor) -> int:
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return key
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._drop, key)
        return key

    def _drop(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- dispatch ---------------------------------------------------------------

    def __enter__(self):
        # The kernel ops re-enter the mode to run their fake
        # implementations: the propagator is wrapped once, outermost.
        if self._depth == 0:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
            self._prop = inner = \
                ShardingPropagator._propagate_tensor_meta_non_cached

            def propagate(prop, op_schema):
                self._propagating += 1
                try:
                    return inner(prop, op_schema)
                finally:
                    self._propagating -= 1
            ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
            ShardingPropagator._propagate_tensor_meta_non_cached = self._prop
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._propagating or func.namespace == "prim":
            return func(*args, **kwargs)
        packet = func.overloadpacket
        inputs = _tensors((args, kwargs))
        fake_in = any(isinstance(t, FakeTensor) for t in inputs)
        if fake_in != self.fake and (inputs or not self.fake):
            return func(*args, **kwargs)
        kernel = KERNELS.get(func)
        if kernel is not None and fake_in:
            with self:
                out = kernel.fake(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        outputs = _tensors(out)
        if self.fake and not any(_data(t) for t in inputs + outputs):
            return out
        self.ops += 1
        if not func.is_view:
            self._read.update(id(t.untyped_storage()) for t in inputs)
        for t in outputs:
            self._add(t)
        name = func._opname
        if func.namespace == "_c10d_functional":
            if name not in ("wait_tensor", "_wrap_tensor_autograd"):
                self.collectives[_COLLECTIVE_KIND[name]] += sum(
                    _nbytes(t) for t in outputs)
            return out
        if packet in flop_registry:
            self.flops_by_op[str(packet)] += int(flop_registry[packet](
                *args, **kwargs, out_val=out))
        if kernel is not None:
            self.kernel_calls[kernel.name] += 1
            self.bytes += kernel.nbytes(*args, **kwargs)
        elif not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in inputs + outputs)
        return out
