"""The model kernels as registered operators, ``torch.ops.repro_torch.*``.

:func:`define` registers one kernel entry point on a
``torch.library.Library``: its CUDA implementation launches the
hand-written kernel, its CPU implementation is the plain PyTorch version,
and its fake implementation (``register_fake``) gives the output shapes
and allocates the scratch the CUDA implementation allocates.  The
dispatcher routes by the inputs' device, so a CUDA tensor launches the
kernel or raises, a CPU tensor takes the plain version, and a fake
tensor (``FakeTensorMode``) takes the card's route, whatever its device,
without reaching ``ctypes``.  The op's operations go into
``torch.utils.flop_counter``'s registry, counted as ``PERF.md`` §6
counts them, so ``FlopCounterMode`` reads them too.

:data:`KERNELS` maps each op to its :class:`Kernel`: the fake
implementation and the operation and byte counts, which
``repro_torch.launch.op_analysis`` reads.  The backward stays
``_autograd``'s plain recompute: the wrappers call the op inside
``_autograd.apply``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"


class Kernel(NamedTuple):
    name: str
    fake: Callable      # the op's arguments -> fake outputs (and scratch)
    flops: Callable     # the op's arguments -> operations
    nbytes: Callable    # the op's arguments -> bytes read and written


KERNELS: Dict[object, Kernel] = {}


_LIB = None


def define(name: str, cuda: Callable, cpu: Callable, fake: Callable,
           flops: Callable, nbytes: Callable):
    """Register ``repro_torch::<name>`` with the schema of ``cuda``'s
    annotations; returns the op's default overload.  The op is defined
    on a ``torch.library.Library`` with plain kernels, not through
    ``custom_op``, whose wrapper imports ``torch._dynamo`` on the first
    call (seconds of host time inside the first prefill) and adds a
    check to every call."""
    global _LIB
    if _LIB is None:
        _LIB = torch.library.Library(NAMESPACE, "DEF")
    _LIB.define(name + torch.library.infer_schema(cuda, mutates_args=()))
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)

    @register_flop_formula(packet, get_raw=True)
    def _formula(*args, out_val=None, **kwargs):
        return flops(*args, **kwargs)

    KERNELS[packet.default] = Kernel(name, fake, flops, nbytes)
    return packet.default


def tensor_bytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
