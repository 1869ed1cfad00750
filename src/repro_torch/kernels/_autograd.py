"""Gradients through the port's kernel wrappers.

The reference has no backward kernel (``repro/kernels`` defines no
``custom_vjp``): off the TPU its wrappers fall back to jnp oracles, which
JAX differentiates.  The port does the same thing in one place:
:func:`apply` runs a wrapper's forward (the CUDA kernel on CUDA tensors,
the plain version on CPU tensors) inside a ``torch.autograd.Function``
whose backward recomputes the plain version on the same device and
returns ``torch.autograd.grad`` of it.  A wrapper calls :func:`apply`
only when :func:`wants_grad` holds, so serving and forecasting (grad off,
or no input requiring grad) call the kernel's registered op
(``_ops.define``) directly and pay nothing.
Each backward runs inside a ``torch.profiler.record_function`` range
named ``PLAIN_BACKWARD``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

Outputs = Tuple[torch.Tensor, ...]
# The profiler range around each backward: a trace splits a training
# step's device time into this recompute and the rest by it.
PLAIN_BACKWARD = "repro_torch.plain_backward"


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd records and any given tensor requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _PlainBackward(torch.autograd.Function):
    """``forward(ctx, fn, plain, *inputs)``: ``fn(*inputs)``, a tuple of
    tensors.  ``backward``: the vector-Jacobian product of
    ``plain(*inputs)``, which returns the same tuple."""

    @staticmethod
    def forward(ctx, fn: Callable[..., Outputs],
                plain: Callable[..., Outputs], *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        with torch.profiler.record_function(PLAIN_BACKWARD):
            return _PlainBackward._backward(ctx, *grads)

    @staticmethod
    def _backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            outputs = ctx.plain(*inputs)
        pairs = [(o, g) for o, g in zip(outputs, grads)
                 if o.requires_grad and g is not None]
        wrt = [t for t, need in zip(inputs, needs) if need]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None) + tuple(next(got) if need else None
                                    for need in needs)


def apply(fn: Callable[..., Outputs], plain: Callable[..., Outputs],
          inputs: Sequence[Optional[torch.Tensor]]) -> Outputs:
    """``fn(*inputs)`` with gradients from ``plain(*inputs)``; both return
    a tuple of tensors of the same shapes and dtypes."""
    return _PlainBackward.apply(fn, plain, *inputs)
