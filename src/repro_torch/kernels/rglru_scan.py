"""RG-LRU diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t``.

``rglru_scan`` runs the hand-written CUDA kernels of
``csrc/rglru_scan.cu`` on CUDA tensors (a ring kernel that streams a and
b through shared memory once, or for inputs of up to 24 MB a chunked
kernel; ``takes_chunked_kernel`` picks by size) and its plain PyTorch
version ``rglru_scan_plain`` on CPU tensors; there is no other switch.
Both compute what the Pallas kernel
``repro/kernels/rglru_scan.py:35 _rglru_kernel`` and its oracle
``repro/kernels/ref.py:40 rglru_scan_ref`` compute: a walk over time
from ``h = 0`` with a float32 carry, for any ``T`` and ``R``.  The
result is written in ``out_dtype`` (default: a's dtype); the model path
passes float32 coefficients and asks for its activation dtype, the cast
its reference applies right after the scan (``models/rglru.py:93``).

With grad enabled and an input that requires grad, the call goes
through ``_autograd.apply``: the same forward, and a backward that
differentiates ``rglru_scan_plain`` recomputed on the same device.

The entry point is the registered op ``torch.ops.repro_torch.
rglru_scan`` (``_ops.define``): the dispatcher sends CUDA tensors to the
kernels, CPU tensors to the plain version and fake tensors to
:func:`_rglru_fake`; :func:`rglru_flops` and :func:`rglru_bytes` count
its work.

``launches`` counts kernel launches (forward only), and
``chunked_launches`` those of the chunked kernel, so a run can show which
kernels it went through.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.kernels import _autograd, _ops

launches = 0
chunked_launches = 0
# Inputs (a and b together) of up to this many bytes take the chunked
# kernel: its second walk then finds them in the 50 MB L2.
CHUNKED_MAX_BYTES = 24 << 20


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, the oracle's sequential
    loop.  a, b: (B, T, R) -> h (B, T, R) in ``out_dtype``."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    out = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(out_dtype or a.dtype)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The RG-LRU recurrence: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  Arguments and result as
    :func:`rglru_scan_plain`."""
    out_dtype = out_dtype or a.dtype
    if _autograd.wants_grad(a, b):
        return _autograd.apply(
            lambda a, b: (RGLRU_OP(a, b, out_dtype),),
            lambda a, b: (rglru_scan_plain(a, b, out_dtype),), (a, b))[0]
    return RGLRU_OP(a, b, out_dtype)


def _rglru_cuda(a: torch.Tensor, b: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    return _rglru_scan_cuda(a, b, out_dtype)


def _rglru_fake(a, b, out_dtype):
    return torch.empty(a.shape, dtype=out_dtype, device=a.device)


def rglru_flops(a, b, out_dtype) -> int:
    """A multiply and an add per element."""
    return 2 * a.numel()


def rglru_bytes(a, b, out_dtype) -> int:
    """a and b read once, h written once in ``out_dtype``."""
    return _ops.tensor_bytes(a, b) + a.numel() * out_dtype.itemsize


RGLRU_OP = _ops.define("rglru_scan", _rglru_cuda, rglru_scan_plain,
                       _rglru_fake, rglru_flops, rglru_bytes)


def takes_chunked_kernel(a: torch.Tensor) -> bool:
    """Whether the chunked kernel takes a call on coefficients ``a`` (b
    has a's shape and dtype); larger inputs take the ring kernel."""
    return 2 * a.numel() * a.element_size() <= CHUNKED_MAX_BYTES


@functools.cache
def _kernel(entry: str):
    """The C entry point ``entry`` of the RG-LRU library, built, loaded
    and typed once per process."""
    fn = getattr(_build.load("rglru_scan"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _rglru_scan_cuda(a, b, out_dtype, chunked: Optional[bool] = None):
    """The CUDA path; ``chunked`` None picks the kernel by size, True or
    False takes the chunked or the ring kernel (both take every size)."""
    global launches, chunked_launches
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError("rglru_scan: expects a and b both float32 or both "
                        f"bfloat16, got {a.dtype}, {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"rglru_scan: out_dtype {out_dtype} is not float32 "
                        "or bfloat16")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError("rglru_scan: a and b must be (B,T,R) of one shape, "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: tensors must be contiguous")
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError("rglru_scan: both tensors must lie on one CUDA "
                         f"device, got {a.device}, {b.device}")
    B, T, R = a.shape
    h = torch.empty((B, T, R), dtype=out_dtype, device=dev)
    if h.numel() == 0:
        return h
    if chunked is None:
        chunked = takes_chunked_kernel(a)
    launch = _kernel("rglru_chunked_launch" if chunked
                     else "rglru_scan_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, T, R,
                    _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan: kernel launch failed with "
                           f"cudaError {rc}")
    launches += 1
    chunked_launches += chunked
    return h
