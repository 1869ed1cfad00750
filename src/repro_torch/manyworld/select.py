"""Masked-argmin placement select for the lane engine.

Every wave placement ends in *select the first extremum of a masked score
buffer*: per lane, the first index of the minimum of
``where(mask, scores, +inf)`` over ``(L, N)`` scores (max-mode schedulers
negate their scores first).  ``masked_argmin`` runs the hand-written CUDA
kernel ``csrc/masked_argmin.cu`` on CUDA tensors and its plain PyTorch
version ``masked_argmin_plain`` on CPU tensors; there is no other switch.
Rows whose minimum is +inf (nothing feasible) give 0: callers gate on
``mask.any(1)``.

``launches`` counts kernel launches, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build

launches = 0


def masked_argmin_plain(scores: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``torch.argmin`` returns the
    first minimum, as NumPy and the reference do."""
    buf = torch.where(mask, scores, torch.inf)
    return torch.argmin(buf, dim=1).to(torch.int32)


def masked_argmin(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First index of the masked minimum per lane: ``scores`` ``(L, N)``
    float64, ``mask`` ``(L, N)`` bool -> ``(L,)`` int32."""
    if scores.device.type == "cpu" and mask.device.type == "cpu":
        return masked_argmin_plain(scores, mask)
    return _masked_argmin_cuda(scores, mask)


def _kernel():
    fn = _build.load("masked_argmin").masked_argmin_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _masked_argmin_cuda(scores: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    global launches
    if scores.device.type != "cuda" or mask.device != scores.device:
        raise ValueError("masked_argmin: scores and mask must lie on one "
                         f"device, got {scores.device} and {mask.device}")
    if scores.dtype != torch.float64 or mask.dtype != torch.bool:
        raise TypeError("masked_argmin: expects float64 scores and a bool "
                        f"mask, got {scores.dtype} and {mask.dtype}")
    if scores.dim() != 2 or mask.shape != scores.shape:
        raise ValueError("masked_argmin: expects (L, N) scores and mask of "
                         f"one shape, got {tuple(scores.shape)} and "
                         f"{tuple(mask.shape)}")
    if not (scores.is_contiguous() and mask.is_contiguous()):
        raise ValueError("masked_argmin: scores and mask must be contiguous")
    n_lanes, n = scores.shape
    if n < 1:
        raise ValueError("masked_argmin: a row needs at least one entry")
    launch = _kernel()
    out = torch.empty(n_lanes, dtype=torch.int32, device=scores.device)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(scores.data_ptr(), mask.data_ptr(), out.data_ptr(),
                    n_lanes, n, stream)
    if rc != 0:
        raise RuntimeError(f"masked_argmin: kernel launch failed with "
                           f"cudaError {rc}")
    launches += 1
    return out
