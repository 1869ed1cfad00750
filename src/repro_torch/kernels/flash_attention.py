"""Flash attention: online-softmax attention, causal and/or sliding
window, grouped-query.

``flash_attention`` runs the hand-written CUDA kernel
``csrc/flash_attention.cu`` on CUDA tensors and its plain PyTorch
version ``flash_attention_plain`` on CPU tensors; there is no other
switch.  Both compute what the Pallas kernel
``repro/kernels/flash_attention.py:39 _flash_kernel`` and its oracle
``repro/kernels/ref.py:13 attention_ref`` compute: q (B, Hq, T, hd)
against k, v (B, Hkv, S, hd), query head h reading kv head
``h // (Hq // Hkv)``, logits ``sm_scale * q.k`` in float32 (default
``sm_scale = hd ** -0.5``), key j visible to query i when ``j <= i``
(causal) and ``j > i - window`` (window > 0) on global indices, hidden
logits at ``NEG_INF = -2**30``, a float32 softmax and a weighted sum of
v accumulated in float32, returned in q's dtype.  Any T and S; hd <= 256
in the kernel.  Every query row must see at least one key.  The models
call it causal with ``S = T`` (every decoder's prefill and training),
and without a mask in Whisper: its encoder (``T = S = 1500``) and its
cross attention at prefill (the prompt's T against the encoder's
``S = 1500``), where every row sees every key.

With ``softcap > 0`` each logit ``y = sm_scale * q.k`` is soft-capped to
``softcap * tanh(y / softcap)``, as the model's reference ``_softcap``
does in ``_mha`` (``repro/models/layers.py:167-176``): after
``sm_scale``, before the mask, so hidden logits stay exactly
``NEG_INF`` (a capped hidden logit would be a visible ``-softcap``).
``softcap <= 0`` means no cap, and launches exactly what a call without
it launches.  The Pallas kernel has no cap: the oracle of a capped call
is the reference's ``_mha``.

The plain version keeps the softmax weights in float32, as the oracle
does, and so does the kernel on float32 inputs.  On bfloat16 inputs the
kernel runs both products on the tensor cores and rounds the weights to
bfloat16 for the weighted sum, as the model's reference ``_mha`` does;
``tests/test_torch_flash_attention.py`` emulates that arithmetic on the
CPU and holds it to the oracle at the bfloat16 tolerance.

With grad enabled and an input that requires grad, the call goes
through ``_autograd.apply``: the same forward, and a backward that
differentiates ``flash_attention_plain`` recomputed on the same device
(it holds the full (T, S) logits: a training-size backward, not a
kernel); through the cap that is ``softcap * (1 - tanh^2)``, as
``jax.grad`` gets it through ``_mha``.

The entry point is the registered op ``torch.ops.repro_torch.
flash_attention`` (``_ops.define``): the dispatcher sends CUDA tensors
to the kernel, CPU tensors to the plain version and fake tensors to
:func:`_flash_fake`; :func:`flash_flops` and :func:`flash_bytes` count
its work, the visible (query, key) pairs only (the cap adds no product
and no byte; :func:`flash_sfu_ops` counts the special-function
operations it adds).

``launches`` counts kernel launches (forward only), so a run can show
that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import _build
from repro_torch.kernels import _autograd, _ops

NEG_INF = -2.0 ** 30
MAX_HEAD_DIM = 256

launches = 0


def _mask(T: int, S: int, causal: bool, window: int, device) -> torch.Tensor:
    """(T, S) bool: key j visible to query i."""
    ti = torch.arange(T, device=device)[:, None]
    si = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (si <= ti)
    if window > 0:
        mask = mask & (si > ti - window)
    return mask


def softcap_logits(s: torch.Tensor, softcap: float) -> torch.Tensor:
    """``softcap * tanh(s / softcap)`` for ``softcap > 0``, else ``s``:
    the reference's ``_softcap``."""
    return torch.tanh(s / softcap) * softcap if softcap > 0 else s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          sm_scale: Optional[float] = None,
                          softcap: float = 0.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, as the oracle computes it:
    the full (T, S) logits per head, capped, masked, a float32 softmax
    over them."""
    B, Hq, T, hd = q.shape
    _, Hkv, S, _ = k.shape
    scale = hd ** -0.5 if sm_scale is None else sm_scale
    qg = q.float().reshape(B, Hkv, Hq // Hkv, T, hd)
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * scale
    s = softcap_logits(s, softcap)
    s = s.masked_fill(~_mask(T, S, causal, window, q.device), NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", w, v.float())
    return out.reshape(B, Hq, T, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors.  Arguments and result as :func:`flash_attention_plain`."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    args = (bool(causal), int(window), scale, float(softcap))
    if _autograd.wants_grad(q, k, v):
        return _autograd.apply(
            lambda q, k, v: (FLASH_OP(q, k, v, *args),),
            lambda q, k, v: (flash_attention_plain(
                q, k, v, causal=causal, window=window, sm_scale=scale,
                softcap=softcap),),
            (q, k, v))[0]
    return FLASH_OP(q, k, v, *args)


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, sm_scale: float,
                softcap: float = 0.0) -> torch.Tensor:
    return _flash_attention_cuda(q, k, v, causal, window, sm_scale, softcap)


def _flash_cpu(q, k, v, causal, window, sm_scale, softcap=0.0):
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 sm_scale=sm_scale, softcap=softcap)


def _flash_fake(q, k, v, causal, window, sm_scale, softcap=0.0):
    return torch.empty_like(q)


def visible_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask leaves visible in one head."""
    i = np.arange(T, dtype=np.int64)
    hi = np.minimum(i, S - 1) if causal else np.full(T, S - 1, np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(q, k, v, causal, window, sm_scale, softcap=0.0) -> int:
    """q.k and p.v over the visible pairs: 4 operations a pair and head
    dim (``PERF.md`` §6), with a cap or without."""
    B, Hq, T, hd = q.shape
    return B * Hq * visible_pairs(T, k.shape[2], causal, window) * 4 * hd


def flash_sfu_ops(B, Hq, T, S, causal, window, softcap=0.0) -> int:
    """Special-function operations over the visible pairs: the
    softmax's exponential, and with a cap its tanh (one each on the
    card's special-function unit)."""
    per_pair = 2 if softcap > 0 else 1
    return B * Hq * visible_pairs(T, S, causal, window) * per_pair


def flash_bytes(q, k, v, causal, window, sm_scale, softcap=0.0) -> int:
    """q, k, v read once and the output written once."""
    return _ops.tensor_bytes(q, k, v) + _ops.tensor_bytes(q)


FLASH_OP = _ops.define("flash_attention", _flash_cuda, _flash_cpu,
                       _flash_fake, flash_flops, flash_bytes)


@functools.cache
def _kernel():
    """The kernel's C entry point, built, loaded and typed once per
    process."""
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_float,
                                            ctypes.c_int, ctypes.c_int64,
                                            ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _flash_attention_cuda(q, k, v, causal, window, sm_scale, softcap=0.0):
    global launches
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: expects q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q must be (B,Hq,T,hd) and k, v "
                         f"(B,Hkv,S,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, T, hd = q.shape
    _, Hkv, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or Hkv < 1 or Hq % Hkv:
        raise ValueError("flash_attention: q and k, v do not agree: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM or S < 1:
        raise ValueError(f"flash_attention: head dim {hd} and key length "
                         f"{S}; the kernel takes 1 <= hd <= {MAX_HEAD_DIM} "
                         "and S >= 1")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be contiguous")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention: every tensor must lie on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = hd ** -0.5 if sm_scale is None else float(sm_scale)
    launch = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, Hq, Hkv, T, S, hd, scale, float(softcap),
                    int(bool(causal)),
                    max(int(window), 0), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"cudaError {rc}")
    launches += 1
    return out
