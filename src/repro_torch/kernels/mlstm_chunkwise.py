"""Chunkwise-parallel stabilised mLSTM cell (xLSTM matrix memory).

``mlstm_chunkwise`` runs the hand-written CUDA kernel
``csrc/mlstm_chunkwise.cu`` on CUDA tensors and its plain PyTorch version
``mlstm_chunkwise_plain`` on CPU tensors; there is no other switch.  Both
compute ``repro/models/xlstm.py _mlstm_chunkwise`` (the function the
Pallas kernel ``repro/kernels/mlstm_chunkwise.py:31 _mlstm_kernel``
computes on a TPU): a sequential walk over chunks of length
``L = min(chunk, T)`` that carries the matrix memory ``C (dk, dv)``, the
normaliser ``n (dk)`` and the stabiliser ``m``, starting from
``m = -inf`` (or a given state), and returns ``h`` in q's dtype and the
final state ``(C, n, m)`` in float32 when ``return_state`` is set.

Two kernels in ``csrc/mlstm_chunkwise.cu`` share the CUDA path, and
the wrapper picks one by shape.  The row kernel (``mlstm_rows``) takes
the forecaster's envelope: chunk length ``L <= 32``, ``dk, dv <= 64``,
with ``L``, ``dk`` and ``dv`` whole 16-byte rows (multiples of 4 in
float32, of 8 in bfloat16) and 16-byte-aligned inputs.  The block
kernel (``mlstm_chunkwise``) takes everything else up to ``L <= 64`` and
``dk <= 384`` (xLSTM-125M's mLSTM heads are 384 wide), any ``dv``, in
both dtypes, with or without a state in and out.

With grad enabled and an input that requires grad, the call goes
through ``_autograd.apply``: the same forward, and a backward that
differentiates ``mlstm_chunkwise_plain`` recomputed on the same device.

``launches`` counts kernel launches of either kernel (forward only),
``row_launches`` those of the row kernel, so a run can show which
kernel it went through.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import _build
from repro_torch.kernels import _autograd

DEFAULT_CHUNK = 64
MAX_CHUNK = 64          # the kernel's limits (shared memory per block)
MAX_DK = 384
ROW_MAX_CHUNK = 32      # the row kernel's envelope (one lane per row)
ROW_MAX_D = 64
STABILISER_FLOOR = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

launches = 0
row_launches = 0


def _chunk_len(T: int, chunk: int) -> int:
    L = min(chunk, T)
    if L < 1 or T % L:
        raise ValueError(f"mlstm_chunkwise: sequence length {T} is not a "
                         f"positive multiple of the chunk length {L}")
    return L


def mlstm_chunkwise_plain(q, k, v, i_raw, f_raw,
                          state: Optional[State] = None,
                          chunk: int = DEFAULT_CHUNK,
                          return_state: bool = True):
    """The kernel's function in plain PyTorch, a loop over chunks written
    as the jnp oracle is.  q,k: (B,H,T,dk); v: (B,H,T,dv); i_raw, f_raw:
    (B,H,T) -> (h (B,H,T,dv) in q.dtype, (C, n, m) or None)."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    L = _chunk_len(T, chunk)
    NC = T // L
    f32 = torch.float32
    qc = q.reshape(B, H, NC, L, dk).to(f32)
    kc = k.reshape(B, H, NC, L, dk).to(f32)
    vc = v.reshape(B, H, NC, L, dv).to(f32)
    ic = i_raw.reshape(B, H, NC, L).to(f32)
    b = torch.cumsum(F.logsigmoid(f_raw.to(f32)).reshape(B, H, NC, L), -1)
    g = b[..., -1]
    if state is None:
        C = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
        n = torch.zeros((B, H, dk), dtype=f32, device=q.device)
        m = torch.full((B, H), -torch.inf, dtype=f32, device=q.device)
    else:
        C, n, m = (s.to(f32) for s in state)
    above = ~torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c in range(NC):
        qi, ki, vi, ii = qc[:, :, c], kc[:, :, c], vc[:, :, c], ic[:, :, c]
        bi, gi = b[:, :, c], g[:, :, c]
        log_a = bi + m[..., None]
        D = (bi[..., :, None] - bi[..., None, :]
             + ii[..., None, :]).masked_fill(above, -torch.inf)
        m_i = torch.maximum(log_a, D.amax(-1)).clamp_min(STABILISER_FLOOR)
        inter_w = torch.exp(log_a - m_i)
        P = torch.exp(D - m_i[..., None]) * torch.einsum(
            "bhid,bhjd->bhij", qi, ki)
        num = (inter_w[..., None] * torch.einsum("bhid,bhdv->bhiv", qi, C)
               + torch.einsum("bhij,bhjv->bhiv", P, vi))
        den = inter_w * torch.einsum("bhid,bhd->bhi", qi, n) + P.sum(-1)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
        if c == NC - 1 and not return_state:
            break
        w_j = gi[..., None] - bi + ii
        m_new = torch.maximum(gi + m, w_j.amax(-1)).clamp_min(
            STABILISER_FLOOR)
        scale_old = torch.exp(gi + m - m_new)
        wk = torch.exp(w_j - m_new[..., None])[..., None] * ki
        C = (scale_old[..., None, None] * C
             + torch.einsum("bhjd,bhjv->bhdv", wk, vi))
        n = scale_old[..., None] * n + wk.sum(-2)
        m = m_new
    h = torch.stack(hs, 2).reshape(B, H, T, dv).to(q.dtype)
    return h, ((C, n, m) if return_state else None)


def mlstm_chunkwise(q, k, v, i_raw, f_raw, state: Optional[State] = None,
                    chunk: int = DEFAULT_CHUNK, return_state: bool = True):
    """The chunkwise mLSTM cell: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors.  Arguments and results as
    :func:`mlstm_chunkwise_plain`."""
    inputs = (q, k, v, i_raw, f_raw) + tuple(state or (None,) * 3)
    if not _autograd.wants_grad(*inputs):
        return _unflatten(_flat(*inputs, chunk=chunk,
                                return_state=return_state))

    def plain(*inputs):
        h, s = mlstm_chunkwise_plain(*inputs[:5], state=_state(inputs),
                                     chunk=chunk, return_state=return_state)
        return (h,) + tuple(s or ())

    return _unflatten(_autograd.apply(
        lambda *x: _flat(*x, chunk=chunk, return_state=return_state),
        plain, inputs))


def _state(inputs) -> Optional[State]:
    return None if inputs[5] is None else tuple(inputs[5:])


def _flat(*inputs, chunk, return_state):
    """The forward on eight tensor slots (q, k, v, i, f, C0, n0, m0; the
    state slots None without a state) -> (h,) or (h, C, n, m)."""
    state = _state(inputs)
    if all(t.device.type == "cpu" for t in inputs if t is not None):
        h, s = mlstm_chunkwise_plain(*inputs[:5], state=state, chunk=chunk,
                                     return_state=return_state)
    else:
        h, s = _mlstm_chunkwise_cuda(*inputs[:5], state, chunk, return_state)
    return (h,) + tuple(s or ())


def _unflatten(out):
    return out[0], (tuple(out[1:]) if len(out) > 1 else None)


@functools.cache
def _kernel(entry: str):
    """The C entry point ``entry`` of the mLSTM library, built, loaded and
    typed once per process."""
    fn = getattr(_build.load("mlstm_chunkwise"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int64] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def takes_row_kernel(L: int, dk: int, dv: int, dtype: torch.dtype,
                     tensors=()) -> bool:
    """Whether the row kernel takes a call of chunk length ``L``, head
    dims ``dk``, ``dv`` and input dtype ``dtype`` on ``tensors``."""
    per_row = 16 // torch.empty((), dtype=dtype).element_size()
    return (L <= ROW_MAX_CHUNK and dk <= ROW_MAX_D and dv <= ROW_MAX_D
            and L % per_row == 0 and dk % per_row == 0 and dv % per_row == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _mlstm_chunkwise_cuda(q, k, v, i_raw, f_raw, state, chunk,
                          return_state, rows: Optional[bool] = None):
    """The CUDA path; ``rows`` None picks the kernel by shape, False takes
    the block kernel (which takes every shape the row kernel takes)."""
    global launches, row_launches
    inputs = (q, k, v, i_raw, f_raw)
    states = tuple(state or ())
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in inputs):
        raise TypeError("mlstm_chunkwise: expects q, k, v, i_raw, f_raw all "
                        "float32 or all bfloat16, got "
                        f"{[t.dtype for t in inputs]}")
    if q.dim() != 4:
        raise ValueError(f"mlstm_chunkwise: q must be (B,H,T,dk), got "
                         f"{tuple(q.shape)}")
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    if (k.shape != q.shape or v.shape != (B, H, T, dv)
            or i_raw.shape != (B, H, T) or f_raw.shape != (B, H, T)):
        raise ValueError("mlstm_chunkwise: shapes do not agree: "
                         f"{[tuple(t.shape) for t in inputs]}")
    if state is not None:
        if len(states) != 3 or [tuple(s.shape) for s in states] != [
                (B, H, dk, dv), (B, H, dk), (B, H)]:
            raise ValueError("mlstm_chunkwise: state must be C (B,H,dk,dv), "
                             "n (B,H,dk), m (B,H)")
        if any(s.dtype != torch.float32 for s in states):
            raise TypeError("mlstm_chunkwise: the state must be float32")
    if not all(t.is_contiguous() for t in inputs + states):
        raise ValueError("mlstm_chunkwise: tensors must be contiguous")
    L = _chunk_len(T, chunk)
    if L > MAX_CHUNK:
        raise ValueError(f"mlstm_chunkwise: chunk length {L} exceeds the "
                         f"kernel's limit of {MAX_CHUNK}")
    if not 1 <= dk <= MAX_DK or dv < 1:
        raise ValueError(f"mlstm_chunkwise: head dims dk={dk}, dv={dv}; the "
                         f"kernel takes 1 <= dk <= {MAX_DK} and dv >= 1")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in inputs + states):
        raise ValueError("mlstm_chunkwise: every tensor must lie on one CUDA "
                         f"device, got {[str(t.device) for t in inputs]}")
    h = torch.empty((B, H, T, dv), dtype=q.dtype, device=dev)
    out_state = None
    if return_state:
        out_state = (torch.empty((B, H, dk, dv), dtype=torch.float32,
                                 device=dev),
                     torch.empty((B, H, dk), dtype=torch.float32, device=dev),
                     torch.empty((B, H), dtype=torch.float32, device=dev))
    if B * H == 0:
        return h, out_state
    if rows is None:
        rows = takes_row_kernel(L, dk, dv, q.dtype, inputs)
    elif rows and not takes_row_kernel(L, dk, dv, q.dtype, inputs):
        raise ValueError("mlstm_chunkwise: the row kernel does not take "
                         f"L={L}, dk={dk}, dv={dv} in {q.dtype}")
    launch = _kernel("mlstm_rows_launch" if rows
                     else "mlstm_chunkwise_launch")
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    s_in = states or (None, None, None)
    s_out = out_state or (None, None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(*(ptr(t) for t in inputs), *(ptr(t) for t in s_in),
                    ptr(h), *(ptr(t) for t in s_out),
                    B * H, T, L, dk, dv, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_chunkwise: kernel launch failed with "
                           f"cudaError {rc}")
    launches += 1
    row_launches += rows
    return h, out_state
