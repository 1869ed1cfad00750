"""Chunkwise-parallel stabilised mLSTM cell (xLSTM matrix memory).

``mlstm_chunkwise`` runs a hand-written CUDA kernel on CUDA tensors and
its plain PyTorch version ``mlstm_chunkwise_plain`` on CPU tensors; there
is no other switch.  Both compute ``repro/models/xlstm.py
_mlstm_chunkwise`` (the function the Pallas kernel
``repro/kernels/mlstm_chunkwise.py:31 _mlstm_kernel`` computes on a
TPU): a sequential walk over chunks of length ``L = min(chunk, T)`` that
carries the matrix memory ``C (dk, dv)``, the normaliser ``n (dk)`` and
the stabiliser ``m``, starting from ``m = -inf`` (or a given state), and
returns ``h`` in q's dtype and the final state ``(C, n, m)`` in float32
when ``return_state`` is set.

Three kernels share the CUDA path, and the wrapper picks one by shape
(:func:`pick_kernel`):

- the parallel kernel (``csrc/mlstm_parallel.cu``) takes bfloat16 calls
  with ``L = 64`` and ``dk``, ``dv`` multiples of 64 up to 384
  (xLSTM-125M's prefill): chunk-parallel on the tensor cores, a gate
  pass, a state pass over chunks and an output pass over (chunk, column
  tile); its algorithm in plain PyTorch is
  :func:`mlstm_chunkwise_parallel_plain`;
- the row kernel (``mlstm_rows`` in ``csrc/mlstm_chunkwise.cu``) takes
  the forecaster's envelope: ``L <= 32``, ``dk, dv <= 64``, with ``L``,
  ``dk`` and ``dv`` whole 16-byte rows (multiples of 4 in float32, of 8
  in bfloat16) and 16-byte-aligned inputs;
- the block kernel (``mlstm_chunkwise`` in the same source) takes
  everything else up to ``L <= 64`` and ``dk <= 384``, any ``dv``, in both
  dtypes (every float32 call outside the row kernel's envelope).

All three take a state in or not and give the final state or not.

With grad enabled and an input that requires grad, the call goes
through ``_autograd.apply``: the same forward, and a backward that
differentiates ``mlstm_chunkwise_plain`` recomputed on the same device.

The entry point is the registered op ``torch.ops.repro_torch.
mlstm_chunkwise`` (``_ops.define``): the dispatcher sends CUDA tensors
to the kernels, CPU tensors to the plain version and fake tensors to
:func:`_mlstm_fake`, which allocates the parallel kernel's scratch where
the card would; :func:`mlstm_flops` and :func:`mlstm_bytes` count its
work.

``launches`` counts CUDA calls of any of the kernels (forward only),
``row_launches`` and ``parallel_launches`` those of the row and the
parallel kernel, so a run can show which kernel it went through.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import _build
from repro_torch.kernels import _autograd, _ops

DEFAULT_CHUNK = 64
MAX_CHUNK = 64          # the kernel's limits (shared memory per block)
MAX_DK = 384
ROW_MAX_CHUNK = 32      # the row kernel's envelope (one lane per row)
ROW_MAX_D = 64
PARALLEL_CHUNK = 64     # the parallel kernel's envelope (a wgmma's rows)
PARALLEL_TILE = 64      # dk and dv in whole tiles of this width
# The float32 operands of the parallel kernel's tensor-core products:
# k_j exp(w_j - m_c), the state C_{c-1} and the intra-chunk weights P.
PARALLEL_OPERANDS = ("k", "C", "P")
STABILISER_FLOOR = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

launches = 0
row_launches = 0
parallel_launches = 0


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


def mlstm_chunkwise_parallel_plain(q, k, v, i_raw, f_raw,
                                   state: Optional[State] = None,
                                   chunk: int = DEFAULT_CHUNK,
                                   return_state: bool = True,
                                   rounding: Optional[str] = None,
                                   operands=PARALLEL_OPERANDS):
    """The parallel kernel's algorithm in plain PyTorch: the function of
    :func:`mlstm_chunkwise_plain` in three passes.  With ``b`` the
    within-chunk cumsum of ``log_sigmoid(f)``, ``g_c = b_{L-1}`` and
    ``w_{c,j} = g_c - b_j + i_j``:

    1. the stabiliser scan over chunks, ``m_c = max(g_c + m_{c-1},
       max_j w_{c,j})`` floored at -1e30, and ``a_c = exp(g_c + m_{c-1}
       - m_c)``;
    2. the state pass, ``U_c = sum_j exp(w_{c,j} - m_c) k_j v_j^T`` for
       every chunk at once, then ``C_c = a_c C_{c-1} + U_c`` (``n``
       likewise);
    3. the output pass, every chunk at once against the state
       ``(C_{c-1}, n_{c-1}, m_{c-1})`` that enters it.

    ``rounding`` rounds the three float32 operands of the kernel's
    tensor-core products, ``k_j exp(w_{c,j} - m_c)``, ``C_{c-1}`` and the
    intra-chunk weights ``P`` (not their row sums): ``"bf16x2"`` to a pair
    of bfloat16 values ``hi + lo``, as the kernel does, ``"bf16"`` to one
    bfloat16 value, None not at all; ``operands`` names which of them
    (``PARALLEL_OPERANDS``).  Only the tests, ``chip_smoke.py`` and
    ``scripts/mlstm_parallel_rounding_torch.py`` call it."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    L = _chunk_len(T, chunk)
    NC = T // L
    f32 = torch.float32

    def rounded(x, operand):
        if rounding is None or operand not in operands:
            return x
        hi = x.to(torch.bfloat16).to(f32)
        if rounding == "bf16":
            return hi
        if rounding != "bf16x2":
            raise ValueError(f"mlstm: unknown rounding {rounding!r}")
        return hi + (x - hi).to(torch.bfloat16).to(f32)

    qc = q.reshape(B, H, NC, L, dk).to(f32)
    kc = k.reshape(B, H, NC, L, dk).to(f32)
    vc = v.reshape(B, H, NC, L, dv).to(f32)
    ic = i_raw.reshape(B, H, NC, L).to(f32)
    b = torch.cumsum(F.logsigmoid(f_raw.to(f32)).reshape(B, H, NC, L), -1)
    g = b[..., -1]
    w = g[..., None] - b + ic
    if state is None:
        C = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
        n = torch.zeros((B, H, dk), dtype=f32, device=q.device)
        m = torch.full((B, H), -torch.inf, dtype=f32, device=q.device)
    else:
        C, n, m = (s.to(f32) for s in state)

    # 1. The stabiliser scan: m_prev[c] = m_{c-1}.
    w_max = w.amax(-1)
    m_prev, scale = [], []
    for c in range(NC):
        m_new = torch.maximum(g[..., c] + m, w_max[..., c]).clamp_min(
            STABILISER_FLOOR)
        m_prev.append(m)
        scale.append(torch.exp(g[..., c] + m - m_new))
        m = m_new
    m_prev = torch.stack(m_prev, 2)

    # 2. The state pass: every chunk's U_c at once (m_c is m_prev[c + 1],
    # and m after the last chunk), then the scan.
    m_c = torch.cat([m_prev[..., 1:], m[..., None]], -1)
    wk = rounded(torch.exp(w - m_c[..., None])[..., None] * kc, "k")
    U = torch.einsum("bhcjd,bhcjv->bhcdv", wk, vc)
    u = wk.sum(-2)
    C_prev, n_prev = [], []
    for c in range(NC):
        C_prev.append(C)
        n_prev.append(n)
        if c == NC - 1 and not return_state:
            break
        C = scale[c][..., None, None] * C + U[:, :, c]
        n = scale[c][..., None] * n + u[:, :, c]
    C_prev = rounded(torch.stack(C_prev, 2), "C")
    n_prev = torch.stack(n_prev, 2)

    # 3. The output pass, every chunk at once.
    above = ~torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    log_a = b + m_prev[..., None]
    D = (b[..., :, None] - b[..., None, :]
         + ic[..., None, :]).masked_fill(above, -torch.inf)
    m_i = torch.maximum(log_a, D.amax(-1)).clamp_min(STABILISER_FLOOR)
    inter_w = torch.exp(log_a - m_i)
    P = torch.exp(D - m_i[..., None]) * torch.einsum(
        "bhcid,bhcjd->bhcij", qc, kc)
    num = (inter_w[..., None] * torch.einsum("bhcid,bhcdv->bhciv", qc,
                                             C_prev)
           + torch.einsum("bhcij,bhcjv->bhciv", rounded(P, "P"), vc))
    den = inter_w * torch.einsum("bhcid,bhcd->bhci", qc, n_prev) + P.sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]
    h = h.reshape(B, H, T, dv).to(q.dtype)
    return h, ((C, n, m) if return_state else None)


def mlstm_chunkwise(q, k, v, i_raw, f_raw, state: Optional[State] = None,
                    chunk: int = DEFAULT_CHUNK, return_state: bool = True):
    """The chunkwise mLSTM cell: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors.  Arguments and results as
    :func:`mlstm_chunkwise_plain`."""
    inputs = (q, k, v, i_raw, f_raw) + tuple(state or (None,) * 3)
    if not _autograd.wants_grad(*inputs):
        return _unflatten(MLSTM_OP(*inputs, chunk, return_state))

    def plain(*inputs):
        h, s = mlstm_chunkwise_plain(*inputs[:5], state=_state(inputs),
                                     chunk=chunk, return_state=return_state)
        return (h,) + tuple(s or ())

    return _unflatten(_autograd.apply(
        lambda *x: tuple(MLSTM_OP(*x, chunk, return_state)), plain, inputs))


def _state(inputs) -> Optional[State]:
    return None if inputs[5] is None else tuple(inputs[5:])


def _unflatten(out):
    return out[0], (tuple(out[1:]) if len(out) > 1 else None)


def _mlstm_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_raw: torch.Tensor, f_raw: torch.Tensor,
                C0: Optional[torch.Tensor], n0: Optional[torch.Tensor],
                m0: Optional[torch.Tensor], chunk: int,
                return_state: bool) -> List[torch.Tensor]:
    """The op on eight tensor slots (the state slots None without a
    state) -> [h] or [h, C, n, m]."""
    inputs = (q, k, v, i_raw, f_raw, C0, n0, m0)
    h, s = _mlstm_chunkwise_cuda(*inputs[:5], _state(inputs), chunk,
                                 return_state)
    return [h, *(s or ())]


def _mlstm_cpu(q, k, v, i_raw, f_raw, C0, n0, m0, chunk, return_state):
    inputs = (q, k, v, i_raw, f_raw, C0, n0, m0)
    h, s = mlstm_chunkwise_plain(*inputs[:5], state=_state(inputs),
                                 chunk=chunk, return_state=return_state)
    return [h, *(s or ())]


def _mlstm_fake(q, k, v, i_raw, f_raw, C0, n0, m0, chunk, return_state):
    """The CUDA route's outputs, and the parallel kernel's scratch where
    its envelope takes the call (fake tensors are taken as aligned)."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    L = _chunk_len(T, chunk)
    out = [torch.empty((B, H, T, dv), dtype=q.dtype, device=q.device)]
    if return_state:
        out += _state_out(B, H, dk, dv, q.device)
    if takes_parallel_kernel(L, dk, dv, q.dtype):
        # held beside the outputs until the call returns, as on the card
        scratch = _parallel_scratch(B, H, T, L, dk, dv, q.device)
        del scratch
    return out


def _state_out(B, H, dk, dv, device) -> List[torch.Tensor]:
    f32 = torch.float32
    return [torch.empty((B, H, dk, dv), dtype=f32, device=device),
            torch.empty((B, H, dk), dtype=f32, device=device),
            torch.empty((B, H), dtype=f32, device=device)]


def _parallel_scratch(B, H, T, L, dk, dv, device) -> Tuple[torch.Tensor, ...]:
    """The parallel kernel's scratch: the states entering each chunk (C
    as bfloat16 hi and lo tiles per 64 columns, n and m in float32) and
    the gate pass's w and (g, max w)."""
    NC = T // L
    f32 = torch.float32
    return (torch.empty(B * H * NC * dv * 2 * dk, dtype=torch.bfloat16,
                        device=device),
            torch.empty(B * H * NC * dk, dtype=f32, device=device),
            torch.empty(B * H * NC, dtype=f32, device=device),
            torch.empty(B * H * (T + 2 * NC), dtype=f32, device=device))


def mlstm_flops(q, k, v, i_raw, f_raw, C0, n0, m0, chunk,
                return_state) -> int:
    """The products q.k and (S o qk).v over the pairs j <= i of each
    chunk, q.C and the C update between chunks, the first chunk's q.C
    with a state in and the last chunk's update with the state out
    (``PERF.md`` §6, ``chip_smoke._mlstm_work``)."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    L = _chunk_len(T, chunk)
    NC = T // L
    per_state = B * H * 2 * L * dk * dv
    ops = B * H * NC * 2 * (L * (L + 1) // 2) * (dk + dv)
    ops += per_state * 2 * (NC - 1)
    return ops + per_state * ((C0 is not None) + bool(return_state))


def mlstm_bytes(q, k, v, i_raw, f_raw, C0, n0, m0, chunk,
                return_state) -> int:
    """Every input read once, h and the state out written once."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    out = B * H * T * dv * q.element_size()
    if return_state:
        out += B * H * (dk * dv + dk + 1) * 4
    return _ops.tensor_bytes(q, k, v, i_raw, f_raw, C0, n0, m0) + out


MLSTM_OP = _ops.define("mlstm_chunkwise", _mlstm_cuda, _mlstm_cpu,
                       _mlstm_fake, mlstm_flops, mlstm_bytes)


@functools.cache
def _kernel(entry: str):
    """The C entry point ``entry`` of the sequential kernels' library,
    built, loaded and typed once per process."""
    fn = getattr(_build.load("mlstm_chunkwise"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int64] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _parallel_kernel():
    """``mlstm_parallel_launch``, built, loaded and typed once."""
    fn = _build.load("mlstm_parallel").mlstm_parallel_launch
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int64] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _aligned(tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def takes_row_kernel(L: int, dk: int, dv: int, dtype: torch.dtype,
                     tensors=()) -> bool:
    """Whether the row kernel takes a call of chunk length ``L``, head
    dims ``dk``, ``dv`` and input dtype ``dtype`` on ``tensors``."""
    per_row = 16 // torch.empty((), dtype=dtype).element_size()
    return (L <= ROW_MAX_CHUNK and dk <= ROW_MAX_D and dv <= ROW_MAX_D
            and L % per_row == 0 and dk % per_row == 0 and dv % per_row == 0
            and _aligned(tensors))


def takes_parallel_kernel(L: int, dk: int, dv: int, dtype: torch.dtype,
                          tensors=()) -> bool:
    """Whether the parallel kernel takes a call of chunk length ``L``,
    head dims ``dk``, ``dv`` and input dtype ``dtype`` on ``tensors`` (q,
    k, v and the state in, which it copies in 16-byte pieces): bfloat16,
    ``L = 64``, ``dk`` and ``dv`` whole 64-wide tiles up to 384,
    16-byte-aligned tensors."""
    return (dtype == torch.bfloat16 and L == PARALLEL_CHUNK
            and all(d % PARALLEL_TILE == 0 and 0 < d <= MAX_DK
                    for d in (dk, dv))
            and _aligned(tensors))


def pick_kernel(L: int, dk: int, dv: int, dtype: torch.dtype,
                inputs=(), states=()) -> str:
    """The kernel the wrapper launches for such a call on ``inputs`` (q,
    k, v and the gates) and ``states`` (the state in, if any):
    ``"parallel"``, ``"rows"`` or ``"block"``."""
    if takes_parallel_kernel(L, dk, dv, dtype,
                             tuple(inputs)[:3] + tuple(states)):
        return "parallel"
    if takes_row_kernel(L, dk, dv, dtype, inputs):
        return "rows"
    return "block"


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _mlstm_chunkwise_cuda(q, k, v, i_raw, f_raw, state, chunk,
                          return_state, kernel: Optional[str] = None):
    """The CUDA path; ``kernel`` None picks the kernel by shape
    (:func:`pick_kernel`), else names one: ``"block"`` takes every shape
    the others take, ``"rows"`` and ``"parallel"`` raise outside their
    envelopes."""
    global launches, row_launches, parallel_launches
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
    takes = {"rows": lambda *a: takes_row_kernel(*a, inputs),
             "parallel": lambda *a: takes_parallel_kernel(
                 *a, inputs[:3] + states)}
    if kernel is None:
        kernel = pick_kernel(L, dk, dv, q.dtype, inputs, states)
    elif kernel in takes:
        if not takes[kernel](L, dk, dv, q.dtype):
            name = "row" if kernel == "rows" else kernel
            raise ValueError(f"mlstm_chunkwise: the {name} kernel does not "
                             f"take L={L}, dk={dk}, dv={dv} in {q.dtype}")
    elif kernel != "block":
        raise ValueError(f"mlstm_chunkwise: no kernel named {kernel!r}")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in inputs + states):
        raise ValueError("mlstm_chunkwise: every tensor must lie on one CUDA "
                         f"device, got {[str(t.device) for t in inputs]}")
    h = torch.empty((B, H, T, dv), dtype=q.dtype, device=dev)
    out_state = tuple(_state_out(B, H, dk, dv, dev)) if return_state \
        else None
    if B * H == 0:
        return h, out_state
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    s_in = states or (None, None, None)
    s_out = out_state or (None, None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "parallel":
            scratch = _parallel_scratch(B, H, T, L, dk, dv, dev)
            rc = _parallel_kernel()(
                *(ptr(t) for t in inputs), *(ptr(t) for t in s_in), ptr(h),
                *(ptr(t) for t in s_out), *(ptr(t) for t in scratch),
                B * H, T, dk, dv, stream)
        else:
            rc = _kernel("mlstm_rows_launch" if kernel == "rows"
                         else "mlstm_chunkwise_launch")(
                *(ptr(t) for t in inputs), *(ptr(t) for t in s_in), ptr(h),
                *(ptr(t) for t in s_out), B * H, T, L, dk, dv,
                _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_chunkwise: kernel launch failed with "
                           f"cudaError {rc}")
    launches += 1
    row_launches += kernel == "rows"
    parallel_launches += kernel == "parallel"
    return h, out_state
