"""xLSTM blocks (Beck et al., 2024), as ``repro/models/xlstm.py``:
mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar memory,
sequential).

mLSTM block: x → up-projection (×proj_factor) with a SiLU gate branch; a
causal conv1d feeds q/k; the chunkwise cell; RMS norm, gating and
down-projection.  The cell, ``_mlstm_chunkwise``, is
:func:`repro_torch.kernels.mlstm_chunkwise.mlstm_chunkwise`: the CUDA
kernel on CUDA tensors, its plain version on CPU tensors.  The
projections around the cell are ``torch.einsum`` (the reference computes
them outside any kernel too).  Decode is the one-step recurrence in
plain PyTorch, as the reference's, with a float32 state (C, n, m, conv).

sLSTM block: per-channel scalar memories with block-diagonal recurrent
weights (one block per head).  The recurrence is on h_{t-1}, so it has
no parallel form and no Pallas kernel: the port walks time in a Python
loop, as the reference's ``lax.scan``, with ``x @ w_x`` for all T
hoisted out of the loop (it does not read h) and the gates summed in the
reference's order ``gx + gh + bias``.  ``slstm_prefill`` returns the
output and the final state ``(c, n, m, h)`` from one walk (the reference
walks twice, to the same values).  Under grad the walk keeps the
reference's memory plan: ``torch.utils.checkpoint`` over
``SLSTM_TIME_CHUNK``-step chunks (the whole T as one chunk when T is not
a multiple of it), the state carried from chunk to chunk, so the
backward holds one chunk's steps at a time.  The cell is one autograd
node (:class:`_SLSTMCellStep`) everywhere it runs: the walk, prefill and
decode.

Dtypes follow the reference: weights are read as ``astype(x.dtype)``
except the RMS norm's scale (float32), and where the float32 decode
state meets a bfloat16 activation the product takes the wider dtype, as
JAX promotes (the weight rounded to bfloat16 first, then widened).
Under a sharding context the reference's ``shard(...)`` constraints pin
the DTensors, the mLSTM kernel runs on each rank's local batch rows and
heads, and the sLSTM's time loop on each rank's batch rows.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import bind_ctx, local_call, shard
from repro_torch.kernels.mlstm_chunkwise import mlstm_chunkwise
from repro_torch.models.conv import (causal_conv1d, causal_conv1d_step,
                                     conv_decode_init, conv_specs)
from repro_torch.models.params import ParamSpec

MLSTM_CHUNK = 64


def _dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    d_up = int(cfg.d_model * cfg.proj_factor)
    heads = cfg.num_heads
    dh = d_up // heads
    return d_up, heads, dh


def mlstm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_up, H, dh = _dims(cfg)
    return {
        "w_up": ParamSpec((d, d_up), ("embed", "rnn")),
        "w_gate": ParamSpec((d, d_up), ("embed", "rnn")),
        "conv": conv_specs(d_up, cfg.conv_width, "rnn"),
        "w_q": ParamSpec((d_up, H, dh), ("rnn", "heads", None)),
        "w_k": ParamSpec((d_up, H, dh), ("rnn", "heads", None)),
        "w_v": ParamSpec((d_up, H, dh), ("rnn", "heads", None)),
        "w_i": ParamSpec((d_up, H), ("rnn", "heads"), scale=0.1),
        "w_f": ParamSpec((d_up, H), ("rnn", "heads"), scale=0.1),
        "b_i": ParamSpec((H,), (None,), init="zeros"),
        # forget-gate bias init positive => long memory at init
        "b_f": ParamSpec((H,), (None,), init="ones", scale=3.0),
        "out_norm": {"scale": ParamSpec((d_up,), (None,), init="ones")},
        "w_down": ParamSpec((d_up, d), ("rnn", "embed")),
    }


def _mlstm_chunkwise(q, k, v, i_raw, f_raw, state=None, chunk=MLSTM_CHUNK,
                     return_state: bool = True):
    """q,k,v: (B,H,T,dh); i_raw,f_raw: (B,H,T).  Returns (h, state) with
    state = (C: (B,H,dk,dv), n: (B,H,dk), m: (B,H)) in float32, or
    ``None`` when ``return_state`` is off."""
    def cell(q, k, v, i_raw, f_raw):
        q, k, v, i_raw, f_raw = (t.contiguous()
                                 for t in (q, k, v, i_raw, f_raw))
        h, st = mlstm_chunkwise(q, k, v, i_raw, f_raw, state=state,
                                chunk=chunk, return_state=return_state)
        return (h,) + tuple(st) if return_state else h

    heads = ("act_batch", "act_heads", None, None)
    args = (q, k, v, i_raw, f_raw)
    in_axes = (heads,) * 3 + (heads[:3],) * 2
    if not return_state:
        return local_call(cell, args, in_axes, heads), None
    B, H, _, dk = q.shape
    shapes = (v.shape, (B, H, dk, v.shape[-1]), (B, H, dk), (B, H))
    h, C, n, m = local_call(cell, args, in_axes,
                            (heads, heads, heads[:3], heads[:2]),
                            out_shapes=shapes)
    return h, (C, n, m)


def _read(w: torch.Tensor, dt: torch.dtype, like: torch.Tensor):
    """A weight as the reference reads it in a product with ``like``:
    cast to the activation dtype ``dt``, then widened to ``like``'s dtype
    (float32 where the decode state made ``like`` float32), as JAX
    promotes a bfloat16 operand against a float32 one."""
    return w.to(dt).to(like.dtype)


def _mlstm_qkv(p, x: torch.Tensor, cfg: ArchConfig, conv_state=None):
    """Shared pre-cell computation.  Returns (q, k, v, i, f, gate, up,
    new_conv_state); ``new_conv_state`` is None without a ``conv_state``
    (a whole sequence).  With a float32 conv state and a bfloat16 x the
    conv output is float32, and so are q, k and the gates."""
    dt = x.dtype
    _, _, dh = _dims(cfg)
    up = shard(torch.einsum("btd,du->btu", x, p["w_up"].to(dt)),
               ("act_batch", None, "act_rnn"))
    gate = F.silu(torch.einsum("btd,du->btu", x, p["w_gate"].to(dt)))
    if conv_state is None:
        c, new_conv_state = causal_conv1d(p["conv"], up), None
    else:
        c, new_conv_state = causal_conv1d_step(p["conv"], up, conv_state)
    c = F.silu(c)
    q = torch.einsum("btu,uhk->bhtk", c, _read(p["w_q"], dt, c))
    k = torch.einsum("btu,uhk->bhtk", c, _read(p["w_k"], dt, c)) \
        * (dh ** -0.5)
    v = torch.einsum("btu,uhk->bhtk", up, p["w_v"].to(dt))
    i_raw = (torch.einsum("btu,uh->bht", c, _read(p["w_i"], dt, c))
             + p["b_i"].to(dt)[None, :, None])
    f_raw = (torch.einsum("btu,uh->bht", c, _read(p["w_f"], dt, c))
             + 3.0 * p["b_f"].to(dt)[None, :, None])
    return q, k, v, i_raw, f_raw, gate, up, new_conv_state


def _mlstm_out(p, h, gate, cfg: ArchConfig, dtype):
    """Head-merge + RMS norm over the up dim + gating + down-projection."""
    B, H, T, dh = h.shape
    hm = h.transpose(1, 2).reshape(B, T, H * dh)
    ms = hm.square().mean(-1, keepdim=True)
    hm = hm * torch.rsqrt(ms + 1e-6) * p["out_norm"]["scale"].float()
    hm = hm.to(dtype) * gate
    return shard(torch.einsum("btu,ud->btd", hm, p["w_down"].to(dtype)),
                 ("act_batch", "act_seq", "act_embed"))


def apply_mlstm(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    q, k, v, i_raw, f_raw, gate, _, _ = _mlstm_qkv(p, x, cfg)
    h, _ = _mlstm_chunkwise(q, k, v, i_raw, f_raw, return_state=False)
    return _mlstm_out(p, h.to(x.dtype), gate, cfg, x.dtype)


def mlstm_prefill(p, x: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Dict]:
    """The block over a whole prompt, and its decode state: the cell's
    final (C, n, m) in float32 and the last ``conv_width - 1`` up-projected
    inputs in x's dtype (``repro/models/transformer.py:279-291``, which
    projects ``up`` a second time, to the same values)."""
    q, k, v, i_raw, f_raw, gate, up, _ = _mlstm_qkv(p, x, cfg)
    h, (C, n, m) = _mlstm_chunkwise(q, k, v, i_raw, f_raw)
    out = _mlstm_out(p, h.to(x.dtype), gate, cfg, x.dtype)
    return out, {"C": C, "n": n, "m": m,
                 "conv": up[:, -(cfg.conv_width - 1):, :]}


def mlstm_decode_step(q, k, v, i_raw, f_raw, state):
    """One-token recurrence.  q, k, v: (B,H,1,dh); gates (B,H,1); state
    (C (B,H,dk,dv), n (B,H,dk), m (B,H)).  Returns (h (B,H,1,dv) in
    float32, the new state)."""
    C, n, m = state
    f32 = torch.float32
    q1, k1, v1 = (t[:, :, 0].to(f32) for t in (q, k, v))
    ii = i_raw[:, :, 0].to(f32)
    ff = F.logsigmoid(f_raw[:, :, 0].to(f32))
    m_new = torch.maximum(ff + m, ii)
    f_st = torch.exp(ff + m - m_new)
    i_st = torch.exp(ii - m_new)
    C_new = (f_st[..., None, None] * C
             + i_st[..., None, None] * torch.einsum("bhd,bhv->bhdv", k1, v1))
    n_new = f_st[..., None] * n + i_st[..., None] * k1
    num = torch.einsum("bhd,bhdv->bhv", q1, C_new)
    den = torch.einsum("bhd,bhd->bh", q1, n_new).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return h[:, :, None, :], (C_new, n_new, m_new)


def mlstm_decode_init(cfg: ArchConfig, batch: int, device=None) -> Dict:
    """Decode state, float32 whatever the activation dtype (the
    reference's ``init_block_state`` never passes one)."""
    d_up, H, dh = _dims(cfg)
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
        "m": torch.full((batch, H), -1e30, dtype=f32, device=device),
        "conv": conv_decode_init(batch, d_up, cfg.conv_width, dtype=f32,
                                 device=device),
    }


def apply_mlstm_decode(p, x: torch.Tensor, cfg: ArchConfig, state: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
    q, k, v, i_raw, f_raw, gate, _, conv_state = _mlstm_qkv(
        p, x, cfg, conv_state=state["conv"])
    h, (C, n, m) = mlstm_decode_step(q, k, v, i_raw, f_raw,
                                     (state["C"], state["n"], state["m"]))
    out = _mlstm_out(p, h.to(x.dtype), gate, cfg, x.dtype)
    return out, {"C": C, "n": n, "m": m, "conv": conv_state}


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #

def slstm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    return {
        "w_x": ParamSpec((d, 4, d), ("embed", None, "rnn")),     # i,f,z,o
        "r_h": ParamSpec((H, dh, 4, dh), (None, None, None, None), scale=0.5),
        "bias": ParamSpec((4, d), (None, None), init="zeros"),
        "w_out": ParamSpec((d, d), ("rnn", "embed")),
    }


SLSTMState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _slstm_cell_parts(gates: torch.Tensor, c: torch.Tensor,
                      n: torch.Tensor, m: torch.Tensor):
    """The cell's values: the new state (c, n, m, h) and the
    intermediates its chain rule reads."""
    i_raw, f_raw, z_raw, o_raw = gates.float().unbind(1)
    a = F.logsigmoid(f_raw) + m
    m_new = torch.maximum(a, i_raw)
    i_st = torch.exp(i_raw - m_new)
    f_st = torch.exp(a - m_new)
    z = torch.tanh(z_raw)
    o = torch.sigmoid(o_raw)
    c_new = f_st * c + i_st * z
    n_new = f_st * n + i_st
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return (c_new, n_new, m_new, h_new), (i_raw, f_raw, a, i_st, f_st, z, o)


class _SLSTMCellStep(torch.autograd.Function):
    """The cell as one autograd node.  The forward runs
    :func:`_slstm_cell_parts` and saves only its inputs; the backward
    recomputes the cell and applies the chain rule by hand, with
    autograd's formulas for each op (``maximum`` halves the gradient on
    ties, ``clamp_min`` passes it where ``n >= 1``).  Under grad the walk
    runs up to three times a step (the step, the superblock's recompute,
    the chunk's recompute), and each of the ops' ~20 nodes and ~20 saved
    tensors a time step would cost host time on every pass."""

    @staticmethod
    def forward(ctx, gates, c, n, m):
        ctx.save_for_backward(gates, c, n, m)
        return _slstm_cell_parts(gates, c, n, m)[0]

    @staticmethod
    def backward(ctx, dc_out, dn_out, dm_out, dh):
        gates, c, n, m = ctx.saved_tensors
        (c_new, n_new, _, _), (i_raw, f_raw, a, i_st, f_st, z, o) = \
            _slstm_cell_parts(gates, c, n, m)
        den = torch.clamp_min(n_new, 1.0)
        q = o * c_new
        dq = dh / den
        dc_new = dc_out + dq * o
        dn_new = dn_out + torch.where(n_new >= 1.0, -dh * q / (den * den),
                                      0.0)
        di_st = dc_new * z + dn_new
        df_st = dc_new * c + dn_new * n
        di_exp = di_st * i_st
        da_exp = df_st * f_st
        dm_new = dm_out - di_exp - da_exp
        split = torch.where(a == i_raw, dm_new / 2, dm_new)
        da = da_exp + split.masked_fill(a < i_raw, 0.0)
        di = di_exp + split.masked_fill(a > i_raw, 0.0)
        dgates = torch.stack([di, da * torch.sigmoid(-f_raw),
                              dc_new * i_st * (1 - z * z),
                              dq * c_new * (1 - o) * o], 1)
        return dgates.to(gates.dtype), dc_new * f_st, dn_new * f_st, da


def _slstm_cell(gates: torch.Tensor, state: SLSTMState) -> SLSTMState:
    """gates: (B, 4, D) raw; state (c, n, m, h) each (B, D) float32."""
    c, n, m, _ = state
    return _SLSTMCellStep.apply(gates, c, n, m)


def _slstm_gx(p, x: torch.Tensor) -> torch.Tensor:
    """The input part of the gates, ``x @ w_x``: (B, [T,] D) -> (B, [T,]
    4, D).  Under a sharding context the product runs on each rank's
    batch rows against ``w_x`` whole (``local_call``): the einsum views
    (4, D) as one dim, which DTensor refuses while that dim is split."""
    rows = ("act_batch",) + (None,) * (x.dim() - 1)
    return local_call(_gx, (x, p["w_x"]), (rows, (None,) * 3),
                      (rows + (None,),), out_shapes=(
                          tuple(x.shape[:-1]) + p["w_x"].shape[1:],))[0]


def _gx(x, w):
    return (torch.einsum("...d,dgk->...gk", x, w.to(x.dtype)),)


def _slstm_gh(r_h: torch.Tensor, h_prev: torch.Tensor,
              dt: torch.dtype) -> torch.Tensor:
    """The recurrent part: the block-diagonal ``h_{t-1} @ r_h`` (one
    block per head, r_h (H, dh, 4, dh)), (B, D) -> (B, 4, D) in
    ``dt``."""
    B, D = h_prev.shape
    H = r_h.shape[0]
    hh = h_prev.reshape(B, H, D // H).to(dt)
    gh = torch.einsum("bhk,hkgj->bghj", hh, r_h.to(dt))
    return gh.reshape(B, 4, D)


def _slstm_gates(p, xt: torch.Tensor, h_prev: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """xt: (B, D); h_prev: (B, D) -> raw gates (B, 4, D)."""
    return (_slstm_gx(p, xt) + _slstm_gh(p["r_h"], h_prev, xt.dtype)
            + p["bias"].to(xt.dtype))


def slstm_decode_init(cfg: ArchConfig, batch: int, device=None) -> Dict:
    """Decode state (c, n, m, h), float32."""
    D = cfg.d_model
    z = lambda: torch.zeros((batch, D), dtype=torch.float32,  # noqa: E731
                            device=device)
    return {"c": z(), "n": z(),
            "m": torch.full((batch, D), -1e30, dtype=torch.float32,
                            device=device), "h": z()}


SLSTM_TIME_CHUNK = 256


def _walk_steps(gx: torch.Tensor, r_h: torch.Tensor, bias: torch.Tensor,
                c, n, m, h):
    """The time loop over gx (B, T, 4, D) from the state (c, n, m, h):
    h (B, T, D) float32 and the final c, n, m, h."""
    state = (c, n, m, h)
    hs = []
    for t in range(gx.shape[1]):
        gates = gx[:, t] + _slstm_gh(r_h, state[3], gx.dtype) + bias
        state = _slstm_cell(gates, state)
        hs.append(state[3])
    return (torch.stack(hs, 1),) + state


def _walk(gx: torch.Tensor, r_h: torch.Tensor, bias: torch.Tensor, cfg):
    """The time loop over gx (B, T, 4, D) from the zero state: h (B, T,
    D) float32 and the final c, n, m, h.  Under grad each
    ``SLSTM_TIME_CHUNK``-step chunk is checkpointed (non-reentrant, so
    it nests inside a checkpointed superblock) and recomputed in the
    backward, as the reference's ``jax.checkpoint`` over its chunked
    scan (``repro/models/xlstm.py:259-283``); the recompute is bound to
    the sharding context, which autograd's device thread does not
    inherit."""
    B, T, _, D = gx.shape
    state = tuple(slstm_decode_init(cfg, B, gx.device)[k]
                  for k in ("c", "n", "m", "h"))
    if not torch.is_grad_enabled():
        return _walk_steps(gx, r_h, bias, *state)
    chunk = SLSTM_TIME_CHUNK if T % SLSTM_TIME_CHUNK == 0 else T
    steps = bind_ctx(_walk_steps)
    hs = []
    for s in range(0, T, chunk):
        h, *state = checkpoint(steps, gx[:, s:s + chunk], r_h, bias, *state,
                               use_reentrant=False, preserve_rng_state=False)
        hs.append(h)
    return (torch.cat(hs, 1),) + tuple(state)


def _slstm_walk(p, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, SLSTMState]:
    """The recurrence over x (B, T, D) from the zero state: (h (B, T, D)
    float32, the final (c, n, m, h)).  Under a sharding context the loop
    runs on each rank's batch rows (``local_call``), since DTensor would
    dispatch every op of every step."""
    B, T, D = x.shape
    gx = _slstm_gx(p, x)                      # (B, T, 4, D), all T at once
    bias = p["bias"].to(x.dtype)
    rows = ("act_batch", None)
    h, *state = local_call(
        _walk, (gx, p["r_h"], bias), (rows + (None, None), (None,) * 4,
                                      (None, None)),
        (rows + (None,),) + (rows,) * 4,
        out_shapes=((B, T, D),) + ((B, D),) * 4, cfg=cfg)
    return h, tuple(state)


def _slstm_out(p, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return shard(torch.einsum("btd,de->bte", h.to(dt), p["w_out"].to(dt)),
                 ("act_batch", "act_seq", "act_embed"))


def apply_slstm(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return _slstm_out(p, _slstm_walk(p, x, cfg)[0], x.dtype)


def slstm_prefill(p, x: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Dict]:
    """The block over a whole prompt and its final state, from one walk
    (``repro/models/transformer.py:288-291`` and ``:318
    _slstm_final_state`` walk twice, to the same values)."""
    hs, (c, n, m, h) = _slstm_walk(p, x, cfg)
    return _slstm_out(p, hs, x.dtype), {"c": c, "n": n, "m": m, "h": h}


def _slstm_step(gx, r_h, bias, c, n, m, h) -> SLSTMState:
    return _slstm_cell(gx + _slstm_gh(r_h, h, gx.dtype) + bias, (c, n, m, h))


def apply_slstm_decode(p, x: torch.Tensor, cfg: ArchConfig, state: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
    """One step.  Under a sharding context the cell runs on each rank's
    batch rows (``local_call``), as the prefill's walk does."""
    B, _, D = x.shape
    rows = ("act_batch", None)
    keys = ("c", "n", "m", "h")
    c, n, m, h = local_call(
        _slstm_step, (_slstm_gx(p, x[:, 0]), p["r_h"],
                      p["bias"].to(x.dtype), *(state[k] for k in keys)),
        (rows + (None,), (None,) * 4, (None, None)) + (rows,) * 4,
        (rows,) * 4, out_shapes=((B, D),) * 4)
    return _slstm_out(p, h[:, None, :], x.dtype), {"c": c, "n": n, "m": m,
                                                   "h": h}
