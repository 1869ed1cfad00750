"""Transformer layers, as ``repro/models/layers.py``: norms, RoPE, the
MLP, attention and its KV cache, cross attention and sinusoidal
positions.

Layout conventions (the reference's)
  activations: (B, T, D);  q/k/v: (B, T, H, head_dim)
  KV cache: {"k", "v": (B, Kv, S, hd), "pos": int32 (B,)}
            (local attention is a ring buffer: position p lives in slot
             p % S, S = min(window, cache_len)); with ``kv_quant`` the
            k, v payloads are int8 beside float16 scales
            "k_scale", "v_scale": (B, Kv, S)

Full-sequence attention goes through
:func:`repro_torch.kernels.flash_attention.flash_attention` (the CUDA
kernel on CUDA tensors, its plain version on CPU tensors), which reads
the kv heads in place of repeating them.  The reference's ``_mha``
rounds the softmax weights to the activation dtype before the weighted
sum; so does the kernel in bfloat16 (it feeds them to the tensor cores
as bf16), while in float32, and in the plain version, they stay float32
as in the Pallas kernel.  With ``pad_heads_to`` the kernel runs on the
padded head count (k, v repeated to every query head, then zero heads
appended, as the reference does); the kernel computes each head apart,
so the real heads do not change.  The one-token decode attends over the
cache in plain PyTorch, as the reference does with einsums, and does not
pad.

Cross attention (Whisper's decoder reading the encoder's output) takes
the encoder's k, v in the reference's (B, S_enc, Kv, hd) layout
(:func:`encode_cross_kv`).  A whole prompt (T > 1) reads them through
the flash kernel without a causal mask; one decode token (T = 1) reads
them in plain PyTorch, as the reference's ``_mha`` does, its float32
softmax weights rounded to the activation dtype before the weighted sum.

Under ``repro_torch.distributed.sharding.sharding_ctx`` the tensors are
DTensors and ``shard`` pins them to the reference's logical axes at the
reference's places; the flash kernel then runs on each rank's local
shard (batch on ``act_batch``, heads on ``act_heads`` / ``act_kv_heads``,
the whole sequence), which computes the same function, since attention
is independent per batch row and head.  A GQA layout whose kv heads do
not shard as its query heads do repeats k, v to every query head first,
as the reference does.  The softmax weights of the one-token cross
attention carry the reference's ``_mha`` constraint in the grouped
(B, Kv, G, S) layout.

With ``cfg.attn_logit_softcap > 0`` every attention caps its float32
logits to ``cap * tanh(s / cap)`` before the mask, as the reference's
``_softcap`` does: the flash kernel (prefill, training, the encoder,
cross attention over a prompt), the one-token decode (after the int8
cache's key scale) and the one-token cross attention.
"""
from __future__ import annotations

import math

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (current_ctx, is_dtensor,
                                              local_call, local_offsets,
                                              local_run, merge_dims, shard,
                                              splittable, unflatten_last)
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 softcap_logits)
from repro_torch.models.params import ParamSpec

# The residual stream's logical axes (sequence-parallel over `model`).
RESIDUAL_AXES = ("act_batch", "act_seq", "act_embed")


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #

def norm_specs(cfg: ArchConfig, d: Optional[int] = None
               ) -> Dict[str, ParamSpec]:
    d = d or cfg.d_model
    specs = {"scale": ParamSpec((d,), (None,), init="ones")}
    if cfg.norm_type == "layernorm":
        specs["bias"] = ParamSpec((d,), (None,), init="zeros")
    return specs


def apply_norm(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The block's pre-norm (B, T, D).  Its output feeds the mixer's and
    the MLP's projections, so under a sharding context it comes back
    with the whole sequence on each rank (the residual stream's
    ``act_seq`` split gathered), as the reference's projections gather
    it; a matmul cannot fold a sequence-split (B, T) into its rows."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return shard(y.to(x.dtype), ("act_batch", None, "act_embed"))


# --------------------------------------------------------------------------- #
# rotary position embeddings (half rotation, partial supported)
# --------------------------------------------------------------------------- #

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) int.  cos and sin are cast to
    x's dtype before the multiply, as the reference does."""
    hd = x.shape[-1]
    rot = int(hd * rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., None] * freqs               # (B,T,half)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, x_pass], dim=-1)


# --------------------------------------------------------------------------- #
# MLP (gated / plain)
# --------------------------------------------------------------------------- #

def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None
              ) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    specs: Dict[str, ParamSpec] = {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if cfg.gated_mlp:
        specs["w_gate"] = ParamSpec((d, f), ("embed", "mlp"))
    if cfg.mlp_bias:
        specs["b_up"] = ParamSpec((f,), (None,), init="zeros")
        specs["b_down"] = ParamSpec((d,), (None,), init="zeros")
    return specs


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``jax.nn.gelu`` is the tanh form by default, ``F.gelu`` the exact
    one: the reference's "gelu" and "gelu_tanh" are both tanh."""
    if kind == "silu":
        return F.silu(x)
    if kind in ("gelu", "gelu_tanh"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def apply_mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    if "b_up" in p:
        h = h + p["b_up"].to(dt)
    if cfg.gated_mlp:
        h = _act(x @ p["w_gate"].to(dt), cfg.act) * h
    else:
        h = _act(h, cfg.act)
    h = shard(h, ("act_batch", None, "act_mlp"))
    out = h @ p["w_down"].to(dt)
    if "b_down" in p:
        out = out + p["b_down"].to(dt)
    return shard(out, RESIDUAL_AXES)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #

def attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    specs: Dict[str, ParamSpec] = {
        "w_q": ParamSpec((d, hq, hd), ("embed", "heads", "head_dim")),
        "w_k": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "w_v": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "w_o": ParamSpec((hq, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["b_q"] = ParamSpec((hq, hd), ("heads", "head_dim"), init="zeros")
        specs["b_k"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"),
                                 init="zeros")
        specs["b_v"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"),
                                 init="zeros")
    return specs


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, T, D) @ (D, H, hd) -> (B, T, H, hd)."""
    D, H, hd = w.shape
    return unflatten_last(x @ merge_dims(w.to(x.dtype), 1), (H, hd))


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, use_rope: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dt = x.dtype
    q = _project(x, p["w_q"])
    k = _project(x, p["w_k"])
    v = _project(x, p["w_v"])
    if cfg.qkv_bias:
        q = q + p["b_q"].to(dt)
        k = k + p["b_k"].to(dt)
        v = v + p["b_v"].to(dt)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    q = q * (cfg.head_dim_ ** -0.5)
    return q, k, v


def _out_proj(out: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hd) @ (H, hd, D) -> (B, T, D)."""
    return merge_dims(out, 2) @ merge_dims(w_o.to(out.dtype), 0)


def _heads_placement(shape, axes):
    """The mesh entry a (B, T, H, hd) tensor's head dim resolves to."""
    spec = current_ctx().resolve(shape, axes)
    return spec[2] if len(spec) > 2 else None


def _flash_local(q, k, v, **kw):
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           **kw)


def attention_from_qkv(q, k, v, *, causal: bool = True, window: int = 0,
                       pad_heads_to: int = 0,
                       softcap: float = 0.0) -> torch.Tensor:
    """The softmax core over projected (B, T, H, hd) q, k, v: the kernel,
    with q already scaled (``sm_scale = 1``) and the logits capped at
    ``softcap`` (none at 0).  Positions are 0..T-1, the only positions
    full-sequence attention is called with.

    With ``pad_heads_to`` above the query heads, k and v are repeated to
    every query head and q, k, v get zero heads up to that count, as the
    reference pads (``layers.py:207-220``); the kernel runs MHA on the
    padded heads and the output keeps the real ones."""
    n_heads = q.shape[2]
    if pad_heads_to > n_heads:
        rep = n_heads // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        pad = (0, 0, 0, pad_heads_to - n_heads)
        # on each rank's batch rows, all heads (a DTensor pad of the
        # heads dim trips torch 2.11's redistribution planner)
        rows = ("act_batch", None, None, None)
        q, k, v = (local_call(F.pad, (t,), (rows,), rows, pad=pad)
                   for t in (q, k, v))
    q_axes = ("act_batch", "act_q_seq", "act_heads", None)
    kv_axes = ("act_batch", None, "act_heads" if k.shape[2] == q.shape[2]
               else "act_kv_heads", None)
    if current_ctx() is not None and k.shape[2] != q.shape[2] and (
            _heads_placement(q.shape, q_axes)
            != _heads_placement(k.shape, kv_axes)):
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        kv_axes = ("act_batch", None, "act_heads", None)
    q = shard(q, q_axes)
    k = shard(k, kv_axes)
    v = shard(v, kv_axes)
    local = ("act_batch", q_axes[2], None, None)
    local_kv = ("act_batch", kv_axes[2], None, None)
    out = local_call(_flash_local,
                     (q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2)),
                     (local, local_kv, local_kv), local,
                     causal=causal, window=window, sm_scale=1.0,
                     softcap=softcap)
    return out.transpose(1, 2)[:, :, :n_heads]


def attention(p, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor, causal: bool = True, window: int = 0,
              use_rope: bool = True) -> torch.Tensor:
    """Training / prefill attention over a whole sequence at positions
    0..T-1 (the reference's callers pass no other)."""
    q, k, v = _project_qkv(p, x, cfg, positions, use_rope)
    out = attention_from_qkv(q, k, v, causal=causal, window=window,
                             pad_heads_to=cfg.pad_heads_to,
                             softcap=cfg.attn_logit_softcap)
    return shard(_out_proj(out, p["w_o"]), RESIDUAL_AXES)


# ----------------------------- decode path ---------------------------------- #

def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  window: int = 0, dtype=torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    """(B, Kv, S, hd) k and v, S = min(window, max_len) for a ring buffer,
    and per-example positions (B,).  With ``cfg.kv_quant``, int8 k and v
    and float16 scales (B, Kv, S), whatever ``dtype`` is."""
    size = min(window, max_len) if window > 0 else max_len
    shape = (batch, cfg.num_kv_heads, size, cfg.head_dim_)
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.kv_quant:
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{name}_scale"] = torch.zeros(shape[:3],
                                                 dtype=torch.float16,
                                                 device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


CACHE_AXES = ("act_batch", "act_kv_heads", "act_kv_seq", None)


def cache_axes(quant: bool = False) -> Dict[str, tuple]:
    """Logical axes of a KV cache's leaves.  ``pos`` is a scalar in the
    uniform-wave states the shape specs describe
    (``repro_torch.launch.shapes``)."""
    ax = {"k": CACHE_AXES, "v": CACHE_AXES, "pos": ()}
    if quant:
        ax["k_scale"] = CACHE_AXES[:3]
        ax["v_scale"] = CACHE_AXES[:3]
    return ax


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., hd) -> (int8 payload, float16 max-abs scale over hd), as
    the reference's ``quantize_kv``: the payload is rounded with the
    float32 scale, and the scale is stored (and later read) as float16.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over batched (..., M, K) and (..., K, N) of one dtype,
    summed and returned in float32: the reference's einsums with
    ``preferred_element_type=float32``.  A product of two bfloat16 values
    is exact in float32, so on the CPU the operands are widened; on the
    card a bfloat16 ``bmm`` writes float32 (no float32 copy of a cache
    operand)."""
    if a.dtype == torch.float32:
        return a @ b
    if not a.is_cuda:
        return a.float() @ b.float()
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*lead, *out.shape[-2:])


def decode_attention(p, x: torch.Tensor, cfg: ArchConfig, cache: Dict,
                     *, window: int = 0, use_rope: bool = True
                     ) -> Tuple[torch.Tensor, Dict]:
    """One token against the cache.  x: (B, 1, D).  The new k, v are
    written into ``cache`` in place, at slot ``pos % S`` (ring buffer) or
    ``min(pos, S - 1)``, and ``pos`` advances; the returned cache is the
    same dict.

    With ``cfg.kv_quant`` the new k, v are quantised (:func:`quantize_kv`)
    and the read folds the scales in, as the reference does
    (``layers.py:340-378``): the logits are ``q . k8`` summed in float32
    times the key's float16 scale; the softmax weights times the value's
    scale are rounded to bfloat16 **whatever the activation dtype**, then
    summed against the int8 payload in float32.  The payload is read in
    the activation dtype (int8 is exact in bfloat16), never as a float32
    copy of the cache.

    Under a sharding context (a cache of DTensors, ``pos`` one scalar for
    a uniform wave or per example) each rank writes the new token into
    its own shard (:func:`write_token`) and attends over it
    (:func:`_decode_core_local`).

    With ``cfg.attn_logit_softcap`` the logits are capped after the key
    scale and before the mask, as the reference's."""
    B, T, _ = x.shape
    if T != 1:
        raise ValueError("decode_attention processes one new token")
    pos = cache["pos"]                 # (B,) per example, or () uniform
    positions = pos.reshape(B, 1) if pos.dim() else \
        pos.reshape(1, 1).expand(B, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, use_rope)
    Kv, G, hd = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim_
    k, v = cache["k"], cache["v"]
    S = k.shape[2]
    slot = torch.remainder(pos, S) if window > 0 else \
        torch.clamp_max(pos, S - 1)
    news = {"k": k_new[:, 0], "v": v_new[:, 0]}
    if cfg.kv_quant:
        for name in ("k", "v"):                          # (B,Kv,hd), (B,Kv)
            news[name], news[f"{name}_scale"] = quantize_kv(news[name])
    sharded = current_ctx() is not None
    if not sharded:
        rows, slot = torch.arange(B, device=x.device), slot.long()
        for name, new in news.items():
            cache[name][rows, :, slot] = new.to(cache[name].dtype)
    else:
        for name, new in news.items():
            write_token(cache[name], new, slot)
    k, v = shard(cache["k"], CACHE_AXES), shard(cache["v"], CACHE_AXES)

    qg = splittable(q, 2, Kv).reshape(B, Kv, G, hd)
    scales = (cache["k_scale"], cache["v_scale"]) if cfg.kv_quant else \
        (None, None)
    cap = cfg.attn_logit_softcap
    if not sharded:
        scores = _decode_scores(qg, k, scales[0], pos, window, S,
                                softcap=cap)
        w = torch.softmax(scores, dim=-1)
        out = _decode_weighted(w, v, scales[1], x.dtype)
    else:
        out = _decode_core_local(qg, k, v, scales, pos, window, x.dtype,
                                 cap)
    out = out.reshape(B, 1, cfg.num_heads, hd)
    pos.add_(1)
    return shard(_out_proj(out, p["w_o"]), RESIDUAL_AXES), cache


def _decode_scores(qg, k, k_scale, pos, window: int, S: int, s0: int = 0,
                   rows: Optional[slice] = None,
                   softcap: float = 0.0) -> torch.Tensor:
    """The masked logits (B, Kv, G, S') of one token's grouped queries
    against cache slots ``s0 .. s0 + S'`` of a cache of ``S`` (a rank's
    part of it, rows ``rows`` of ``pos``), float32.  With ``k_scale``
    (int8 cache) the logits are ``q . k8`` times the key's scale; then
    capped at ``softcap`` (none at 0), then masked."""
    if k_scale is not None:
        scores = _dot_f32(qg, k.to(qg.dtype).transpose(-1, -2))
        scores = scores * k_scale.float()[:, :, None, :]
    else:
        scores = torch.einsum("bkgh,bksh->bkgs", qg.float(), k.float())
    scores = softcap_logits(scores, softcap)
    slot_ids = torch.arange(s0, s0 + k.shape[2], dtype=torch.int32,
                            device=qg.device)
    pb = pos.reshape(-1, 1)                  # (B, 1), or (1, 1) uniform
    if rows is not None:
        pb = pb[rows]
    if window > 0:
        # slot i holds global position p_i = pos - ((pos - i) mod S);
        # valid slots cover (pos - S, pos].
        valid = pb - torch.remainder(pb - slot_ids[None, :], S) >= 0
    else:
        valid = slot_ids[None, :] <= pb
    return scores.masked_fill(~valid[:, None, None, :], NEG_INF)


def _decode_weighted(w, v, v_scale, dt) -> torch.Tensor:
    """The softmax weights (B, Kv, G, S) against v (B, Kv, S, hd), in
    ``dt``; with ``v_scale`` (int8 cache) the weights times the value's
    scale are rounded to bfloat16 **whatever the activation dtype**, as
    the reference rounds, and summed against the payload in float32."""
    if v_scale is not None:
        w = (w * v_scale.float()[:, :, None, :]).to(torch.bfloat16)
        return _dot_f32(w, v.to(torch.bfloat16)).to(dt)
    return torch.einsum("bkgs,bksh->bkgh", w.to(dt), v)


def _decode_core_local(qg, k, v, scales, pos, window: int, dt,
                       softcap: float = 0.0):
    """:func:`_decode_scores`, softmax and :func:`_decode_weighted` on
    DTensors: the logits and the weighted sum run on each rank's shard
    of the cache (``local_run``), and where the cache's slots are split
    the weights are gathered whole for the softmax and each rank's part
    of the sum is reduced (``Partial``), flash-decode style, so that the
    cache never moves."""
    from torch.distributed.tensor import Partial, Shard
    cache_pl = list(k.placements)
    q_pl = _shard_split(k)
    s_pl = [Shard(3) if isinstance(p, Shard) and p.dim == 2 else p
            for p in cache_pl]
    out_pl = [Partial() if isinstance(c, Shard) and c.dim == 2 else p
              for c, p in zip(cache_pl, q_pl)]
    b0, _, s0 = local_offsets(k)[:3]
    S = k.shape[2]
    pos = pos.full_tensor() if is_dtensor(pos) else pos
    k_scale, v_scale = scales
    n_rows = k.to_local().shape[0]
    rows = slice(b0, b0 + n_rows) if pos.dim() else None

    def scores_fn(q_l, k_l, *ks):
        return _decode_scores(q_l, k_l, ks[0] if ks else None, pos, window,
                              S, s0, rows, softcap)
    extra = (k_scale,) if k_scale is not None else ()
    scores = local_run(scores_fn, (qg, k) + extra,
                       (q_pl, cache_pl) + (cache_pl,) * len(extra), s_pl)
    w = torch.softmax(scores, dim=-1)

    def weighted_fn(w_l, v_l, *vs):
        return _decode_weighted(w_l, v_l, vs[0] if vs else None, dt)
    extra = (v_scale,) if v_scale is not None else ()
    return local_run(weighted_fn, (w, v) + extra,
                     (s_pl, cache_pl) + (cache_pl,) * len(extra), out_pl)


def _shard_split(buf: torch.Tensor) -> list:
    """The placements that give a tensor laid out as the DTensor cache
    ``buf`` (B, Kv, S, ...) without its sequence dim the same batch and
    head split, whole on every rank along the mesh dims that split S."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
            for p in buf.placements]


def write_token(buf: torch.Tensor, new: torch.Tensor,
                slot: torch.Tensor) -> None:
    """``buf[b, :, slot[b]] = new[b]`` on each rank's shard of the
    DTensor cache ``buf`` (B, Kv, S, ...), in place: ``new`` (B, Kv,
    ...) is brought to the cache's batch and head split, ``slot`` holds
    the global slots (B,), or one for every row.  A rank writes the rows
    whose slot lies in its part of the sequence and writes back what the
    others hold there, so that no shape depends on the data."""
    val = new.redistribute(buf.device_mesh, _shard_split(buf)).to_local()
    slot = slot.full_tensor() if is_dtensor(slot) else slot
    local = buf.to_local()
    b0, _, s0 = local_offsets(buf)[:3]
    n_rows, n_slots = local.shape[0], local.shape[2]
    at = slot.long().expand(buf.shape[0])[b0:b0 + n_rows] - s0
    inside = ((at >= 0) & (at < n_slots)).reshape(
        (n_rows,) + (1,) * (val.dim() - 1))
    at = at.clamp(0, n_slots - 1)
    rows = torch.arange(n_rows, device=local.device)
    held = local[rows, :, at]
    local[rows, :, at] = torch.where(inside, val.to(local.dtype), held)


def fill_prefix(buf: torch.Tensor, val: torch.Tensor) -> None:
    """``buf[:, :, :n] = val`` (n = val's length along dim 2) on each
    rank's shard of the DTensor cache ``buf``, in place; ``val`` is
    brought to the cache's batch and head split, whole along dim 2."""
    val = val.redistribute(buf.device_mesh, _shard_split(buf)).to_local()
    local = buf.to_local()
    s0 = local_offsets(buf)[2]
    n = min(max(val.shape[2] - s0, 0), local.shape[2])
    if n:
        local[:, :, :n] = val[:, :, s0:s0 + n]


def sharded_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                     window: int = 0, dtype=torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """:func:`init_kv_cache` as DTensors on the sharding context's mesh:
    each rank makes only its shard, the payloads and scales at
    :data:`CACHE_AXES`, the per-example positions (B,) whole on every
    rank."""
    from torch.distributed.tensor import zeros
    ctx = current_ctx()
    axes = dict(cache_axes(cfg.kv_quant), pos=(None,))
    return {name: zeros(t.shape, dtype=t.dtype, device_mesh=ctx.mesh,
                        placements=ctx.placements_for(t.shape, axes[name]))
            for name, t in init_kv_cache(cfg, batch, max_len, window, dtype,
                                         device="meta").items()}


# ----------------------------- cross attention ------------------------------- #

def cross_attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    return attn_specs(cfg)


def encode_cross_kv(p, enc_out: torch.Tensor, cfg: ArchConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's k, v from the encoder output (B, S, D):
    each (B, S, Kv, hd) in the encoder output's dtype."""
    dt = enc_out.dtype
    k = _project(enc_out, p["w_k"])
    v = _project(enc_out, p["w_v"])
    if cfg.qkv_bias:
        k = k + p["b_k"].to(dt)
        v = v + p["b_v"].to(dt)
    return k, v


def cross_attention(p, x: torch.Tensor, cfg: ArchConfig,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor]
                    ) -> torch.Tensor:
    """Decoder -> encoder attention over every encoder position (no
    mask, no RoPE).  x: (B, T, D); ``enc_kv``: (B, S, Kv, hd) k and v.
    Only q is projected (the reference also projects the decoder's k, v
    and discards them).  T > 1 runs the flash kernel with ``causal=False``;
    T = 1 (decode) is the reference's ``_mha`` in plain PyTorch: float32
    logits and softmax, the weights rounded to the activation dtype, the
    weighted sum over v in that dtype.  Both cap the logits at
    ``cfg.attn_logit_softcap`` before the softmax."""
    dt = x.dtype
    B, T, _ = x.shape
    q = _project(x, p["w_q"])
    if cfg.qkv_bias:
        q = q + p["b_q"].to(dt)
    q = q * (cfg.head_dim_ ** -0.5)
    k, v = (t.to(dt) for t in enc_kv)
    if T > 1:
        out = attention_from_qkv(q, k, v, causal=False,
                                 softcap=cfg.attn_logit_softcap)
    else:
        Kv, G, hd = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim_
        qg = splittable(q, 2, Kv).reshape(B, Kv, G, hd)
        grouped = ("act_batch", "act_kv_heads", None, None)
        enc = ("act_batch", None, "act_kv_heads", None)
        out = local_call(_cross_decode, (qg, k, v), (grouped, enc, enc),
                         grouped, dt=dt, softcap=cfg.attn_logit_softcap
                         ).reshape(B, 1, cfg.num_heads, hd)
    return shard(_out_proj(out, p["w_o"]), RESIDUAL_AXES)


def _cross_decode(qg, k, v, dt, softcap: float = 0.0):
    """One token's grouped queries (B, Kv, G, hd) against the encoder's
    k, v (B, S, Kv, hd): float32 logits capped at ``softcap`` (none at
    0) and softmax, the weights rounded to ``dt``.  Under a sharding
    context it runs on each rank's batch rows and kv heads
    (``local_call``), where the weights carry the reference's
    (act_batch, act_kv_heads) constraint."""
    scores = softcap_logits(
        torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float()), softcap)
    w = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bkgs,bskh->bkgh", w, v)


# --------------------------------------------------------------------------- #
# sinusoidal positions (whisper)
# --------------------------------------------------------------------------- #

def _sinusoid(pos: torch.Tensor, d: int, log_1e4, dtype) -> torch.Tensor:
    """(N, d) [sin | cos] rows at the float32 positions ``pos`` (N,):
    frequencies ``exp(-log_1e4 * i / (d/2 - 1))``, all in float32, then
    cast to ``dtype``."""
    half = d // 2
    freqs = torch.exp(-log_1e4 * torch.arange(
        half, dtype=torch.float32, device=pos.device) / (half - 1))
    angles = pos[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], -1).to(dtype)


def sinusoidal_embeddings(length: int, d: int, dtype=torch.float32,
                          device=None) -> torch.Tensor:
    """(length, d) table of positions 0..length-1, as the reference's
    (``log(1e4)`` taken in double, then used as a float32 scalar)."""
    return _sinusoid(torch.arange(length, dtype=torch.float32,
                                  device=device), d, math.log(10_000.0),
                     dtype)


def sinusoid_at(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """(N, d) rows at the positions ``pos`` (N,), as the reference's
    ``decode_step`` computes them inline: ``log(1e4)`` taken in
    float32."""
    log = torch.log(torch.tensor(10_000.0, dtype=torch.float32,
                                 device=pos.device))
    return _sinusoid(pos.reshape(-1).float(), d, log, dtype)
