"""The mLSTM block of xLSTM (Beck et al., 2024), as the mLSTM part of
``repro/models/xlstm.py``.

Block: x → up-projection (×proj_factor) with a SiLU gate branch; a causal
conv1d feeds q/k; the chunkwise cell; RMS norm, gating and
down-projection.  The cell, ``_mlstm_chunkwise``, is
:func:`repro_torch.kernels.mlstm_chunkwise.mlstm_chunkwise`: the CUDA
kernel on CUDA tensors, its plain version on CPU tensors.  The
projections around the cell are ``torch.einsum`` in float32 (the
reference computes them outside any kernel too).  The reference's
``shard(...)`` layout hints carry no arithmetic and are dropped.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mlstm_chunkwise import mlstm_chunkwise
from repro_torch.models.conv import causal_conv1d, conv_specs
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
    q, k, v, i_raw, f_raw = (t.contiguous() for t in (q, k, v, i_raw, f_raw))
    return mlstm_chunkwise(q, k, v, i_raw, f_raw, state=state, chunk=chunk,
                           return_state=return_state)


def _mlstm_qkv(p, x: torch.Tensor, cfg: ArchConfig):
    """Shared pre-cell computation.  Returns (q, k, v, i, f, gate, up)."""
    dt = x.dtype
    _, _, dh = _dims(cfg)
    up = torch.einsum("btd,du->btu", x, p["w_up"].to(dt))
    gate = F.silu(torch.einsum("btd,du->btu", x, p["w_gate"].to(dt)))
    c = F.silu(causal_conv1d(p["conv"], up))
    q = torch.einsum("btu,uhk->bhtk", c, p["w_q"].to(dt))
    k = torch.einsum("btu,uhk->bhtk", c, p["w_k"].to(dt)) * (dh ** -0.5)
    v = torch.einsum("btu,uhk->bhtk", up, p["w_v"].to(dt))
    i_raw = (torch.einsum("btu,uh->bht", c, p["w_i"].to(dt))
             + p["b_i"].to(dt)[None, :, None])
    f_raw = (torch.einsum("btu,uh->bht", c, p["w_f"].to(dt))
             + 3.0 * p["b_f"].to(dt)[None, :, None])
    return q, k, v, i_raw, f_raw, gate, up


def _mlstm_out(p, h, gate, cfg: ArchConfig, dtype):
    """Head-merge + RMS norm over the up dim + gating + down-projection."""
    B, H, T, dh = h.shape
    hm = h.transpose(1, 2).reshape(B, T, H * dh)
    ms = hm.square().mean(-1, keepdim=True)
    hm = hm * torch.rsqrt(ms + 1e-6) * p["out_norm"]["scale"].float()
    hm = hm.to(dtype) * gate
    return torch.einsum("btu,ud->btd", hm, p["w_down"].to(dtype))


def apply_mlstm(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    q, k, v, i_raw, f_raw, gate, _ = _mlstm_qkv(p, x, cfg)
    h, _ = _mlstm_chunkwise(q, k, v, i_raw, f_raw, return_state=False)
    return _mlstm_out(p, h.to(x.dtype), gate, cfg, x.dtype)
