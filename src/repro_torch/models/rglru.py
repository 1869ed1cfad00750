"""RG-LRU recurrent block (Griffin / RecurrentGemma), as
``repro/models/rglru.py``.

Recurrence (diagonal, per channel):
    r_t = sigmoid(W_a x_t)                       (recurrence gate)
    i_t = sigmoid(W_x x_t)                       (input gate)
    log a_t = -c * softplus(Lambda) * r_t        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The whole-sequence recurrence is
:func:`repro_torch.kernels.rglru_scan.rglru_scan` (the CUDA kernel on
CUDA tensors, its plain version on CPU tensors); decode is the one-step
recurrence with a float32 state (B, R).  Block: a tanh-GeLU gate branch
times a conv1d(4) → RG-LRU branch, projected out.  Gate projections are
block-diagonal over ``RGLRU_BLOCKS`` blocks.

Dtypes follow the reference exactly.  In prefill the conv output ``xc``
has the activation dtype, so ``w_a``, ``w_x``, ``b_a``, ``b_x`` are read
in it; in decode the state is float32 and ``causal_conv1d_step`` widens
``xc`` to float32, so the same four leaves are read in float32.  The port
keeps those four (and ``lam``) as float32 leaves and casts them where the
reference does, which gives both.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import local_call, shard
from repro_torch.kernels.rglru_scan import rglru_scan as _scan
from repro_torch.models.conv import (causal_conv1d, causal_conv1d_step,
                                     conv_decode_init, conv_specs)
from repro_torch.models.params import ParamSpec

RGLRU_BLOCKS = 16
RGLRU_C = 8.0


def _rnn_width(cfg: ArchConfig) -> int:
    return cfg.d_rnn or cfg.d_model


def rglru_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, r = cfg.d_model, _rnn_width(cfg)
    nb = RGLRU_BLOCKS
    rb = r // nb
    return {
        "w_in": ParamSpec((d, r), ("embed", "rnn")),
        "w_gate_branch": ParamSpec((d, r), ("embed", "rnn")),
        "conv": conv_specs(r, cfg.conv_width, "rnn"),
        "w_a": ParamSpec((nb, rb, rb), ("rnn_blocks", None, None)),
        "b_a": ParamSpec((nb, rb), ("rnn_blocks", None), init="zeros"),
        "w_x": ParamSpec((nb, rb, rb), ("rnn_blocks", None, None)),
        "b_x": ParamSpec((nb, rb), ("rnn_blocks", None), init="zeros"),
        "lam": ParamSpec((r,), ("rnn",), init="rglru_lambda"),
        "w_out": ParamSpec((r, d), ("rnn", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) for every x (``F.softplus``
    switches to x above 20; this does not)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _gates(p, xc: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections.  xc: (B, T, R) -> (r_t, i_t) f32."""
    B, T, _ = xc.shape
    nb = RGLRU_BLOCKS
    xb = xc.reshape(B, T, nb, r // nb)
    ra = torch.einsum("btni,nij->btnj", xb, p["w_a"].to(xc.dtype)) \
        + p["b_a"].to(xc.dtype)
    ri = torch.einsum("btni,nij->btnj", xb, p["w_x"].to(xc.dtype)) \
        + p["b_x"].to(xc.dtype)
    rec_gate = torch.sigmoid(ra.reshape(B, T, r).float())
    in_gate = torch.sigmoid(ri.reshape(B, T, r).float())
    return rec_gate, in_gate


def _coeffs(p, xc: torch.Tensor, r: int):
    """Returns (a, gated_input) both f32, shape (B, T, R)."""
    rec_gate, in_gate = _gates(p, xc, r)
    log_a = -RGLRU_C * softplus(p["lam"].float()) * rec_gate
    a = torch.exp(log_a)
    scale = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    gated = scale * in_gate * xc.float()
    return a, gated


def rglru_scan(p, xc: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence linear recurrence, in xc's dtype (the kernel; on
    each rank's local channels under a sharding context)."""
    a, b = _coeffs(p, xc, _rnn_width(cfg))
    axes = ("act_batch", None, "act_rnn")
    return local_call(_scan, (a, b), (axes, axes), axes, out_dtype=xc.dtype)


def _branches(p, x: torch.Tensor):
    dt = x.dtype
    branch = shard(x @ p["w_in"].to(dt), ("act_batch", None, "act_rnn"))
    gate = F.gelu(x @ p["w_gate_branch"].to(dt), approximate="tanh")
    return branch, gate


def rglru_prefill(p, x: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Dict]:
    """The block over a whole sequence, and its decode state: ``h`` at the
    last position (rounded to x's dtype by the scan, then widened to
    float32) and the last ``conv_width - 1`` conv inputs in x's dtype, as
    ``repro/models/transformer.py:332 _rglru_prefill``."""
    branch, gate = _branches(p, x)
    xc = causal_conv1d(p["conv"], branch)
    h = rglru_scan(p, xc, cfg)
    out = shard((h * gate) @ p["w_out"].to(x.dtype),
                ("act_batch", "act_seq", "act_embed"))
    state = {"h": h[:, -1].float(),
             "conv": branch[:, -(cfg.conv_width - 1):, :]}
    return out, state


def apply_rglru(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return rglru_prefill(p, x, cfg)[0]


def rglru_decode_init(cfg: ArchConfig, batch: int, device=None) -> Dict:
    """Decode state, float32 whatever the activation dtype (the
    reference's ``init_block_state`` never passes one)."""
    r = _rnn_width(cfg)
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": conv_decode_init(batch, r, cfg.conv_width,
                                     dtype=torch.float32, device=device)}


def apply_rglru_decode(p, x: torch.Tensor, cfg: ArchConfig, state: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
    """One token.  x: (B, 1, D); the float32 state widens xc to float32."""
    dt = x.dtype
    r = _rnn_width(cfg)
    branch, gate = _branches(p, x)
    xc, conv_state = causal_conv1d_step(p["conv"], branch, state["conv"])
    a, b = _coeffs(p, xc, r)
    h = a[:, 0] * state["h"].float() + b[:, 0]
    y = h[:, None, :].to(dt) * gate
    out = y @ p["w_out"].to(dt)
    return out, {"h": h, "conv": conv_state}
