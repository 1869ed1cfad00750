"""Depthwise causal 1-D convolution, as ``repro/models/conv.py``.

A sum of shifted inputs (the width is tiny: 4 in the forecaster and in
RecurrentGemma), the same sum the reference takes.  ``F.conv1d`` is not
used: cuDNN runs float32 convolutions in TF32 by default, which would not
hold the reference's tolerance.  Decode keeps the last ``width - 1``
inputs as its state.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import local_call
from repro_torch.models.params import ParamSpec


def conv_specs(channels: int, width: int, axis_name: str = "rnn"
               ) -> Dict[str, ParamSpec]:
    return {
        "w": ParamSpec((width, channels), ("conv", axis_name), scale=1.0),
        "b": ParamSpec((channels,), (axis_name,), init="zeros"),
    }


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w = w.to(x.dtype)
    width = w.shape[0]
    out = x * w[width - 1]
    for j in range(1, width):
        shifted = F.pad(x, (0, 0, j, 0))[:, :x.shape[1], :]
        out = out + shifted * w[width - 1 - j]
    return out + b.to(x.dtype)


def causal_conv1d(p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C) -> (B, T, C); left-padded causal depthwise conv (on
    each rank's rows and channels under a sharding context: DTensor's
    padding rule misplaces the gradient on some versions)."""
    axes = ("act_batch", None, "act_rnn")
    return local_call(_conv, (x, p["w"], p["b"]),
                      (axes, (None, "act_rnn"), ("act_rnn",)), axes)


def conv_decode_init(batch: int, channels: int, width: int,
                     dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Decode state: the last width-1 inputs, shape (B, width-1, C)."""
    return torch.zeros((batch, width - 1, channels), dtype=dtype,
                       device=device)


def causal_conv1d_step(p, x: torch.Tensor, state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x: (B, 1, C); state: (B, width-1, C).  The
    window takes the wider of the two dtypes, as JAX promotes: a float32
    state with a bfloat16 input gives a float32 output and state."""
    w = p["w"].to(x.dtype)
    dt = torch.promote_types(state.dtype, x.dtype)
    window = torch.cat([state.to(dt), x.to(dt)], dim=1)   # (B, width, C)
    out = (window * w.to(dt)).sum(1)[:, None, :] + p["b"].to(x.dtype).to(dt)
    return out, window[:, 1:, :]
