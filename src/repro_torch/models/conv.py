"""Depthwise causal 1-D convolution, as ``repro/models/conv.py``.

A sum of shifted inputs (the width is tiny, 4 in the forecaster), the
same sum the reference takes.  ``F.conv1d`` is not used: cuDNN runs
float32 convolutions in TF32 by default, which would not hold the
reference's tolerance.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


def conv_specs(channels: int, width: int, axis_name: str = "rnn"
               ) -> Dict[str, ParamSpec]:
    return {
        "w": ParamSpec((width, channels), ("conv", axis_name), scale=1.0),
        "b": ParamSpec((channels,), (axis_name,), init="zeros"),
    }


def causal_conv1d(p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C) -> (B, T, C); left-padded causal depthwise conv."""
    w = p["w"].to(x.dtype)
    width = w.shape[0]
    out = x * w[width - 1]
    for j in range(1, width):
        shifted = F.pad(x, (0, 0, j, 0))[:, :x.shape[1], :]
        out = out + shifted * w[width - 1 - j]
    return out + p["b"].to(x.dtype)
