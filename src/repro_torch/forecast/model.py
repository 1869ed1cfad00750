"""Learned rate forecaster: the serving side of ``repro/forecast/model.py``.

A one-block mLSTM trunk reads ``history_bins`` past rates in ``log1p``
space and predicts the next window's mean arrival rate.  The path is
``load_forecaster(dir)`` → ``LearnedForecaster.observe_bin/predict``, and
the batched ``apply_forecast`` over windowed examples; on the card every
mLSTM cell runs the CUDA kernel ``kernels/csrc/mlstm_chunkwise.cu``.

``load_forecaster`` reads a checkpoint saved by the JAX package's
``save_forecaster`` unchanged.  ``LearnedForecaster`` keeps the
``observe_bin(rate)`` / ``predict() -> (rate, conf)`` contract of the
baselines, so the reference's ``PredictiveAutoscaler`` can take it as
``ExperimentSpec(forecaster_obj=...)``.  Training is not ported yet.
"""
from __future__ import annotations

import collections
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.forecast.baseline import _EPS
from repro_torch.forecast.features import WindowConfig
from repro_torch.models.params import ParamSpec, params_from_numpy
from repro_torch.models.xlstm import apply_mlstm, mlstm_specs
from repro_torch.train import checkpoint


def forecast_arch(d_model: int = 32, num_heads: int = 2) -> ArchConfig:
    """The forecaster's trunk: d_model 32, 2 heads, proj_factor 2, conv
    width 4 by default; the LM-only fields are the reference's inert
    placeholders."""
    return ArchConfig(name="rate-mlstm", family="ssm", num_layers=1,
                      d_model=d_model, num_heads=num_heads,
                      num_kv_heads=num_heads, d_ff=2 * d_model, vocab_size=0)


def forecast_specs(cfg: ArchConfig) -> Dict:
    return {
        "w_in": ParamSpec((1, cfg.d_model), ("embed", "rnn")),
        "block": mlstm_specs(cfg),
        "w_out": ParamSpec((cfg.d_model, 1), ("rnn", "embed"), scale=0.1),
        "b_out": ParamSpec((1,), (None,), init="zeros"),
    }


def apply_forecast(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, T) log1p-rates -> (B,) predicted log1p next-window rate."""
    h = x[..., None] @ params["w_in"]                   # (B, T, D)
    h = h + apply_mlstm(params["block"], h, cfg)        # residual trunk
    y = h[:, -1, :] @ params["w_out"] + params["b_out"]
    return y[:, 0]


class LearnedForecaster:
    """Online wrapper giving trained params the baseline forecaster
    contract (`observe_bin` / `predict`, see
    :mod:`repro_torch.forecast.baseline`).

    ``predict`` is one forward pass at batch 1 over the last
    ``history_bins`` rates on the parameters' device, and one read of the
    result back to the host.  Confidence uses the EW one-step-error
    convention of `EwmaForecaster`."""

    name = "mlstm"

    def __init__(self, params, arch: ArchConfig, window: WindowConfig,
                 err_alpha: float = 0.25):
        self.params = params
        self.arch = arch
        self.window = window
        self.err_alpha = err_alpha
        self.device = params["w_in"].device
        self._hist = collections.deque(maxlen=window.history_bins)
        self._mae = 0.0
        self._last_pred: Optional[float] = None

    def observe_bin(self, rate: float) -> None:
        rate = float(rate)
        if self._last_pred is not None:
            self._mae += self.err_alpha * (abs(rate - self._last_pred)
                                           - self._mae)
        self._hist.append(rate)

    def predict(self) -> Tuple[float, float]:
        if len(self._hist) < self.window.history_bins:
            return 0.0, 0.0
        x = torch.from_numpy(np.log1p(np.asarray(self._hist, np.float32)))
        with torch.inference_mode():
            y = apply_forecast(self.params, x[None].to(self.device),
                               self.arch)
            y = y.cpu().numpy()
        rate = max(0.0, float(np.expm1(y[0])))
        self._last_pred = rate
        conf = 1.0 / (1.0 + self._mae / (rate + _EPS))
        return rate, conf


def load_forecaster(directory: str, step: Optional[int] = None,
                    device=None) -> LearnedForecaster:
    """The forecaster saved in ``directory`` (by the JAX package's
    ``save_forecaster``), on ``device`` (``None`` is the card)."""
    dev = resolve_device(device)
    found = checkpoint.latest_step(directory) if step is None else step
    if found is None:
        raise FileNotFoundError(f"no forecaster checkpoint in {directory}")
    with open(os.path.join(directory, f"step_{found:08d}", "meta.json")) as f:
        extra = json.load(f)["extra"]
    arch = forecast_arch(d_model=int(extra["d_model"]),
                         num_heads=int(extra["num_heads"]))
    leaves, _, _ = checkpoint.restore(directory, forecast_specs(arch),
                                      step=found)
    window = WindowConfig(bin_s=float(extra["bin_s"]),
                          history_bins=int(extra["history_bins"]),
                          horizon_bins=int(extra["horizon_bins"]))
    return LearnedForecaster(params_from_numpy(leaves, device=dev), arch,
                             window)
