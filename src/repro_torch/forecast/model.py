"""Learned rate forecaster, as ``repro/forecast/model.py``.

A one-block mLSTM trunk reads ``history_bins`` past rates in ``log1p``
space and predicts the next window's mean arrival rate.  Training is
``train_forecaster`` (the port's AdamW over the squared error in log
space) and ``save_forecaster``; serving is ``load_forecaster(dir)`` →
``LearnedForecaster.observe_bin/predict``, and the batched
``apply_forecast`` over windowed examples.  On the card every mLSTM cell
runs the CUDA kernel ``kernels/csrc/mlstm_chunkwise.cu``, in training
too (its backward differentiates the plain cell).

Checkpoints are the JAX package's format both ways: ``load_forecaster``
reads one its ``save_forecaster`` wrote, and the reference's
``load_forecaster`` reads one this ``save_forecaster`` wrote.
``LearnedForecaster`` keeps the ``observe_bin(rate)`` / ``predict() ->
(rate, conf)`` contract of the baselines, so the reference's
``PredictiveAutoscaler`` can take it as
``ExperimentSpec(forecaster_obj=...)``.

``train_forecaster`` draws its batch order from
``np.random.default_rng(seed)`` exactly as the reference does; its
initial parameters come from a ``torch.Generator`` seeded with ``seed``
(not JAX's numbers), or from the caller (``params=``).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.forecast.baseline import _EPS
from repro_torch.forecast.features import WindowConfig
from repro_torch.models.params import (ParamSpec, init_params,
                                      leaves_with_paths, map_tree,
                                      params_from_numpy)
from repro_torch.models.xlstm import apply_mlstm, mlstm_specs
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)


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


@dataclasses.dataclass
class TrainResult:
    params: Dict
    arch: ArchConfig
    window: WindowConfig
    losses: np.ndarray            # per-step training loss
    val_mse: Optional[float]      # log-space MSE on the val split


def _batches(rng: np.random.Generator, n: int, batch: int, steps: int
             ) -> Iterator[np.ndarray]:
    for _ in range(steps):
        yield rng.integers(0, n, size=batch)


def train_forecaster(X: np.ndarray, y: np.ndarray, *,
                     window: WindowConfig,
                     X_val: Optional[np.ndarray] = None,
                     y_val: Optional[np.ndarray] = None,
                     seed: int = 0, steps: int = 300, batch: int = 64,
                     d_model: int = 32, num_heads: int = 2,
                     learning_rate: float = 3e-3,
                     params: Optional[Dict] = None,
                     device=None) -> TrainResult:
    """Fit the mLSTM forecaster on (X, y) rate examples on ``device``
    (``None`` is the card).

    The reference's loop: AdamW with ``warmup_steps = max(1, steps //
    10)``, no weight decay, the mean squared error in log1p space, and
    ``steps`` batches of ``min(batch, n)`` indices from
    ``np.random.default_rng(seed)``.  ``params`` (a tree of tensors, e.g.
    the reference's initial parameters through ``params_from_numpy``) is
    copied and trained in place of a fresh draw.  The per-step losses are
    read back once, at the end."""
    if X.shape[0] == 0:
        raise ValueError("empty training set")
    dev = resolve_device(device)
    arch = forecast_arch(d_model=d_model, num_heads=num_heads)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(forecast_specs(arch), gen, dev)
    params = map_tree(lambda _, p: p.detach().to(dev, torch.float32)
                      .clone().requires_grad_(), params)
    paths, leaves = zip(*leaves_with_paths(params))
    opt_cfg = OptimizerConfig(learning_rate=learning_rate,
                              warmup_steps=max(1, steps // 10),
                              total_steps=steps, weight_decay=0.0)
    opt_state = init_opt_state(params)

    Xl = torch.from_numpy(np.log1p(np.asarray(X, np.float32))).to(dev)
    yl = torch.from_numpy(np.log1p(np.asarray(y, np.float32))).to(dev)
    n = Xl.shape[0]
    losses = []
    for idx in _batches(np.random.default_rng(seed), n, min(batch, n), steps):
        idx = torch.from_numpy(idx).to(dev)
        pred = apply_forecast(params, Xl[idx], arch)
        loss = torch.mean((pred - yl[idx]) ** 2)
        grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
        adamw_update(opt_cfg, params,
                     map_tree(lambda path, _: grads[path], params), opt_state)
        losses.append(loss.detach())
    params = map_tree(lambda _, p: p.detach(), params)

    val_mse = None
    if X_val is not None and X_val.shape[0]:
        with torch.no_grad():
            xv = torch.from_numpy(np.log1p(np.asarray(X_val, np.float32)))
            yv = torch.from_numpy(np.log1p(np.asarray(y_val, np.float32)))
            pred = apply_forecast(params, xv.to(dev), arch)
            val_mse = float(torch.mean((pred - yv.to(dev)) ** 2))
    losses = torch.stack(losses).cpu().numpy() if losses else \
        np.zeros(0, np.float32)
    return TrainResult(params=params, arch=arch, window=window,
                       losses=losses, val_mse=val_mse)


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


def save_forecaster(directory: str, result: TrainResult, step: int) -> str:
    """Persist trained params + geometry in the JAX package's checkpoint
    format (``leaves.npz`` + ``meta.json``, atomic, keep-N)."""
    extra = {"d_model": result.arch.d_model,
             "num_heads": result.arch.num_heads,
             "bin_s": result.window.bin_s,
             "history_bins": result.window.history_bins,
             "horizon_bins": result.window.horizon_bins}
    return checkpoint.CheckpointManager(directory).save(step, result.params,
                                                        extra=extra)


def load_forecaster(directory: str, step: Optional[int] = None,
                    device=None) -> LearnedForecaster:
    """The forecaster saved in ``directory`` (by either package's
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
