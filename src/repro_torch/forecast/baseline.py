"""Numpy-only rate forecasters, copies of ``repro/forecast/baseline.py``.

`EwmaForecaster` is the *online* forecaster the reference's
`PredictiveAutoscaler` uses by default: pure Python/float state.
`Ar1Baseline` is the closed-form offline baseline the learned model is
scored against.

Both follow one forecaster contract (shared with
`repro_torch.forecast.model.LearnedForecaster`):

* ``observe_bin(rate)`` — one closed arrival bin (jobs/s), in order;
* ``predict() -> (rate, confidence)`` — forecast for the next window,
  with confidence in [0, 1]; confidence 0.0 means "no usable forecast"
  and callers (the autoscaler's fallback contract) must degrade to pure
  reactive Alg. 5 behavior.

Confidence is one convention everywhere: an EW mean absolute error of
past one-step forecasts, normalized by the current level —
``conf = 1 / (1 + mae / (level + eps))`` — so an erratic series that the
forecaster keeps mispredicting talks itself out of prelaunching.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

_EPS = 1e-6


class EwmaForecaster:
    """Online EWMA level with EW-error confidence."""

    name = "ewma"

    def __init__(self, alpha: float = 0.35, err_alpha: float = 0.25,
                 warmup_bins: int = 4):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.err_alpha = err_alpha
        self.warmup_bins = warmup_bins
        self._level: Optional[float] = None
        self._mae = 0.0
        self._seen = 0

    def observe_bin(self, rate: float) -> None:
        rate = float(rate)
        if self._level is None:
            self._level = rate
        else:
            err = abs(rate - self._level)    # previous prediction == level
            self._mae += self.err_alpha * (err - self._mae)
            self._level += self.alpha * (rate - self._level)
        self._seen += 1

    def predict(self) -> Tuple[float, float]:
        if self._level is None or self._seen < self.warmup_bins:
            return 0.0, 0.0
        conf = 1.0 / (1.0 + self._mae / (self._level + _EPS))
        return self._level, conf


@dataclasses.dataclass(frozen=True)
class Ar1Baseline:
    """``y = mu + phi · (x_last - mu)`` fitted by least squares on the
    last history bin — the classic per-scenario AR(1) yardstick."""

    mu: float
    phi: float

    @classmethod
    def fit(cls, X: np.ndarray, y: np.ndarray) -> "Ar1Baseline":
        x = np.asarray(X, np.float64)[:, -1]
        y = np.asarray(y, np.float64)
        mu = float(x.mean()) if x.size else 0.0
        xc, yc = x - mu, y - mu
        denom = float(np.dot(xc, xc))
        phi = float(np.dot(xc, yc) / denom) if denom > 0 else 0.0
        return cls(mu=mu, phi=max(-1.0, min(1.0, phi)))

    def predict_batch(self, X: np.ndarray) -> np.ndarray:
        x = np.asarray(X, np.float64)[:, -1]
        return self.mu + self.phi * (x - self.mu)
