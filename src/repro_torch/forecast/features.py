"""Windowed arrival-rate features from `TraceStore.arrival_time` columns.

A copy of ``repro/forecast/features.py`` over the port's own
``build_scenario``.  The six seeded generator families
(`repro_torch.scenarios.generators`) are the data factory: every
(family, seed, window) triple maps to one fixed array of labeled examples, so train/val membership is a pure function of the
same triple — no RNG is consumed here at all.

An example is ``history_bins`` consecutive per-bin arrival rates followed
by the label: the mean rate over the next ``horizon_bins`` bins.  Rates
(jobs/s) are what the `PredictiveAutoscaler` converts to node demand, so
the forecaster predicts in the same unit it is consumed in.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.scenarios import build_scenario


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """Feature-window geometry shared by extraction, training and the
    online autoscaler binning."""

    bin_s: float = 30.0       # arrival-count bin width (seconds)
    history_bins: int = 16    # model input length
    horizon_bins: int = 2     # label: mean rate over the next this-many bins

    def __post_init__(self):
        if self.bin_s <= 0 or self.history_bins < 1 or self.horizon_bins < 1:
            raise ValueError(f"degenerate window config: {self}")


def bin_rates(arrival_time: np.ndarray, bin_s: float,
              n_bins: Optional[int] = None) -> np.ndarray:
    """Per-bin arrival rate (jobs/s) of a sorted arrival-time column.

    The trace's last arrival closes the series: bins past it would read as
    spurious zero-rate tail (the scenario *ended*, demand didn't vanish)."""
    t = np.asarray(arrival_time, np.float64)
    if t.size == 0:
        return np.zeros(0 if n_bins is None else n_bins, np.float64)
    if n_bins is None:
        n_bins = int(np.floor(float(t[-1]) / bin_s)) + 1
    idx = np.minimum((t / bin_s).astype(np.int64), n_bins - 1)
    counts = np.bincount(idx, minlength=n_bins)[:n_bins]
    return counts.astype(np.float64) / bin_s


def windowed_examples(rates: np.ndarray, cfg: WindowConfig
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Slide (history → next-horizon-mean) over a rate series.

    Returns ``X`` of shape (n, history_bins) and ``y`` of shape (n,);
    empty (0-row) arrays when the series is shorter than one example."""
    H, K = cfg.history_bins, cfg.horizon_bins
    rates = np.asarray(rates, np.float64)
    n = rates.size - H - K + 1
    if n <= 0:
        return (np.zeros((0, H), np.float64), np.zeros(0, np.float64))
    windows = np.lib.stride_tricks.sliding_window_view(rates, H + K)[:n]
    X = windows[:, :H].copy()
    y = windows[:, H:].mean(axis=1)
    return X, y


def family_examples(family: str, seed: int, cfg: WindowConfig,
                    n_jobs: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Examples for one (family, seed): build the registry scenario, bin
    its arrival column, window it.  Deterministic end to end."""
    trace = build_scenario(family, seed=seed, n_jobs=n_jobs)
    return windowed_examples(bin_rates(trace.arrival_time, cfg.bin_s), cfg)


def is_val_seed(seed: int) -> bool:
    """Val membership: a pure function of the seed (every 4th seed), so
    the split needs no RNG and never drifts with iteration order."""
    return seed % 4 == 3


def make_dataset(families: Sequence[str], seeds: Sequence[int],
                 cfg: WindowConfig, n_jobs: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
    """Stacked train/val examples over families × seeds.

    Whole (family, seed) traces go to exactly one split (`is_val_seed`) —
    splitting within a trace would leak overlapping windows across the
    boundary."""
    tr_x, tr_y, va_x, va_y = [], [], [], []
    for family in families:
        for seed in seeds:
            X, y = family_examples(family, seed, cfg, n_jobs=n_jobs)
            if X.shape[0] == 0:
                continue
            (va_x if is_val_seed(seed) else tr_x).append(X)
            (va_y if is_val_seed(seed) else tr_y).append(y)
    H = cfg.history_bins
    empty = lambda: np.zeros((0, H), np.float64)     # noqa: E731
    return {
        "X_train": np.concatenate(tr_x) if tr_x else empty(),
        "y_train": np.concatenate(tr_y) if tr_y else np.zeros(0),
        "X_val": np.concatenate(va_x) if va_x else empty(),
        "y_val": np.concatenate(va_y) if va_y else np.zeros(0),
    }
