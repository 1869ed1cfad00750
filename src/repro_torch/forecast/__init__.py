"""Workload-rate forecasting, the port of ``repro/forecast``.

* `features` — windowed (history → next-window rate) examples from the
  port's scenario traces; numpy copies of the reference's.
* `baseline` — the online EWMA forecaster and the closed-form AR(1)
  baseline; numpy copies.
* `model` — the learned mLSTM forecaster: ``train_forecaster`` and
  ``save_forecaster``, ``load_forecaster`` →
  ``LearnedForecaster.observe_bin/predict`` and the batched
  ``apply_forecast``, whose mLSTM cell is the CUDA kernel on the card.
"""
from repro_torch.forecast.baseline import Ar1Baseline, EwmaForecaster
from repro_torch.forecast.features import (WindowConfig, bin_rates,
                                           family_examples, make_dataset,
                                           windowed_examples)

__all__ = ["Ar1Baseline", "EwmaForecaster", "WindowConfig", "bin_rates",
           "family_examples", "make_dataset", "windowed_examples"]
