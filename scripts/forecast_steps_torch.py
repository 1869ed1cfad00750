#!/usr/bin/env python3
"""Val log-MSE of the learned forecaster by training length, the port
beside the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/forecast_steps_torch.py

On the golden dataset (``FORECAST_eval.json``'s 6 families x 48 seeds,
window 30 s / 16 / 2) it trains ``train_forecaster`` at 300 steps (its
default) and 1000 steps (``FORECAST_eval.json``'s) for init seeds 0..5,
in both packages (each from its own init: the port's ``torch.Generator``
draws other numbers than ``jax.random``), and at 300 steps on three
smaller datasets; it prints one JSON line per run with the EWMA and
AR(1) baselines' val log-MSE on the same split (about 4 minutes).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro.forecast import baseline as ref_baseline  # noqa: E402
from repro.forecast import features  # noqa: E402
from repro.forecast import model as ref_model  # noqa: E402
from repro_torch.forecast import model as port_model  # noqa: E402

FAMILIES = ("diurnal", "flash-crowd", "heavy-tail", "mix-ramp",
            "scale-stress", "multi-tenant")


def baselines(data) -> dict:
    ar1 = ref_baseline.Ar1Baseline.fit(data["X_train"], data["y_train"])
    ar1_mse = float(np.mean(
        (np.log1p(np.maximum(ar1.predict_batch(data["X_val"]), 0.0))
         - np.log1p(data["y_val"])) ** 2))
    errs = []
    for hist, target in zip(data["X_val"], data["y_val"]):
        f = ref_baseline.EwmaForecaster()
        for r in hist:
            f.observe_bin(float(r))
        errs.append((np.log1p(f.predict()[0]) - np.log1p(float(target))) ** 2)
    return {"ar1": ar1_mse, "ewma": float(np.mean(errs))}


def run(name, data, steps, seeds) -> None:
    base = baselines(data)
    window = features.WindowConfig()
    for seed in seeds:
        kw = dict(window=window, X_val=data["X_val"], y_val=data["y_val"],
                  seed=seed, steps=steps)
        port = port_model.train_forecaster(data["X_train"], data["y_train"],
                                           device="cpu", **kw).val_mse
        ref = ref_model.train_forecaster(data["X_train"], data["y_train"],
                                         **kw).val_mse
        print(json.dumps({"dataset": name,
                          "train_windows": int(data["X_train"].shape[0]),
                          "steps": steps, "seed": seed,
                          "val_log_mse": {"port": port, "jax": ref, **base},
                          "beats_ar1": {"port": port < base["ar1"],
                                        "jax": ref < base["ar1"]}}),
              flush=True)


def main() -> None:
    window = features.WindowConfig()
    golden = features.make_dataset(FAMILIES, range(48), window)
    for steps in (300, 1000):
        run("golden", golden, steps, range(6))
    for fams, seeds in ((FAMILIES[:3], 6), (FAMILIES, 4), (FAMILIES, 8)):
        run(f"{len(fams)}x{seeds}", features.make_dataset(
            fams, range(seeds), window), 300, (0,))


if __name__ == "__main__":
    main()
