"""Replaying the train fixture ``tests/data/torch_train_golden.npz``: a
reference run of 3 AdamW steps of a 3-layer float32 RecurrentGemma twin
(its initial parameters, each step's loss, grad norm and lr, and the
parameters after the last step), and the bounds the port is held to.

The CPU tests, the card tests and ``chip_smoke.py`` all replay it
through :func:`replay` and compare with :data:`TOL`.
"""
import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.models.params import (leaves_with_paths, map_tree,
                                       params_from_numpy)
from repro_torch.train import train_step as ts
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptimizerConfig

# Relative bounds, float32 compute on both sides from the same parameters
# and batches: losses and grad norms are sums over the same terms in
# other orders; the parameters' update after the last step in norm
# (AdamW's m / (sqrt(v) + eps) maps a gradient near eps onto a step
# anywhere between 0 and lr, so no bound is put on single elements).
TOL = {"loss": 1e-5, "grad_norm": 1e-4, "lr": 1e-6, "update_rel": 1e-3}


def setup(fx: Dict[str, np.ndarray], device) -> Tuple:
    """The fixture's config, optimizer, data and initial parameters."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", tiny=True),
                              dtype="float32",
                              ce_chunk=int(fx["ce_chunk"]))
    opt_cfg = OptimizerConfig(learning_rate=float(fx["learning_rate"]),
                              warmup_steps=int(fx["warmup_steps"]),
                              total_steps=int(fx["total_steps"]))
    data_cfg = DataConfig(batch_size=int(fx["batch_size"]),
                          seq_len=int(fx["seq_len"]),
                          accum=int(fx["accum"]), seed=0)
    tree = map_tree(lambda path, _: fx["init/" + "/".join(map(str, path))],
                    tf.model_specs(cfg))
    return cfg, opt_cfg, data_cfg, params_from_numpy(tree, device)


def update_rel(p0: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
               got: Dict[str, np.ndarray]) -> float:
    """||(got - p0) - (want - p0)|| / ||want - p0|| over every leaf."""
    keys = sorted(want)
    d_want = np.concatenate([(want[k] - p0[k]).ravel() for k in keys])
    d_got = np.concatenate([(got[k] - p0[k]).ravel() for k in keys])
    return float(np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want))


def replay(fx: Dict[str, np.ndarray], device) -> Dict:
    """Runs the fixture's steps through ``make_train_step`` on ``device``
    and compares them with the recorded run: each step's metrics, the
    update's relative error, and each quantity's worst share of its
    bound in :data:`TOL` (at most 1 where the replay agrees)."""
    cfg, opt_cfg, data_cfg, params = setup(fx, device)
    state = ts.TrainState(params, ts.init_opt_state(params))
    step = ts.make_train_step(cfg, opt_cfg, accum=data_cfg.accum)
    data = SyntheticLM(cfg, data_cfg)
    shares: Dict[str, float] = {}
    per_step: List[Dict[str, float]] = []
    for s in range(int(fx["steps"])):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(s).items()}
        state, m = step(state, batch)
        got = {k: float(m[k]) for k in ("loss", "grad_norm", "lr")}
        per_step.append(got)
        for key, value in got.items():
            want = float(fx[key][s])
            share = abs(value - want) / (TOL[key] * abs(want))
            shares[key] = max(shares.get(key, 0.0), share)
    p0, want = ({k[len(pre):]: v for k, v in fx.items() if k.startswith(pre)}
                for pre in ("init/", "final/"))
    got = {"/".join(map(str, path)): t.cpu().numpy()
           for path, t in leaves_with_paths(state.params)}
    rel = update_rel(p0, want, got)
    shares["update_rel"] = rel / TOL["update_rel"]
    return {"cfg": cfg, "accum": data_cfg.accum, "per_step": per_step,
            "update_rel_err": rel, "worst_share_of_tol": shares,
            "params_max_abs_err": max(float(np.abs(got[k] - want[k]).max())
                                      for k in want)}
