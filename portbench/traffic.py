"""The one traffic generator: a mix file of parameters in, a list of
requests out.

An open loop: each request is due at a fixed time, whatever the system
does.  The sizes are a stratified sample of the mix's distributions
(the quantiles at ``(i + 0.5) / n``) and the arrival gaps the same
quantiles of an exponential, arranged once in an order drawn from the
fixed ``ARRANGEMENT`` seed: one sample path of the arrival process with
its sizes.  A run's seed picks where on that path its window starts (a
rotation) and draws the prompts' tokens.  So every seed offers the same
requests, with the same neighbours, and only the window's two ends and
the tokens change with it: runs of different seeds differ as little as
runs of one seed.

A mix file holds::

    {"arrivals": "poisson",
     "prompt": {"dist": "lognormal", "median": m, "sigma": s,
                "min": lo, "max": hi},          # or "uniform"
     "output": {"dist": "uniform", "min": lo, "max": hi}}

The cell gives the offered rate; the configuration may ask for prompts
over ``prompt_multiple`` tokens to be rounded up to a multiple of it.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List

import numpy as np


# The seed of the one arrangement of sizes and gaps that every run's
# window is a rotation of.
ARRANGEMENT = 20261018


@dataclasses.dataclass
class Offered:
    uid: int
    due: float                 # seconds after the window opens
    prompt: np.ndarray         # int32 token ids
    max_new_tokens: int


def _quantiles(dist: dict, u: np.ndarray) -> np.ndarray:
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        vals = lo + np.floor(u * (hi - lo + 1))
    elif kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        vals = np.round(dist["median"] * np.exp(dist["sigma"] * z))
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    lo, hi = dist.get("min", -math.inf), dist.get("max", math.inf)
    return np.clip(vals, lo, hi).astype(np.int64)


def round_up(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple`` when above it."""
    if multiple <= 0 or n <= multiple:
        return n
    return -(-n // multiple) * multiple


def offered(mix: dict, rate: float, seconds: float, seed: int, vocab: int,
            prompt_multiple: int = 0) -> List[Offered]:
    """The requests due in a window of ``seconds`` at ``rate`` a second,
    ordered by due time; the first is due at 0 and the last before
    ``seconds``."""
    if mix.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    fixed = np.random.default_rng([ARRANGEMENT, n])
    rng = np.random.default_rng(seed)
    turn = int(rng.integers(n))
    prompts, outputs, gaps = (np.roll(fixed.permutation(a), -turn) for a in (
        _quantiles(mix["prompt"], u), _quantiles(mix["output"], u),
        -np.log1p(-u)))
    gaps = gaps * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    out = []
    for i in range(n):
        length = round_up(int(prompts[i]), prompt_multiple)
        toks = rng.integers(0, vocab, length, dtype=np.int32)
        out.append(Offered(uid=i, due=float(due[i]), prompt=toks,
                           max_new_tokens=int(outputs[i])))
    return out
