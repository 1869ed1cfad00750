"""Typed parameter space for the policy search.

A `ParamSpace` is an ordered tuple of named parameters — continuous
(`FloatParam`) or categorical (`ChoiceParam`) — with seeded sampling,
validation, and an **exact** encoding to flat float vectors:

* a `FloatParam` gene stores the raw value (identity map);
* a `ChoiceParam` gene stores ``float(index)`` into its choices tuple.

Small integer indices and raw floats both round-trip through the vector
unchanged, so ``space.decode(space.encode(cfg)) == cfg`` holds *exactly*
(``==``, not approximately) — which is what lets the NSGA-II evaluation
cache key on vectors and lets golden fixtures pin configs bit-for-bit.

`default_space()` is the paper-policy search space: the weighted
scheduler's scoring weights, both rescheduler aggressiveness and
autoscaler rate/threshold knobs (Alg. 3–6), and the node-template mix
axis.  `to_cell_spec` maps a config dict onto a `runner.CellSpec`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

Value = Union[float, str]


@dataclasses.dataclass(frozen=True)
class FloatParam:
    """A bounded continuous parameter; values are raw floats in [lo, hi]."""

    name: str
    lo: float
    hi: float

    def __post_init__(self):
        if not self.lo < self.hi:
            raise ValueError(f"{self.name}: need lo < hi, got "
                             f"[{self.lo}, {self.hi}]")

    def sample(self, rng) -> float:
        return float(rng.uniform(self.lo, self.hi))

    def clip(self, v: float) -> float:
        return min(max(float(v), self.lo), self.hi)

    def validate(self, v) -> None:
        if not isinstance(v, float):
            raise TypeError(f"{self.name}: expected float, got {type(v)!r}")
        if not self.lo <= v <= self.hi:
            raise ValueError(f"{self.name}: {v} outside [{self.lo}, {self.hi}]")


@dataclasses.dataclass(frozen=True)
class ChoiceParam:
    """A categorical parameter; encoded as float(index) into `choices`."""

    name: str
    choices: Tuple[str, ...]

    def __post_init__(self):
        if len(self.choices) < 1:
            raise ValueError(f"{self.name}: empty choices")
        if len(set(self.choices)) != len(self.choices):
            raise ValueError(f"{self.name}: duplicate choices")

    def sample(self, rng) -> str:
        return self.choices[int(rng.integers(len(self.choices)))]

    def validate(self, v) -> None:
        if v not in self.choices:
            raise ValueError(f"{self.name}: {v!r} not in {self.choices}")


Param = Union[FloatParam, ChoiceParam]


class ParamSpace:
    """An ordered, named parameter space with exact vector encoding."""

    def __init__(self, params: Sequence[Param]):
        self.params: Tuple[Param, ...] = tuple(params)
        names = [p.name for p in self.params]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate parameter names in {names}")
        self.names: Tuple[str, ...] = tuple(names)

    def __len__(self) -> int:
        return len(self.params)

    def validate(self, cfg: Dict[str, Value]) -> None:
        """Raise unless `cfg` has exactly this space's keys, all in-range."""
        extra = set(cfg) - set(self.names)
        missing = set(self.names) - set(cfg)
        if extra or missing:
            raise ValueError(f"config keys mismatch: extra={sorted(extra)} "
                             f"missing={sorted(missing)}")
        for p in self.params:
            p.validate(cfg[p.name])

    def sample(self, rng) -> Dict[str, Value]:
        """One uniform config.  Draws one value per parameter *in space
        order*, so the stream of configs is a pure function of the rng
        state (sampling is part of the search's determinism contract)."""
        return {p.name: p.sample(rng) for p in self.params}

    def encode(self, cfg: Dict[str, Value]) -> Tuple[float, ...]:
        self.validate(cfg)
        vec = []
        for p in self.params:
            if isinstance(p, FloatParam):
                vec.append(float(cfg[p.name]))
            else:
                vec.append(float(p.choices.index(cfg[p.name])))
        return tuple(vec)

    def decode(self, vec: Sequence[float]) -> Dict[str, Value]:
        if len(vec) != len(self.params):
            raise ValueError(f"vector length {len(vec)} != space size "
                             f"{len(self.params)}")
        cfg: Dict[str, Value] = {}
        for p, v in zip(self.params, vec):
            if isinstance(p, FloatParam):
                cfg[p.name] = p.clip(v)
            else:
                idx = int(round(v))
                if not 0 <= idx < len(p.choices):
                    raise ValueError(f"{p.name}: index {v} out of range")
                cfg[p.name] = p.choices[idx]
        return cfg

    def bounds(self) -> Tuple[Tuple[float, float], ...]:
        """Per-gene (lo, hi) in vector coordinates — choice genes span
        their index range (used by crossover/mutation clipping)."""
        out = []
        for p in self.params:
            if isinstance(p, FloatParam):
                out.append((p.lo, p.hi))
            else:
                out.append((0.0, float(len(p.choices) - 1)))
        return tuple(out)


def default_space() -> ParamSpace:
    """The paper-policy search space (weighted-scheduler scoring
    weights, rescheduler aggressiveness, autoscaler thresholds/rate
    limits, node-template mix).

    Threshold ranges deliberately extend past the feasible utilization
    band [0, 1]: ``scale_out_bypass_util`` at its upper bound never
    fires (pure Alg. 5 rate limiting) and ``scale_in_util_ceiling`` at
    its upper bound always consolidates (pure Alg. 6) — the paper's
    behavior is *inside* the space, not a special case bolted on.
    """
    return ParamSpace((
        FloatParam("w_pack", 0.0, 1.0),
        FloatParam("w_lr", 0.0, 1.0),
        FloatParam("w_bal", 0.0, 1.0),
        FloatParam("max_pod_age_s", 0.0, 240.0),
        FloatParam("provisioning_interval_s", 10.0, 240.0),
        FloatParam("scale_out_bypass_util", 0.5, 2.0),
        FloatParam("scale_in_util_ceiling", 0.05, 2.0),
        ChoiceParam("rescheduler", ("void", "binding", "non-binding")),
        ChoiceParam("autoscaler", ("binding", "non-binding")),
        ChoiceParam("template", ("m2.tiny", "m2.small", "m2.medium")),
    ))


def predictive_space() -> ParamSpace:
    """`default_space()` widened with the predictive autoscaler and its
    lead-time / headroom knobs (forecast-ahead scaling as a search
    axis).

    A separate constructor rather than a widened `default_space()`: the
    NSGA-II golden fixture pins configs drawn from the default space, and
    sampling draws one value per parameter in space order — adding
    parameters (or a third autoscaler choice) would shift that stream and
    silently invalidate the fixture.  The extra knobs are inert for
    non-predictive autoscaler genes, mirroring how the threshold knobs of
    `default_space()` are inert at their paper-behavior bounds.
    """
    params = []
    for p in default_space().params:
        if p.name == "autoscaler":
            params.append(ChoiceParam(
                "autoscaler", ("binding", "non-binding", "predictive")))
        else:
            params.append(p)
    params.append(FloatParam("forecast_lead_s", 30.0, 240.0))
    params.append(FloatParam("forecast_headroom", 1.0, 2.0))
    return ParamSpace(params)


# Table-4 defaults expressed as a point of `default_space()` — the
# paper's Alg. 3–6 chain (non-binding rescheduler, binding autoscaler,
# 60 s knobs, m2.small workers).  Thresholds sit at the bounds where
# they reproduce the unconditional paper behavior; weights (1, 0, 0)
# make the weighted scheduler rank nodes like most-allocated packing.
PAPER_DEFAULT_CONFIG: Dict[str, Value] = {
    "w_pack": 1.0, "w_lr": 0.0, "w_bal": 0.0,
    "max_pod_age_s": 60.0,
    "provisioning_interval_s": 60.0,
    "scale_out_bypass_util": 2.0,
    "scale_in_util_ceiling": 2.0,
    "rescheduler": "non-binding",
    "autoscaler": "binding",
    "template": "m2.small",
}


def to_cell_spec(cfg: Dict[str, Value], scenario: str, seed: int = 0,
                 n_jobs: Optional[int] = None, engine: Optional[str] = None,
                 chaos: bool = False):
    """Map a `default_space()` config onto a runnable `CellSpec`.

    The scheduler is always the weighted scorer; an all-zero weight
    corner (reachable only by mutation clipping every weight to its
    floor) falls back to pure packing rather than constructing an
    unnormalizable scheduler.
    """
    from repro_torch.search.runner import CellSpec
    weights = (cfg["w_pack"], cfg["w_lr"], cfg["w_bal"])
    if sum(weights) <= 0.0:
        weights = (1.0, 0.0, 0.0)
    return CellSpec(
        scenario=scenario, scheduler="weighted",
        autoscaler=cfg["autoscaler"], rescheduler=cfg["rescheduler"],
        seed=seed, n_jobs=n_jobs, engine=engine,
        scheduler_weights=weights,
        max_pod_age_s=cfg["max_pod_age_s"],
        provisioning_interval_s=cfg["provisioning_interval_s"],
        scale_out_bypass_util=cfg["scale_out_bypass_util"],
        scale_in_util_ceiling=cfg["scale_in_util_ceiling"],
        template_name=cfg["template"], chaos=chaos,
        initial_workers=3 if chaos else 1,
        # predictive_space() knobs; absent (default_space configs) they
        # fall back to the CellSpec defaults, which match the
        # PredictiveAutoscaler constructor.
        forecast_lead_s=float(cfg.get("forecast_lead_s", 90.0)),
        forecast_headroom=float(cfg.get("forecast_headroom", 1.15)))
