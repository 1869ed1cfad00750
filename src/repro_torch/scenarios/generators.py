"""The port's scenario families, as seeded samplers.

Copies of ``HeavyTail``, ``Diurnal``, ``FlashCrowd``, ``MixRamp``,
``AutoscalerStress`` and ``MultiTenant`` from
``repro/scenarios/generators.py``.  Each ``cfg.build(seed)`` makes the
same ``np.random.default_rng(seed)`` draws in the same order as the
reference, so the traces are bit-identical to it.

Arrival processes are sampled by time-rescaling: for an intensity λ(t)
with integrated rate Λ(t), ``tᵢ = Λ⁻¹(Eᵢ)`` where ``Eᵢ`` is a cumulative
sum of unit-mean exponential draws; the inversion is one ``np.interp``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pods import PodSpec
from repro_torch.core.workload import JOB_TYPES, mix_templates
from repro_torch.scenarios.trace import TraceStore

BATCH_TEMPLATES: List[PodSpec] = [
    JOB_TYPES["batch_small"], JOB_TYPES["batch_med"], JOB_TYPES["batch_large"]]
SERVICE_TEMPLATES: List[PodSpec] = [
    JOB_TYPES["service_small"], JOB_TYPES["service_med"],
    JOB_TYPES["service_large"]]


def _normalized(weights: Optional[Sequence[float]], k: int) -> np.ndarray:
    w = (np.full(k, 1.0 / k) if weights is None
         else np.asarray(weights, np.float64))
    if w.shape != (k,) or (w < 0).any() or w.sum() <= 0:
        raise ValueError(f"need {k} non-negative weights with positive sum")
    return w / w.sum()


def _pick_templates(rng: np.random.Generator, k: int,
                    weights: Optional[Sequence[float]], n: int) -> np.ndarray:
    return rng.choice(k, size=n, p=_normalized(weights, k)).astype(np.int32)


def _unit_targets(rng: np.random.Generator, n: int) -> np.ndarray:
    """Cumulative unit-mean exponential targets E₁ < E₂ < … < Eₙ."""
    return np.cumsum(rng.exponential(1.0, size=n))


def _invert_piecewise(targets: np.ndarray, t_breaks: np.ndarray,
                      lam_cum: np.ndarray) -> np.ndarray:
    """tᵢ = Λ⁻¹(Eᵢ) for a piecewise-linear Λ given by breakpoints."""
    assert lam_cum[-1] >= targets[-1], "integrated rate fell short"
    t0 = np.concatenate(([0.0], t_breaks))
    l0 = np.concatenate(([0.0], lam_cum))
    return np.interp(targets, l0, t0)


@dataclasses.dataclass
class Diurnal:
    """Sinusoidal day/night rate: λ(t) = base·(1 + amp·sin(2πt/period))."""

    n_jobs: int = 2_000
    base_rate_per_s: float = 1.0
    period_s: float = 3_600.0
    amplitude: float = 0.6
    noise: float = 0.1
    weights: Optional[Sequence[float]] = None
    name: str = "diurnal"

    def build(self, seed: int = 0) -> TraceStore:
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0, size=self.n_jobs)
        if self.noise > 0:
            gaps = gaps * rng.lognormal(0.0, self.noise, size=self.n_jobs)
        targets = np.cumsum(gaps)
        base, amp, period = (self.base_rate_per_s, self.amplitude,
                             self.period_s)
        horizon = targets[-1] / base * 1.1 + period
        grid = np.linspace(0.0, horizon,
                           max(4096, int(64 * horizon / period)))
        w = 2.0 * np.pi / period
        lam = base * (grid - amp / w * (np.cos(w * grid) - 1.0))
        assert lam[-1] >= targets[-1]
        times = np.interp(targets, lam, grid)
        templates, w_mix = mix_templates("mixed")
        tid = _pick_templates(rng, len(templates),
                              self.weights if self.weights is not None
                              else w_mix, self.n_jobs)
        return TraceStore(templates, tid, times, name=self.name)


@dataclasses.dataclass
class FlashCrowd:
    """2-state Markov-modulated Poisson process: normal ↔ burst regimes."""

    n_jobs: int = 2_000
    base_rate_per_s: float = 0.5
    burst_rate_per_s: float = 8.0
    mean_normal_s: float = 1_200.0
    mean_burst_s: float = 120.0
    weights: Optional[Sequence[float]] = None
    name: str = "flash-crowd"

    def build(self, seed: int = 0) -> TraceStore:
        rng = np.random.default_rng(seed)
        targets = _unit_targets(rng, self.n_jobs)
        pair_mass = (self.base_rate_per_s * self.mean_normal_s
                     + self.burst_rate_per_s * self.mean_burst_s)
        n_pairs = int(np.ceil(targets[-1] / pair_mass * 1.5)) + 4
        while True:
            dwell = np.empty(2 * n_pairs)
            dwell[0::2] = rng.exponential(self.mean_normal_s, size=n_pairs)
            dwell[1::2] = rng.exponential(self.mean_burst_s, size=n_pairs)
            rates = np.empty(2 * n_pairs)
            rates[0::2] = self.base_rate_per_s
            rates[1::2] = self.burst_rate_per_s
            lam_cum = np.cumsum(rates * dwell)
            if lam_cum[-1] >= targets[-1]:
                break
            n_pairs *= 2
        times = _invert_piecewise(targets, np.cumsum(dwell), lam_cum)
        templates, w_mix = mix_templates("bursty")
        tid = _pick_templates(rng, len(templates),
                              self.weights if self.weights is not None
                              else w_mix, self.n_jobs)
        return TraceStore(templates, tid, times, name=self.name)


@dataclasses.dataclass
class HeavyTail:
    """Batch-only jobs whose durations are drawn per row (lognormal or
    Pareto) instead of taken from the template."""

    n_jobs: int = 2_000
    rate_per_s: float = 2.0
    dist: str = "lognormal"
    median_s: float = 120.0
    sigma: float = 1.0
    alpha: float = 1.5
    cap_s: float = 7_200.0
    weights: Optional[Sequence[float]] = None
    name: str = "heavy-tail"

    def build(self, seed: int = 0) -> TraceStore:
        rng = np.random.default_rng(seed)
        times = np.cumsum(rng.exponential(1.0 / self.rate_per_s,
                                          size=self.n_jobs))
        if self.dist == "lognormal":
            dur = rng.lognormal(np.log(self.median_s), self.sigma,
                                size=self.n_jobs)
        elif self.dist == "pareto":
            dur = self.median_s * (1.0 + rng.pareto(self.alpha,
                                                    size=self.n_jobs))
        else:
            raise ValueError(f"dist must be lognormal|pareto, got {self.dist!r}")
        dur = np.clip(dur, 1.0, self.cap_s)
        tid = _pick_templates(rng, len(BATCH_TEMPLATES), self.weights,
                              self.n_jobs)
        return TraceStore(BATCH_TEMPLATES, tid, times, duration_s=dur,
                          name=self.name)


@dataclasses.dataclass
class MixRamp:
    """Poisson arrivals whose service share ramps linearly from
    ``service_frac_start`` to ``service_frac_end`` across the trace."""

    n_jobs: int = 2_000
    rate_per_s: float = 1.0
    service_frac_start: float = 0.05
    service_frac_end: float = 0.5
    batch_weights: Optional[Sequence[float]] = None
    service_weights: Optional[Sequence[float]] = None
    name: str = "mix-ramp"

    def build(self, seed: int = 0) -> TraceStore:
        rng = np.random.default_rng(seed)
        times = np.cumsum(rng.exponential(1.0 / self.rate_per_s,
                                          size=self.n_jobs))
        p = np.linspace(self.service_frac_start, self.service_frac_end,
                        self.n_jobs)
        is_service = rng.random(self.n_jobs) < p
        nb = len(BATCH_TEMPLATES)
        tid = _pick_templates(rng, nb, self.batch_weights, self.n_jobs)
        tid_service = nb + _pick_templates(
            rng, len(SERVICE_TEMPLATES), self.service_weights, self.n_jobs)
        tid = np.where(is_service, tid_service, tid).astype(np.int32)
        return TraceStore(BATCH_TEMPLATES + SERVICE_TEMPLATES, tid, times,
                          name=self.name)


@dataclasses.dataclass
class AutoscalerStress:
    """Rate staircase low→high then cliff back down, repeated: every climb
    forces scale-out under a growing backlog, every cliff leaves idle
    autoscaled nodes for scale-in to reclaim."""

    n_jobs: int = 2_000
    low_rate_per_s: float = 0.2
    high_rate_per_s: float = 4.0
    n_steps: int = 4                 # staircase levels per climb
    epoch_s: float = 300.0           # dwell per level
    batch_only: bool = True          # batch-heavy → nodes fully drain
    name: str = "scale-stress"

    def build(self, seed: int = 0) -> TraceStore:
        rng = np.random.default_rng(seed)
        targets = _unit_targets(rng, self.n_jobs)
        step_rates = np.linspace(self.low_rate_per_s, self.high_rate_per_s,
                                 self.n_steps)
        cycle_mass = step_rates.sum() * self.epoch_s
        n_cycles = int(np.ceil(targets[-1] / cycle_mass)) + 1
        rates = np.tile(step_rates, n_cycles)
        dwell = np.full(rates.size, self.epoch_s)
        lam_cum = np.cumsum(rates * dwell)
        times = _invert_piecewise(targets, np.cumsum(dwell), lam_cum)
        if self.batch_only:
            templates: List[PodSpec] = list(BATCH_TEMPLATES)
            weights = None
        else:
            templates, weights = mix_templates("mixed")
        tid = _pick_templates(rng, len(templates), weights, self.n_jobs)
        return TraceStore(templates, tid, times, name=self.name)


@dataclasses.dataclass
class MultiTenant:
    """Independent tenant streams merged into one interleaved trace.

    Tenant streams are seeded from ``np.random.SeedSequence(seed).spawn``,
    so the composition is a pure function of one seed.  ``n_jobs`` sizes
    the default diurnal/flash-crowd/heavy-tail trio (total jobs, split
    35/35/30); explicit ``tenants`` carry their own sizes, so combining
    the two is rejected."""

    tenants: Tuple = ()              # scenario configs; () -> default trio
    n_jobs: Optional[int] = None     # total across the default trio
    name: str = "multi-tenant"

    def build(self, seed: int = 0) -> TraceStore:
        if self.tenants:
            if self.n_jobs is not None:
                raise ValueError("n_jobs sizes the default tenant trio; "
                                 "size explicit tenant configs directly")
            tenants = self.tenants
        else:
            total = self.n_jobs if self.n_jobs is not None else 2_000
            n1 = int(round(total * 0.35))
            n2 = int(round(total * 0.35))
            tenants = (Diurnal(n_jobs=n1), FlashCrowd(n_jobs=n2),
                       HeavyTail(n_jobs=total - n1 - n2))
        streams = np.random.SeedSequence(seed).spawn(len(tenants))
        parts = [cfg.build(stream) for cfg, stream in zip(tenants, streams)]
        return TraceStore.merge(parts, name=self.name)
