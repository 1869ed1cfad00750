"""Scenario registry: name → seeded TraceStore builder.

As ``repro/scenarios/registry.py``: a scenario *name* resolves to a
builder ``fn(seed, n_jobs) -> TraceStore``, so experiment specs and cells
stay plain data (a string + a seed) while traces stay columnar.

Built-ins:

* ``paper-bursty`` / ``paper-slow`` / ``paper-mixed`` — the paper's three
  §7.1 workloads, produced by ``generate_workload`` and columnarized
  bit-compatibly (``n_jobs`` is ignored: Table 2 fixes them at 50 jobs);
* ``diurnal``, ``flash-crowd``, ``heavy-tail``, ``mix-ramp``,
  ``scale-stress``, ``multi-tenant`` — the generator families of
  ``repro_torch.scenarios.generators`` with their default configs.

``register`` adds custom scenarios (idempotent per name unless
``overwrite=True``); use a config dataclass directly when you need
non-default parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core.workload import WORKLOAD_MIXES, generate_workload
from repro_torch.scenarios import generators as _g
from repro_torch.scenarios.trace import TraceStore

Builder = Callable[[int, Optional[int]], TraceStore]

_REGISTRY: Dict[str, Builder] = {}


def register(name: str, builder: Builder, *, overwrite: bool = False) -> None:
    """Add ``builder(seed, n_jobs) -> TraceStore`` under ``name``."""
    if name in _REGISTRY and not overwrite:
        raise KeyError(f"scenario {name!r} already registered")
    _REGISTRY[name] = builder


def names() -> List[str]:
    return sorted(_REGISTRY)


def build_scenario(name: str, seed: int = 0,
                   n_jobs: Optional[int] = None) -> TraceStore:
    """Build the named scenario's trace.  ``n_jobs`` overrides the family's
    default trace length (ignored by the fixed-size paper workloads)."""
    builder = _REGISTRY.get(name)
    if builder is None:
        raise KeyError(f"unknown scenario {name!r}; one of {names()}")
    return builder(seed, n_jobs)


def _paper_builder(workload: str) -> Builder:
    def build(seed: int, n_jobs: Optional[int]) -> TraceStore:
        # Table 2 fixes the job count; n_jobs is accepted (and ignored) so
        # sweep code can treat every builder uniformly.
        return TraceStore.from_arrivals(generate_workload(workload, seed=seed),
                                        name=f"paper-{workload}")
    return build


def _family_builder(cfg) -> Builder:
    def build(seed: int, n_jobs: Optional[int]) -> TraceStore:
        c = cfg
        if (n_jobs is not None
                and any(f.name == "n_jobs" for f in dataclasses.fields(cfg))):
            c = dataclasses.replace(cfg, n_jobs=n_jobs)
        return c.build(seed)
    return build


for _w in WORKLOAD_MIXES:
    register(f"paper-{_w}", _paper_builder(_w))

register("diurnal", _family_builder(_g.Diurnal()))
register("flash-crowd", _family_builder(_g.FlashCrowd()))
register("heavy-tail", _family_builder(_g.HeavyTail()))
register("mix-ramp", _family_builder(_g.MixRamp()))
register("scale-stress", _family_builder(_g.AutoscalerStress()))
register("multi-tenant", _family_builder(_g.MultiTenant()))


# Chaos families (repro_torch.scenarios.chaos).  Registered builders produce
# only the workload trace — the disruption schedule rides on
# ExperimentSpec.failure_injector, wired by chaos.chaos_spec (a scenario
# name alone can't carry the stateful injector stack).
from repro_torch.scenarios import chaos as _chaos   # noqa: E402  (needs register)

for _name, _cfg in _chaos.CHAOS_SCENARIOS.items():
    register(_name, _family_builder(_cfg))
