"""Scenario registry: name → seeded TraceStore builder.

The six generator families of :mod:`repro_torch.scenarios.generators`
with their default configs, as in ``repro/scenarios/registry.py``.  The
reference's other names (the paper workloads and the chaos families) are
not ported yet and raise ``KeyError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.scenarios import generators as _g
from repro_torch.scenarios.trace import TraceStore

Builder = Callable[[int, Optional[int]], TraceStore]

# Reference scenario names whose port is still queued (ROADMAP.md).
NOT_PORTED = ("paper-bursty", "paper-slow", "paper-mixed", "spot-spike",
              "zone-outage", "capacity-crunch")


def _family_builder(cfg) -> Builder:
    def build(seed: int, n_jobs: Optional[int]) -> TraceStore:
        c = cfg if n_jobs is None else dataclasses.replace(cfg, n_jobs=n_jobs)
        return c.build(seed)
    return build


_REGISTRY: Dict[str, Builder] = {
    "diurnal": _family_builder(_g.Diurnal()),
    "flash-crowd": _family_builder(_g.FlashCrowd()),
    "heavy-tail": _family_builder(_g.HeavyTail()),
    "mix-ramp": _family_builder(_g.MixRamp()),
    "scale-stress": _family_builder(_g.AutoscalerStress()),
    "multi-tenant": _family_builder(_g.MultiTenant()),
}


def names() -> List[str]:
    return sorted(_REGISTRY)


def build_scenario(name: str, seed: int = 0,
                   n_jobs: Optional[int] = None) -> TraceStore:
    """Build the named scenario's trace; ``n_jobs`` overrides the
    family's default trace length."""
    builder = _REGISTRY.get(name)
    if builder is None:
        if name in NOT_PORTED:
            raise KeyError(
                f"scenario {name!r} is not ported to repro_torch yet "
                f"(ROADMAP.md Queue 1 item 5); ported: {names()}")
        raise KeyError(f"unknown scenario {name!r}; one of {names()}")
    return builder(seed, n_jobs)
