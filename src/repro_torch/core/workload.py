"""The paper's six job types and three mixes as plain data (Tables 1 & 2).

A copy of the data in ``repro/core/workload.py`` and ``gi`` from
``repro/core/resources.py``: the scenario generators draw template ids
from these mixes, and the lane engine reads each type's requests,
duration and kind.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

BATCH = "batch"
SERVICE = "service"


def gi(x: float) -> float:
    """Gibibytes -> MB (paper requests are written in Gi)."""
    return x * 1024.0


@dataclasses.dataclass(frozen=True)
class Resources:
    """(compressible CPU milli-units, non-compressible memory MB)."""

    cpu_m: int = 0
    mem_mb: float = 0.0


@dataclasses.dataclass(frozen=True)
class JobType:
    """One pod template: requests, nominal runtime (batch) and kind."""

    type_name: str
    kind: str
    requests: Resources
    duration_s: float = 0.0


JOB_TYPES: Dict[str, JobType] = {
    "batch_small": JobType("batch_small", BATCH,
                           Resources(100, gi(0.3)), duration_s=5 * 60),
    "batch_med": JobType("batch_med", BATCH,
                         Resources(200, gi(0.6)), duration_s=10 * 60),
    "batch_large": JobType("batch_large", BATCH,
                           Resources(300, gi(0.9)), duration_s=15 * 60),
    "service_small": JobType("service_small", SERVICE,
                             Resources(100, gi(1.0))),
    "service_med": JobType("service_med", SERVICE,
                           Resources(200, gi(1.4))),
    "service_large": JobType("service_large", SERVICE,
                             Resources(300, gi(2.359))),
}

WORKLOAD_MIXES: Dict[str, Dict[str, int]] = {
    "bursty": {"batch_small": 10, "batch_med": 8, "batch_large": 5,
               "service_small": 6, "service_med": 12, "service_large": 9},
    "slow": {"batch_small": 17, "batch_med": 11, "batch_large": 4,
             "service_small": 6, "service_med": 7, "service_large": 5},
    "mixed": {"batch_small": 6, "batch_med": 7, "batch_large": 9,
              "service_small": 7, "service_med": 11, "service_large": 10},
}


def mix_templates(name: str):
    """One Table-2 mix as ``(templates, probabilities)``."""
    if name not in WORKLOAD_MIXES:
        raise KeyError(f"unknown workload {name!r}; one of {list(WORKLOAD_MIXES)}")
    mix = WORKLOAD_MIXES[name]
    templates = [JOB_TYPES[t] for t in mix]
    total = float(sum(mix.values()))
    return templates, [c / total for c in mix.values()]
