"""Synthetic workloads (paper §7.1, Tables 1 & 2).

Six job types (three batch sizes that "sleep", three nginx-like services) and
three arrival patterns:

* **bursty** — exponential inter-arrivals, mean 10 s;
* **slow**   — exponential inter-arrivals, mean 60 s;
* **mixed**  — alternating bursty/slow periods, first chosen at random,
  ≥ 10 jobs per period.

NOTE (documented in DESIGN.md §7): the paper's Table 2 swaps the bursty/slow
means relative to the prose; we follow the prose (bursty = 10 s, slow = 60 s),
which also matches the Table 5 pending-time pattern.

A copy of ``repro/core/workload.py``: the scenario generators draw
template ids from these mixes, the lane engine reads each type's
requests, duration and kind, and the serial simulator replays
``generate_workload``'s arrivals.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.pods import PodKind, PodSpec
from repro_torch.core.resources import Resources, gi

# --- Table 1: job types -------------------------------------------------------

JOB_TYPES: Dict[str, PodSpec] = {
    "batch_small": PodSpec("batch_small", PodKind.BATCH,
                           Resources(100, gi(0.3)), duration_s=5 * 60),
    "batch_med": PodSpec("batch_med", PodKind.BATCH,
                         Resources(200, gi(0.6)), duration_s=10 * 60),
    "batch_large": PodSpec("batch_large", PodKind.BATCH,
                           Resources(300, gi(0.9)), duration_s=15 * 60),
    "service_small": PodSpec("service_small", PodKind.SERVICE,
                             Resources(100, gi(1.0)), moveable=True),
    "service_med": PodSpec("service_med", PodKind.SERVICE,
                           Resources(200, gi(1.4)), moveable=True),
    "service_large": PodSpec("service_large", PodKind.SERVICE,
                             Resources(300, gi(2.359)), moveable=True),
}

# --- Table 2: workload mixes (counts per type) --------------------------------

WORKLOAD_MIXES: Dict[str, Dict[str, int]] = {
    "bursty": {"batch_small": 10, "batch_med": 8, "batch_large": 5,
               "service_small": 6, "service_med": 12, "service_large": 9},
    "slow": {"batch_small": 17, "batch_med": 11, "batch_large": 4,
             "service_small": 6, "service_med": 7, "service_large": 5},
    "mixed": {"batch_small": 6, "batch_med": 7, "batch_large": 9,
              "service_small": 7, "service_med": 11, "service_large": 10},
}

BURSTY_MEAN_S = 10.0
SLOW_MEAN_S = 60.0
MIN_JOBS_PER_PERIOD = 10


def mix_templates(name: str):
    """One Table-2 mix as ``(templates, probabilities)``.

    The sampling distribution behind the workload: scenario generators
    (``repro_torch.scenarios.generators``) draw template ids from it instead of
    materializing the finite multiset, which generalizes the paper's 50-job
    mixes to traces of any length."""
    if name not in WORKLOAD_MIXES:
        raise KeyError(f"unknown workload {name!r}; one of {list(WORKLOAD_MIXES)}")
    mix = WORKLOAD_MIXES[name]
    templates = [JOB_TYPES[t] for t in mix]
    total = float(sum(mix.values()))
    return templates, [c / total for c in mix.values()]


@dataclasses.dataclass(frozen=True)
class Arrival:
    time: float
    spec: PodSpec


def _job_multiset(mix: Dict[str, int]) -> List[PodSpec]:
    jobs: List[PodSpec] = []
    for type_name, count in mix.items():
        jobs.extend([JOB_TYPES[type_name]] * count)
    return jobs


def generate_workload(name: str, seed: int = 0,
                      moveable_services: bool = True) -> List[Arrival]:
    """Returns the arrival sequence for one of the paper's three workloads.

    Jobs are drawn without replacement from the Table 2 multiset in random
    order ("jobs were selected at random with equal probability"); delays are
    exponential with the workload's mean.
    """
    if name not in WORKLOAD_MIXES:
        raise KeyError(f"unknown workload {name!r}; one of {list(WORKLOAD_MIXES)}")
    rng = np.random.default_rng(seed)
    jobs = _job_multiset(WORKLOAD_MIXES[name])
    order = rng.permutation(len(jobs))
    jobs = [jobs[i] for i in order]
    if not moveable_services:
        jobs = [dataclasses.replace(j, moveable=False) if j.moveable else j
                for j in jobs]

    arrivals: List[Arrival] = []
    t = 0.0
    if name == "mixed":
        # Alternating bursty/slow periods, first chosen at random, >=10 jobs each.
        bursty_first = bool(rng.integers(0, 2))
        idx = 0
        period = 0
        while idx < len(jobs):
            is_bursty = (period % 2 == 0) == bursty_first
            mean = BURSTY_MEAN_S if is_bursty else SLOW_MEAN_S
            remaining = len(jobs) - idx
            if remaining <= 2 * MIN_JOBS_PER_PERIOD:
                n = remaining          # avoid a trailing too-short period
            else:
                n = int(rng.integers(MIN_JOBS_PER_PERIOD, remaining -
                                     MIN_JOBS_PER_PERIOD + 1))
            for _ in range(n):
                t += float(rng.exponential(mean))
                arrivals.append(Arrival(t, jobs[idx]))
                idx += 1
            period += 1
    else:
        mean = BURSTY_MEAN_S if name == "bursty" else SLOW_MEAN_S
        for spec in jobs:
            t += float(rng.exponential(mean))
            arrivals.append(Arrival(t, spec))
    return arrivals


def make_fleet_job_types(chips_per_host: int = 4,
                         hbm_gb_per_chip: float = 16.0) -> Dict[str, PodSpec]:
    """TPU-fleet job templates with the same small/med/large structure.

    Requests are expressed in the host's resource units: ``cpu_m`` = chip
    milli-shares (1000 per chip), ``mem_mb`` = HBM MB.  Training jobs are
    checkpointable (the fleet's notion of a moveable batch workload is
    resume-from-checkpoint rather than K8s-moveable, see pods.py).
    """
    hbm = chips_per_host * hbm_gb_per_chip * 1024.0
    return {
        "train_small": PodSpec("train_small", PodKind.BATCH,
                               Resources(1000, hbm * 0.10), duration_s=5 * 60,
                               checkpointable=True, checkpoint_interval_s=30),
        "train_med": PodSpec("train_med", PodKind.BATCH,
                             Resources(2000, hbm * 0.20), duration_s=10 * 60,
                             checkpointable=True, checkpoint_interval_s=30),
        "train_large": PodSpec("train_large", PodKind.BATCH,
                               Resources(3000, hbm * 0.30), duration_s=15 * 60,
                               checkpointable=True, checkpoint_interval_s=30),
        "serve_small": PodSpec("serve_small", PodKind.SERVICE,
                               Resources(1000, hbm * 0.25), moveable=True),
        "serve_med": PodSpec("serve_med", PodKind.SERVICE,
                             Resources(2000, hbm * 0.35), moveable=True),
        "serve_large": PodSpec("serve_large", PodKind.SERVICE,
                               Resources(3000, hbm * 0.60), moveable=True),
    }
