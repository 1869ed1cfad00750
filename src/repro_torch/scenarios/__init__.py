"""Scenario subsystem: columnar workload traces, generators, replay, sweeps.

* :mod:`repro_torch.scenarios.trace` — :class:`TraceStore`, the SoA trace that
  replays straight into the array engine's ``PodStore`` with zero
  per-arrival Python objects;
* :mod:`repro_torch.scenarios.generators` — parameterized scenario families
  (diurnal, flash-crowd MMPP, heavy-tail durations, mix ramps,
  autoscaler stress, multi-tenant composition);
* :mod:`repro_torch.scenarios.adapter` — Borg/Alibaba-style CSV ingestion with
  resource rescaling onto a target node template;
* :mod:`repro_torch.scenarios.registry` — name → builder lookup behind
  ``ExperimentSpec(scenario=...)`` and the cell runner;
* :mod:`repro_torch.scenarios.chaos` — disruption-bearing scenario families
  (spot-spike, zone-outage, capacity-crunch) and the chaos-parity
  harness behind the golden chaos fixture.
"""
from repro_torch.scenarios.adapter import CsvTraceSpec, load_csv_trace
from repro_torch.scenarios.chaos import (CHAOS_SCENARIOS, CapacityCrunch,
                                         SpotSpike, ZoneOutage,
                                         capture_chaos_trace, chaos_spec,
                                         run_chaos_cell)
from repro_torch.scenarios.generators import (AutoscalerStress, Diurnal,
                                              FlashCrowd, HeavyTail, MixRamp,
                                              MultiTenant)
from repro_torch.scenarios.registry import build_scenario, names, register
from repro_torch.scenarios.trace import KIND_BATCH, KIND_SERVICE, TraceStore

__all__ = [
    "TraceStore", "KIND_BATCH", "KIND_SERVICE",
    "Diurnal", "FlashCrowd", "HeavyTail", "MixRamp", "AutoscalerStress",
    "MultiTenant",
    "CHAOS_SCENARIOS", "SpotSpike", "ZoneOutage", "CapacityCrunch",
    "chaos_spec", "capture_chaos_trace", "run_chaos_cell",
    "CsvTraceSpec", "load_csv_trace",
    "build_scenario", "names", "register",
]
