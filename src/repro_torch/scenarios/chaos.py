"""Chaos scenario families + the chaos-parity harness.

Three disruption-bearing scenarios pair a workload trace with a seeded
`repro_torch.core.disruption` schedule:

* ``spot-spike`` — flat Poisson mixed workload on spot capacity whose
  cheap instance types are reclaimed aggressively (notice-before-kill);
* ``zone-outage`` — steady mixed workload hit by a correlated zone
  failure at a fixed time;
* ``capacity-crunch`` — the `AutoscalerStress` rate staircase under
  simultaneous spot reclaims *and* pod crash-loops — the worst day the
  autoscaler can have.

Each config's ``build(seed)`` returns the workload :class:`TraceStore`
(so the registry can replay the trace *without* disruptions, like any
scenario) and ``injector(seed)`` returns a **fresh** injector stack
(injectors are stateful: RNG position, crash budgets, zone labels — a
shared instance would leak schedule state across runs and break parity).

The harness half of this module checks the port against the committed
chaos fixture:

* `chaos_spec` — an `ExperimentSpec` wired with the scenario's trace and
  disruption schedule;
* `capture_chaos_trace` — a golden-trace-style spied run that logs every
  bind/evict/complete, the disruption log, and runs the column audit
  after **every** disruption event (`PodStore.audit_columns` on the
  array engine, `Cluster.check_invariants(deep=True)` on the object
  engine) — identical disruption schedules must yield bit-identical
  event sequences on both engines;
* `run_chaos_cell` — resilience metrics for one scenario (recovery time
  after each disruption, lost work, evictions, and the cost delta
  against the same trace run *without* disruptions).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.disruption import (CrashLoopInjector, DisruptionInjector,
                                         SpotReclaimInjector,
                                         ZoneOutageInjector)
from repro_torch.core.workload import mix_templates
from repro_torch.scenarios.generators import AutoscalerStress, _pick_templates
from repro_torch.scenarios.trace import TraceStore


def _flat_mixed_trace(rng: np.random.Generator, n_jobs: int,
                      rate_per_s: float, name: str) -> TraceStore:
    times = np.cumsum(rng.exponential(1.0 / rate_per_s, size=n_jobs))
    templates, weights = mix_templates("mixed")
    tid = _pick_templates(rng, len(templates), weights, n_jobs)
    return TraceStore(templates, tid, times, name=name)


@dataclasses.dataclass
class SpotSpike:
    """Steady mixed workload on flaky spot capacity: cheaper instance
    types are reclaimed more often (per-type MTBR), each reclaim preceded
    by a notice window the binding autoscaler uses to pre-launch
    replacement capacity."""

    n_jobs: int = 400
    rate_per_s: float = 1.0
    mtbr_s: float = 900.0            # reclaim MTBR of the reference type
    notice_s: float = 90.0
    name: str = "spot-spike"

    def build(self, seed: int = 0) -> TraceStore:
        rng = np.random.default_rng(seed)
        return _flat_mixed_trace(rng, self.n_jobs, self.rate_per_s, self.name)

    def injector(self, seed: int = 0) -> DisruptionInjector:
        # Cheap types are flakier — the spot market's actual price/risk
        # trade keyed on Node.node_type (see NECTAR_CATALOG).
        rates = {"m2.tiny": 0.6 * self.mtbr_s,
                 "m2.small": self.mtbr_s,
                 "m2.medium": 1.6 * self.mtbr_s}
        return DisruptionInjector(injectors=(
            SpotReclaimInjector(reclaim_mtbr_s=rates,
                                default_mtbr_s=self.mtbr_s,
                                notice_s=self.notice_s, seed=seed + 17),
        ))


@dataclasses.dataclass
class ZoneOutage:
    """Steady mixed workload hit by one correlated zone failure: every
    live node in a seeded zone dies at ``outage_at_s``."""

    n_jobs: int = 400
    rate_per_s: float = 1.0
    outage_at_s: Tuple[float, ...] = (240.0,)
    zones: Tuple[str, ...] = ("zone-a", "zone-b", "zone-c")
    name: str = "zone-outage"

    def build(self, seed: int = 0) -> TraceStore:
        rng = np.random.default_rng(seed)
        return _flat_mixed_trace(rng, self.n_jobs, self.rate_per_s, self.name)

    def injector(self, seed: int = 0) -> DisruptionInjector:
        return DisruptionInjector(injectors=(
            ZoneOutageInjector(zones=self.zones,
                               outage_times=self.outage_at_s,
                               seed=seed + 29),
        ))


@dataclasses.dataclass
class CapacityCrunch:
    """`AutoscalerStress` staircase under spot reclaims and crash-loops:
    demand spikes exactly while capacity is being reclaimed and software
    is flaking — the compound-disruption worst case."""

    n_jobs: int = 400
    mtbr_s: float = 1_200.0
    notice_s: float = 60.0
    mtbc_s: float = 400.0            # mean time between pod crashes
    restart_budget: int = 3
    name: str = "capacity-crunch"

    def build(self, seed: int = 0) -> TraceStore:
        cfg = dataclasses.replace(AutoscalerStress(), n_jobs=self.n_jobs,
                                  name=self.name)
        return cfg.build(seed)

    def injector(self, seed: int = 0) -> DisruptionInjector:
        return DisruptionInjector(injectors=(
            SpotReclaimInjector(default_mtbr_s=self.mtbr_s,
                                notice_s=self.notice_s, seed=seed + 41),
            CrashLoopInjector(mtbc_s=self.mtbc_s, seed=seed + 43,
                              restart_budget=self.restart_budget),
        ))


CHAOS_SCENARIOS = {
    "spot-spike": SpotSpike(),
    "zone-outage": ZoneOutage(),
    "capacity-crunch": CapacityCrunch(),
}

# Trace length pinned by tests/data/golden_chaos_trace.json: small enough
# to keep the committed fixture and the test wall time bounded, large
# enough that every scenario still evicts, reclaims and audits.
GOLDEN_JOBS = 120


# --- harness ------------------------------------------------------------------

def chaos_spec(name: str, seed: int = 0, n_jobs: Optional[int] = None,
               engine: Optional[str] = None, scheduler: str = "best-fit",
               rescheduler: str = "non-binding", autoscaler: str = "binding",
               with_disruptions: bool = True, obs: object = None):
    """An `ExperimentSpec` for one chaos scenario — trace + fresh
    disruption schedule (or, with ``with_disruptions=False``, the same
    trace undisturbed: the baseline for cost/recovery deltas).  ``obs``
    (an ``repro_torch.obs.ObsConfig``) attaches the flight recorder, which
    captures the disruption decisions — preemption notices, node-fail
    evictions, crash loops — with their attributed inputs."""
    from repro_torch.core.experiment import ExperimentSpec
    cfg = CHAOS_SCENARIOS[name]
    if n_jobs is not None:
        cfg = dataclasses.replace(cfg, n_jobs=n_jobs)
    return ExperimentSpec(
        trace=cfg.build(seed), scheduler=scheduler, rescheduler=rescheduler,
        autoscaler=autoscaler, seed=seed, engine=engine, initial_workers=3,
        failure_injector=cfg.injector(seed) if with_disruptions else None,
        obs=obs)


def capture_chaos_trace(name: str, engine: str, seed: int = 0,
                        n_jobs: Optional[int] = None) -> Dict:
    """Spied chaos run: full event log + disruption log + per-event audits.

    The returned dict is JSON-round-trip normalized, so ``==`` between
    engines (or against the golden fixture) is a bit-exact diff.  Spying
    ``on_unbind`` intentionally forces the object-path eviction — the
    unspied column fast path is exercised by `run_chaos_cell`.
    """
    from repro_torch.core import reset_id_counters
    from repro_torch.core.experiment import build_simulation

    reset_id_counters()
    sim = build_simulation(chaos_spec(name, seed=seed, n_jobs=n_jobs,
                                      engine=engine))
    binds, evictions, completions = [], [], []
    cluster = sim.cluster
    inner_bind, inner_unbind = cluster.on_bind, cluster.on_unbind
    inner_complete = cluster.on_complete

    def on_bind(pod):
        binds.append([pod.uid, pod.incarnation, pod.node_id, pod.bound_time])
        inner_bind(pod)

    def on_unbind(pod):
        evictions.append([pod.uid, pod.incarnation, pod.pending_since])
        inner_unbind(pod)

    def on_complete(pod):
        completions.append([pod.uid, pod.node_id, pod.finish_time])
        inner_complete(pod)

    cluster.on_bind, cluster.on_unbind = on_bind, on_unbind
    cluster.on_complete = on_complete

    audits = [0]

    def on_disruption(s, kind):
        if s.cluster.pod_store is not None:
            s.cluster.pod_store.audit_columns(s.cluster)
        else:
            s.cluster.check_invariants(deep=True)
        audits[0] += 1

    sim.on_disruption = on_disruption
    result = sim.run()
    trace = {
        "scenario": name, "seed": seed, "binds": binds,
        "evictions": evictions, "completions": completions,
        "scale_events": [[n.node_id, n.terminate_time]
                         for n in cluster.terminated],
        "disruption_log": [list(e[:3]) + [list(e[3])]
                           for e in sim.disruption_log],
        "audits": audits[0],
        "result": dataclasses.asdict(result),
    }
    return json.loads(json.dumps(trace))


def _recovery_times(binds: List[List], disruption_log: List) -> List[float]:
    """Seconds from each capacity-loss event until its last victim pod is
    re-bound (victims that never re-bind — e.g. the run drained — are
    skipped rather than scored 0)."""
    out = []
    for t, kind, subject, payload in disruption_log:
        if kind == "node_fail":
            victims = set(payload)        # payload = evicted pod uids
        elif kind == "pod_crash":
            victims = {subject}           # subject = the crashed pod's uid
        else:
            continue   # zone_outage fans out into per-node node_fail entries
        if not victims:
            continue
        per_victim = {}
        for uid, _inc, _node, bt in binds:
            if uid in victims and bt > t:
                per_victim.setdefault(uid, bt)   # first re-bind after t
        if per_victim and len(per_victim) == len(victims):
            out.append(max(per_victim.values()) - t)
    return out


def run_chaos_cell(name: str, seed: int = 0, n_jobs: Optional[int] = None,
                   engine: Optional[str] = None) -> Dict:
    """One resilience row: the disrupted run's recovery/lost-work metrics
    plus the cost delta against the undisturbed baseline of the same
    trace."""
    from repro_torch.core import reset_id_counters
    from repro_torch.core.experiment import run_experiment

    t0 = time.perf_counter()
    trace = capture_chaos_trace(name, engine or "array", seed=seed,
                                n_jobs=n_jobs)
    wall = time.perf_counter() - t0
    reset_id_counters()
    baseline = run_experiment(chaos_spec(name, seed=seed, n_jobs=n_jobs,
                                         engine=engine,
                                         with_disruptions=False))
    r = trace["result"]
    recoveries = _recovery_times(trace["binds"], trace["disruption_log"])
    return {
        "scenario": name, "seed": seed, "engine": engine or "array",
        "completed": r["completed"],
        "failures_injected": r["failures_injected"],
        "preemption_notices": r["preemption_notices"],
        "evictions": r["evictions"],
        "lost_work_s": round(r["lost_work_s"], 3),
        "disruption_events": len(trace["disruption_log"]),
        "audits": trace["audits"],
        "recovery_mean_s": round(float(np.mean(recoveries)), 3)
        if recoveries else 0.0,
        "recovery_max_s": round(float(np.max(recoveries)), 3)
        if recoveries else 0.0,
        "cost": round(r["cost"], 3),
        "cost_baseline": round(baseline.cost, 3),
        "cost_delta": round(r["cost"] - baseline.cost, 3),
        "duration_s": round(r["duration_s"], 1),
        "duration_baseline_s": round(baseline.duration_s, 1),
        "wall_s": round(wall, 3),
    }
