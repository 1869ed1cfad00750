"""Spot-market disruptions (robustness extension; paper §8 "reliability").

`repro_torch.core.failures.FailureInjector` models independent hardware loss.
Real fleets built on preemptible capacity see three *additional* disruption
shapes, each with its own event kind in `repro_torch.core.simulation`:

* `SpotReclaimInjector` — the provider reclaims a spot instance, but sends
  a **notice** (`NODE_NOTICE`) `notice_s` seconds before the kill.  The
  notice taints the node (no new placements) and gives the autoscaler a
  head start (`notify_preemption_notice`) so replacement capacity boots
  while the doomed node drains.  Reclaim pressure is per instance type —
  cheap types are flakier — keyed on `Node.node_type`.
* `ZoneOutageInjector` — correlated failure: nodes carry a zone label and
  a `ZONE_OUTAGE` event kills every live node in one seeded zone at once.
* `CrashLoopInjector` — software failure: a bound batch pod crashes
  (`POD_CRASH`), restarts with exponential backoff, and is abandoned after
  `restart_budget` crashes.

All injectors speak the `FailureInjector` protocol (`prime(sim)` /
`arm_node(sim, node)`) so they plug into `ExperimentSpec.failure_injector`
unchanged; `DisruptionInjector` composes several into one.  Every random
draw comes from a per-injector `np.random.default_rng(seed)` and both
engines replay the identical event sequence — disruption schedules are
part of the parity contract (``capture_chaos_trace`` compares them).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import Node, NodeState
from repro_torch.core.simulation import NODE_NOTICE, POD_CRASH, ZONE_OUTAGE
from repro_torch.obs.recorder import R_CRASH, R_UNSPEC


@dataclasses.dataclass
class SpotReclaimInjector:
    """Per-instance-type spot reclaims with a notice-before-kill window.

    ``reclaim_mtbr_s`` maps ``Node.node_type`` to the mean time between
    reclaims for that type; types absent from the map use
    ``default_mtbr_s`` (``None`` → that type is never reclaimed).  Static
    nodes model on-demand capacity and are exempt unless
    ``arm_static_nodes`` is set.
    """

    reclaim_mtbr_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    default_mtbr_s: Optional[float] = None
    notice_s: float = 120.0
    seed: int = 0
    arm_static_nodes: bool = False

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def prime(self, sim) -> None:
        for node in sim.cluster.nodes.values():
            if self.arm_static_nodes or node.autoscaled:
                self.arm_node(sim, node)

    def arm_node(self, sim, node: Node) -> None:
        if not (self.arm_static_nodes or node.autoscaled):
            return
        mtbr = self.reclaim_mtbr_s.get(node.node_type, self.default_mtbr_s)
        if mtbr is None or mtbr <= 0.0 or mtbr == float("inf"):
            return   # this instance type is never reclaimed
        ttr = float(self._rng.exponential(mtbr))
        sim.push(sim.now + ttr, NODE_NOTICE, (node, self.notice_s))


@dataclasses.dataclass
class ZoneOutageInjector:
    """Correlated zone failure.

    Nodes are labelled round-robin over ``zones`` in the deterministic
    order they are armed (static nodes at `prime`, then `NODE_READY`
    order — identical on both engines).  Each outage event draws one zone
    and fails every live labelled node in it via `sim.fail_node`, so the
    victims flow through the ordinary NODE_FAIL recovery path (bulk
    column eviction, autoscaler cleanup, cost retirement).

    Schedule: either a fixed list of ``outage_times`` (absolute sim
    seconds) or a seeded renewal process with ``mean_interval_s``.
    PROVISIONING nodes are unlabelled (``zone == ""``) until they are
    armed at readiness, so an outage never targets capacity that has not
    booted — the provider's control plane, not the zone, owns it.
    """

    zones: Tuple[str, ...] = ("zone-a", "zone-b", "zone-c")
    outage_times: Tuple[float, ...] = ()
    mean_interval_s: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._next_zone = 0
        if self.outage_times and self.mean_interval_s is not None:
            raise ValueError("pass outage_times or mean_interval_s, not both")

    def _label(self, node: Node) -> None:
        if not node.zone:
            node.zone = self.zones[self._next_zone % len(self.zones)]
            self._next_zone += 1

    def prime(self, sim) -> None:
        for node in sim.cluster.nodes.values():
            self._label(node)
        for t in self.outage_times:
            sim.push(float(t), ZONE_OUTAGE, self)
        if self.mean_interval_s is not None:
            self._schedule_next(sim)

    def arm_node(self, sim, node: Node) -> None:
        self._label(node)

    def _schedule_next(self, sim) -> None:
        dt = float(self._rng.exponential(self.mean_interval_s))
        sim.push(sim.now + dt, ZONE_OUTAGE, self)

    def on_outage(self, sim) -> None:
        zone = self.zones[int(self._rng.integers(len(self.zones)))]
        victims = [node for node in list(sim.cluster.nodes.values())
                   if node.zone == zone
                   and node.state != NodeState.TERMINATED]
        sim.disruption_log.append(
            (sim.now, "zone_outage", zone, [n.node_id for n in victims]))
        for node in victims:
            sim.fail_node(node)
        if self.mean_interval_s is not None:
            self._schedule_next(sim)


@dataclasses.dataclass
class CrashLoopInjector:
    """Software crash-loops over bound batch pods.

    Every ``~Exp(mtbc_s)`` seconds one currently bound batch pod (chosen
    uniformly among those still under budget and past their backoff
    window) crashes: it is evicted ``failed=True`` and re-pends through
    the normal recovery machinery.  Each crash doubles the pod's backoff
    (``backoff_base_s * 2**(n-1)``) during which it cannot be chosen
    again; after ``restart_budget`` crashes the pod is never re-targeted
    (the restart budget is exhausted — it still runs, we just stop
    kicking it).
    """

    mtbc_s: float = 600.0
    seed: int = 0
    restart_budget: int = 3
    backoff_base_s: float = 60.0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._crashes: Dict[int, int] = {}      # pod uid -> crash count
        self._eligible_at: Dict[int, float] = {}  # uid -> backoff expiry

    def prime(self, sim) -> None:
        self._schedule_next(sim)

    def arm_node(self, sim, node: Node) -> None:
        pass   # crash-loops target pods, not nodes

    def _schedule_next(self, sim) -> None:
        dt = float(self._rng.exponential(self.mtbc_s))
        sim.push(sim.now + dt, POD_CRASH, self)

    def on_crash_event(self, sim) -> None:
        candidates = [uid for uid in sim.orch.bound_batch_uids()
                      if self._crashes.get(uid, 0) < self.restart_budget
                      and self._eligible_at.get(uid, 0.0) <= sim.now]
        if candidates:
            # Draw only when there is a choice: an empty tick must not
            # consume randomness, or the schedule would depend on how
            # often the workload happens to be idle.
            uid = candidates[int(self._rng.integers(len(candidates)))]
            pod = sim.orch.bound_batch_pod(uid)
            n = self._crashes.get(uid, 0) + 1
            self._crashes[uid] = n
            self._eligible_at[uid] = (
                sim.now + self.backoff_base_s * 2.0 ** (n - 1))
            obs = sim.obs
            if obs is not None:
                obs.reason = R_CRASH   # eviction attribution context
            try:
                sim.cluster.unbind(pod, sim.now, failed=True)
            finally:
                if obs is not None:
                    obs.reason = R_UNSPEC
            sim.disruption_log.append((sim.now, "pod_crash", uid, [n]))
        self._schedule_next(sim)

    def crash_counts(self) -> Dict[int, int]:
        return dict(self._crashes)


@dataclasses.dataclass
class DisruptionInjector:
    """Composite: fans `prime`/`arm_node` out to several injectors."""

    injectors: Tuple[object, ...] = ()

    def prime(self, sim) -> None:
        for inj in self.injectors:
            inj.prime(sim)

    def arm_node(self, sim, node: Node) -> None:
        for inj in self.injectors:
            inj.arm_node(sim, node)
