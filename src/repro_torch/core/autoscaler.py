"""Autoscalers (paper §6.3, Algorithms 5, 6, 7).

Scale-out policies:

* **Void** — ignore scale requests (static cluster).
* **Simple / non-binding (NBAS, Alg. 5)** — launch at most one instance per
  ``provisioning_interval`` (set to the provisioning delay + contingency).
* **Binding (BAS, Alg. 7)** — track pod↔provisioning-node associations: a pod
  already assigned to a booting node never triggers another launch, and a
  booting node with spare planned room absorbs further unschedulable pods.

Scale-in (Alg. 6) is shared by both active autoscalers and runs only after a
fully successful scheduling cycle:

1. terminate empty dynamically-created nodes;
2. drain nodes whose pods are all moveable *and* all placeable elsewhere;
3. for mixed moveable+batch nodes whose moveables are placeable elsewhere,
   evict the moveables and **taint** the node so it drains as batch completes.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import engine as _engine
from repro_torch.core.cluster import Cluster, Node, NodeState
from repro_torch.core.pods import Pod
from repro_torch.core.rescheduler import _ShadowBase, _ShadowCapacity
from repro_torch.core.resources import Resources
from repro_torch.obs.recorder import (R_CONSOLIDATE, R_UNSPEC, SO_ABSORBED,
                                      SO_ASSOCIATED, SO_LAUNCH, SO_LIMITED,
                                      SO_PRELAUNCH)


class NodeProvider(abc.ABC):
    """What the autoscaler needs from the cloud adapter (repro_torch.cloud)."""

    @abc.abstractmethod
    def launch_node(self, now: float) -> Node:
        """Request a new worker; returns it in PROVISIONING state."""

    @abc.abstractmethod
    def terminate_node(self, node: Node, now: float) -> None:
        """Deprovision (stops billing)."""


class Autoscaler(abc.ABC):
    name = "autoscaler"

    #: Set (by instances) that want `observe_arrivals` called with every
    #: arrival batch.  A plain class attribute so the simulation's hot
    #: path can gate on one attribute read; False keeps existing
    #: autoscalers' event handling byte-identical.
    observes_arrivals = False

    def __init__(self, provider: NodeProvider,
                 scale_in_util_ceiling: Optional[float] = None):
        self.provider = provider
        # Observability recorder (repro_torch.obs.ObsRecorder.attach sets it);
        # None = compiled out — decision sites pay one is-None test.
        self.obs = None
        # Policy-search knob (the "lower threshold" of threshold-based
        # cluster autoscalers): run Alg. 6 consolidation only while mean
        # RAM utilization is at or below this ceiling — a busy cluster
        # skips the drain/taint pass entirely.  None (default) preserves
        # the paper's unconditional scale-in.
        self.scale_in_util_ceiling = scale_in_util_ceiling
        # Version-invalidated shadow snapshot shared by the Alg. 6
        # placeability checks (same cache the reschedulers use): step 2/3
        # candidates that don't consolidate reuse one base instead of
        # re-snapshotting the free vectors per candidate.
        self._shadow_base = _ShadowBase()

    @abc.abstractmethod
    def scale_out(self, cluster: Cluster, pod: Pod, now: float) -> None:
        """Called per unschedulable pod after rescheduling failed."""

    def scale_in(self, cluster: Cluster, now: float) -> List[str]:
        """Alg. 6; returns ids of nodes terminated or tainted (for logs)."""
        return []

    def notify_node_ready(self, node: Node) -> None:
        """Provider callback once a node joins the cluster."""

    def notify_node_lost(self, node: Node) -> None:
        """``node`` died (failure/reclaim), possibly while still
        PROVISIONING: drop any provisioning association so its pods can
        trigger replacement capacity instead of staying stranded.
        Default: stateless autoscalers have nothing to clean up."""

    def notify_node_removed(self, node: Node) -> None:
        """Scale-in (Alg. 6) removed ``node`` from the cluster.  A node
        that leaves this way never gets its pending NODE_FAIL delivered
        (the kill early-returns once the node is gone), so per-node
        bookkeeping keyed on the node id must be released here.
        Default: stateless autoscalers track nothing per node."""

    def notify_preemption_notice(self, cluster: Cluster, node: Node,
                                 now: float) -> None:
        """``node`` received a spot reclaim notice and will be killed when
        the notice window closes (``Simulation._on_node_notice``).
        Default: do nothing — react after the kill like any failure."""

    def observe_arrivals(self, times, cpu_m=None, mem_mb=None) -> None:
        """Arrival observation feed (only delivered when
        ``observes_arrivals`` is True): the batch's arrival instants plus,
        when available, per-arrival requested cpu_m/mem_mb columns.
        Default: reactive autoscalers ignore demand history."""

    def on_cycle(self, cluster: Cluster, now: float) -> None:
        """Per-scheduling-cycle hook, called before placement.  Default:
        no-op — the paper's autoscalers act only on unschedulable pods."""

    # -- shared Alg. 6 body ----------------------------------------------------
    @staticmethod
    def _step1_candidates(cluster: Cluster) -> List[Node]:
        """Empty dynamically-created nodes (READY or TAINTED), in cluster
        insertion order (slots are append-only, so ascending slot order is
        insertion order — termination order is behaviour)."""
        arr = cluster.arrays
        if arr is not None:
            state = arr.live("state")
            mask = (arr.live("active") & arr.live("autoscaled")
                    & (arr.live("pod_count") == 0)
                    & ((state == _engine.STATE_READY)
                       | (state == _engine.STATE_TAINTED)))
            return [cluster.node_by_slot(int(s)) for s in np.nonzero(mask)[0]]
        return [node for node in list(cluster.nodes.values())
                if (node.autoscaled and not node.pods
                    and node.state in (NodeState.READY, NodeState.TAINTED))]

    @staticmethod
    def _step23_candidates(cluster: Cluster) -> List[Node]:
        """Non-empty autoscaled READY nodes, in cluster insertion order."""
        arr = cluster.arrays
        if arr is not None:
            mask = (arr.live("active") & arr.live("autoscaled")
                    & (arr.live("pod_count") > 0)
                    & (arr.live("state") == _engine.STATE_READY))
            return [cluster.node_by_slot(int(s)) for s in np.nonzero(mask)[0]]
        return [node for node in list(cluster.nodes.values())
                if node.autoscaled and node.state == NodeState.READY
                and node.pods]

    def _utilization(self, cluster: Cluster) -> float:
        """Mean RAM req/cap ratio over READY|TAINTED nodes — the Table-5
        quantity the threshold knobs gate on (0.0 on an empty cluster).
        ``utilization_totals`` is incremental on the array engine and its
        fsum reduction is flush-order independent, so reading it here does
        not disturb the 20 s sampler."""
        n_nodes, ram_sum, _cpu, _ppn = cluster.utilization_totals()
        return ram_sum / n_nodes if n_nodes else 0.0

    def _scale_in_impl(self, cluster: Cluster, now: float) -> List[str]:
        if (self.scale_in_util_ceiling is not None
                and self._utilization(cluster) > self.scale_in_util_ceiling):
            return []
        touched: List[str] = []
        obs = self.obs

        # 1. Shut down empty dynamically-created nodes (READY or TAINTED).
        for node in self._step1_candidates(cluster):
            if obs is not None:   # record before removal mutates utilization
                obs.scale_in(now, node.node_id, 1)
            self.provider.terminate_node(node, now)
            cluster.remove_node(node, now)
            self.notify_node_removed(node)
            touched.append(node.node_id)

        # 2./3. Consolidate moveable pods off candidate nodes.
        if obs is not None:
            obs.reason = R_CONSOLIDATE   # eviction attribution context
        try:
            for node in self._step23_candidates(cluster):
                if node.has_only_moveable():
                    if self._all_placeable(cluster, node,
                                           node.moveable_pods()):
                        pods = list(node.pods.values())
                        if obs is not None:
                            obs.scale_in(now, node.node_id, 2, len(pods))
                        for pod in pods:
                            cluster.unbind(pod, now)   # recreated next cycle
                        self.provider.terminate_node(node, now)
                        cluster.remove_node(node, now)
                        self.notify_node_removed(node)
                        touched.append(node.node_id)
                elif node.has_moveable_and_batch():
                    movers = node.moveable_pods()
                    if movers and self._all_placeable(cluster, node, movers):
                        if obs is not None:
                            obs.scale_in(now, node.node_id, 3, len(movers))
                        for pod in movers:
                            cluster.unbind(pod, now)
                        node.taint()                # drains as batch completes
                        touched.append(node.node_id)
        finally:
            if obs is not None:
                obs.reason = R_UNSPEC
        return touched

    def _all_placeable(self, cluster: Cluster, exclude: Node,
                       pods: List[Pod]) -> bool:
        """True iff *all* of `pods` fit on other nodes (shadow accounting)."""
        base = self._shadow_base if cluster.arrays is not None else None
        shadow = _ShadowCapacity(cluster, exclude=exclude, base=base)
        try:
            ordered = sorted(pods, key=lambda p: (p.requests.mem_mb, p.uid),
                             reverse=True)
            return all(shadow.place_best_fit(p.requests) is not None
                       for p in ordered)
        finally:
            shadow.rollback()


class VoidAutoscaler(Autoscaler):
    """Paper: ignores scale-out and scale-in — a fixed-size cluster."""

    name = "void"

    def scale_out(self, cluster: Cluster, pod: Pod, now: float) -> None:
        return

    def scale_in(self, cluster: Cluster, now: float) -> List[str]:
        return []


class SimpleAutoscaler(Autoscaler):
    """Paper Alg. 5 (+6) — the *non-binding* autoscaler (NBAS)."""

    name = "non-binding"

    def __init__(self, provider: NodeProvider,
                 provisioning_interval_s: float = 60.0,
                 scale_out_bypass_util: Optional[float] = None,
                 scale_in_util_ceiling: Optional[float] = None):
        super().__init__(provider, scale_in_util_ceiling=scale_in_util_ceiling)
        self.provisioning_interval_s = provisioning_interval_s
        # Policy-search knob (the "upper threshold"): when mean RAM
        # utilization reaches this level the Alg. 5 rate limit is bypassed
        # — a saturated cluster may launch every cycle instead of once per
        # provisioning interval.  None (default) keeps the paper's
        # unconditional rate limit.
        self.scale_out_bypass_util = scale_out_bypass_util
        self._last_launch: Optional[float] = None

    def scale_out(self, cluster: Cluster, pod: Pod, now: float) -> None:
        rate_ok = (self._last_launch is None
                   or now - self._last_launch >= self.provisioning_interval_s)
        if not rate_ok and self.scale_out_bypass_util is not None:
            rate_ok = self._utilization(cluster) >= self.scale_out_bypass_util
        obs = self.obs
        if rate_ok:
            node = self.provider.launch_node(now)
            cluster.add_node(node)
            if obs is not None:
                since = (float("nan") if self._last_launch is None
                         else now - self._last_launch)
                obs.scale_out(now, pod.uid, node.node_id, SO_LAUNCH,
                              detail=since)
            self._last_launch = now
        elif obs is not None:
            # Rate limited: _last_launch is set (else rate_ok held).
            obs.scale_out(now, pod.uid, None, SO_LIMITED,
                          detail=now - self._last_launch)

    def scale_in(self, cluster: Cluster, now: float) -> List[str]:
        return self._scale_in_impl(cluster, now)


@dataclasses.dataclass
class _ProvisioningTracker:
    node: Node
    assigned: Dict[int, Resources]    # pod uid -> its planned requests

    @property
    def planned_free(self) -> Resources:
        free = self.node.allocatable
        for req in self.assigned.values():
            free = free - req
        return free


class BindingAutoscaler(Autoscaler):
    """Paper Alg. 7 (+6) — the *binding* autoscaler (BAS).

    Keeps the pod↔booting-node association so that one unschedulable pod
    triggers at most one launch, and booting capacity is packed before any
    further launch (the mechanism behind the paper's lowest-cost results).
    """

    name = "binding"

    def __init__(self, provider: NodeProvider,
                 scale_in_util_ceiling: Optional[float] = None):
        super().__init__(provider, scale_in_util_ceiling=scale_in_util_ceiling)
        self._tracked: Dict[str, _ProvisioningTracker] = {}
        self._pod_to_node: Dict[int, str] = {}
        self._noticed: set = set()   # node ids already given a replacement

    def scale_out(self, cluster: Cluster, pod: Pod, now: float) -> None:
        obs = self.obs
        if pod.uid in self._pod_to_node:
            if obs is not None:
                obs.scale_out(now, pod.uid, self._pod_to_node[pod.uid],
                              SO_ASSOCIATED)
            return  # already associated with a booting node — ignore
        # Is there still room in one of the nodes being provisioned?
        for tracker in sorted(self._tracked.values(),
                              key=lambda t: t.node.node_id):
            if pod.requests.fits_in(tracker.planned_free):
                tracker.assigned[pod.uid] = pod.requests
                self._pod_to_node[pod.uid] = tracker.node.node_id
                if obs is not None:
                    obs.scale_out(now, pod.uid, tracker.node.node_id,
                                  SO_ABSORBED,
                                  detail=float(len(tracker.assigned)))
                return
        # Launch a new node and assign the pod to it.
        node = self.provider.launch_node(now)
        cluster.add_node(node)
        self._tracked[node.node_id] = _ProvisioningTracker(
            node=node, assigned={pod.uid: pod.requests})
        self._pod_to_node[pod.uid] = node.node_id
        if obs is not None:
            obs.scale_out(now, pod.uid, node.node_id, SO_LAUNCH)

    def notify_node_ready(self, node: Node) -> None:
        tracker = self._tracked.pop(node.node_id, None)
        if tracker is None:
            return
        for uid in tracker.assigned:
            self._pod_to_node.pop(uid, None)
        # The scheduler (not the autoscaler) places pods on the new node.

    def notify_node_lost(self, node: Node) -> None:
        """Release the association state of a dead node.  Without this, a
        node failing while PROVISIONING leaks its tracker and every pod
        assigned to it stays permanently stranded (``scale_out``'s
        "already associated" early-return never launches a replacement)."""
        self._noticed.discard(node.node_id)
        tracker = self._tracked.pop(node.node_id, None)
        if tracker is None:
            return
        for uid in tracker.assigned:
            self._pod_to_node.pop(uid, None)

    def notify_node_removed(self, node: Node) -> None:
        """A noticed node that drains during its notice window is reaped
        by Alg. 6 step 1 before the kill fires; without this hook its id
        would sit in ``_noticed`` forever."""
        self._noticed.discard(node.node_id)

    def notify_preemption_notice(self, cluster: Cluster, node: Node,
                                 now: float) -> None:
        """Launch replacement capacity *during* the notice window instead
        of after the kill: the replacement boots while the doomed node
        drains, so evictees re-bind one provisioning delay sooner.  The
        evictees associate with the booting replacement through the
        normal ``scale_out`` path once the kill re-pends them; an empty
        replacement (the workload drained during the window) is reaped by
        scale-in."""
        if node.node_id in self._noticed:
            return   # one replacement per reclaimed node
        self._noticed.add(node.node_id)
        if not node.pods:
            return   # nothing to re-home; later arrivals scale out normally
        replacement = self._launch_replacement(node, now)
        cluster.add_node(replacement)
        self._tracked[replacement.node_id] = _ProvisioningTracker(
            node=replacement, assigned={})

    def _launch_replacement(self, node: Node, now: float) -> Node:
        """Like-for-like replacement; the heterogeneous subclass launches
        the reclaimed node's own instance type."""
        return self.provider.launch_node(now)

    def scale_in(self, cluster: Cluster, now: float) -> List[str]:
        return self._scale_in_impl(cluster, now)


class PredictiveAutoscaler(SimpleAutoscaler):
    """Forecast-ahead extension of Alg. 5 (beyond-paper, ROADMAP item 2).

    The reactive algorithms pay one full provisioning delay per burst:
    capacity is requested only after pods are already unschedulable.  This
    autoscaler additionally feeds observed arrivals into a rate forecaster
    (``repro_torch.forecast`` contract: ``observe_bin`` / ``predict``) and, each
    scheduling cycle, converts the predicted rate over the next
    ``lead_time_s`` into node demand via the provider template's capacity
    — launching *ahead* of the burst so nodes are READY when it lands.

    Fallback contract: with ``forecaster=None``, or whenever the
    forecaster's confidence is below ``conf_min``, behavior is exactly
    inherited Alg. 5 + Alg. 6 — the predictive path adds no launches, no
    RNG, and no event-order perturbation, so a disabled instance is
    bit-identical to `SimpleAutoscaler`.

    Freshly prelaunched nodes are protected from Alg. 6 step 1 for one
    provisioning-delay + lead window; without that grace period, scale-in
    would reap a speculative node the cycle after it boots empty and the
    deficit would relaunch it — a churn loop that burns cost without ever
    holding capacity through the predicted burst.

    Demand model: while the cluster is keeping up, speculation covers
    only the *unexpected* part of demand — the forecast rate in excess of
    a slow EWMA of the same bin stream (``trend_min`` scales the
    reference).  The reactive base algorithm already matches capacity to
    a steady rate, so holding ``rate * lead`` of free capacity through a
    plateau is pure idle cost, and launching into a falling rate (the
    forecaster's lag after a cliff) is worse.  But while pods are
    actually unschedulable (``scale_out`` fired within the last bin) the
    cluster is in sustained overload — Alg. 5's one-node-per-interval
    ramp is the bottleneck — and the full forecast rate drives the
    deficit so the fleet keeps building until the backlog clears.

    The overload ramp *escalates*: one node per cycle at onset, rising to
    ``max_prelaunch_per_cycle`` once the overload has persisted past
    ``escalate_s``.  A brief overload (a staircase climb the reactive
    path nearly keeps up with) gets a gentle nudge that does not
    overshoot the next cliff; a flash crowd that stays unschedulable for
    many minutes is provably beyond Alg. 5's one-node-per-interval ramp
    and gets the full-speed build-out.
    """

    name = "predictive"

    def __init__(self, provider: NodeProvider,
                 provisioning_interval_s: float = 60.0,
                 scale_out_bypass_util: Optional[float] = None,
                 scale_in_util_ceiling: Optional[float] = None,
                 forecaster=None,
                 bin_s: float = 30.0,
                 lead_time_s: float = 90.0,
                 headroom: float = 1.15,
                 conf_min: float = 0.35,
                 trend_min: float = 1.0,
                 slow_alpha: float = 0.08,
                 escalate_s: float = 900.0,
                 max_prelaunch_per_cycle: int = 2):
        super().__init__(provider,
                         provisioning_interval_s=provisioning_interval_s,
                         scale_out_bypass_util=scale_out_bypass_util,
                         scale_in_util_ceiling=scale_in_util_ceiling)
        self.forecaster = forecaster
        self.observes_arrivals = forecaster is not None
        self.bin_s = bin_s
        self.lead_time_s = lead_time_s
        self.headroom = headroom
        self.conf_min = conf_min
        self.trend_min = trend_min
        self.slow_alpha = slow_alpha
        self.escalate_s = escalate_s
        self.max_prelaunch_per_cycle = max_prelaunch_per_cycle
        template = getattr(provider, "template", None)
        boot_s = (template.provisioning_delay_s if template is not None
                  else provisioning_interval_s)
        self._protect_s = boot_s + lead_time_s
        self._cur_bin = 0          # index of the still-open arrival bin
        self._cur_count = 0        # arrivals observed in the open bin
        self._slow_rate: Optional[float] = None   # trend-gate reference
        self._last_bin_rate = 0.0  # most recent *closed* bin's rate
        self._arr_n = 0            # running per-arrival request means
        self._arr_cpu = 0.0
        self._arr_mem = 0.0
        self._prelaunched_at: Dict[str, float] = {}
        self._last_unsched = -np.inf   # last time Alg. 5 saw an unschedulable pod
        self._overload_since = -np.inf   # start of the current overload episode
        self._scale_in_now = 0.0
        self.prelaunched = 0       # diagnostic: speculative launches

    # -- arrival feed ---------------------------------------------------------
    def observe_arrivals(self, times, cpu_m=None, mem_mb=None) -> None:
        times = np.asarray(times, np.float64)
        if times.size == 0:
            return
        self._arr_n += times.size
        if cpu_m is not None:
            self._arr_cpu += float(np.sum(cpu_m))
        if mem_mb is not None:
            self._arr_mem += float(np.sum(mem_mb))
        for b in np.floor_divide(times, self.bin_s).astype(np.int64):
            self._roll_to(int(b))
            self._cur_count += 1

    def _roll_to(self, b: int) -> None:
        """Close (emit) every bin strictly before ``b``, including empty
        ones — a quiet stretch is signal, not missing data."""
        while self._cur_bin < b:
            r = self._cur_count / self.bin_s
            self.forecaster.observe_bin(r)
            self._last_bin_rate = r
            if self._slow_rate is None:
                self._slow_rate = r
            else:
                self._slow_rate += self.slow_alpha * (r - self._slow_rate)
            self._cur_count = 0
            self._cur_bin += 1

    def scale_out(self, cluster: Cluster, pod: Pod, now: float) -> None:
        """Alg. 5 scale-out, plus an overload stamp: a call here means a
        pod was unschedulable this cycle, which switches the next
        ``on_cycle`` from rise-only speculation to full-rate ramping."""
        if now - self._last_unsched > self.bin_s:
            self._overload_since = now   # a fresh episode, not a continuation
        self._last_unsched = now
        super().scale_out(cluster, pod, now)

    # -- predictive prelaunch -------------------------------------------------
    def on_cycle(self, cluster: Cluster, now: float) -> None:
        if self.forecaster is None:
            return
        if self._prelaunched_at:
            cutoff = now - self._protect_s
            expired = [nid for nid, t0 in self._prelaunched_at.items()
                       if t0 <= cutoff]
            for nid in expired:
                del self._prelaunched_at[nid]
        self._roll_to(int(now // self.bin_s))
        rate, conf = self.forecaster.predict()
        obs = self.obs
        if obs is not None:
            obs.forecast(now, rate, conf,
                         now - self._last_unsched <= self.bin_s,
                         self._slow_rate if self._slow_rate is not None
                         else 0.0)
        if conf < self.conf_min or rate <= 0.0 or self._arr_n == 0:
            return   # fallback contract: stay purely reactive
        slow = self._slow_rate if self._slow_rate is not None else 0.0
        if rate < slow:
            # Forecast says demand fell: stop shielding speculative nodes
            # from Alg. 6 step 1 — let the cliff drain.
            self._prelaunched_at.clear()
        overloaded = now - self._last_unsched <= self.bin_s
        # Escalation needs the overload to be *fed*: persistent backlog
        # with arrivals still landing (a non-empty last bin) means Alg. 5's
        # ramp is losing the race; a backlog with arrivals gone is a fixed
        # drain the existing fleet retires without further build-out.
        escalated = (overloaded
                     and now - self._overload_since >= self.escalate_s
                     and self._last_bin_rate > 0.0)
        if not escalated:
            # Alg. 5's launch rate limit applies to speculative launches
            # too (the stamp below is shared): un-escalated prediction
            # *shifts* the reactive launch earlier — ahead of the pods
            # going unschedulable — it does not add fleet beyond what the
            # reactive ramp would build.  That keeps cost pinned to the
            # NBAS trajectory while capacity arrives one boot earlier.
            if (self._last_launch is not None
                    and now - self._last_launch < self.provisioning_interval_s):
                return
        if overloaded:
            target_rate = rate   # sustained overload: ramp at forecast rate
        else:
            # Keeping up: speculate only on the rise the reactive path
            # cannot see yet (forecast in excess of the slow trend).
            target_rate = rate - self.trend_min * slow
            if target_rate <= 0.0:
                return   # steady or falling: leave it to reactive Alg. 5
        allowed = self.max_prelaunch_per_cycle if escalated else 1
        jobs = target_rate * self.lead_time_s * self.headroom
        need_cpu = jobs * (self._arr_cpu / self._arr_n)
        need_mem = jobs * (self._arr_mem / self._arr_n)
        free_cpu, free_mem = self._free_capacity(cluster)
        alloc = self.provider.template.allocatable
        deficit = max((need_cpu - free_cpu) / max(alloc.cpu_m, 1),
                      (need_mem - free_mem) / max(alloc.mem_mb, 1e-9))
        if deficit <= 0.0:
            return
        for _ in range(min(allowed, int(np.ceil(deficit)))):
            node = self.provider.launch_node(now)
            cluster.add_node(node)
            self._prelaunched_at[node.node_id] = now
            self.prelaunched += 1
            self._last_launch = now   # shared with the Alg. 5 rate limiter
            if obs is not None:
                obs.scale_out(now, -1, node.node_id, SO_PRELAUNCH, rate=rate,
                              conf=conf, headroom=self.headroom,
                              detail=deficit)

    @staticmethod
    def _free_capacity(cluster: Cluster):
        """(cpu_m, mem_mb) the cluster can still absorb within the lead
        window: free room on READY nodes plus the full allocatable of
        nodes already PROVISIONING (they will be up by then)."""
        arr = cluster.arrays
        if arr is not None:
            active = arr.live("active")
            state = arr.live("state")
            ready = active & (state == _engine.STATE_READY)
            prov = active & (state == _engine.STATE_PROVISIONING)
            free_cpu, free_mem = arr.free_views()
            cpu = (float(np.sum(free_cpu[ready]))
                   + float(np.sum(arr.live("alloc_cpu")[prov])))
            mem = (float(np.sum(free_mem[ready]))
                   + float(np.sum(arr.live("alloc_mem")[prov])))
            return cpu, mem
        cpu = mem = 0.0
        for node in cluster.nodes.values():
            if node.state == NodeState.READY:
                free = node.free
                cpu += free.cpu_m
                mem += free.mem_mb
            elif node.state == NodeState.PROVISIONING:
                cpu += node.allocatable.cpu_m
                mem += node.allocatable.mem_mb
        return cpu, mem

    # -- scale-in protection --------------------------------------------------
    def scale_in(self, cluster: Cluster, now: float) -> List[str]:
        self._scale_in_now = now
        return self._scale_in_impl(cluster, now)

    def _step1_candidates(self, cluster: Cluster) -> List[Node]:
        cands = Autoscaler._step1_candidates(cluster)
        if not self._prelaunched_at:
            return cands
        cutoff = self._scale_in_now - self._protect_s
        return [node for node in cands
                if self._prelaunched_at.get(node.node_id, -np.inf) <= cutoff]

    def notify_node_removed(self, node: Node) -> None:
        self._prelaunched_at.pop(node.node_id, None)

    def notify_node_lost(self, node: Node) -> None:
        self._prelaunched_at.pop(node.node_id, None)


AUTOSCALERS = {
    cls.name: cls
    for cls in (VoidAutoscaler, SimpleAutoscaler, BindingAutoscaler,
                PredictiveAutoscaler)
}
