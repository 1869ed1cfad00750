"""Discrete-event simulator for the paper's evaluation (§7).

Deterministic (seeded, no wall clock).  Events live on a typed
:class:`Timeline` — a two-stream structure replacing the seed's flat
one-entry-per-event heap:

* the **arrival stream** — the workload trace is already sorted by
  submission time, so ARRIVAL events are never heap-managed at all: the
  timeline merges the presorted stream against the heap head and drains
  every arrival due before the next non-arrival event as **one batch**
  (50 k trace entries collapse into a few hundred batch events);
* the **event heap** — everything else, with POD_DONE *bucketed*: each
  cycle sorts the pods it bound by completion timestamp into the
  PodStore's append-only completion log and pushes one event per distinct
  timestamp carrying a ``(lo, hi)`` range into that log (stale entries are
  filtered at fire time via the phase/incarnation columns — there is no
  per-pod scheduling dict).

Event kinds:

* ``ARRIVAL``     — a run of trace jobs is submitted (batch payload);
* ``CYCLE``       — periodic scheduler cycle (paper Alg. 1);
* ``POD_DONE``    — batch pods ran to completion (bucketed, see above);
* ``NODE_READY``  — a provisioning VM joined the cluster (boot delay model);
* ``SAMPLE``      — 20 s Table-5 utilization sampling;
* ``NODE_FAIL``   — fleet extension: a node dies (failure injection);
* ``NODE_NOTICE`` — disruption: spot reclaim notice — the node is drained
  and killed after the notice window (``repro_torch.core.disruption``);
* ``ZONE_OUTAGE`` — disruption: a correlated zone failure event (the
  payload injector picks the zone and kills its nodes);
* ``POD_CRASH``   — disruption: a crash-loop event (the payload injector
  picks a running batch pod within its restart budget).

Disruption events (kind >= ``NODE_FAIL``) append to ``disruption_log`` and,
when ``on_disruption`` is set, invoke it after the handler — the chaos
harness hooks ``PodStore.audit_columns`` there.

Ordering is identical to the seed heap: the seed pushed every arrival
before any other event, so at equal timestamps arrivals always won the
sequence-number tie-break — exactly the ``arrival_time <= heap_head`` rule
the timeline applies; all other simultaneous events retain push order via
the heap's sequence counter.

Exit condition: all arrivals submitted and every batch pod SUCCEEDED;
services are then torn down and billing closed (paper's *scheduling
duration* = first submission → last batch completion).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from bisect import bisect_right
from typing import List, Optional, Tuple

from repro_torch.core import engine as _engine
from repro_torch.core.autoscaler import Autoscaler
from repro_torch.core.cluster import Cluster, Node, NodeState
from repro_torch.core.cost import CostModel
from repro_torch.core.metrics import SAMPLE_PERIOD_S, ExperimentResult, MetricsCollector
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.pods import Pod, PodPhase
from repro_torch.core.workload import Arrival

(ARRIVAL, CYCLE, POD_DONE, NODE_READY, SAMPLE,
 NODE_FAIL, NODE_NOTICE, ZONE_OUTAGE, POD_CRASH) = range(9)

_INF = float("inf")


class Timeline:
    """Typed event timeline: presorted arrival stream + bucketed heap.

    ``pop()`` yields ``(t, kind, payload)`` in global time order.  ARRIVAL
    events carry a **batch payload** (a list of :class:`Arrival`): one pop
    drains every arrival due at or before the next heap event, bounded by
    ``horizon`` so a batch never crosses the simulation's time limit (the
    consumer must still see the first out-of-limit event to stop on it,
    exactly like popping it off the seed heap).

    Tie-break contract (bit-parity with the seed heap): arrivals were
    pushed first in the seed, so they carried the lowest sequence numbers —
    at equal timestamps an arrival always preceded any other event.  Here
    that is the ``t_arrival <= t_heap`` comparison.  Heap events pushed
    later keep their relative push order via ``seq``.
    """

    def __init__(self, arrivals: Optional[List[Arrival]] = None,
                 horizon: float = _INF, trace=None):
        if trace is not None:
            # Trace-native mode: the key column is the TraceStore's
            # arrival_time column itself (bisect works on the ndarray) and
            # ARRIVAL payloads are ``(lo, hi)`` row ranges — no Arrival
            # objects exist at any point.
            self._arrivals = None
            self._trace = trace
            self._times = trace.arrival_time
            self._n = trace.n
        else:
            self._arrivals = arrivals or []
            self._trace = None
            self._times = [a.time for a in self._arrivals]   # bisect keys
            self._n = len(self._arrivals)
        self._ai = 0
        self._horizon = horizon
        self._heap: List[Tuple[float, int, int, object]] = []
        self._seq = itertools.count()

    def push(self, t: float, kind: int, payload=None) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def __bool__(self) -> bool:
        return bool(self._heap) or self._ai < self._n

    def pop(self) -> Tuple[float, int, object]:
        """Earliest event; ARRIVAL runs come out as one batch.  Batch
        payloads are ``Arrival`` slices (list mode) or ``(lo, hi)`` row
        ranges (trace mode)."""
        ai = self._ai
        t_arr = float(self._times[ai]) if ai < self._n else _INF
        heap = self._heap
        if heap:
            head = heap[0]
            if head[0] < t_arr:
                heapq.heappop(heap)
                return head[0], head[2], head[3]
            limit = head[0]
        else:
            if t_arr is _INF:
                raise IndexError("pop from empty Timeline")
            limit = _INF
        if t_arr > self._horizon:
            # Out-of-horizon arrival: surface it alone, like the seed heap
            # popping the first over-limit event (the consumer stops on it).
            self._ai = ai + 1
            if self._arrivals is None:
                return t_arr, ARRIVAL, (ai, ai + 1)
            return t_arr, ARRIVAL, self._arrivals[ai:ai + 1]
        j = bisect_right(self._times, min(limit, self._horizon), ai)
        self._ai = j
        if self._arrivals is None:
            return t_arr, ARRIVAL, (ai, j)
        return t_arr, ARRIVAL, self._arrivals[ai:j]


@dataclasses.dataclass
class SimConfig:
    cycle_period_s: float = 10.0
    max_sim_time_s: float = 48 * 3600.0
    sample_period_s: float = SAMPLE_PERIOD_S
    # Benchmark instrumentation: stop issuing CYCLE events after this many
    # (None = unlimited) and record per-cycle wall-clock latency.
    max_cycles: Optional[int] = None
    record_cycle_times: bool = False


class Simulation:
    """Drives one experiment: workload trace × policy combo × cluster."""

    def __init__(self, orchestrator: Orchestrator, cost: CostModel,
                 arrivals: Optional[List[Arrival]] = None,
                 config: Optional[SimConfig] = None,
                 failure_injector=None, trace=None):
        self.orch = orchestrator
        self.cluster = orchestrator.cluster
        self.cost = cost
        if trace is not None and arrivals:
            raise ValueError("pass either arrivals or trace, not both")
        if trace is not None and orchestrator.store is None:
            # The object engine has no columnar ingest: materialize the
            # classic arrival list once (an API boundary; the seed engine
            # is object-speed anyway).
            arrivals, trace = trace.to_arrivals(), None
        self.trace = trace   # columnar workload (scenarios.TraceStore)
        self.arrivals = sorted(arrivals or [], key=lambda a: a.time)
        # Total jobs in the workload, whichever form it arrived in (the
        # exit condition and stuck detection compare against it).
        self.n_arrivals = trace.n if trace is not None else len(self.arrivals)
        self.config = config or SimConfig()
        self.metrics = MetricsCollector()
        self.failure_injector = failure_injector
        self.now = 0.0
        self.timeline: Optional[Timeline] = None
        self.cycle_wall_s: List[float] = []    # per-cycle latency (bench)
        self.cycle_placed: List[int] = []      # per-cycle placements (bench)
        self.n_cycles = 0
        self.failures_injected = 0
        self.preemption_notices = 0
        # Chronological ledger of disruption events:
        # (time, kind-str, subject-id, payload-list) — "node_fail" carries
        # the evicted pod uids, "reclaim_notice" the resident count,
        # "zone_outage" the victim node ids, "pod_crash" the crashed uid.
        self.disruption_log: List[tuple] = []
        # Optional observer called as on_disruption(sim, kind) after every
        # disruption event (kind >= NODE_FAIL); the chaos harness audits
        # the pod columns here.
        self.on_disruption = None
        # Observability recorder (repro_torch.obs.ObsRecorder.attach sets it);
        # None = compiled out — the run loop pays one is-None test per event.
        self.obs = None
        self._stuck = False
        self.first_submit: Optional[float] = None
        self.last_batch_done: Optional[float] = None

    # -- event plumbing -----------------------------------------------------------
    def push(self, t: float, kind: int, payload=None) -> None:
        if self.timeline is None:   # pre-run priming (failure injectors)
            self.timeline = Timeline(self.arrivals, trace=self.trace)
        self.timeline.push(t, kind, payload)

    # -- public: used by SimProvider ----------------------------------------------
    def schedule_node_ready(self, node: Node, t: float) -> None:
        self.push(t, NODE_READY, node)

    # -- main loop ------------------------------------------------------------------
    def run(self) -> ExperimentResult:
        if self.timeline is None:
            self.timeline = Timeline(self.arrivals, trace=self.trace)
        tl = self.timeline
        tl._horizon = self.config.max_sim_time_s   # config may change pre-run
        tl.push(0.0, CYCLE)
        tl.push(0.0, SAMPLE)
        if self.failure_injector is not None:
            self.failure_injector.prime(self)

        max_t = self.config.max_sim_time_s
        completed = False
        obs = self.obs
        prof = obs.prof if obs is not None else None
        while tl:
            if prof is None:
                t, kind, payload = tl.pop()
            else:
                t0 = prof.start()
                t, kind, payload = tl.pop()
                prof.stop("timeline_drain", t0, self.now)
            if t > max_t:
                break
            self.now = t
            if kind == ARRIVAL:
                if prof is None:
                    self._on_arrivals(payload)
                else:
                    t0 = prof.start()
                    self._on_arrivals(payload)
                    prof.stop("arrival_ingest", t0, t)
            elif kind == CYCLE:
                self._on_cycle()
            elif kind == POD_DONE:
                if prof is None:
                    self._on_pod_done(payload)
                else:
                    t0 = prof.start()
                    self._on_pod_done(payload)
                    prof.stop("completion_commit", t0, t)
            elif kind == NODE_READY:
                self._on_node_ready(payload)
            elif kind == SAMPLE:
                if prof is None:
                    self._on_sample()
                else:
                    t0 = prof.start()
                    self._on_sample()
                    prof.stop("metrics_sample", t0, t)
            elif kind == NODE_FAIL:
                self._on_node_fail(payload)
            elif kind == NODE_NOTICE:
                self._on_node_notice(payload)
            elif kind == ZONE_OUTAGE:
                payload.on_outage(self)
            elif kind == POD_CRASH:
                payload.on_crash_event(self)
            if kind >= NODE_FAIL and self.on_disruption is not None:
                self.on_disruption(self, kind)
            if self._done():
                completed = True
                break

        end = self.last_batch_done if completed and self.last_batch_done else self.now
        self.cost.close_all(end)
        return self._result(completed, end)

    # -- handlers --------------------------------------------------------------------
    def _on_arrivals(self, batch) -> None:
        """Submit one ARRIVAL batch.  Each pod's submit_time/pending_since
        is its own arrival instant, exactly as under per-event handling;
        ``now`` jumps straight to the batch's last arrival because nothing
        can observe the intermediate instants — no other event is due
        before then (Timeline contract) and submission never reads the
        clock.  Trace mode: the batch is a ``(lo, hi)`` row range and
        submission is the columnar bulk ingest (zero Arrival objects)."""
        if type(batch) is tuple:
            lo, hi = batch
            times = self.trace.arrival_time
            if self.first_submit is None:
                self.first_submit = float(times[lo])
            self.now = float(times[hi - 1])
            if self.orch.autoscaler.observes_arrivals:
                self.orch.autoscaler.observe_arrivals(
                    times[lo:hi], self.trace.cpu_m[lo:hi],
                    self.trace.mem_mb[lo:hi])
            self.orch.submit_trace(self.trace, lo, hi)
            return
        if self.first_submit is None:
            self.first_submit = batch[0].time
        self.now = batch[-1].time
        if self.orch.autoscaler.observes_arrivals:
            reqs = [a.spec.requests for a in batch]
            self.orch.autoscaler.observe_arrivals(
                [a.time for a in batch],
                [r.cpu_m for r in reqs], [r.mem_mb for r in reqs])
        self.orch.submit_wave(batch)

    def _on_cycle(self) -> None:
        t0 = time.perf_counter() if self.config.record_cycle_times else 0.0
        stats = self.orch.cycle(self.now)
        obs = self.obs
        prof = obs.prof if obs is not None else None
        if prof is None:
            self._schedule_completions()
        else:
            ts = prof.start()
            self._schedule_completions()
            prof.stop("completion_schedule", ts, self.now)
        if self.config.record_cycle_times:
            self.cycle_wall_s.append(time.perf_counter() - t0)
            self.cycle_placed.append(stats.placed)
        self.n_cycles += 1
        if (self.config.max_cycles is not None
                and self.n_cycles >= self.config.max_cycles):
            return   # benchmark cap: stop perpetuating cycles
        if self._permanently_stuck(stats):
            self._stuck = True
            return   # stop perpetuating cycles; timeline drains, run() returns
        self.push(self.now + self.config.cycle_period_s, CYCLE)

    def _permanently_stuck(self, stats) -> bool:
        """A static (void-autoscaled) cluster with pending pods, nothing
        running that could free space, and no provisioning in flight can
        never make progress — bail instead of simulating to max_sim_time."""
        if len(self.orch.pods) != self.n_arrivals:
            return False
        if stats.placed or stats.rescheduled or stats.scale_out_requests == 0:
            return False
        if self.cluster.provisioning_nodes():
            return False
        if self.orch.has_running_batch():
            return False   # a completion may free space later
        return self.orch.n_pending > 0

    def _schedule_completions(self) -> None:
        """Any batch pod bound (or re-bound) since the last cycle gets a
        completion for its current incarnation.  The orchestrator hands us
        exactly the pods bound since the last drain — no per-cycle scan of
        every running pod — and completions sharing a timestamp (pods of the
        same spec bound in the same cycle) are bucketed into a single heap
        event, so the event heap sees one push per distinct completion time
        per cycle instead of one per pod.

        The cycle's entries are stable-sorted by completion time (bind
        order preserved within a timestamp — the per-pod event order the
        seed engine produced for equal timestamps).  On the shell-less fast
        path they append to the PodStore's columnar completion log
        (:meth:`PodStore.log_completions`) and each bucket's POD_DONE
        payload is a ``(lo, hi)`` range into it; a cycle that drained any
        ``Pod`` object (object engine, or a shell materialized since the
        bind) falls back to list payloads of ``(pod | row, incarnation)``.
        Both shapes compute ``t_done`` with the identical float ops (a
        shell-less row has ``progress_s == 0`` by construction).

        There is no cross-cycle scheduling dict: a ``(uid, incarnation)``
        pair can only be drained twice within *one* cycle (bind → evict →
        re-bind bumps the incarnation, and the drain list resets every
        cycle), so a per-call ``seen`` set is the whole dedup story; fire-
        time staleness is the phase/incarnation check in `_on_pod_done`."""
        node_of = self.cluster.nodes.get
        now = self.now
        store = self.orch.store
        slot_nodes = self.cluster._slot_nodes
        entries: list = []                 # (t_done, row | pod, incarnation)
        all_rows = True
        seen = set()
        for item in self.orch.drain_newly_bound_batch():
            if type(item) is int:
                row = item
                pod = store.shells.get(row)
                if pod is None:
                    if store.phase[row] != _engine.POD_BOUND:
                        continue   # bound then evicted before the drain
                    uid = store.uid[row]
                    if uid in seen:
                        continue
                    seen.add(uid)
                    node = slot_nodes[store.node_slot[row]]
                    speed = node.speed_factor if node else 1.0
                    # progress_s is 0 for a never-evicted, shell-less pod.
                    remaining = store.duration_s[row] - 0.0
                    entries.append((now + remaining / max(speed, 1e-6),
                                    row, store.incarnation[row]))
                    continue
            else:
                pod = item
            if pod.phase is not PodPhase.BOUND:
                continue   # bound then evicted again before the drain
            if pod.uid in seen:
                continue
            seen.add(pod.uid)
            all_rows = False
            node = node_of(pod.node_id)
            speed = node.speed_factor if node else 1.0
            remaining = pod.spec.duration_s - pod.progress_s
            entries.append((now + remaining / max(speed, 1e-6),
                            pod, pod.incarnation))
        if not entries:
            return
        entries.sort(key=lambda e: e[0])   # stable: bind order within a time
        i, n = 0, len(entries)
        while i < n:
            t_done = entries[i][0]
            j = i
            while j < n and entries[j][0] == t_done:
                j += 1
            if all_rows and store is not None:
                payload = store.log_completions(
                    [e[1] for e in entries[i:j]],
                    [e[2] for e in entries[i:j]])
            else:
                payload = [(e[1], e[2]) for e in entries[i:j]]
            self.push(t_done, POD_DONE, payload)
            i = j

    def _on_pod_done(self, payload) -> None:
        # One POD_DONE event carries every completion bucketed at this
        # timestamp, in bind order (matching the per-pod event order the
        # seed engine produced for equal timestamps).  The payload is a
        # ``(lo, hi)`` range into the PodStore completion log (fast path)
        # or a list of ``(pod | store-row, incarnation)`` (object engine /
        # mixed-shell cycles); live-vs-stale is decided here, per entry, by
        # the phase + incarnation columns — this event was that
        # incarnation's one shot either way.
        #
        # Rows stay column-only through the commit
        # (``Cluster.complete_wave_store``) unless an external
        # ``on_complete`` observer is attached — an API boundary, which
        # materializes shells and routes through the object-path
        # ``complete_wave`` so the observer sees real pods, in order.
        store = self.orch.store
        if type(payload) is tuple:
            lo, hi = payload
            pairs = zip(store.done_rows[lo:hi], store.done_incs[lo:hi])
            store.consume_completions(lo, hi)
        else:
            pairs = payload
        live: list = []
        rows_present = False
        for first, incarnation in pairs:
            if type(first) is int:
                row = first
                pod = store.shells.get(row)
                if pod is None:
                    if (store.phase[row] != _engine.POD_BOUND
                            or store.incarnation[row] != incarnation):
                        continue   # stale: pod was evicted/failed since
                    live.append(row)
                    rows_present = True
                    continue
            else:
                pod = first
            if pod.phase is not PodPhase.BOUND or pod.incarnation != incarnation:
                continue   # stale entry: pod was evicted/failed since
            live.append(pod)
        if live:
            if rows_present:
                orch = self.orch
                if self.cluster.on_complete == orch._on_pod_completed:
                    self.cluster.complete_wave_store(
                        live, self.now, on_row=orch._on_row_completed)
                else:
                    # External observer: materialize rows, keep bind order.
                    self.cluster.complete_wave(
                        [store.pod_at(e) if type(e) is int else e
                         for e in live], self.now)
            else:
                self.cluster.complete_wave(live, self.now)
            self.last_batch_done = self.now

    def _on_node_ready(self, node: Node) -> None:
        if node.state != NodeState.PROVISIONING:
            return
        node.mark_ready(self.now)
        self.orch.autoscaler.notify_node_ready(node)
        if self.failure_injector is not None:
            self.failure_injector.arm_node(self, node)

    def _on_sample(self) -> None:
        self.metrics.sample(self.cluster, self.now)
        self.push(self.now + self.config.sample_period_s, SAMPLE)

    def _on_node_fail(self, node: Node) -> None:
        if node.node_id not in self.cluster.nodes:
            return
        if node.state == NodeState.TERMINATED:
            return
        self.failures_injected += 1
        cluster = self.cluster
        if (cluster.pod_store is not None
                and cluster.on_unbind == self.orch._on_pod_unbound):
            # Shell-less fast path: the whole node evicts as bulk column
            # writes (no per-pod materialization).  An external on_unbind
            # observer is an API boundary — the object loop below
            # materializes shells so the observer sees real pods, in order.
            victims = cluster.fail_node_store(
                node, self.now, on_row=self.orch._on_row_unbound)
        else:
            victims = []
            for pod in list(node.pods.values()):
                victims.append(pod.uid)
                cluster.unbind(pod, self.now, failed=True)
        # Drop any provisioning association so evictees can trigger
        # replacement capacity (the BindingAutoscaler leak fix).
        self.orch.autoscaler.notify_node_lost(node)
        if node.state == NodeState.PROVISIONING:
            node.state = NodeState.READY   # force through the state machine
            node.ready_time = self.now
        self.cost.on_deprovision(node, self.now)
        cluster.remove_node(node, self.now)
        self.disruption_log.append(
            (self.now, "node_fail", node.node_id, victims))

    def fail_node(self, node: Node) -> None:
        """Public entry point for disruption injectors: kill ``node`` at the
        current instant through the normal NODE_FAIL plumbing."""
        self._on_node_fail(node)

    def _on_node_notice(self, payload) -> None:
        """Spot reclaim notice (``disruption.SpotReclaimInjector``): the
        node will be killed ``kill_delay_s`` from now.  Drain it (taint —
        no new pods land during the window), tell the autoscaler so
        replacement capacity can launch *before* the kill, and schedule
        the kill itself through the normal NODE_FAIL plumbing."""
        node, kill_delay_s = payload
        if node.node_id not in self.cluster.nodes:
            return
        if node.state == NodeState.TERMINATED:
            return
        self.preemption_notices += 1
        self.disruption_log.append(
            (self.now, "reclaim_notice", node.node_id, [len(node.pods)]))
        obs = self.obs
        if obs is not None:
            obs.preempt_notice(self.now, node.node_id, len(node.pods),
                               kill_delay_s)
        node.taint()
        self.orch.autoscaler.notify_preemption_notice(
            self.cluster, node, self.now)
        self.push(self.now + kill_delay_s, NODE_FAIL, node)

    # -- termination / results ----------------------------------------------------
    def _done(self) -> bool:
        """All jobs placed & executed: every batch SUCCEEDED and every
        service BOUND (a cluster that never fits its services never
        completed the workload — this matters for the Fig. 4 baseline)."""
        if len(self.orch.pods) != self.n_arrivals or not self.orch.pods:
            return False
        if not self.orch.batch_all_done():
            return False
        return self.orch.services_all_bound()

    def _result(self, completed: bool, end: float) -> ExperimentResult:
        store = self.orch.store
        if store is not None:
            # Column-native end-of-run walk: shells contribute their
            # recorded interval lists, shell-less rows derive theirs from
            # the columns — same multiset, no 50k-shell materialization.
            self.metrics.record_pending_intervals(
                store.pending_intervals_all())
            evictions = store.total_incarnations()
            lost_work = store.total_lost_work_s()
        else:
            for pod in self.orch.pods:
                self.metrics.record_pending_intervals(pod.pending_intervals)
            evictions = sum(p.incarnation for p in self.orch.pods)
            lost_work = sum((p.lost_work_s for p in self.orch.pods), 0.0)
        start = self.first_submit or 0.0
        return ExperimentResult(
            workload="", scheduler=self.orch.scheduler.name,
            rescheduler=self.orch.rescheduler.name,
            autoscaler=self.orch.autoscaler.name,
            completed=completed,
            cost=self.cost.total_cost(end),
            duration_s=end - start,
            median_pending_s=self.metrics.median_pending_s(),
            mean_pending_s=self.metrics.mean_pending_s(),
            max_pending_s=self.metrics.max_pending_s(),
            avg_ram_ratio=self.metrics.avg_ram_ratio(),
            avg_cpu_ratio=self.metrics.avg_cpu_ratio(),
            avg_pods_per_node=self.metrics.avg_pods_per_node(),
            max_nodes=self.metrics.max_nodes(),
            node_seconds=self.cost.total_node_seconds(end),
            evictions=evictions,
            scale_outs=self.orch.total_scale_outs,
            scale_ins=self.orch.total_scale_ins,
            failures_injected=self.failures_injected,
            preemption_notices=self.preemption_notices,
            lost_work_s=lost_work,
        )
