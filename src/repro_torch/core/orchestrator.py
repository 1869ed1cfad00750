"""The control loop (paper §4.2, Algorithm 1).

::

    while the scheduler exit condition is not satisfied
        get all pending tasks
        for each pending task t
            schedule t
            if t cannot be placed
                reschedule
                if rescheduling failed
                    scale out
        scale in

Semantics matched to the paper:

* a successful **non-binding** reschedule leaves the evictees *and* the
  triggering pod in the queue for the *next* cycle — so that cycle is not
  "fully successful" and scale-in is skipped;
* **scale-in runs only when every pending pod of the cycle was placed**;
* pods created by evictions during a cycle wait until the next cycle
  (we iterate over a snapshot of the queue).

Two cycle engines implement the "for each pending task t: schedule t" body:

* **wave placement** (array engine, default) — pod state lives in the SoA
  ``engine.PodStore`` (uid-indexed columns; ``Pod`` objects are shells
  materialized on demand at API boundaries) and the whole pending snapshot
  of store *rows* is handed to ``Scheduler.select_wave_store``, which
  places it against a ``WavePlacer``'s working arrays; the placed prefix
  commits once per wave — as pure column writes
  (``Cluster.bind_wave_store``) when no external ``on_bind`` observer is
  attached, through the object-path ``Cluster.bind_wave`` (shells
  materialize) otherwise.  When a pod blocks, the wave flushes, the paper's
  reschedule/scale-out path runs for that pod (materialized — policies are
  an object API), and the wave resumes after it — reusing the same placer
  when the mirror's version counter shows the blocked-pod handling didn't
  mutate the cluster.  Decisions are bit-identical to the per-pod loop
  (``tests/test_engine_parity.py``).
* **per-pod loop** (seed object engine, ``ExperimentSpec(engine="object")``) —
  one ``Scheduler.schedule`` call per pending pod over real ``Pod``
  objects, kept verbatim as the parity reference.

Queueing is event-driven, not scan-driven: the orchestrator registers
bind/unbind/complete callbacks on the cluster and maintains the pending set
keyed on ``(pending_since, uid)`` with lazy invalidation, so a cycle's FIFO
snapshot costs O(k) for the k pending pods instead of filtering and
re-sorting a buffer of every pod ever submitted.  On the store path the
arrival stream never touches a heap at all: ``submit_wave`` bulk-ingests
each presorted ARRIVAL batch into the columns and *appends* its queue
entries (batch times are nondecreasing and uids monotone, so the whole
stream is sorted by construction); only eviction re-pends and object-path
submissions go through a small heap, and ``pending_rows`` merges the three
sorted streams in one pass.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import engine as _engine
from repro_torch.core.autoscaler import Autoscaler, VoidAutoscaler
from repro_torch.core.cluster import Cluster
from repro_torch.core.pods import Pod, PodPhase
from repro_torch.core.rescheduler import (Rescheduler, RescheduleOutcome,
                                          VoidRescheduler)
from repro_torch.core.scheduler import Scheduler


@dataclasses.dataclass
class CycleStats:
    placed: int = 0
    unschedulable: int = 0
    rescheduled: int = 0
    scale_out_requests: int = 0
    scale_ins: int = 0
    all_placed: bool = True


class _StorePodSeq:
    """``Orchestrator.pods`` on the store path: a sequence view over every
    ingested row, in submission (uid) order.

    ``len``/truthiness are O(1) column reads — the simulator's exit condition
    polls them every cycle — while indexing/iteration materialize ``Pod``
    shells on demand (an API boundary: external readers get full-fidelity
    objects, the hot path never touches this)."""

    __slots__ = ("_store",)

    def __init__(self, store):
        self._store = store

    def __len__(self) -> int:
        return self._store.n_rows

    def __bool__(self) -> bool:
        return self._store.n_rows > 0

    def __getitem__(self, i):
        store = self._store
        if isinstance(i, slice):
            return [store.pod_at(r) for r in range(store.n_rows)[i]]
        return store.pod_at(range(store.n_rows)[i])

    def __iter__(self):
        store = self._store
        for row in range(store.n_rows):
            yield store.pod_at(row)


class Orchestrator:
    """Glues scheduler + rescheduler + autoscaler over one cluster.

    Owns the pending queue (two-level (pending_since, uid) structure fed by
    cluster bind/unbind callbacks) and the running counters the simulator's
    exit condition reads.  ``cycle`` is paper Alg. 1; on the array engine it
    places each cycle's snapshot in waves (see ``_cycle_wave``), on the
    object engine it runs the seed per-pod loop — both bit-identical."""

    def __init__(self, cluster: Cluster, scheduler: Scheduler,
                 rescheduler: Rescheduler, autoscaler: Autoscaler,
                 straggler_threshold: float = 0.0,
                 on_evict: Optional[Callable[[Pod, float], None]] = None):
        self.cluster = cluster
        self.scheduler = scheduler
        self.rescheduler = rescheduler
        self.autoscaler = autoscaler
        # Pod state: on the array engine the SoA PodStore is the source of
        # truth and `pods` is a lazy sequence view (shells on demand); on the
        # seed object engine `pods` is the plain list of every Pod submitted.
        if cluster.arrays is not None:
            self.store = _engine.PodStore(cluster.arrays)
            cluster.pod_store = self.store
            self.pods = _StorePodSeq(self.store)
        else:
            self.store = None
            self.pods: List[Pod] = []      # every pod ever submitted
        self.total_evictions = 0
        self.total_scale_outs = 0
        self.total_scale_ins = 0
        # Flight recorder (repro_torch.obs.ObsRecorder), attached by
        # build_simulation when ExperimentSpec.obs is set; None = obs
        # compiled out (one attribute test per cycle phase).
        self.obs = None
        # Fleet extension: evict checkpointable batch pods running on nodes
        # slower than `straggler_threshold` × nominal speed (0 disables).
        self.straggler_threshold = straggler_threshold
        self.on_evict = on_evict
        # Event-driven queue + counters (maintained via cluster callbacks).
        # Two-level pending queue keyed on (pending_since, uid): a min-heap
        # of entries pushed since the last snapshot, merged into the carried
        # sorted pending prefix by pending_pods().  Entries go stale when
        # their pod binds (and possibly re-pends with a new pending_since) —
        # snapshots drop them lazily.  push_seq only breaks ties between
        # duplicate (pending_since, uid) entries so the heap never compares
        # Pod objects.
        self._pending_heap: List[Tuple[float, int, int, Pod]] = []
        self._pending_sorted: List[Tuple[float, int, int, Pod]] = []
        self._push_seq = itertools.count()
        # Store-path pending queue: three sorted (pending_since, uid, row)
        # streams.  Arrival ingests *append* (batches are presorted and uids
        # monotone, so the whole arrival stream is sorted by construction —
        # zero heap pushes); evictions/adoptions go through the small heap;
        # snapshots carry their sorted prefix forward.  Same keys, same lazy
        # invalidation, same FIFO order as the seed queue.
        self._arrival_entries: List[Tuple[float, int, int]] = []
        self._row_heap: List[Tuple[float, int, int]] = []
        self._row_sorted: List[Tuple[float, int, int]] = []
        # uid -> BOUND batch pod; values are None on the store fast path
        # until something needs the shell (e.g. straggler mitigation).
        self._bound_batch: Dict[int, Optional[Pod]] = {}
        # Batch pods bound since the last drain, in global bind order:
        # Pod objects from object-path binds, store rows (ints) from
        # fast-path wave commits.  One list so completion scheduling sees
        # the exact seed bucketing order even when the two mix in a cycle.
        self._newly_bound_batch: list = []
        self.n_pending = 0
        self.n_batch_total = 0
        self.n_batch_done = 0
        self.n_service_total = 0
        self.n_service_bound = 0
        self._cycle_count = 0
        cluster.on_bind = self._on_pod_bound
        cluster.on_unbind = self._on_pod_unbound
        cluster.on_complete = self._on_pod_completed

    # -- cluster callbacks -------------------------------------------------------
    def _on_pod_bound(self, pod: Pod) -> None:
        self.n_pending -= 1
        if pod.is_batch:
            self._bound_batch[pod.uid] = pod
            self._newly_bound_batch.append(pod)
        elif pod.is_service:
            self.n_service_bound += 1

    def _on_pod_unbound(self, pod: Pod) -> None:
        # evict() recreates the pod as a fresh PENDING incarnation
        self.n_pending += 1
        self._push_pending(pod)
        if pod.is_batch:
            self._bound_batch.pop(pod.uid, None)
        elif pod.is_service:
            self.n_service_bound -= 1

    def _on_row_unbound(self, row: int) -> None:
        """Store-path ``_on_pod_unbound`` for one column-evicted shell-less
        row (``Cluster.fail_node_store``): same bookkeeping, no shell.
        The caller already re-pended the row, so ``pending_since[row]`` is
        the eviction instant — the same key ``_push_pending`` would use."""
        store = self.store
        self.n_pending += 1
        heapq.heappush(self._row_heap,
                       (store.pending_since[row], store.uid[row], row))
        f = store.flags[row]
        if f & _engine.POD_F_BATCH:
            self._bound_batch.pop(store.uid[row], None)
        elif f & _engine.POD_F_SERVICE:
            self.n_service_bound -= 1

    def _on_row_completed(self, row: int) -> None:
        """Store-path ``_on_pod_completed``: same bookkeeping, no shell."""
        self._bound_batch.pop(self.store.uid[row], None)
        self.n_batch_done += 1

    def _on_pod_completed(self, pod: Pod) -> None:
        self._bound_batch.pop(pod.uid, None)
        self.n_batch_done += 1

    def bound_batch_uids(self) -> list:
        """Uids of currently-BOUND batch pods, in uid (submission) order —
        the crash-loop injector's candidate set.  O(1) membership state,
        no shell materialization."""
        return sorted(self._bound_batch)

    def bound_batch_pod(self, uid: int) -> Pod:
        """The BOUND batch pod for ``uid``, materializing (and caching) its
        shell on the store path — same idiom as ``_mitigate_stragglers``."""
        pod = self._bound_batch[uid]
        if pod is None:
            pod = self.store.pod_at(self.store.index[uid])
            self._bound_batch[uid] = pod
        return pod

    def drain_newly_bound_batch(self) -> list:
        """Batch pods bound (or re-bound) since the last drain, in bind
        order; the simulator schedules one completion event per
        (pod, incarnation).  Entries are ``Pod`` objects (object-path binds)
        or ``PodStore`` rows (ints, shell-less fast-path binds)."""
        out = self._newly_bound_batch
        self._newly_bound_batch = []
        return out

    # -- queue ------------------------------------------------------------------
    def _push_pending(self, pod: Pod) -> None:
        if self.store is not None:
            row = self.store.index.get(pod.uid)
            if row is None:
                row = self.store.adopt(pod)
            heapq.heappush(self._row_heap, (pod.pending_since, pod.uid, row))
            return
        heapq.heappush(self._pending_heap,
                       (pod.pending_since, pod.uid, next(self._push_seq), pod))

    def submit(self, pod: Pod) -> None:
        """Enqueue a newly-created pod (object-path entry point: the seed
        ARRIVAL handler, live-cluster submissions, tests).  On the array
        engine the pod is adopted into the PodStore — it stays the mutable
        face, the columns mirror it."""
        if self.store is None:
            self.pods.append(pod)
        self._push_pending(pod)   # adopts into the store on the array engine
        self.n_pending += 1
        if pod.is_batch:
            self.n_batch_total += 1
        elif pod.is_service:
            self.n_service_total += 1

    def submit_wave(self, arrivals) -> None:
        """Enqueue one pod per arrival of a presorted ARRIVAL batch.

        Store path (array engine): the batch ingests straight into the SoA
        columns — no ``Pod`` construction, no heap pushes.  Queue entries
        append to the sorted arrival stream: batch times are nondecreasing,
        uids are allocated in batch order, and every entry pushed before
        this event carries ``pending_since <= now <= arrivals[0].time``, so
        appends preserve the stream's sort (property-tested against
        one-at-a-time heappush in ``tests/test_pod_store.py``).

        Object path: equivalent to ``submit(Pod(...))`` per entry with the
        per-pod call overhead hoisted out of the loop."""
        if self.store is not None:
            rows, uids = self.store.ingest(arrivals)
            entries = self._arrival_entries
            flags = self.store.flags
            n_batch = n_service = 0
            first = rows[0] if len(rows) else 0
            for off, a in enumerate(arrivals):
                row = first + off
                entries.append((a.time, uids[off], row))
                f = flags[row]
                if f & _engine.POD_F_BATCH:
                    n_batch += 1
                elif f & _engine.POD_F_SERVICE:
                    n_service += 1
            self.n_pending += len(arrivals)
            self.n_batch_total += n_batch
            self.n_service_total += n_service
            return
        pods = self.pods
        heap = self._pending_heap
        seq = self._push_seq
        n_batch = n_service = 0
        for a in arrivals:
            pod = Pod(spec=a.spec, submit_time=a.time)
            pods.append(pod)
            heapq.heappush(heap, (pod.pending_since, pod.uid, next(seq), pod))
            if pod.is_batch:
                n_batch += 1
            elif pod.is_service:
                n_service += 1
        self.n_pending += len(arrivals)
        self.n_batch_total += n_batch
        self.n_service_total += n_service

    def submit_trace(self, trace, lo: int, hi: int) -> None:
        """Trace-native :meth:`submit_wave`: enqueue rows ``[lo, hi)`` of a
        columnar trace (``repro_torch.scenarios.trace.TraceStore``).

        Store path (array engine): the batch bulk-ingests straight from the
        trace columns into the PodStore columns
        (``PodStore.ingest_trace``) — zero per-arrival Python objects, no
        heap pushes; queue entries append to the sorted arrival stream
        under the same sortedness argument as :meth:`submit_wave`, and the
        batch/service counters update from one vector pass over the
        trace's ``kind`` column.  Object path: falls back to materializing
        the slice as ``Arrival`` objects (the seed engine is object-speed
        anyway)."""
        if self.store is None:
            self.submit_wave(trace.arrivals_slice(lo, hi))
            return
        rows, uids, times = self.store.ingest_trace(trace, lo, hi)
        self._arrival_entries.extend(zip(times, uids, rows))
        n_batch, n_service = trace.count_kinds(lo, hi)
        self.n_pending += hi - lo
        self.n_batch_total += n_batch
        self.n_service_total += n_service

    def pending_pods(self) -> List[Pod]:
        """Currently-pending pods, FIFO by (pending_since, uid).

        O(k + j·log j) snapshot for k pending pods and j pushes since the
        last snapshot: the previous snapshot is carried forward *already
        sorted*, the j new entries drain from the heap in key order, and the
        two sorted streams merge in one pass — nothing is re-sorted.  Lazy
        invalidation drops each stale entry exactly once during the merge:
        an entry is stale when its pod is no longer PENDING, when it was
        re-pended with a newer ``pending_since`` (bound then evicted — the
        eviction pushed a fresh entry), or when it is a same-key duplicate
        (bound and evicted twice at one timestamp).

        On the store path this is an API boundary: the row snapshot comes
        from :meth:`pending_rows` (idempotent — the carried prefix is
        preserved) and each row materializes its ``Pod`` shell."""
        if self.store is not None:
            store = self.store
            return [store.pod_at(r) for r in self.pending_rows()]
        heap = self._pending_heap
        if heap:
            # Draining the whole heap == sorting it (keys are unique), and
            # one C-level sort beats n heappops.
            fresh = sorted(heap)
            heap.clear()
            merged = (heapq.merge(self._pending_sorted, fresh)
                      if self._pending_sorted else fresh)
        else:
            merged = self._pending_sorted
        out: List[Pod] = []
        entries: List[Tuple[float, int, int, Pod]] = []
        seen = set()
        pending = PodPhase.PENDING
        for entry in merged:
            ps, uid, _, pod = entry
            if (pod.phase is pending and pod.pending_since == ps
                    and uid not in seen):
                seen.add(uid)
                out.append(pod)
                entries.append(entry)
        self._pending_sorted = entries
        return out

    def pending_rows(self) -> List[int]:
        """Store-path :meth:`pending_pods`: currently-pending store rows,
        FIFO by (pending_since, uid).

        Same three-way merge discipline, row-native: the carried sorted
        prefix, the bulk-appended arrival stream (already sorted — see
        :meth:`submit_wave`) and the sorted eviction heap merge in one pass,
        with stale entries (phase or pending_since moved on, or same-key
        duplicates) dropped lazily against the SoA columns instead of Pod
        attributes."""
        heap = self._row_heap
        arrivals = self._arrival_entries
        streams = []
        if self._row_sorted:
            streams.append(self._row_sorted)
        if arrivals:
            streams.append(arrivals)
            self._arrival_entries = []
        if heap:
            fresh = sorted(heap)
            heap.clear()
            streams.append(fresh)
        if len(streams) == 1:
            merged = streams[0]
        elif streams:
            merged = heapq.merge(*streams)
        else:
            merged = ()
        store = self.store
        phase = store.phase
        ps_col = store.pending_since
        pending = _engine.POD_PENDING
        out: List[int] = []
        entries: List[Tuple[float, int, int]] = []
        seen = set()
        for entry in merged:
            ps, uid, row = entry
            if (phase[row] == pending and ps_col[row] == ps
                    and uid not in seen):
                seen.add(uid)
                out.append(row)
                entries.append(entry)
        self._row_sorted = entries
        return out

    def running_pods(self) -> List[Pod]:
        if self.store is not None:
            store = self.store
            bound = _engine.POD_BOUND
            return [store.pod_at(r) for r in range(store.n_rows)
                    if store.phase[r] == bound]
        return [p for p in self.pods if p.phase == PodPhase.BOUND]

    def batch_all_done(self) -> bool:
        return self.n_batch_done == self.n_batch_total

    def services_all_bound(self) -> bool:
        return self.n_service_bound == self.n_service_total

    def has_running_batch(self) -> bool:
        return bool(self._bound_batch)

    # -- Algorithm 1 --------------------------------------------------------------
    def cycle(self, now: float) -> CycleStats:
        """One scheduling cycle (paper Alg. 1): place the pending snapshot,
        reschedule/scale-out per blocked pod, scale in after a fully
        successful cycle.  Dispatches to wave placement on the array engine
        and to the seed per-pod loop otherwise; both produce bit-identical
        bindings and stats."""
        stats = CycleStats()
        obs = self.obs
        prof = obs.prof if obs is not None else None
        if self.straggler_threshold > 0:
            self._mitigate_stragglers(now)
        # Predictive prelaunch hook (no-op for the paper's autoscalers):
        # runs before placement so capacity requested for a forecast burst
        # starts booting in the same cycle that observes the demand.
        if prof is None:
            self.autoscaler.on_cycle(self.cluster, now)
        else:
            t0 = prof.start()
            self.autoscaler.on_cycle(self.cluster, now)
            prof.stop("autoscaler_step", t0, now)
        if self.store is not None:
            self._cycle_wave(self.pending_rows(), now, stats)
        else:
            self._cycle_per_pod(self.pending_pods(), now, stats)
        if stats.all_placed:
            if prof is None:
                removed = self.autoscaler.scale_in(self.cluster, now)
            else:
                t0 = prof.start()
                removed = self.autoscaler.scale_in(self.cluster, now)
                prof.stop("scale_in", t0, now)
            stats.scale_ins = len(removed)
            self.total_scale_ins += len(removed)
        # Fast (vectorized) invariant every cycle; full object-walk +
        # mirror cross-check periodically so drift can't hide for a run.
        self._cycle_count += 1
        self.cluster.check_invariants(deep=self._cycle_count % 64 == 0)
        return stats

    def _cycle_wave(self, snapshot: List[int], now: float,
                    stats: CycleStats) -> None:
        """Wave placement (array engine): place the snapshot of store rows
        in batches.

        Each ``select_wave_store`` call places a maximal prefix of the
        remaining snapshot against the placer's working arrays; the prefix
        commits once per wave, then the blocked pod (if any) goes through
        the paper's reschedule/scale-out path — materialized to a ``Pod``
        shell, since reschedulers/autoscalers are an object API — and the
        wave resumes after it.  The placer — including its per-request-size
        filter caches — is reused across waves as long as the mirror's
        version counter proves nothing mutated cluster state behind its
        back.

        Commit flavour: when ``cluster.on_bind`` is still this
        orchestrator's own handler, the wave commits shell-less
        (``Cluster.bind_wave_store`` — pure column/accounting writes, with
        the orchestrator bookkeeping done row-wise here).  Any *external*
        ``on_bind`` observer (parity spies, user callbacks) is an API
        boundary: shells materialize and the wave commits through the
        object-path ``bind_wave`` so the observer sees real pods, in order.
        """
        arr = self.cluster.arrays
        store = self.store
        fast = self.cluster.on_bind == self._on_pod_bound
        # Void rescheduler + void autoscaler (exact types: subclasses may
        # override behaviour) ignore the pod entirely — Alg. 1's fallback
        # chain degenerates to counter updates, so a blocked pod needs no
        # shell.  This is the static-cluster regime (fig-4 baseline,
        # throughput benchmarks), where a saturated cluster re-blocks tens
        # of thousands of pending pods every cycle.
        void_fallback = (type(self.rescheduler) is VoidRescheduler
                         and type(self.autoscaler) is VoidAutoscaler)
        obs = self.obs
        prof = obs.prof if obs is not None else None
        placer = None
        start = 0
        while start < len(snapshot):
            if placer is None or not placer.in_sync():
                placer = _engine.WavePlacer(arr)
            if prof is None:
                bindings, blocked = self.scheduler.select_wave_store(
                    placer, store, snapshot, start)
            else:
                t0 = prof.start()
                bindings, blocked = self.scheduler.select_wave_store(
                    placer, store, snapshot, start)
                prof.stop("wave_select", t0, now)
            if bindings:
                t0 = prof.start() if prof is not None else 0.0
                if fast:
                    self.cluster.bind_wave_store(bindings, now)
                    self._note_bound_rows(bindings)
                else:
                    by_slot = self.cluster.node_by_slot
                    self.cluster.bind_wave(
                        [(store.pod_at(row), by_slot(slot))
                         for row, slot in bindings], now)
                if prof is not None:
                    prof.stop("bind_commit", t0, now)
                placer.version = arr.version   # re-arm: our own commit
                stats.placed += len(bindings)
            if blocked is None:
                return
            if void_fallback:
                # Inlined _handle_unschedulable for the void/void chain:
                # reschedule FAILED -> scale-out request -> ignored.
                stats.unschedulable += 1
                stats.all_placed = False
                stats.scale_out_requests += 1
                self.total_scale_outs += 1
                if obs is not None:
                    # Same event _handle_unschedulable records, shell-less.
                    obs.resched(now, store.uid[snapshot[blocked]], 2)
            else:
                self._handle_unschedulable(store.pod_at(snapshot[blocked]),
                                           now, stats)
            start = blocked + 1

    def _note_bound_rows(self, bindings) -> None:
        """Row-wise ``_on_pod_bound`` for one fast-committed wave."""
        store = self.store
        flags = store.flags
        uid_col = store.uid
        shells = store.shells
        bound_batch = self._bound_batch
        newly = self._newly_bound_batch
        n_service = 0
        F_BATCH = _engine.POD_F_BATCH
        F_SERVICE = _engine.POD_F_SERVICE
        for row, _slot in bindings:
            f = flags[row]
            if f & F_BATCH:
                bound_batch[uid_col[row]] = shells.get(row)
                newly.append(row)
            elif f & F_SERVICE:
                n_service += 1
        self.n_pending -= len(bindings)
        self.n_service_bound += n_service

    def _cycle_per_pod(self, snapshot: List[Pod], now: float,
                       stats: CycleStats) -> None:
        """Seed per-pod loop (object engine): the parity reference."""
        obs = self.obs
        prof = obs.prof if obs is not None else None
        for pod in snapshot:
            if pod.phase != PodPhase.PENDING:
                continue   # a binding rescheduler may have placed it already
            if prof is None:
                placed = self.scheduler.schedule(self.cluster, pod, now)
            else:
                t0 = prof.start()
                placed = self.scheduler.schedule(self.cluster, pod, now)
                prof.stop("wave_select", t0, now)
            if placed:
                stats.placed += 1
                continue
            self._handle_unschedulable(pod, now, stats)

    def _handle_unschedulable(self, pod: Pod, now: float,
                              stats: CycleStats) -> None:
        """Alg. 1 fallback chain for one unplaceable pod: reschedule, and on
        failure request scale-out (shared by both cycle engines)."""
        stats.unschedulable += 1
        stats.all_placed = False
        obs = self.obs
        prof = obs.prof if obs is not None else None
        if prof is None:
            outcome = self.rescheduler.reschedule(self.cluster, pod, now)
        else:
            t0 = prof.start()
            outcome = self.rescheduler.reschedule(self.cluster, pod, now)
            prof.stop("reschedule", t0, now)
        if outcome == RescheduleOutcome.WAIT:
            if obs is not None:
                obs.resched(now, pod.uid, 0)   # RS_WAIT
            return   # age gate: suppress autoscaling for this pod too
        if outcome == RescheduleOutcome.RESCHEDULED:
            stats.rescheduled += 1
            # Binding rescheduler may have bound the pod itself.
            # (The RESCHEDULED event — with victim node + relocation count
            # attribution — is recorded by the rescheduler, which knows
            # the plan it committed.)
            if pod.phase != PodPhase.PENDING:
                stats.placed += 1
                stats.unschedulable -= 1
            return
        if obs is not None:
            obs.resched(now, pod.uid, 2)       # RS_FAILED
        stats.scale_out_requests += 1
        self.total_scale_outs += 1
        self.autoscaler.scale_out(self.cluster, pod, now)

    # -- fleet extension: straggler mitigation -----------------------------------
    def _mitigate_stragglers(self, now: float) -> None:
        # uid order == submission order (uids are monotone), matching the
        # seed's scan over self.pods.
        store = self.store
        for uid in sorted(self._bound_batch):
            pod = self._bound_batch[uid]
            if pod is None:
                # Shell-less fast-path resident: gate on the spec flag first
                # (same decision the object path takes) and materialize only
                # candidates that pass it.
                row = store.index[uid]
                if not store.flags[row] & _engine.POD_F_CHECKPOINTABLE:
                    continue
                pod = store.pod_at(row)
                self._bound_batch[uid] = pod
            if not pod.spec.checkpointable:
                continue
            node = self.cluster.node_of(pod)
            if node is None or node.speed_factor >= self.straggler_threshold:
                continue
            if self.on_evict:
                self.on_evict(pod, now)
            obs = self.obs
            if obs is not None:
                obs.reason = 4   # R_STRAGGLER eviction attribution
            try:
                self.cluster.unbind(pod, now)   # checkpoint + requeue
            finally:
                if obs is not None:
                    obs.reason = 0
            node.taint()                    # cordon the straggler
            self.total_evictions += 1
