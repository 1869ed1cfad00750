"""Reschedulers (paper §6.2, Algorithms 3 & 4).

Both active variants share the same plan-construction logic: pick a victim
node, plan relocations for its moveable pods onto *other* nodes using shadow
capacity accounting, and commit only if the freed memory lets the
unschedulable pod fit.  They differ in what happens after eviction:

* **Non-binding** — evictees and the pending pod go back to the queue; the
  scheduler places everyone next cycle ("it seems to be a better option to
  allow the scheduler to place all pending pods", §7.2).
* **Binding** — the rescheduler itself creates the bindings it planned.

Pseudocode/text discrepancy note: the paper's prose says candidate nodes are
sorted *ascending* by available memory while Algorithms 3/4 say *descending*.
We follow the pseudocode (descending): the node with the most free memory
needs the fewest evictions to make room, which matches the algorithm's
evict-as-little-as-possible structure.  (`sort_ascending=True` switches to the
prose order for the ablation in benchmarks.)

``_ShadowCapacity`` is array-backed when the cluster carries a SoA mirror:
best-fit placement of each mover is a masked argmin over the free-memory
vector instead of a dict scan.  The same shadow is used by Alg. 6 scale-in
placeability checks (see ``autoscaler._all_placeable``).
"""
from __future__ import annotations

import abc
import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import engine as _engine
from repro_torch.core.cluster import Cluster, Node
from repro_torch.core.pods import Pod
from repro_torch.core.resources import Resources
from repro_torch.obs.recorder import R_RESCHED, R_UNSPEC, RS_RESCHEDULED


class RescheduleOutcome(enum.Enum):
    """Tri-state result consumed by the orchestrator (Alg. 1).

    The `max_pod_age` gate exists "with the aim of reducing the number of
    unnecessary rescheduling **and autoscaling** decisions" (§6.2) — i.e. a
    young pending pod yields WAIT, which suppresses scale-out for this cycle
    and gives running batch jobs the chance to complete and free room.
    """

    WAIT = "wait"            # age gate not reached — do NOT scale out yet
    RESCHEDULED = "done"     # evictions performed (room being made)
    FAILED = "failed"        # nothing can be consolidated — scale out


@dataclasses.dataclass
class ReschedulePlan:
    """Planned evictions: victim node + (pod -> target node id) map."""

    victim: Node
    relocations: Dict[int, Tuple[Pod, str]]   # uid -> (pod, target node id)


class _ShadowBase:
    """Version-keyed base snapshot shared by a cycle's shadow passes.

    Rebuilding ``_ShadowCapacity`` costs O(n_slots) per candidate node per
    blocked pod, and a deeply-backlogged cycle replays the identical failing
    plan for hundreds of blocked pods against an *unchanged* cluster — the
    ROADMAP bottleneck that forced the sweep onto the void rescheduler.
    This cache keeps one base copy of the free vectors + READY mask, keyed
    on the mirror's monotone ``version`` counter (any bind/unbind/
    membership/state change bumps it), and serves shadows that *undo their
    own writes* (verbatim old-value restore, so the base stays bit-exact)
    instead of re-snapshotting.  ``failed_keys`` additionally latches
    request sizes whose plan construction failed at this version: plan
    construction is a pure function of (cluster state, pod.requests), so an
    identical request can only fail identically until the version moves.
    """

    __slots__ = ("arr", "version", "free_cpu", "free_mem", "ready_mask",
                 "failed_keys")

    def __init__(self):
        self.arr = None
        self.version = -1

    def refresh(self, arr) -> None:
        if arr is self.arr and arr.version == self.version:
            return
        self.arr = arr
        self.version = arr.version
        # Same `alloc - used` float op free_views() applies — bit-identical
        # to an uncached per-pod snapshot at this version.
        self.free_cpu, self.free_mem = arr.free_views()
        self.ready_mask = arr.live("active") & (
            arr.live("state") == _engine.STATE_READY)
        self.failed_keys = set()


class _ShadowCapacity:
    """Hypothetical free-capacity tracker for multi-pod relocation planning.

    Array mode (cluster has a SoA mirror): snapshot of the free vectors with
    the victim masked out; ``place_best_fit`` is a masked argmin + in-place
    subtraction.  Dict mode (seed engine): per-node ``Resources`` map.  Both
    modes pick min (free_mem, node_id) and subtract with the same float ops,
    so plans are identical.

    With a ``base`` (`_ShadowBase`), the shadow borrows the cached vectors
    instead of snapshotting, records every write in an undo log, and
    ``rollback()`` restores the stored old values verbatim — exact, unlike
    add-the-delta-back, which is not an IEEE-754 inverse.  Callers that
    pass ``base`` must call ``rollback()`` when done (try/finally).
    """

    def __init__(self, cluster: Cluster, exclude: Node,
                 base: Optional[_ShadowBase] = None):
        self._arr = cluster.arrays
        self._undo = None
        self._excluded = None
        if self._arr is not None:
            arr = self._arr
            if base is not None:
                base.refresh(arr)
                self.free_cpu, self.free_mem = base.free_cpu, base.free_mem
                self.mask = base.ready_mask
                self._undo = []
                if exclude._slot is not None and exclude._arrays is arr:
                    slot = exclude._slot
                    self._excluded = (slot, bool(self.mask[slot]))
                    self.mask[slot] = False
                return
            self.free_cpu, self.free_mem = arr.free_views()
            self.mask = arr.live("active") & (
                arr.live("state") == _engine.STATE_READY)
            if exclude._slot is not None and exclude._arrays is arr:
                self.mask[exclude._slot] = False
            return
        self.free: Dict[str, Resources] = {
            n.node_id: n.free for n in cluster.ready_nodes()
            if n.node_id != exclude.node_id
        }

    def place_best_fit(self, req: Resources) -> Optional[str]:
        """Best-fit placement against shadow capacities (consistent with
        the best-fit scheduler the system runs)."""
        if self._arr is not None:
            fits = self.mask & (self.free_cpu >= req.cpu_m) & (
                (self.free_mem + 1e-9) >= req.mem_mb)
            if not fits.any():
                return None
            best = self.free_mem[fits].min()
            slot = self._arr.first_by_id(fits & (self.free_mem == best))
            if self._undo is not None:
                self._undo.append((slot, self.free_cpu[slot],
                                   self.free_mem[slot]))
            self.free_cpu[slot] -= req.cpu_m
            self.free_mem[slot] -= req.mem_mb
            return self._arr.node_ids[slot]
        candidates = [(free.mem_mb, nid) for nid, free in self.free.items()
                      if req.fits_in(free)]
        if not candidates:
            return None
        _, nid = min(candidates)
        self.free[nid] = self.free[nid] - req
        return nid

    def rollback(self) -> None:
        """Restore a base-backed shadow's writes (no-op otherwise)."""
        if self._undo is not None:
            for slot, cpu, mem in reversed(self._undo):
                self.free_cpu[slot] = cpu
                self.free_mem[slot] = mem
            self._undo = []
        if self._excluded is not None:
            slot, was = self._excluded
            self.mask[slot] = was
            self._excluded = None


class Rescheduler(abc.ABC):
    """Interface used by the orchestrator when a pod is unschedulable."""

    name = "rescheduler"

    def __init__(self, max_pod_age_s: float = 60.0, sort_ascending: bool = False):
        self.max_pod_age_s = max_pod_age_s
        self.sort_ascending = sort_ascending
        # Observability recorder (repro_torch.obs.ObsRecorder.attach sets it);
        # None = compiled out.
        self.obs = None
        # Array-engine plan-construction cache, version-invalidated (see
        # _ShadowBase): shared across every blocked pod of a cycle as long
        # as nothing mutates the cluster in between.
        self._shadow_base = _ShadowBase()

    @abc.abstractmethod
    def reschedule(self, cluster: Cluster, pod: Pod, now: float) -> RescheduleOutcome:
        """Try to make room for `pod` (see RescheduleOutcome)."""

    # -- shared plan construction (Alg. 3/4 body) -----------------------------
    def _candidate_nodes(self, cluster: Cluster, pod: Pod) -> List[Node]:
        """Stage 1 filter: READY nodes that already have enough *CPU* for the
        pod (evictions only need to free memory, the non-compressible axis),
        sorted by (free_mem, node_id) — descending unless sort_ascending."""
        arr = cluster.arrays
        if arr is not None:
            free_cpu, free_mem = arr.free_views()
            mask = arr.live("active") & (
                arr.live("state") == _engine.STATE_READY) & (
                free_cpu >= pod.requests.cpu_m)
            idx = np.nonzero(mask)[0]
            rank = arr.live("id_rank")[idx]
            if self.sort_ascending:
                order = np.lexsort((rank, free_mem[idx]))
            else:
                order = np.lexsort((-rank, -free_mem[idx]))
            return [cluster.node_by_slot(int(i)) for i in idx[order]]
        nodes = [n for n in cluster.ready_nodes()
                 if pod.requests.cpu_fits_in(n.free)]
        nodes.sort(key=lambda n: (n.free.mem_mb, n.node_id),
                   reverse=not self.sort_ascending)
        return nodes

    def _build_plan(self, cluster: Cluster, pod: Pod) -> Optional[ReschedulePlan]:
        # Plan construction is deterministic in (cluster state, pod.requests):
        # on the array engine, latch request sizes that failed at the current
        # mirror version so the deeply-backlogged case — many blocked pods of
        # the same shape against an unchanged cluster — pays for one scan
        # instead of one per pod.  The object path stays verbatim seed
        # behavior (it is the parity reference; both paths build identical
        # plans regardless).
        arr = cluster.arrays
        base = None
        if arr is not None:
            base = self._shadow_base
            base.refresh(arr)
            key = (pod.requests.cpu_m, pod.requests.mem_mb)
            if key in base.failed_keys:
                return None
        obs = self.obs
        prof = obs.prof if obs is not None else None
        if prof is None:
            plan = self._build_plan_uncached(cluster, pod, base)
        else:
            t0 = prof.start()
            plan = self._build_plan_uncached(cluster, pod, base)
            prof.stop("shadow_plan", t0)
        if plan is None and base is not None:
            base.failed_keys.add(key)
        return plan

    def _build_plan_uncached(self, cluster: Cluster, pod: Pod,
                             base: Optional[_ShadowBase]) -> Optional[ReschedulePlan]:
        for node in self._candidate_nodes(cluster, pod):
            moveables = node.moveable_pods()
            if not moveables:
                continue
            # Evict the largest movers first: fewest evictions to close the gap.
            moveables.sort(key=lambda p: (p.requests.mem_mb, p.uid), reverse=True)
            shadow = _ShadowCapacity(cluster, exclude=node, base=base)
            try:
                relocations: Dict[int, Tuple[Pod, str]] = {}
                freed = 0.0
                needed = pod.requests.mem_mb - node.free.mem_mb
                for mover in moveables:
                    if freed >= needed - 1e-9:
                        break
                    target = shadow.place_best_fit(mover.requests)
                    if target is None:
                        continue
                    relocations[mover.uid] = (mover, target)
                    freed += mover.requests.mem_mb
                if freed >= needed - 1e-9 and relocations:
                    return ReschedulePlan(victim=node, relocations=relocations)
            finally:
                shadow.rollback()
        return None

    def _gated(self, pod: Pod, now: float) -> bool:
        """Alg. 3/4 precondition: pod must have been pending max_pod_age."""
        return pod.age(now) >= self.max_pod_age_s


class VoidRescheduler(Rescheduler):
    """Paper: ignores every rescheduling request — no gate, so the
    orchestrator proceeds straight to scale-out ("blindly provisions")."""

    name = "void"

    def reschedule(self, cluster: Cluster, pod: Pod, now: float) -> RescheduleOutcome:
        return RescheduleOutcome.FAILED


class NonBindingRescheduler(Rescheduler):
    """Paper Alg. 3: evict planned movers; everyone returns to the queue."""

    name = "non-binding"

    def reschedule(self, cluster: Cluster, pod: Pod, now: float) -> RescheduleOutcome:
        if not self._gated(pod, now):
            return RescheduleOutcome.WAIT
        plan = self._build_plan(cluster, pod)
        if plan is None:
            return RescheduleOutcome.FAILED
        obs = self.obs
        if obs is not None:
            obs.resched(now, pod.uid, RS_RESCHEDULED,
                        victim=plan.victim.node_id,
                        n_moved=len(plan.relocations))
            obs.reason = R_RESCHED   # eviction attribution context
        try:
            for mover, _target in plan.relocations.values():
                cluster.unbind(mover, now)   # -> PENDING, recreated next cycle
        finally:
            if obs is not None:
                obs.reason = R_UNSPEC
        return RescheduleOutcome.RESCHEDULED


class BindingRescheduler(Rescheduler):
    """Paper Alg. 4: evict planned movers and bind them (and the pending pod)
    to their planned nodes immediately."""

    name = "binding"

    def reschedule(self, cluster: Cluster, pod: Pod, now: float) -> RescheduleOutcome:
        if not self._gated(pod, now):
            return RescheduleOutcome.WAIT
        plan = self._build_plan(cluster, pod)
        if plan is None:
            return RescheduleOutcome.FAILED
        obs = self.obs
        if obs is not None:
            obs.resched(now, pod.uid, RS_RESCHEDULED,
                        victim=plan.victim.node_id,
                        n_moved=len(plan.relocations))
            obs.reason = R_RESCHED   # eviction attribution context
        try:
            for mover, target in plan.relocations.values():
                cluster.unbind(mover, now)
                cluster.bind(mover, cluster.get(target), now)
        finally:
            if obs is not None:
                obs.reason = R_UNSPEC
        # Place the unschedulable pod on the freed victim node.
        if plan.victim.fits(pod.requests):
            cluster.bind(pod, plan.victim, now)
        return RescheduleOutcome.RESCHEDULED


RESCHEDULERS = {
    cls.name: cls
    for cls in (VoidRescheduler, NonBindingRescheduler, BindingRescheduler)
}
