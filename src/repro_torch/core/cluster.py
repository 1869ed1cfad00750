"""Cluster + node state model (paper §4).

Nodes move through a small state machine::

    PROVISIONING --ready--> READY --taint--> TAINTED --untaint--> READY
          \\                                   |
           \\--------------- terminate --------+--> TERMINATED

``TAINTED`` mirrors the paper's *taint as unschedulable* (Alg. 6 step 3):
schedulers avoid tainted nodes unless no untainted node fits.

Capacity accounting is *request-based*, exactly like the default Kubernetes
scheduler (§4.1): the sum of requests of pods bound to a node never exceeds
its allocatable capacity, regardless of actual usage.

Accounting is **incremental**: ``Node.used`` is maintained on every
add_pod/remove_pod instead of re-summing resident pods on each access, and a
structure-of-arrays mirror (``repro_torch.core.engine.ClusterArrays``) is kept in
lockstep so schedulers can vectorize filter+select.  Both the object path and
the array path read the *same* incrementally-maintained floats, so the two
engines are bit-for-bit identical.

On the array engine, pod state itself is SoA too
(``repro_torch.core.engine.PodStore``, attached as ``Cluster.pod_store``): the
bind/unbind/complete commit points write the pod columns alongside any
materialized ``Pod`` shells, ``bind_wave_store``/``complete_wave_store``
commit whole waves as column writes with the identical accounting ops in
the identical order, and ``Node.pods`` is a :class:`ResidentPods` mapping
whose shell-less residents materialize lazily on first object access.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core import engine as _engine
from repro_torch.core.pods import Pod
from repro_torch.core.resources import Resources, sum_resources


class NodeState(enum.Enum):
    PROVISIONING = "provisioning"   # VM requested, not yet joined the cluster
    READY = "ready"
    TAINTED = "tainted"             # schedulable only as a last resort
    TERMINATED = "terminated"

    @property
    def value_code(self) -> int:
        """Int code used by the SoA mirror's state vector."""
        return _STATE_CODES[self]


_STATE_CODES = {
    NodeState.PROVISIONING: _engine.STATE_PROVISIONING,
    NodeState.READY: _engine.STATE_READY,
    NodeState.TAINTED: _engine.STATE_TAINTED,
    NodeState.TERMINATED: _engine.STATE_TERMINATED,
}

_node_seq = itertools.count()


class ResidentPods(dict):
    """``Node.pods``: a ``{uid: Pod}`` mapping whose values may be *lazy*.

    On the array engine's shell-less fast path (``Cluster.bind_wave_store``)
    a resident pod is recorded as ``uid -> None`` plus its SoA columns in the
    :class:`repro_torch.core.engine.PodStore`; the ``Pod`` shell is materialized
    from the columns the first time any reader actually asks for the object
    (``values()`` / ``items()`` / ``__getitem__`` / ``get``).  Keys, length
    and truthiness never materialize — ``len(node.pods)`` and membership
    checks stay O(1) — so counters, the mirror's ``pod_count`` sync and the
    ``terminate`` guard all see shell-less residents.

    On the seed object engine no lazy entry is ever inserted and every
    operation degrades to the plain dict it subclasses.
    """

    __slots__ = ("_store", "_lazy")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._store = None
        # Conservative "may contain uid -> None entries" flag: set by the
        # fast bind path (once per touched node per wave, not per pod — the
        # per-pod insert stays the inherited C setitem), cleared when a full
        # materialization proves the mapping dense again.  Deletions don't
        # maintain it, so the flag may stay True after the last lazy entry
        # is gone; that only costs one no-op scan on the next values() call.
        self._lazy = False

    # Lazy insertion happens in Cluster.bind_wave_store: a plain
    # ``pods[uid] = None`` per pod (the inherited C setitem) plus one
    # ``_store``/``_lazy`` write per touched node after the wave.

    # -- lazy materialization --------------------------------------------------
    def _materialize(self, uid: int):
        pod = self._store.pod_by_uid(uid)
        dict.__setitem__(self, uid, pod)
        return pod

    def __getitem__(self, uid: int):
        pod = dict.__getitem__(self, uid)
        if pod is None:
            pod = self._materialize(uid)
        return pod

    def get(self, uid, default=None):
        pod = dict.get(self, uid, default)
        if pod is None and dict.__contains__(self, uid):
            pod = self._materialize(uid)
        return pod

    def values(self):
        if self._lazy:
            self._materialize_all()
        return dict.values(self)

    def items(self):
        if self._lazy:
            self._materialize_all()
        return dict.items(self)

    def _materialize_all(self) -> None:
        for uid, pod in list(dict.items(self)):
            if pod is None:
                self._materialize(uid)
        self._lazy = False

    # -- store-aware iteration (invariant checks avoid materializing) ---------
    def lazy_uids(self):
        return [uid for uid, pod in dict.items(self) if pod is None]

    def materialized_values(self):
        return [pod for pod in dict.values(self) if pod is not None]


@dataclasses.dataclass
class Node:
    """One worker (paper: m2.small VM; fleet: one TPU v5e host)."""

    allocatable: Resources
    node_type: str = "worker"
    autoscaled: bool = False            # created dynamically (Alg. 6 precondition)
    node_id: str = ""
    state: NodeState = NodeState.PROVISIONING
    provision_time: float = 0.0         # when the provider was asked for it
    ready_time: Optional[float] = None  # when it joined the cluster
    terminate_time: Optional[float] = None
    pods: Dict[int, Pod] = dataclasses.field(default_factory=dict)
    # Fleet extensions.
    speed_factor: float = 1.0           # <1.0 models a straggler node
    failed: bool = False
    oversub: bool = False               # request-sum may exceed allocatable
    # Availability-zone label for correlated failures (assigned by
    # disruption.ZoneOutageInjector; "" == unlabelled, never targeted).
    zone: str = ""

    def __post_init__(self):
        if not self.node_id:
            self.node_id = f"node-{next(_node_seq)}"
        # Resident-pod mapping with lazy shell materialization (plain-dict
        # behaviour on the seed engine; see ResidentPods).
        self.pods = ResidentPods(self.pods)
        # Incremental accounting (seeded from any pre-populated pods dict).
        self._used_cpu_m: int = 0
        self._used_mem_mb: float = 0.0
        self._moveable_count: int = 0
        self._batch_count: int = 0
        for p in self.pods.values():
            self._account_add(p)
        # SoA mirror back-references, set by Cluster.add_node.
        self._arrays: Optional[_engine.ClusterArrays] = None
        self._slot: Optional[int] = None

    # -- capacity ------------------------------------------------------------
    @property
    def used(self) -> Resources:
        return Resources(self._used_cpu_m, self._used_mem_mb)

    @property
    def free(self) -> Resources:
        return Resources(self.allocatable.cpu_m - self._used_cpu_m,
                         self.allocatable.mem_mb - self._used_mem_mb)

    def fits(self, req: Resources) -> bool:
        return req.fits_in(self.free)

    # -- queries used by the paper's algorithms ------------------------------
    @property
    def schedulable(self) -> bool:
        return self.state == NodeState.READY

    @property
    def last_resort(self) -> bool:
        return self.state == NodeState.TAINTED

    def moveable_pods(self) -> List[Pod]:
        if self._moveable_count == 0:
            return []   # count-based early exit: never materializes shells
        return [p for p in self.pods.values() if p.moveable]

    def has_only_moveable(self) -> bool:
        return bool(self.pods) and self._moveable_count == len(self.pods)

    def has_moveable_and_batch(self) -> bool:
        return (self._moveable_count > 0 and self._batch_count > 0
                and self._moveable_count + self._batch_count == len(self.pods))

    # -- lifecycle -----------------------------------------------------------
    def _notify_state(self) -> None:
        if self._arrays is not None:
            self._arrays.sync_state(self._slot, self)

    def mark_ready(self, now: float) -> None:
        assert self.state == NodeState.PROVISIONING
        self.state = NodeState.READY
        self.ready_time = now
        self._notify_state()

    def taint(self) -> None:
        if self.state == NodeState.READY:
            self.state = NodeState.TAINTED
            self._notify_state()

    def untaint(self) -> None:
        if self.state == NodeState.TAINTED:
            self.state = NodeState.READY
            self._notify_state()

    def terminate(self, now: float) -> None:
        assert not self.pods, f"terminating non-empty node {self.node_id}"
        self.state = NodeState.TERMINATED
        self.terminate_time = now
        self._notify_state()

    # -- bindings ------------------------------------------------------------
    def _account_add(self, pod: Pod) -> None:
        self._used_cpu_m += pod.requests.cpu_m
        self._used_mem_mb += pod.requests.mem_mb
        if pod.moveable:
            self._moveable_count += 1
        if pod.is_batch:
            self._batch_count += 1

    def _account_remove(self, pod: Pod) -> None:
        self._used_cpu_m -= pod.requests.cpu_m
        self._used_mem_mb -= pod.requests.mem_mb
        if pod.moveable:
            self._moveable_count -= 1
        if pod.is_batch:
            self._batch_count -= 1

    def _notify_usage(self) -> None:
        if self._arrays is not None:
            self._arrays.sync_usage(self._slot, self)

    def add_pod(self, pod: Pod, *, enforce: bool = True) -> None:
        if enforce:
            assert pod.requests.fits_in(self.free), (
                f"overcommit on {self.node_id}: {pod} does not fit {self.free}")
        self.pods[pod.uid] = pod
        self._account_add(pod)
        self._notify_usage()

    def remove_pod(self, pod: Pod) -> None:
        del self.pods[pod.uid]
        self._account_remove(pod)
        self._notify_usage()

    def __repr__(self):
        return (f"Node({self.node_id}, {self.state.value}, "
                f"pods={len(self.pods)}, free={self.free})")


class Cluster:
    """The live cluster: the single source of truth (paper: etcd).

    ``arrays`` is the SoA mirror used by the vectorized schedulers / shadow
    capacity / scale-in; pass ``use_arrays=False`` to run the seed
    object-scan engine.  ``wave_select`` and ``wave_runlen`` are the
    mirror's wave kernel and run-length fast path (``ClusterArrays``).

    The orchestrator registers ``on_bind`` / ``on_unbind`` / ``on_complete``
    callbacks so it can maintain its pending queue and running counters
    without rescanning every pod each cycle.
    """

    def __init__(self, use_arrays: bool = True,
                 wave_select: Optional[str] = None,
                 wave_runlen: bool = True):
        self.nodes: Dict[str, Node] = {}
        self.terminated: List[Node] = []    # kept for cost accounting
        self.arrays: Optional[_engine.ClusterArrays] = (
            _engine.ClusterArrays(wave_select=wave_select,
                                  wave_runlen=wave_runlen)
            if use_arrays else None)
        # SoA pod columns (set by the orchestrator on the array engine); the
        # bind/unbind/complete commit points keep it in lockstep with any
        # materialized Pod shells.
        self.pod_store = None
        # slot -> live Node (None once removed): O(1) node lookup for the
        # store fast paths, in lockstep with ClusterArrays slots.
        self._slot_nodes: List[Optional[Node]] = []
        self.on_bind: Optional[Callable[[Pod], None]] = None
        self.on_unbind: Optional[Callable[[Pod], None]] = None
        self.on_complete: Optional[Callable[[Pod], None]] = None
        # Flight recorder (repro_torch.obs.ObsRecorder), attached by
        # build_simulation when ExperimentSpec.obs is set.  Unlike the
        # on_bind/on_unbind observers, the recorder hooks at the *commit*
        # points below, so it sees every bind/evict on both engines without
        # deoptimizing the shell-less fast paths (which key on the observer
        # callbacks staying the orchestrator's own).  None = compiled out:
        # each commit pays one attribute test.
        self.obs = None

    # -- membership ----------------------------------------------------------
    def add_node(self, node: Node) -> Node:
        self.nodes[node.node_id] = node
        if self.arrays is not None:
            node._arrays = self.arrays
            node._slot = self.arrays.add(node)
            self._slot_nodes.append(node)
        return node

    def remove_node(self, node: Node, now: float) -> None:
        node.terminate(now)
        self.terminated.append(node)
        del self.nodes[node.node_id]
        if node._arrays is not None:
            self._slot_nodes[node._slot] = None
            node._arrays.remove(node._slot)
            node._arrays = None

    def get(self, node_id: str) -> Node:
        return self.nodes[node_id]

    # -- views ---------------------------------------------------------------
    def ready_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.state == NodeState.READY]

    def tainted_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.state == NodeState.TAINTED]

    def schedulable_nodes(self) -> List[Node]:
        """READY nodes; the scheduler falls back to TAINTED separately."""
        return self.ready_nodes()

    def provisioning_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values()
                if n.state == NodeState.PROVISIONING]

    def all_pods(self) -> List[Pod]:
        return [p for n in self.nodes.values() for p in n.pods.values()]

    def node_of(self, pod: Pod) -> Optional[Node]:
        return self.nodes.get(pod.node_id) if pod.node_id else None

    def node_by_slot(self, slot: int) -> Node:
        return self.nodes[self.arrays.node_ids[slot]]

    # -- bindings (paper §4.2 createBinding) ----------------------------------
    def bind(self, pod: Pod, node: Node, now: float, *,
             enforce: bool = True) -> None:
        node.add_pod(pod, enforce=enforce)
        pod.bind(node.node_id, now)
        if self.pod_store is not None:
            self.pod_store.sync_bind(pod, node._slot)
        if self.obs is not None:
            # Pod.bind leaves pending_since at the interval it just closed.
            self.obs.bind(now, pod.uid, node.node_id,
                          now - pod.pending_since, pod.incarnation)
        if self.on_bind is not None:
            self.on_bind(pod)

    def bind_wave(self, bindings, now: float) -> None:
        """Commit one wave of scheduler-chosen ``(pod, node)`` binds.

        Equivalent to calling :meth:`bind` per pair — per-pod object effects
        (incremental node accounting, ``Pod.bind``, the ``on_bind`` callback)
        happen in wave order — except that:

        * the SoA mirror's usage columns are synced **once per touched node**
          after the loop instead of once per bind (the mirror is written by
          assignment from the node's final accounting, so the result is
          bit-identical);
        * the per-bind feasibility assert is skipped: the wave already
          established feasibility against bit-identical free values, and the
          per-cycle ``check_invariants`` still guards capacity.
        """
        touched: Dict[str, Node] = {}
        on_bind = self.on_bind
        obs = self.obs
        store = self.pod_store
        for pod, node in bindings:
            node.pods[pod.uid] = pod
            node._account_add(pod)
            touched[node.node_id] = node
            pod.bind(node.node_id, now)
            if store is not None:
                store.sync_bind(pod, node._slot)
            if obs is not None:
                obs.bind(now, pod.uid, node.node_id,
                         now - pod.pending_since, pod.incarnation)
            if on_bind is not None:
                on_bind(pod)
        for node in touched.values():
            node._notify_usage()

    def bind_wave_store(self, bindings, now: float) -> None:
        """Commit one wave of ``(row, slot)`` binds straight into the SoA pod
        columns — the shell-less fast path of ``Orchestrator._cycle_wave``.

        Semantically :meth:`bind_wave` with ``Pod`` objects elided: node
        accounting applies the identical ``+=`` in the identical order, the
        pod's bind record lands in the store columns instead of object
        attributes, and residency is a lazy ``uid -> None`` entry that
        materializes into a shell only if something later asks for the
        object.  Rows that already carry a shell (a re-pended evictee placed
        by the wave) go through the full object transition so the shell and
        columns stay in lockstep.

        The caller guarantees no external ``on_bind`` observer is attached
        (an observer is an API boundary: ``Orchestrator._cycle_wave``
        detects one and falls back to the materializing :meth:`bind_wave`);
        orchestrator bookkeeping happens row-wise on the caller's side.
        """
        store = self.pod_store
        shells = store.shells
        slot_nodes = self._slot_nodes
        uid_col = store.uid
        cpu_col = store.cpu_m
        mem_col = store.mem_mb
        flag_col = store.flags
        phase_col = store.phase
        slot_col = store.node_slot
        bt_col = store.bound_time
        touched: Dict[int, Node] = {}
        F_BATCH = _engine.POD_F_BATCH
        F_MOVE = _engine.POD_F_MOVEABLE
        obs = self.obs
        if obs is not None:
            ps_col = store.pending_since
            inc_col = store.incarnation
            for row, slot in bindings:
                # Columns are untouched until the commit loop below, so the
                # open pending interval and incarnation read exactly.
                obs.bind(now, uid_col[row], slot_nodes[slot].node_id,
                         now - ps_col[row], inc_col[row])
        for row, slot in bindings:
            node = slot_nodes[slot]
            uid = uid_col[row]
            pod = shells.get(row)
            if pod is not None:
                node.pods[uid] = pod
                node._account_add(pod)
                pod.bind(node.node_id, now)
                phase_col[row] = _engine.POD_BOUND
                slot_col[row] = slot
                bt_col[row] = pod.bound_time
            else:
                # Lazy residency: uid -> None via the inherited C dict
                # setitem; the touched loop below arms the node's
                # ResidentPods (_store/_lazy) once per node, not per pod.
                node.pods[uid] = None
                # Same += order as Node._account_add, on the same scalars.
                node._used_cpu_m += cpu_col[row]
                node._used_mem_mb += mem_col[row]
                f = flag_col[row]
                if f & F_MOVE:
                    node._moveable_count += 1
                if f & F_BATCH:
                    node._batch_count += 1
                phase_col[row] = _engine.POD_BOUND
                slot_col[row] = slot
                bt_col[row] = now
            touched[slot] = node
        for node in touched.values():
            pods = node.pods
            pods._store = store
            pods._lazy = True
            node._notify_usage()

    def unbind(self, pod: Pod, now: float, *, failed: bool = False) -> None:
        node = self.node_of(pod)
        if node is not None:
            node.remove_pod(pod)
        pod.evict(now, failed=failed)
        if self.pod_store is not None:
            self.pod_store.sync_unbind(pod)
        if self.obs is not None:
            self.obs.evict(now, pod.uid,
                           node.node_id if node is not None else None,
                           pod.incarnation, failed)
        if self.on_unbind is not None:
            self.on_unbind(pod)

    def fail_node_store(self, node: Node, now: float,
                        on_row=None) -> List[int]:
        """Bulk-evict every resident of a failing node straight through the
        SoA pod columns — the shell-less fast path of
        ``Simulation._on_node_fail``.

        Semantically identical to calling :meth:`unbind` (``failed=True``)
        per resident in residency (insertion) order.  Residents that carry
        a shell — and checkpointable residents whose eviction would bank
        durable progress, which ``Pod._restore``'s progress-is-zero
        invariant requires to materialize — take the full object
        transition; everything else re-pends as pure column writes: node
        accounting decrements in the identical scalar order, the pending
        interval the bind opened recorded in
        ``PodStore.closed_intervals``, and lost work accumulated in the
        ``lost_work_s`` column with the identical float ops ``Pod.evict``
        applies (a shell-less row has ``progress_s == 0`` by
        construction, so ``0.0 + ran`` is bit-exact).  The mirror syncs
        once after the loop.  ``on_row`` is the orchestrator's row-level
        ``on_unbind`` equivalent for column-evicted rows; shelled
        residents still go through ``self.on_unbind``.  The caller
        guarantees no external ``on_unbind`` observer is attached
        (``Simulation._on_node_fail`` detects one and falls back to the
        per-pod object loop so observers see real pods, in order).

        Returns the evicted uids in residency order (the disruption log's
        victim list)."""
        store = self.pod_store
        shells = store.shells
        index = store.index
        flag_col = store.flags
        bt_col = store.bound_time
        ps_col = store.pending_since
        lost_col = store.lost_work_s
        cpu_col = store.cpu_m
        mem_col = store.mem_mb
        spec_of = store._spec_by_id
        sid_col = store.spec_id
        phase_col = store.phase
        slot_col = store.node_slot
        inc_col = store.incarnation
        closed = store.closed_intervals
        F_BATCH = _engine.POD_F_BATCH
        F_MOVE = _engine.POD_F_MOVEABLE
        F_CKPT = _engine.POD_F_CHECKPOINTABLE
        on_unbind = self.on_unbind
        obs = self.obs
        victims = list(dict.keys(node.pods))
        for uid in victims:
            row = index[uid]
            pod = shells.get(row)
            f = flag_col[row]
            if pod is None and f & F_CKPT:
                iv = spec_of[sid_col[row]].checkpoint_interval_s or 1.0
                total = 0.0 + (now - bt_col[row])
                if (total // iv) * iv > 0.0:
                    # Eviction would bank durable progress — materialize so
                    # the shell carries it (Pod._restore invariant).
                    pod = store.pod_at(row)
            if pod is not None:
                del node.pods[uid]
                node._account_remove(pod)
                pod.evict(now, failed=True)
                store.sync_unbind(pod)
                if obs is not None:
                    obs.evict(now, uid, node.node_id, pod.incarnation, True)
                if on_unbind is not None:
                    on_unbind(pod)
                continue
            dict.__delitem__(node.pods, uid)
            # Same -= order as Node._account_remove, on the same scalars.
            node._used_cpu_m -= cpu_col[row]
            node._used_mem_mb -= mem_col[row]
            if f & F_MOVE:
                node._moveable_count -= 1
            if f & F_BATCH:
                node._batch_count -= 1
            bt = bt_col[row]
            if f & F_BATCH:
                ran = now - bt
                if f & F_CKPT:
                    # Salvage is provably zero (guarded above): the whole
                    # run since bind is lost, via Pod.evict's exact ops.
                    iv = spec_of[sid_col[row]].checkpoint_interval_s or 1.0
                    total = 0.0 + ran
                    lost_col[row] += total - (total // iv) * iv
                else:
                    lost_col[row] += 0.0 + ran
            # Pod.evict column semantics: close the interval the bind
            # opened, re-pend as a fresh incarnation.
            closed.setdefault(row, []).append(bt - ps_col[row])
            phase_col[row] = _engine.POD_PENDING
            slot_col[row] = -1
            bt_col[row] = None
            ps_col[row] = now
            inc_col[row] += 1
            if obs is not None:
                obs.evict(now, uid, node.node_id, int(inc_col[row]), True)
            if on_row is not None:
                on_row(row)
        node._notify_usage()
        return victims

    def complete(self, pod: Pod, now: float) -> None:
        """A batch pod ran to completion: release capacity, mark SUCCEEDED."""
        node = self.node_of(pod)
        if node is not None:
            node.remove_pod(pod)
        pod.complete(now)
        if self.pod_store is not None:
            self.pod_store.sync_complete(pod)
        if self.on_complete is not None:
            self.on_complete(pod)

    def complete_wave(self, pods, now: float) -> None:
        """Commit one batch of completions sharing a timestamp.

        Equivalent to calling :meth:`complete` per pod in order — per-pod
        object effects (incremental node accounting, ``Pod.complete``, the
        ``on_complete`` callback) are identical — except the SoA mirror's
        usage columns sync **once per touched node** after the loop instead
        of once per pod (assignment from the node's final accounting, so the
        mirror lands on bit-identical values)."""
        touched: Dict[str, Node] = {}
        nodes = self.nodes
        on_complete = self.on_complete
        store = self.pod_store
        for pod in pods:
            node = nodes.get(pod.node_id)
            if node is not None:
                del node.pods[pod.uid]
                node._account_remove(pod)
                touched[node.node_id] = node
            pod.complete(now)
            if store is not None:
                store.sync_complete(pod)
            if on_complete is not None:
                on_complete(pod)
        for node in touched.values():
            node._notify_usage()

    def complete_wave_store(self, entries, now: float, on_row=None) -> None:
        """Commit one timestamp-bucket of completions on the store path.

        ``entries`` preserves bind order and may mix shell-less **rows**
        (ints) with materialized **Pod** objects (a shelled pod bound in the
        same bucket as shell-less ones): each entry applies the seed's
        per-completion effects — node accounting decrements in entry order,
        ``Pod.complete`` semantics (phase SUCCEEDED, finish time, node
        linkage retained) — with rows writing columns instead of attributes.
        ``on_row`` is the orchestrator's row-level ``on_complete``
        equivalent; ``Pod`` entries still go through ``self.on_complete``.
        The mirror syncs once per touched node, like :meth:`complete_wave`.
        """
        store = self.pod_store
        slot_nodes = self._slot_nodes
        uid_col = store.uid
        cpu_col = store.cpu_m
        mem_col = store.mem_mb
        flag_col = store.flags
        phase_col = store.phase
        ft_col = store.finish_time
        nodes = self.nodes
        on_complete = self.on_complete
        touched: Dict[int, Node] = {}   # id(node) -> node
        F_BATCH = _engine.POD_F_BATCH
        F_MOVE = _engine.POD_F_MOVEABLE
        shells = store.shells
        for entry in entries:
            if type(entry) is int:
                row = entry
                pod = shells.get(row)
                if pod is None:
                    uid = uid_col[row]
                    node = slot_nodes[store.node_slot[row]]
                    if node is not None:
                        del node.pods[uid]
                        # Same -= order as Node._account_remove.
                        node._used_cpu_m -= cpu_col[row]
                        node._used_mem_mb -= mem_col[row]
                        f = flag_col[row]
                        if f & F_MOVE:
                            node._moveable_count -= 1
                        if f & F_BATCH:
                            node._batch_count -= 1
                        touched[id(node)] = node
                    phase_col[row] = _engine.POD_SUCCEEDED
                    ft_col[row] = now
                    if on_row is not None:
                        on_row(row)
                    continue
                # A shell materialized since the bind: fall through to the
                # object transition so shell and columns stay in lockstep.
            else:
                pod = entry
            node = nodes.get(pod.node_id)
            if node is not None:
                del node.pods[pod.uid]
                node._account_remove(pod)
                touched[id(node)] = node
            pod.complete(now)
            store.sync_complete(pod)
            if on_complete is not None:
                on_complete(pod)
        for node in touched.values():
            node._notify_usage()

    # -- metrics fast path ----------------------------------------------------
    def utilization_totals(self):
        """``(n_nodes, ram_ratio_sum, cpu_ratio_sum, pod_count_sum)`` over
        READY|TAINTED nodes — the exact sums behind the Table-5 ratios.

        On the array engine this reads the mirror's incrementally-maintained
        sampling aggregates (O(dirty slots) since the last sample,
        ``engine.ClusterArrays.sample_totals``); the object path recomputes
        from scratch.  Both produce the correctly-rounded ``fsum`` of the
        same per-node ratios, so dividing by ``n_nodes`` gives Table-5
        values bit-identical across engines and across sampling strategies
        (``statistics.fmean(xs) == math.fsum(xs) / len(xs)``)."""
        if self.arrays is not None:
            return self.arrays.sample_totals()
        n, ram, cpu, ppn = self.utilization_view()
        return n, math.fsum(ram), math.fsum(cpu), sum(ppn)

    def utilization_view(self):
        """(n_nodes, ram_ratios, cpu_ratios, pods_per_node) over READY|TAINTED
        nodes, in insertion order.  Array path and object path produce
        bit-identical values (same floats, same elementwise ops).  The
        Table-5 sampler itself uses :meth:`utilization_totals`; this
        per-node view remains for diagnostics and as the from-scratch
        reference the aggregate parity tests compare against."""
        if self.arrays is not None:
            arr = self.arrays
            state = arr.live("state")
            mask = arr.live("active") & (
                (state == _engine.STATE_READY) | (state == _engine.STATE_TAINTED))
            alloc_c = arr.live("alloc_cpu")[mask]
            ram = arr.live("used_mem")[mask] / arr.live("alloc_mem")[mask]
            cpu = arr.live("used_cpu")[mask] / np.maximum(alloc_c, 1)
            ppn = arr.live("pod_count")[mask]
            return int(mask.sum()), ram, cpu, ppn
        nodes = [n for n in self.nodes.values()
                 if n.state in (NodeState.READY, NodeState.TAINTED)]
        ram = [n.used.mem_mb / n.allocatable.mem_mb for n in nodes]
        cpu = [n.used.cpu_m / max(n.allocatable.cpu_m, 1) for n in nodes]
        ppn = [len(n.pods) for n in nodes]
        return len(nodes), ram, cpu, ppn

    # -- invariant (property-tested) ------------------------------------------
    def check_invariants(self, deep: bool = False) -> None:
        if self.arrays is not None:
            # Vectorized fast path: capacity respected on every live node.
            # The orchestrator runs the deep check periodically so mirror
            # drift / pod-linkage bugs still surface on the array engine.
            arr = self.arrays
            live = arr.live("active") & ~arr.live("oversub")
            over_cpu = arr.live("used_cpu") > arr.live("alloc_cpu")
            over_mem = arr.live("used_mem") > arr.live("alloc_mem") + 1e-6
            bad = live & (over_cpu | over_mem)
            if bad.any():
                slot = int(np.argmax(bad))
                raise AssertionError(
                    f"capacity violated on {arr.node_ids[slot]}")
            if not deep:
                return
            if self.pod_store is not None:
                # Array-native deep audit: node accounting re-summed from
                # the PodStore columns with bincount reductions + shell
                # lockstep checks (engine.PodStore.audit_columns), then the
                # mirror cross-verified field-by-field against the object
                # model.  No shell is materialized; the per-node object
                # walk below remains for store-less clusters.
                self.pod_store.audit_columns(self)
                self.arrays.verify_against(self)
                return
        store = self.pod_store
        for n in self.nodes.values():
            if n.oversub:
                continue   # estimator-driven oversubscription is intentional
            used = n.used
            assert used.cpu_m <= n.allocatable.cpu_m, n
            assert used.mem_mb <= n.allocatable.mem_mb + 1e-6, n
            # Shell-less residents are checked against their columns rather
            # than materialized — a deep check must not defeat the lazy-shell
            # economics of the store fast path.
            lazy = n.pods.lazy_uids() if store is not None else []
            for p in n.pods.materialized_values():
                assert p.node_id == n.node_id, (p, n)
            for uid in lazy:
                row = store.index[uid]
                assert store.phase[row] == _engine.POD_BOUND, (uid, n)
                assert store.node_slot[row] == n._slot, (uid, n)
            if deep:
                # incremental accounting matches a fresh re-sum
                resum = sum_resources(
                    p.requests for p in n.pods.materialized_values())
                for uid in lazy:
                    row = store.index[uid]
                    resum = resum + Resources(store.cpu_m[row],
                                              store.mem_mb[row])
                assert used.cpu_m == resum.cpu_m, n
                assert abs(used.mem_mb - resum.mem_mb) < 1e-6, n
        if deep and self.arrays is not None:
            self.arrays.verify_against(self)
