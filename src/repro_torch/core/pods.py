"""Pod / job object model (paper §3, §5.1).

A *pod* is the schedulable unit.  The paper distinguishes:

* **services** — long-running, latency-sensitive (K8s ``Deployment``), may be
  labelled ``rescheduling: moveable``;
* **batch jobs** — run-to-completion (K8s ``Job``), labelled ``type: batch``,
  never moveable.

In the TPU-fleet adaptation a service pod is a serving deployment and a batch
pod is a training job; *moveable* means *checkpointable* (the eviction →
recreate cycle becomes checkpoint → restore, see ``repro_torch.train.checkpoint``).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional

from repro_torch.core.resources import Resources


class PodKind(enum.Enum):
    SERVICE = "service"   # long-running (K8s Deployment / serving job)
    BATCH = "batch"       # run-to-completion (K8s Job / training job)


class PodPhase(enum.Enum):
    PENDING = "pending"       # in the scheduling queue
    BOUND = "bound"           # binding created; starts running at bind time
    SUCCEEDED = "succeeded"   # batch only: ran to completion
    EVICTED = "evicted"       # shut down for rescheduling; will be recreated
    FAILED = "failed"         # node failure killed it; will be recreated


_uid = itertools.count()


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """Immutable template for a pod (the YAML of Fig. 3/4 in the paper)."""

    type_name: str                 # e.g. "batch_small", "service_med"
    kind: PodKind
    requests: Resources            # requests == limits (guaranteed QoS class)
    duration_s: float = 0.0        # batch only: nominal runtime
    moveable: bool = False         # services only (label rescheduling:moveable)
    # Fleet extension: moveable batch jobs are checkpointable training jobs.
    checkpointable: bool = False
    checkpoint_interval_s: float = 0.0
    scheduler_name: str = "customScheduler"

    def __post_init__(self):
        if self.kind == PodKind.BATCH and self.moveable:
            raise ValueError("paper §5.1: batch jobs cannot be moveable")


class Pod:
    """A live pod instance.

    A pod evicted by the rescheduler/autoscaler is *recreated*: in Kubernetes
    the deployment controller spawns a fresh pod for the same template.  We
    model that by resetting the instance back to PENDING with a fresh
    ``pending_since`` and an incremented ``incarnation`` — identity (``uid``)
    is stable across incarnations so metrics can track the logical task.

    A plain slotted class, not a dataclass: large traces create one instance
    per arrival (50 k+ per benchmark run), so construction and attribute
    access are hot.  ``requests`` / ``is_batch`` / ``is_service`` /
    ``moveable`` are materialized once from the immutable spec instead of
    going through property descriptors on every read.
    """

    __slots__ = ("spec", "submit_time", "uid", "phase", "node_id",
                 "pending_since", "bound_time", "finish_time", "incarnation",
                 "progress_s", "checkpointed_s", "lost_work_s",
                 "pending_intervals",
                 "requests", "is_batch", "is_service", "moveable")

    def __init__(self, spec: PodSpec, submit_time: float):
        self.spec = spec
        self.submit_time = submit_time
        self.uid: int = next(_uid)
        self.phase = PodPhase.PENDING
        self.node_id: Optional[str] = None
        self.pending_since = submit_time  # start of current pending interval
        self.bound_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.incarnation = 0
        self.progress_s = 0.0       # batch: completed work (checkpoint restore)
        self.checkpointed_s = 0.0   # batch: durable progress at last checkpoint
        self.lost_work_s = 0.0      # batch: Σ executed-but-not-durable work
        self.pending_intervals: list = []
        self.requests: Resources = spec.requests
        self.is_batch: bool = spec.kind == PodKind.BATCH
        self.is_service: bool = spec.kind == PodKind.SERVICE
        self.moveable: bool = spec.moveable

    @classmethod
    def _restore(cls, spec: PodSpec, submit_time: float, uid: int,
                 phase: "PodPhase", node_id: Optional[str],
                 pending_since: float, bound_time: Optional[float],
                 finish_time: Optional[float], incarnation: int,
                 pending_intervals: list, lost_work_s: float = 0.0) -> "Pod":
        """Materialize a pod *shell* from SoA column state (PodStore).

        Unlike ``__init__`` this does **not** draw from the global uid
        counter: the store already allocated the uid at ingest time.  The
        attribute values are handed in verbatim from the columns, so the
        shell is indistinguishable from the object the seed path would have
        produced (property-tested by ``tests/test_engine_parity.py``).
        A store-resident pod is only evicted column-natively when it banks
        no durable progress (``Cluster.fail_node_store`` materializes it
        otherwise), so ``progress_s`` / ``checkpointed_s`` are always zero
        here — but ``lost_work_s`` may carry prior bulk-eviction losses.
        """
        pod = object.__new__(cls)
        pod.spec = spec
        pod.submit_time = submit_time
        pod.uid = uid
        pod.phase = phase
        pod.node_id = node_id
        pod.pending_since = pending_since
        pod.bound_time = bound_time
        pod.finish_time = finish_time
        pod.incarnation = incarnation
        pod.progress_s = 0.0
        pod.checkpointed_s = 0.0
        pod.lost_work_s = lost_work_s
        pod.pending_intervals = pending_intervals
        pod.requests = spec.requests
        pod.is_batch = spec.kind == PodKind.BATCH
        pod.is_service = spec.kind == PodKind.SERVICE
        pod.moveable = spec.moveable
        return pod

    # -- convenience ---------------------------------------------------------
    @property
    def name(self) -> str:
        return f"{self.spec.type_name}-{self.uid}"

    def age(self, now: float) -> float:
        """Time spent in the current pending interval (rescheduler gate)."""
        return now - self.pending_since

    def remaining_s(self, now: float) -> float:
        """Batch only: work left, given progress at the current binding."""
        assert self.is_batch and self.bound_time is not None
        done_before = self.progress_s
        return max(0.0, self.spec.duration_s - done_before - (now - self.bound_time))

    # -- lifecycle -----------------------------------------------------------
    def bind(self, node_id: str, now: float) -> None:
        assert self.phase == PodPhase.PENDING, self
        self.pending_intervals.append(now - self.pending_since)
        self.phase = PodPhase.BOUND
        self.node_id = node_id
        self.bound_time = now

    def evict(self, now: float, *, failed: bool = False) -> None:
        """Shut down and immediately recreate as a fresh PENDING incarnation."""
        assert self.phase == PodPhase.BOUND, self
        if self.is_batch:
            ran = now - (self.bound_time or now)
            if self.spec.checkpointable:
                # Durable progress = last checkpoint boundary (fleet semantics).
                iv = self.spec.checkpoint_interval_s or 1.0
                total = self.progress_s + ran
                self.checkpointed_s = (total // iv) * iv
                # Work past the last durable checkpoint is redone on restore.
                self.lost_work_s += total - self.checkpointed_s
                self.progress_s = self.checkpointed_s
            elif failed:
                self.lost_work_s += self.progress_s + ran
                self.progress_s = 0.0     # restart from scratch
            # moveable batch pods do not exist (guarded in PodSpec)
        self.phase = PodPhase.FAILED if failed else PodPhase.EVICTED
        self.node_id = None
        self.bound_time = None
        # recreate
        self.phase = PodPhase.PENDING
        self.pending_since = now
        self.incarnation += 1

    def complete(self, now: float) -> None:
        assert self.is_batch and self.phase == PodPhase.BOUND
        self.phase = PodPhase.SUCCEEDED
        self.finish_time = now

    def __hash__(self):
        return hash(self.uid)

    def __eq__(self, other):
        return isinstance(other, Pod) and other.uid == self.uid

    def __repr__(self):
        return (f"Pod({self.name}, {self.phase.value}, node={self.node_id}, "
                f"inc={self.incarnation})")
