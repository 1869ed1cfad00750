"""Live mode: the orchestrator drives *real torch jobs* on in-process
nodes, as ``repro/cloud/local_provider.py`` drives JAX jobs.

A *node* is a worker slot (capacity-accounted exactly like a sim node),
a *batch pod* is a real ``repro_torch.train.Trainer`` running in a
thread, and a *moveable service* is a ``ServeEngine``.  Eviction sends
the cooperative stop signal; the trainer checkpoints; the next binding
resumes from the durable step on whichever node the scheduler picks —
the paper's recreate-by-controller semantics, executed for real.

`LiveCluster.run()` is a wall-clock analogue of the discrete-event
simulator: a scheduler cycle every `cycle_period_s`, arrivals from a
trace, completion detection from the job threads.

The module touches no device: the job factory does (a ``Trainer(...,
device=None)`` trains on the card, ``device="cpu"`` on the CPU).  Every
clock read goes through the module's ``time``, as the reference's do,
so one patched clock can drive both packages.  A job thread that raises
ends without a result, and the cluster waits on it until ``run``'s
timeout, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core.autoscaler import (Autoscaler, NodeProvider,
                                         VoidAutoscaler)
from repro_torch.core.cluster import Cluster, Node
from repro_torch.core.cost import CostModel
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.pods import Pod, PodKind, PodPhase, PodSpec
from repro_torch.core.rescheduler import Rescheduler, VoidRescheduler
from repro_torch.core.resources import Resources
from repro_torch.core.scheduler import (BestFitBinPackingScheduler,
                                        Scheduler)


@dataclasses.dataclass
class LiveJob:
    """A real workload bound to a pod: factory builds a fresh runner each
    incarnation (the runner must resume from its own durable state)."""

    pod: Pod
    factory: Callable[[], object]     # -> object with run() and request_stop()
    runner: Optional[object] = None
    thread: Optional[threading.Thread] = None
    result: Optional[Dict] = None

    def start(self) -> None:
        self.runner = self.factory()

        def _run():
            self.result = self.runner.run()

        self.thread = threading.Thread(target=_run, daemon=True)
        self.thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        if self.runner is not None and self.thread is not None:
            self.runner.request_stop()
            self.thread.join(timeout)

    @property
    def finished(self) -> bool:
        return (self.thread is not None and not self.thread.is_alive()
                and self.result is not None
                and self.result.get("completed") == 1.0)


class LocalCloudProvider(NodeProvider):
    """Nodes are process-local worker slots (instant provisioning by
    default; a delay can be configured to exercise the binding autoscaler)."""

    def __init__(self, template_resources: Resources, cost: CostModel,
                 provisioning_delay_s: float = 0.0):
        self.template_resources = template_resources
        self.cost = cost
        self.delay = provisioning_delay_s
        self.pending_ready: List[tuple] = []   # (node, ready_at)

    def make_static_node(self) -> Node:
        node = Node(allocatable=self.template_resources, autoscaled=False,
                    node_type="local")
        node.mark_ready(time.time())
        self.cost.on_provision(node, time.time())
        return node

    def launch_node(self, now: float) -> Node:
        node = Node(allocatable=self.template_resources, autoscaled=True,
                    node_type="local")
        self.cost.on_provision(node, time.time())
        self.pending_ready.append((node, time.time() + self.delay))
        return node

    def terminate_node(self, node: Node, now: float) -> None:
        self.cost.on_deprovision(node, time.time())

    def poll_ready(self, notify) -> None:
        now = time.time()
        still = []
        for node, ready_at in self.pending_ready:
            if now >= ready_at:
                node.mark_ready(now)
                notify(node)
            else:
                still.append((node, ready_at))
        self.pending_ready = still


class LiveCluster:
    """Wall-clock orchestration of real jobs (the paper's Algorithm 1)."""

    def __init__(self, provider: LocalCloudProvider,
                 scheduler: Optional[Scheduler] = None,
                 rescheduler: Optional[Rescheduler] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 cycle_period_s: float = 0.5,
                 log: Callable[[str], None] = print):
        self.provider = provider
        self.cluster = Cluster()
        self.orch = Orchestrator(
            self.cluster,
            scheduler or BestFitBinPackingScheduler(),
            rescheduler or VoidRescheduler(max_pod_age_s=1.0),
            autoscaler or VoidAutoscaler(provider))
        self.cycle_period_s = cycle_period_s
        self.jobs: Dict[int, LiveJob] = {}
        self.log = log

    def add_static_nodes(self, n: int) -> None:
        for _ in range(n):
            self.cluster.add_node(self.provider.make_static_node())

    def submit(self, spec: PodSpec, factory: Callable[[], object]) -> Pod:
        pod = Pod(spec=spec, submit_time=time.time())
        self.orch.submit(pod)
        self.jobs[pod.uid] = LiveJob(pod=pod, factory=factory)
        return pod

    # -- lifecycle wiring -------------------------------------------------------
    def _sync_jobs(self) -> None:
        """Start newly-bound jobs; stop evicted ones; reap completions."""
        for job in self.jobs.values():
            pod = job.pod
            if pod.phase == PodPhase.BOUND and job.thread is None:
                job.start()
                self.log(f"[live] {pod.name} started on {pod.node_id}")
            elif pod.phase == PodPhase.PENDING and job.thread is not None:
                # evicted (rescheduler/scale-in/failure): stop + checkpoint,
                # a fresh incarnation starts at the next binding
                job.stop()
                job.thread = None
                job.runner = None
                self.log(f"[live] {pod.name} evicted; checkpointed")
            elif (pod.phase == PodPhase.BOUND and pod.is_batch
                  and job.finished):
                self.cluster.complete(pod, time.time())
                self.log(f"[live] {pod.name} completed")

    def evict(self, pod: Pod) -> None:
        """External preemption (e.g. a failure drill)."""
        job = self.jobs[pod.uid]
        job.stop()
        job.thread = None
        job.runner = None
        self.cluster.unbind(pod, time.time())

    def run(self, until: Callable[[], bool], timeout_s: float = 600.0) -> bool:
        t0 = time.time()
        while time.time() - t0 < timeout_s:
            self.provider.poll_ready(self.orch.autoscaler.notify_node_ready)
            self.orch.cycle(time.time())
            self._sync_jobs()
            if until():
                return True
            time.sleep(self.cycle_period_s)
        return False

    def batch_done(self) -> bool:
        return all(j.pod.phase == PodPhase.SUCCEEDED
                   for j in self.jobs.values() if j.pod.is_batch)
