"""Resource-consumption estimation (paper §4.2 + §8, implemented here).

The paper leaves the Resource Consumption Estimator unintegrated ("currently,
this functionality has not been integrated") and lists it as future work.  We
implement it as a beyond-paper feature, **off by default** so the faithful
reproduction schedules on raw requests:

* `UsageModel` — ground truth for the simulation: each job type actually uses
  ``usage_fraction`` of its request (the paper observes requests are
  "usually misestimated and overestimated by users").
* `EmaEstimator` — online exponential-moving-average estimate of per-type
  usage, learned from (simulated) metrics-server samples.
* `OversubscribingScheduler` — wraps any scheduler; feasibility uses
  ``effective = max(headroom × estimate, floor × request)`` instead of the raw
  request, packing more pods per node.  The CPU axis is compressible so it is
  oversubscribed more aggressively than memory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.cluster import Cluster, Node
from repro_torch.core.pods import Pod
from repro_torch.core.resources import Resources
from repro_torch.core.scheduler import Scheduler


@dataclasses.dataclass
class UsageModel:
    """Simulated true usage as a fraction of the request, per job type."""

    fractions: Dict[str, float]
    default_fraction: float = 0.6

    def usage(self, pod: Pod) -> Resources:
        f = self.fractions.get(pod.spec.type_name, self.default_fraction)
        return pod.requests * f


class EmaEstimator:
    """Per-job-type EMA of observed usage/request ratios."""

    def __init__(self, alpha: float = 0.3, prior: float = 1.0):
        self.alpha = alpha
        self.prior = prior
        self._ratio: Dict[str, float] = {}

    #: Single zero-division guard for usage/request ratios on both axes.
    EPS = 1e-9

    def observe(self, pod: Pod, used: Resources) -> None:
        req = pod.requests
        ratio = max(used.cpu_m / max(req.cpu_m, self.EPS),
                    used.mem_mb / max(req.mem_mb, self.EPS))
        prev = self._ratio.get(pod.spec.type_name, self.prior)
        self._ratio[pod.spec.type_name] = (
            self.alpha * ratio + (1 - self.alpha) * prev)

    def ratio(self, type_name: str) -> float:
        return self._ratio.get(type_name, self.prior)

    def effective_request(self, pod: Pod, *, mem_floor: float = 0.7,
                          cpu_floor: float = 0.3,
                          headroom: float = 1.2) -> Resources:
        r = min(1.0, self.ratio(pod.spec.type_name) * headroom)
        # Round half-up with a floor of 1 millicore: plain int() truncates
        # toward zero, so a 1-millicore request at any ratio < 1 would
        # estimate to 0 cpu_m and look free to every feasibility check.
        return Resources(
            cpu_m=max(1, int(pod.requests.cpu_m * max(r, cpu_floor) + 0.5)),
            mem_mb=pod.requests.mem_mb * max(r, mem_floor),
        )


class OversubscribingScheduler(Scheduler):
    """Scheduler decorator: feasibility on estimated (not requested) usage.

    Binding still records the *full* request (Kubernetes guaranteed QoS), but
    node feasibility is checked against estimated usage sums, allowing
    controlled oversubscription.  ``max_oversub`` caps total estimated usage
    relative to allocatable capacity.
    """

    name = "oversubscribing"

    def __init__(self, inner: Scheduler, estimator: EmaEstimator,
                 max_oversub: float = 1.0):
        self.inner = inner
        self.estimator = estimator
        self.max_oversub = max_oversub

    def _estimated_used(self, node: Node) -> Resources:
        total = Resources.zero()
        for p in node.pods.values():
            total = total + self.estimator.effective_request(p)
        return total

    def suitable_nodes(self, cluster: Cluster, pod: Pod) -> List[Node]:
        eff = self.estimator.effective_request(pod)
        cap = self.max_oversub
        out = []
        for n in cluster.ready_nodes():
            free = (n.allocatable * cap) - self._estimated_used(n)
            if eff.fits_in(free):
                out.append(n)
        if out:
            return out
        return [n for n in cluster.tainted_nodes()
                if eff.fits_in((n.allocatable * cap) - self._estimated_used(n))]

    def select(self, nodes: List[Node], pod: Pod) -> Optional[Node]:
        return self.inner.select(nodes, pod)

    def schedule(self, cluster: Cluster, pod: Pod, now: float) -> bool:
        nodes = self.suitable_nodes(cluster, pod)
        node = self.select(nodes, pod) if nodes else None
        if node is None:
            return False
        # Bind without the hard request-fits assertion: oversubscription is
        # the point.  Guaranteed QoS accounting still tracks full requests.
        if not pod.requests.fits_in(node.free):
            node.oversub = True
        cluster.bind(pod, node, now, enforce=False)
        return True
