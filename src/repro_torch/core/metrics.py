"""Experiment metrics (paper §7.2, Table 5 + Fig. 3/4 quantities).

* **cost** — from `CostModel` (per-second billing).
* **scheduling duration** — first job submitted → last batch job completed.
* **median scheduling time** — median of per-pod pending intervals.
* **RAM / CPU req/cap ratios** — sampled every 20 s over cluster nodes, then
  time-averaged (paper's Table 5 definition).
* **pods per node** — same sampling.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Tuple

from repro_torch.core.cluster import Cluster

SAMPLE_PERIOD_S = 20.0


@dataclasses.dataclass
class Sample:
    time: float
    n_nodes: int
    ram_ratio: float
    cpu_ratio: float
    pods_per_node: float


class MetricsCollector:
    def __init__(self):
        self.samples: List[Sample] = []
        self.pending_intervals: List[float] = []
        # (sample time, live node count) at every 20 s tick — exported
        # through the obs bundle (repro_torch.obs.ObsRecorder.bundle) alongside
        # pending_intervals for fleet-size-over-time plots.
        self.node_count_series: List[Tuple[float, int]] = []

    def sample(self, cluster: Cluster, now: float) -> None:
        # cluster.utilization_totals() reads the SoA mirror's incrementally
        # maintained sampling aggregates (O(dirty nodes) per tick) when the
        # mirror is on; the sums are exact (fsum rounding), so sum/n is
        # bit-identical to the seed per-node fmean scan on both engines.
        n_nodes, ram_sum, cpu_sum, ppn_sum = cluster.utilization_totals()
        # node_count_series records the n_nodes actually sampled — including
        # the (now, 0) point on an empty cluster, which the seed dropped.
        self.node_count_series.append((now, n_nodes))
        if n_nodes == 0:
            self.samples.append(Sample(now, 0, 0.0, 0.0, 0.0))
            return
        self.samples.append(Sample(now, n_nodes, ram_sum / n_nodes,
                                   cpu_sum / n_nodes,
                                   float(ppn_sum) / n_nodes))

    def record_pending_interval(self, seconds: float) -> None:
        self.pending_intervals.append(seconds)

    def record_pending_intervals(self, seconds) -> None:
        """Bulk append (one call per pod at end-of-run, not per interval)."""
        self.pending_intervals.extend(seconds)

    # -- aggregates -------------------------------------------------------------
    def median_pending_s(self) -> float:
        return statistics.median(self.pending_intervals) if self.pending_intervals else 0.0

    def mean_pending_s(self) -> float:
        """Mean per-pod pending interval — the policy-search objective
        (repro_torch.search): unlike the median it is sensitive to the long tail
        a bad autoscaling policy produces."""
        return (statistics.fmean(self.pending_intervals)
                if self.pending_intervals else 0.0)

    def max_pending_s(self) -> float:
        return max(self.pending_intervals) if self.pending_intervals else 0.0

    def avg_ram_ratio(self) -> float:
        xs = [s.ram_ratio for s in self.samples if s.n_nodes > 0]
        return statistics.fmean(xs) if xs else 0.0

    def avg_cpu_ratio(self) -> float:
        xs = [s.cpu_ratio for s in self.samples if s.n_nodes > 0]
        return statistics.fmean(xs) if xs else 0.0

    def avg_pods_per_node(self) -> float:
        xs = [s.pods_per_node for s in self.samples if s.n_nodes > 0]
        return statistics.fmean(xs) if xs else 0.0

    def max_nodes(self) -> int:
        return max((s.n_nodes for s in self.samples), default=0)


@dataclasses.dataclass
class ExperimentResult:
    """One row of Fig. 3 / Table 5."""

    workload: str
    scheduler: str
    rescheduler: str
    autoscaler: str
    completed: bool
    cost: float
    duration_s: float
    median_pending_s: float
    mean_pending_s: float
    max_pending_s: float
    avg_ram_ratio: float
    avg_cpu_ratio: float
    avg_pods_per_node: float
    max_nodes: int
    node_seconds: int
    evictions: int = 0
    scale_outs: int = 0
    scale_ins: int = 0
    failures_injected: int = 0
    # Disruption telemetry (repro_torch.core.disruption): spot reclaim notices
    # delivered, and Σ executed-but-not-durable seconds across evictions.
    preemption_notices: int = 0
    lost_work_s: float = 0.0

    def combo(self) -> str:
        abbrev = {"void": "VR", "non-binding": "NBR", "binding": "BR"}
        as_abbrev = {"void": "VAS", "non-binding": "NBAS", "binding": "BAS",
                     "predictive": "PAS"}
        return f"{abbrev.get(self.rescheduler, self.rescheduler)}-" \
               f"{as_abbrev.get(self.autoscaler, self.autoscaler)}"

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)
