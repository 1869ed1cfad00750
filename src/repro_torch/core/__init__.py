"""The paper's contribution: cost-efficient scheduling, rescheduling and
autoscaling for container/job orchestration (Rodriguez & Buyya, 2018).

The serial simulator of ``repro/core``, copied module for module: NumPy
and Python on the host, its rows bit-identical to the reference's.  One
departure: engine, wave kernel and run-length fast path are explicit
``ExperimentSpec`` / ``Cluster`` arguments (the reference also reads
them from environment variables).  The device enters through the
forecaster that ``ExperimentSpec(forecaster_obj=...)`` hands the
predictive autoscaler.
"""

from repro_torch.core.autoscaler import (AUTOSCALERS, Autoscaler,
                                         BindingAutoscaler, NodeProvider,
                                         PredictiveAutoscaler,
                                         SimpleAutoscaler, VoidAutoscaler)
from repro_torch.core.cluster import Cluster, Node, NodeState
from repro_torch.core.cost import CostModel
from repro_torch.core.disruption import (CrashLoopInjector,
                                         DisruptionInjector,
                                         SpotReclaimInjector,
                                         ZoneOutageInjector)
from repro_torch.core.experiment import (ExperimentSpec, build_simulation,
                                         run_all_combos, run_experiment,
                                         run_k8s_baseline)
from repro_torch.core.failures import FailureInjector, StragglerInjector
from repro_torch.core.metrics import ExperimentResult, MetricsCollector
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.pods import Pod, PodKind, PodPhase, PodSpec
from repro_torch.core.rescheduler import (RESCHEDULERS, BindingRescheduler,
                                          NonBindingRescheduler, Rescheduler,
                                          VoidRescheduler)
from repro_torch.core.resources import Resources, gi
from repro_torch.core.scheduler import (SCHEDULERS, BestFitBinPackingScheduler,
                                        FirstFitScheduler,
                                        KubernetesDefaultScheduler, Scheduler,
                                        WorstFitScheduler)
from repro_torch.core.simulation import SimConfig, Simulation
from repro_torch.core.workload import (JOB_TYPES, WORKLOAD_MIXES, Arrival,
                                       generate_workload, make_fleet_job_types)


def reset_id_counters() -> None:
    """Restart the global node/pod id sequences.

    Auto-generated node ids ("node-<seq>") order *lexicographically*, so any
    engine-vs-engine comparison (parity tests, benchmarks) must start both
    runs from the same counter value.  Test/bench isolation only — never
    call this inside a running simulation.
    """
    import itertools

    from repro_torch.core import cluster as _cluster_mod
    from repro_torch.core import pods as _pods_mod
    _cluster_mod._node_seq = itertools.count()
    _pods_mod._uid = itertools.count()

__all__ = [
    "AUTOSCALERS", "Autoscaler", "BindingAutoscaler", "NodeProvider",
    "PredictiveAutoscaler", "SimpleAutoscaler", "VoidAutoscaler",
    "Cluster", "Node", "NodeState",
    "CostModel", "CrashLoopInjector", "DisruptionInjector",
    "SpotReclaimInjector", "ZoneOutageInjector", "FailureInjector",
    "StragglerInjector", "ExperimentSpec", "build_simulation", "run_all_combos",
    "run_experiment", "run_k8s_baseline", "ExperimentResult",
    "MetricsCollector", "Orchestrator", "Pod", "PodKind", "PodPhase",
    "PodSpec", "RESCHEDULERS", "BindingRescheduler", "NonBindingRescheduler",
    "Rescheduler", "VoidRescheduler", "Resources", "gi", "SCHEDULERS",
    "BestFitBinPackingScheduler", "FirstFitScheduler",
    "KubernetesDefaultScheduler", "Scheduler", "WorstFitScheduler",
    "SimConfig", "Simulation", "JOB_TYPES", "WORKLOAD_MIXES", "Arrival",
    "generate_workload", "make_fleet_job_types", "reset_id_counters",
]
