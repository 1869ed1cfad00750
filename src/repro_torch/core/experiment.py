"""Experiment wiring: one call = one cell of Fig. 3 / Fig. 4 / Table 5.

`run_experiment` reproduces a rescheduler×autoscaler combination on one of the
paper's workloads; `run_k8s_baseline` reproduces the Fig.-4 baseline (default
kube-scheduler on the *minimum* static cluster that completes the workload).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.autoscaler import (BindingAutoscaler,
                                         PredictiveAutoscaler,
                                         SimpleAutoscaler, VoidAutoscaler)
from repro_torch.core.cluster import Cluster
from repro_torch.core.cost import CostModel
from repro_torch.core.metrics import ExperimentResult
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.rescheduler import RESCHEDULERS
from repro_torch.core.scheduler import SCHEDULERS
from repro_torch.core.simulation import SimConfig, Simulation
from repro_torch.core.workload import Arrival, generate_workload

MAX_POD_AGE_S = 60.0            # Table 4
PROVISIONING_INTERVAL_S = 60.0  # Table 4
PRICE_PER_S = 0.011             # Table 4


@dataclasses.dataclass
class ExperimentSpec:
    workload: str = "mixed"
    scheduler: str = "best-fit"
    rescheduler: str = "void"
    autoscaler: str = "binding"
    seed: int = 0
    initial_workers: int = 1
    static_workers: Optional[int] = None   # forces a fixed-size cluster
    template: object = None                # NodeTemplate; None -> M2_SMALL
    # Picklable twin of `template`: a `repro_torch.cloud.adapter.NODE_TEMPLATES`
    # name — the policy search's node-template axis crosses process
    # boundaries as a string.  Mutually exclusive with `template`.
    template_name: Optional[str] = None
    max_pod_age_s: float = MAX_POD_AGE_S
    provisioning_interval_s: float = PROVISIONING_INTERVAL_S
    cycle_period_s: float = 10.0
    # Policy-search knobs (repro_torch.search).  All default to the paper's
    # hard-coded behavior:
    # * scheduler_weights — (w_pack, w_lr, w_bal) for scheduler="weighted"
    #   (raises with any other scheduler: silently inert weights would make
    #   searched configs unreproducible);
    # * scale_out_bypass_util — NBAS Alg. 5 rate-limit bypass above this
    #   mean RAM utilization (non-binding autoscaler only, None = never);
    # * scale_in_util_ceiling — run Alg. 6 consolidation only at or below
    #   this mean RAM utilization (None = always).
    scheduler_weights: Optional[tuple] = None
    scale_out_bypass_util: Optional[float] = None
    scale_in_util_ceiling: Optional[float] = None
    # Predictive-autoscaler knobs (autoscaler="predictive" only — see
    # repro_torch.core.autoscaler.PredictiveAutoscaler + repro_torch.forecast).
    # `forecaster` names the built-in online forecaster ("ewma"); None
    # disables prediction entirely (bit-identical to autoscaler
    # "non-binding").  `forecaster_obj` injects a programmatic forecaster
    # (e.g. a trained repro_torch.forecast.model.LearnedForecaster restored
    # from a checkpoint) and takes precedence over the name.
    forecaster: Optional[str] = "ewma"
    forecaster_obj: object = None
    forecast_bin_s: float = 30.0
    forecast_lead_s: float = 90.0
    forecast_headroom: float = 1.15
    forecast_conf_min: float = 0.35
    failure_injector: object = None
    straggler_threshold: float = 0.0
    # repro_torch.core.failures.StragglerInjector — wired into the provider's
    # launch path so a deterministic fraction of autoscaled nodes boots
    # slow; pair with straggler_threshold > 0 to exercise the eviction
    # policy that moves checkpointable batch work off them.
    straggler_injector: object = None
    arrivals: Optional[List[Arrival]] = None   # override the workload trace
    # Columnar workload sources (repro_torch.scenarios): a TraceStore replayed
    # natively through the array engine's bulk ingest, or a registry
    # scenario name built with this spec's seed.  `arrivals`, `trace` and
    # `scenario` are mutually exclusive — see `workload_source`.
    trace: object = None                       # scenarios.TraceStore
    scenario: Optional[str] = None             # scenarios.registry name
    scenario_jobs: Optional[int] = None        # override the family's length
    # "array" (vectorized SoA engine; None means it too) or "object" (seed
    # object-scan engine).  The port reads no environment variable.
    engine: Optional[str] = None
    # Wave selection kernel: "argmin" (flat reduction), "segtree" (O(log n)
    # index), or "auto" (tree above engine.SEGTREE_AUTO_MIN_NODES active
    # nodes — the kernels are decision-identical, so this is purely a
    # performance choice); None means "auto".
    wave_select: Optional[str] = None
    # Best-fit run-length fast path of the array engine's wave loop
    # (decision-identical; False forces per-pod extremum queries).
    wave_runlen: bool = True
    # Observability (repro_torch.obs): an ObsConfig (or True for defaults)
    # attaches a flight recorder + cycle-phase profiler to the built
    # simulation.  None (default) compiles observability out — the hot
    # paths pay one is-None test and results are untouched; with it set,
    # recording is passive and ExperimentResult stays bit-identical.
    obs: object = None

    def workload_source(self):
        """Resolve this spec's workload to ``(arrivals, trace)`` — exactly
        one is non-None.

        ``arrivals`` (explicit list), ``trace`` (columnar TraceStore) and
        ``scenario`` (registry name, built with this spec's seed and
        ``scenario_jobs``) are mutually exclusive; naming more than one is
        ambiguous and raises immediately rather than silently preferring
        one.  With none set, the paper workload named by ``workload`` is
        generated as the classic arrival list."""
        sources = [name for name, v in (("arrivals", self.arrivals),
                                        ("trace", self.trace),
                                        ("scenario", self.scenario))
                   if v is not None]
        if len(sources) > 1:
            raise ValueError(
                f"ExperimentSpec got multiple workload sources "
                f"({' + '.join(sources)}); set at most one of "
                f"arrivals / trace / scenario")
        if self.scenario_jobs is not None and self.scenario is None:
            raise ValueError("scenario_jobs is only meaningful together "
                             "with scenario=<registry name>")
        if self.arrivals is not None:
            return self.arrivals, None
        if self.trace is not None:
            return None, self.trace
        if self.scenario is not None:
            from repro_torch.scenarios import build_scenario
            return None, build_scenario(self.scenario, seed=self.seed,
                                        n_jobs=self.scenario_jobs)
        return generate_workload(self.workload, seed=self.seed), None

    def workload_label(self) -> str:
        """The name recorded on the ExperimentResult row."""
        if self.scenario is not None:
            return self.scenario
        if self.trace is not None:
            return getattr(self.trace, "name", "trace")
        return self.workload


def build_simulation(spec: ExperimentSpec) -> Simulation:
    # Imported here (not at module level) to avoid a package import cycle:
    # repro_torch.cloud.adapter needs repro_torch.core.autoscaler's NodeProvider.
    from repro_torch.cloud.adapter import M2_SMALL, NODE_TEMPLATES, SimCloudProvider

    if spec.template is not None and spec.template_name is not None:
        raise ValueError("ExperimentSpec got both template and template_name;"
                         " set at most one")
    if spec.template_name is not None:
        try:
            template = NODE_TEMPLATES[spec.template_name]
        except KeyError:
            raise KeyError(
                f"unknown template_name {spec.template_name!r}; known: "
                f"{sorted(NODE_TEMPLATES)}") from None
    else:
        template = spec.template or M2_SMALL

    cost = CostModel(price_per_s=PRICE_PER_S)
    # Non-default templates bill at their own catalog price; M2_SMALL's
    # entry equals PRICE_PER_S, so this is value-neutral for the default.
    cost.price_table.setdefault(template.name, template.price_per_s)
    provider = SimCloudProvider(template, cost,
                                straggler_injector=spec.straggler_injector)
    cluster = Cluster(use_arrays=spec.engine != "object",
                      wave_select=spec.wave_select,
                      wave_runlen=spec.wave_runlen)

    n_static = (spec.static_workers if spec.static_workers is not None
                else spec.initial_workers)
    for _ in range(n_static):
        cluster.add_node(provider.make_static_node(0.0))

    if spec.scheduler_weights is not None and spec.scheduler != "weighted":
        raise ValueError(
            f"scheduler_weights is only meaningful with scheduler='weighted'"
            f" (got scheduler={spec.scheduler!r})")
    if spec.scheduler == "weighted" and spec.scheduler_weights is not None:
        scheduler = SCHEDULERS["weighted"](*spec.scheduler_weights)
    else:
        scheduler = SCHEDULERS[spec.scheduler]()
    rescheduler = RESCHEDULERS[spec.rescheduler](
        max_pod_age_s=spec.max_pod_age_s)
    if spec.autoscaler == "void":
        autoscaler = VoidAutoscaler(provider)
    elif spec.autoscaler == "non-binding":
        autoscaler = SimpleAutoscaler(
            provider, provisioning_interval_s=spec.provisioning_interval_s,
            scale_out_bypass_util=spec.scale_out_bypass_util,
            scale_in_util_ceiling=spec.scale_in_util_ceiling)
    elif spec.autoscaler == "binding":
        autoscaler = BindingAutoscaler(
            provider, scale_in_util_ceiling=spec.scale_in_util_ceiling)
    elif spec.autoscaler == "predictive":
        if spec.forecaster_obj is not None:
            forecaster = spec.forecaster_obj
        elif spec.forecaster is None:
            forecaster = None
        elif spec.forecaster == "ewma":
            from repro_torch.forecast import EwmaForecaster
            forecaster = EwmaForecaster()
        else:
            raise KeyError(f"unknown forecaster {spec.forecaster!r}; "
                           f"known: 'ewma', None, or set forecaster_obj")
        autoscaler = PredictiveAutoscaler(
            provider, provisioning_interval_s=spec.provisioning_interval_s,
            scale_out_bypass_util=spec.scale_out_bypass_util,
            scale_in_util_ceiling=spec.scale_in_util_ceiling,
            forecaster=forecaster, bin_s=spec.forecast_bin_s,
            lead_time_s=spec.forecast_lead_s,
            headroom=spec.forecast_headroom,
            conf_min=spec.forecast_conf_min)
    else:
        raise KeyError(spec.autoscaler)

    orch = Orchestrator(cluster, scheduler, rescheduler, autoscaler,
                        straggler_threshold=spec.straggler_threshold)
    arrivals, trace = spec.workload_source()
    sim = Simulation(orch, cost, arrivals, trace=trace,
                     config=SimConfig(cycle_period_s=spec.cycle_period_s),
                     failure_injector=spec.failure_injector)
    provider.attach(sim)
    if spec.obs is not None and spec.obs is not False:
        from repro_torch.obs import ObsConfig, ObsRecorder
        config = spec.obs if isinstance(spec.obs, ObsConfig) else None
        recorder = ObsRecorder(config).attach(sim)
        recorder.meta = {
            "workload": spec.workload_label(), "scheduler": spec.scheduler,
            "rescheduler": spec.rescheduler, "autoscaler": spec.autoscaler,
            "seed": spec.seed,
            "engine": "array" if cluster.arrays is not None else "object"}
    return sim


def run_experiment(spec: ExperimentSpec) -> ExperimentResult:
    sim = build_simulation(spec)
    result = sim.run()
    result.workload = spec.workload_label()
    return result


def run_k8s_baseline(workload: str, seed: int = 0, max_nodes: int = 60,
                     cycle_period_s: float = 10.0,
                     engine: Optional[str] = None,
                     search: str = "bisect") -> ExperimentResult:
    """Fig. 4 baseline: default K8s scheduler on the minimum static cluster
    able to *successfully place* and execute all jobs.

    "Successfully place" is read as placement without queuing (every pod is
    bound in the scheduling cycle it arrives in): with queuing allowed, any
    cluster big enough for the services alone eventually "completes", which
    contradicts the paper's reported K8s scheduling durations being slightly
    *better* than the autoscaled ones (§7.2/Fig. 4B — zero pending time).

    The acceptability predicate is monotone in the cluster size (more
    spread-scheduled identical nodes never create queuing), so the minimum
    is found by **bisection** over ``[1, max_nodes]`` — O(log max_nodes)
    simulations instead of one per candidate size (``search="linear"``
    restores the scan order; ``tests/test_engine_parity.py`` asserts both
    searches pick the same cluster).  Each candidate run restarts the global
    id counters so its outcome depends only on ``n`` — not on how many sims
    ran before it — which is what makes the two search orders comparable.
    Note this hermeticity is a deliberate change from the seed linear scan,
    whose candidates inherited whatever counter state earlier candidates
    left behind (node ids order lexicographically, so counter offsets could
    shift tie-breaks): baseline rows are now reproducible in isolation, but
    may differ from the seed's exact numbers.
    """
    def attempt(n: int) -> ExperimentResult:
        # Deferred import: reset_id_counters lives in the package root,
        # which imports this module (same cycle-avoidance as build_simulation).
        from repro_torch.core import reset_id_counters
        reset_id_counters()
        spec = ExperimentSpec(workload=workload, scheduler="k8s-default",
                              rescheduler="void", autoscaler="void",
                              static_workers=n, seed=seed,
                              cycle_period_s=cycle_period_s, engine=engine)
        return run_experiment(spec)

    def acceptable(r: ExperimentResult) -> bool:
        return r.completed and r.max_pending_s <= cycle_period_s + 1e-9

    if search == "linear":
        for n in range(1, max_nodes + 1):
            result = attempt(n)
            if acceptable(result):
                return result
    elif search == "bisect":
        best = attempt(max_nodes)
        if acceptable(best):
            lo, hi = 1, max_nodes
            while lo < hi:
                mid = (lo + hi) // 2
                result = attempt(mid)
                if acceptable(result):
                    hi, best = mid, result
                else:
                    lo = mid + 1
            return best
    else:
        raise ValueError(f"search must be 'bisect' or 'linear', got {search!r}")
    raise RuntimeError(f"k8s baseline did not complete with <= {max_nodes}"
                       f" nodes on workload {workload!r}")


def run_all_combos(workload: str, seed: int = 0,
                   engine: Optional[str] = None) -> List[ExperimentResult]:
    """The six rescheduler × autoscaler combinations of Fig. 3."""
    out = []
    for rescheduler in ("void", "binding", "non-binding"):
        for autoscaler in ("non-binding", "binding"):
            spec = ExperimentSpec(workload=workload, rescheduler=rescheduler,
                                  autoscaler=autoscaler, seed=seed,
                                  engine=engine)
            out.append(run_experiment(spec))
    return out
