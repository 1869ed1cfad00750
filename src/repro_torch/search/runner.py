"""Parallel cell runner: scheduler × autoscaler × scenario grid cells,
as ``repro/search/runner.py``.

One *cell* is one fully-specified experiment — a scenario family replayed
under one policy configuration.  `CellSpec` is a frozen, hashable,
**picklable** description of a cell (every field is a primitive or a
tuple), `run_cell` executes it, and `run_cells` fans a list of cells over
a `concurrent.futures` process pool.

The contract that makes the pool safe is hermeticity: `run_cell` resets
the global id counters and builds the scenario trace from its
``(scenario, seed, n_jobs)`` key, so a cell's result depends only on its
own spec — not on which process runs it, what ran in that process before,
or what order the pool completes in.  `run_cells` therefore guarantees

* **bit-identical results** to the serial path (``workers <= 1`` runs the
  exact same `run_cell` inline), and
* **stable ordering**: results are returned in submission order
  regardless of completion order (futures are consumed in the order the
  cells were given, never as-completed).

Traces are memoized per *process* keyed ``(scenario, seed, n_jobs)`` —
replay is read-only, so a worker evaluating many policy configs on the
same scenario builds its trace once.  Memoizing per process (rather than
shipping TraceStores through pickle) also keeps task payloads tiny.

``workers="lanes"`` evaluates void/void static-cluster cells on the lane
engine (:mod:`repro_torch.manyworld`), on the card by default, and every
other cell serially.  The reference's crash-test hook (an environment
variable) is left out, since the port reads none.
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import ExperimentSpec, reset_id_counters, run_experiment

# Metrics copied off the ExperimentResult verbatim (no rounding: the
# serial/parallel bit-identity contract is on these exact floats).
_RESULT_FIELDS = (
    "completed", "cost", "duration_s", "mean_pending_s", "median_pending_s",
    "max_pending_s", "avg_ram_ratio", "avg_cpu_ratio", "avg_pods_per_node",
    "max_nodes", "node_seconds", "evictions", "scale_outs", "scale_ins",
    "failures_injected", "preemption_notices", "lost_work_s",
)


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One grid cell: a scenario replayed under one policy configuration.

    Every field is picklable by construction (strings, numbers, tuples);
    node templates travel as `NODE_TEMPLATES` names and chaos injector
    stacks are rebuilt worker-side from ``(scenario, seed)``.
    """

    scenario: str
    scheduler: str = "best-fit"
    autoscaler: str = "binding"
    rescheduler: str = "void"
    seed: int = 0
    n_jobs: Optional[int] = None
    engine: Optional[str] = None
    # Policy-search knobs (defaults = the paper's Table-4 behavior).
    scheduler_weights: Optional[Tuple[float, float, float]] = None
    max_pod_age_s: float = 60.0
    provisioning_interval_s: float = 60.0
    scale_out_bypass_util: Optional[float] = None
    scale_in_util_ceiling: Optional[float] = None
    template_name: Optional[str] = None
    initial_workers: int = 1
    # Predictive-autoscaler knobs (autoscaler="predictive"; see
    # repro_torch.core.autoscaler.PredictiveAutoscaler).  The forecaster travels
    # as a builtin name ("ewma"; None = prediction disabled) so cells stay
    # picklable and are rebuilt fresh worker-side — forecasters are
    # stateful, a shared instance would leak rate history across cells.
    forecaster: Optional[str] = "ewma"
    forecast_bin_s: float = 30.0
    forecast_lead_s: float = 90.0
    forecast_headroom: float = 1.15
    forecast_conf_min: float = 0.35
    # With chaos=True the scenario must be a `CHAOS_SCENARIOS` name; the
    # worker wires in that scenario's seeded disruption injector stack
    # (fresh per run — injectors are stateful) so `lost_work_s` becomes a
    # meaningful objective.
    chaos: bool = False
    # Per-cell trace capture: a directory path (primitive, so cells stay
    # picklable) makes the worker run with the flight recorder attached
    # and export ``<obs_dir>/<label>.npz`` — recording is passive, so the
    # row's metrics stay bit-identical to an uninstrumented run.
    obs_dir: Optional[str] = None

    @property
    def label(self) -> str:
        """Stable human-readable cell id, used in errors and CSV lines."""
        parts = [self.scenario, self.scheduler, self.autoscaler,
                 self.rescheduler, f"seed{self.seed}"]
        if self.chaos:
            parts.append("chaos")
        return ".".join(parts)

    def to_experiment_spec(self, trace) -> ExperimentSpec:
        injector = None
        if self.chaos:
            from repro_torch.scenarios.chaos import CHAOS_SCENARIOS
            injector = CHAOS_SCENARIOS[self.scenario].injector(self.seed)
        return ExperimentSpec(
            trace=trace, scheduler=self.scheduler, autoscaler=self.autoscaler,
            rescheduler=self.rescheduler, seed=self.seed, engine=self.engine,
            scheduler_weights=self.scheduler_weights,
            max_pod_age_s=self.max_pod_age_s,
            provisioning_interval_s=self.provisioning_interval_s,
            scale_out_bypass_util=self.scale_out_bypass_util,
            scale_in_util_ceiling=self.scale_in_util_ceiling,
            template_name=self.template_name,
            initial_workers=self.initial_workers,
            forecaster=self.forecaster,
            forecast_bin_s=self.forecast_bin_s,
            forecast_lead_s=self.forecast_lead_s,
            forecast_headroom=self.forecast_headroom,
            forecast_conf_min=self.forecast_conf_min,
            failure_injector=injector)


class CellError(RuntimeError):
    """A cell failed (worker exception or worker-process death); the
    message names the cell so a 500-cell search points at the culprit."""


_TRACE_CACHE: Dict[Tuple[str, int, Optional[int]], object] = {}


def _get_trace(scenario: str, seed: int, n_jobs: Optional[int]):
    key = (scenario, seed, n_jobs)
    trace = _TRACE_CACHE.get(key)
    if trace is None:
        from repro_torch.scenarios import build_scenario
        trace = _TRACE_CACHE[key] = build_scenario(scenario, seed=seed,
                                                   n_jobs=n_jobs)
    return trace


def _template_of(cell: CellSpec):
    from repro_torch.cloud.adapter import M2_SMALL, NODE_TEMPLATES
    return (NODE_TEMPLATES[cell.template_name]
            if cell.template_name is not None else M2_SMALL)


def _infeasible(cell: CellSpec, trace) -> bool:
    """True when some pod in the trace cannot fit even an *empty* node of
    the cell's template — no amount of scaling ever places it, so the
    simulation would grind to ``max_sim_time_s`` launching nodes the
    whole way (the search's small-template axis makes this reachable).
    """
    if trace.n == 0:
        return False
    alloc = _template_of(cell).allocatable
    return bool(trace.cpu_m.max() > alloc.cpu_m
                or trace.mem_mb.max() > alloc.mem_mb)


def run_cell(cell: CellSpec) -> dict:
    """Execute one cell and return its metrics row.

    Fresh id counters per cell: tie-breaks (node ids order
    lexicographically) depend only on this cell's own run, which is what
    makes cells order- and process-independent.  Infeasible cells (a pod
    larger than the node template) short-circuit to a zeroed
    ``completed=False`` row instead of simulating a hopeless 48 h.
    """
    trace = _get_trace(cell.scenario, cell.seed, cell.n_jobs)
    if _infeasible(cell, trace):
        row = {"label": cell.label, "cell": dataclasses.asdict(cell),
               "n_jobs": trace.n, "infeasible": True}
        for field in _RESULT_FIELDS:
            row[field] = False if field == "completed" else 0
        row["wall_s"] = 0.0
        return row
    reset_id_counters()
    spec = cell.to_experiment_spec(trace)
    t0 = time.perf_counter()
    if cell.obs_dir is not None:
        from repro_torch.obs import run_recorded
        result, recorder = run_recorded(spec)
        os.makedirs(cell.obs_dir, exist_ok=True)
        recorder.export(os.path.join(cell.obs_dir, f"{cell.label}.npz"))
    else:
        result = run_experiment(spec)
    wall = time.perf_counter() - t0
    row = {"label": cell.label, "cell": dataclasses.asdict(cell),
           "n_jobs": trace.n, "infeasible": False}
    for field in _RESULT_FIELDS:
        row[field] = getattr(result, field)
    row["wall_s"] = wall
    return row


def run_cells(cells: Sequence[CellSpec], workers=1,
              max_tasks_per_child: Optional[int] = None,
              device=None) -> List[dict]:
    """Run every cell; results come back in the order cells were given.

    ``workers <= 1`` runs serially in-process — the reference path the
    pool is tested bit-identical against.  With a pool, futures are
    consumed in submission order (not as-completed), so the output list
    is the same whichever worker finished first.  A failing cell raises
    `CellError` naming the cell; a dying worker (hard exit) raises
    `CellError` instead of hanging the remaining futures.

    ``workers="lanes"`` evaluates the list on the many-world lane engine
    (`repro_torch.manyworld`) on ``device`` (``None`` means CUDA): void/void
    static-cluster cells run batched in one lane program per bucket — same
    rows, same order, bit-identical metrics (``wall_s`` becomes the lane's
    share of its batch).  Every cell outside that envelope runs through
    the serial ``run_cell`` in its place.  ``device`` is read only by the
    lane engine: the serial simulator runs on the host.
    """
    cells = list(cells)
    if workers == "lanes":
        from repro_torch.manyworld.evaluator import run_cells_lanes
        return run_cells_lanes(cells, device=device)
    if workers <= 1:
        rows = []
        for cell in cells:
            try:
                rows.append(run_cell(cell))
            except Exception as exc:
                raise CellError(f"cell {cell.label} failed: {exc!r}") from exc
        return rows
    kwargs = {}
    if max_tasks_per_child is not None:
        kwargs["max_tasks_per_child"] = max_tasks_per_child
    rows: List[dict] = []
    with ProcessPoolExecutor(max_workers=workers, **kwargs) as pool:
        futures = [(cell, pool.submit(run_cell, cell)) for cell in cells]
        for cell, future in futures:
            try:
                rows.append(future.result())
            except BrokenProcessPool as exc:
                raise CellError(
                    f"worker process died while running cell {cell.label}"
                    f" (or a cell batched with it); the pool is broken —"
                    f" remaining cells were not run") from exc
            except Exception as exc:
                raise CellError(
                    f"cell {cell.label} failed: {exc!r}") from exc
    return rows
