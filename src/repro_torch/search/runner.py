"""Cell runner: scheduler × scenario grid cells on the lane engine.

One *cell* is one fully specified experiment — a scenario family replayed
under one policy configuration.  :class:`CellSpec` is the same frozen,
picklable description as ``repro.search.runner.CellSpec`` (same fields,
defaults and label), so a cell list built for the reference runs here
unchanged.  :func:`run_cells` evaluates it on the many-world lane engine
(:mod:`repro_torch.manyworld`); the serial simulator is not ported, so
``workers="lanes"`` is the only mode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# Metrics of a row, in the reference's order; the rows of eligible cells
# are bit-identical to the serial runner's on every one of them.
_RESULT_FIELDS = (
    "completed", "cost", "duration_s", "mean_pending_s", "median_pending_s",
    "max_pending_s", "avg_ram_ratio", "avg_cpu_ratio", "avg_pods_per_node",
    "max_nodes", "node_seconds", "evictions", "scale_outs", "scale_ins",
    "failures_injected", "preemption_notices", "lost_work_s",
)


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One grid cell: a scenario replayed under one policy configuration.

    Every field is a primitive or a tuple.  Only void/void static-cluster
    cells (``manyworld.evaluator.lane_eligible``) can run in this package;
    the other fields are kept so that cells and their rows match the
    reference's field for field.
    """

    scenario: str
    scheduler: str = "best-fit"
    autoscaler: str = "binding"
    rescheduler: str = "void"
    seed: int = 0
    n_jobs: Optional[int] = None
    engine: Optional[str] = None
    scheduler_weights: Optional[Tuple[float, float, float]] = None
    max_pod_age_s: float = 60.0
    provisioning_interval_s: float = 60.0
    scale_out_bypass_util: Optional[float] = None
    scale_in_util_ceiling: Optional[float] = None
    template_name: Optional[str] = None
    initial_workers: int = 1
    forecaster: Optional[str] = "ewma"
    forecast_bin_s: float = 30.0
    forecast_lead_s: float = 90.0
    forecast_headroom: float = 1.15
    forecast_conf_min: float = 0.35
    chaos: bool = False
    obs_dir: Optional[str] = None

    @property
    def label(self) -> str:
        """Stable human-readable cell id, used in errors and CSV lines."""
        parts = [self.scenario, self.scheduler, self.autoscaler,
                 self.rescheduler, f"seed{self.seed}"]
        if self.chaos:
            parts.append("chaos")
        return ".".join(parts)


class CellError(RuntimeError):
    """A cell failed; the message names the cell."""


_TRACE_CACHE: Dict[Tuple[str, int, Optional[int]], object] = {}


def _get_trace(scenario: str, seed: int, n_jobs: Optional[int]):
    """The cell's trace, memoized per process by ``(scenario, seed,
    n_jobs)`` (replay is read-only)."""
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
    """True when some pod cannot fit even an *empty* node of the cell's
    template: such a cell short-circuits to a zeroed ``completed=False``
    row, as in the reference."""
    if trace.n == 0:
        return False
    alloc = _template_of(cell).allocatable
    return bool(trace.cpu_m.max() > alloc.cpu_m
                or trace.mem_mb.max() > alloc.mem_mb)


def run_cells(cells: Sequence[CellSpec], workers="lanes",
              device=None) -> List[dict]:
    """Run every cell on the lane engine; rows come back in the order the
    cells were given, bit-identical to the reference's serial
    ``run_cells(cells, workers=1)`` except ``wall_s`` (the lane's share of
    its batch).  ``device=None`` means CUDA."""
    if workers != "lanes":
        raise NotImplementedError(
            f"workers={workers!r}: repro_torch runs cells on the lane "
            "engine only (workers='lanes'); the serial simulator is not "
            "ported")
    from repro_torch.manyworld.evaluator import run_cells_lanes
    return run_cells_lanes(list(cells), device=device)
