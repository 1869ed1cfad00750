"""Pareto-front artifact + paper-baseline comparison report.

`baseline_rows` runs the paper's actual Table-4 default chain (Alg. 2
best-fit scheduler, Alg. 3/4 non-binding rescheduler, Alg. 5/6 binding
autoscaler, 60 s knobs, m2.small workers) on the search's scenarios —
note this is the *real* best-fit scheduler, not its weighted-scorer
approximation, so the comparison is against the paper's own chain.

`build_report` turns a `SearchResult` into a JSON-serializable dict:

* ``front`` — every non-dominated config with its vector, decoded
  parameters, aggregate objectives, and per-scenario metrics;
* ``baseline`` — the paper default's per-scenario metrics;
* ``dominations`` — per scenario, which searched configs beat the paper
  default on *all three* axes (cost, mean pending time, utilization)
  simultaneously, with the cost delta in percent — the "beats the
  paper's Alg. 5/6 defaults by X% on scenario Y" line.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.search.nsga2 import SearchResult
from repro_torch.search.runner import CellSpec, run_cells

# The paper's default chain, as an actual CellSpec (per scenario).
PAPER_BASELINE = dict(scheduler="best-fit", rescheduler="non-binding",
                      autoscaler="binding", max_pod_age_s=60.0,
                      provisioning_interval_s=60.0)

# A searched config must beat the baseline on every one of these axes at
# once to count as dominating (sign: minimize; utilization negated).
_DOMINATION_AXES = (("cost", 1.0), ("mean_pending_s", 1.0),
                    ("avg_ram_ratio", -1.0))


def baseline_cells(scenarios: Sequence[str], seed: int = 0,
                   n_jobs: Optional[int] = None,
                   engine: Optional[str] = None,
                   chaos: bool = False) -> List[CellSpec]:
    return [CellSpec(scenario=sc, seed=seed, n_jobs=n_jobs, engine=engine,
                     chaos=chaos, initial_workers=3 if chaos else 1,
                     **PAPER_BASELINE)
            for sc in scenarios]


def baseline_rows(scenarios: Sequence[str], seed: int = 0,
                  n_jobs: Optional[int] = None, engine: Optional[str] = None,
                  chaos: bool = False, workers: int = 1) -> Dict[str, dict]:
    cells = baseline_cells(scenarios, seed=seed, n_jobs=n_jobs,
                           engine=engine, chaos=chaos)
    rows = run_cells(cells, workers=workers)
    return dict(zip(scenarios, rows))


def _beats(row: dict, base: dict) -> bool:
    """Strict per-scenario Pareto domination over the baseline row."""
    no_worse = all(sign * row[f] <= sign * base[f]
                   for f, sign in _DOMINATION_AXES)
    better = any(sign * row[f] < sign * base[f]
                 for f, sign in _DOMINATION_AXES)
    return no_worse and better


def build_report(result: SearchResult, baseline: Dict[str, dict]) -> dict:
    """JSON-serializable search artifact (see module docstring)."""
    front = []
    for ind in result.front:
        front.append({
            "vector": list(ind.vector),
            "config": ind.config,
            "objectives": dict(zip(result.objectives, ind.objectives)),
            "per_scenario": {
                sc: {k: row[k] for k in ("cost", "mean_pending_s",
                                         "avg_ram_ratio", "lost_work_s",
                                         "completed")}
                for sc, row in ind.per_scenario.items()},
        })

    dominations = []
    for scenario, base in baseline.items():
        for i, ind in enumerate(result.front):
            row = ind.per_scenario.get(scenario)
            if row is None or not row["completed"] or not _beats(row, base):
                continue
            cost_delta_pct = (100.0 * (base["cost"] - row["cost"])
                              / base["cost"]) if base["cost"] else 0.0
            dominations.append({
                "scenario": scenario, "front_index": i,
                "config": ind.config,
                "cost_delta_pct": cost_delta_pct,
                "searched": {f: row[f] for f, _ in _DOMINATION_AXES},
                "paper_default": {f: base[f] for f, _ in _DOMINATION_AXES},
            })
    dominations.sort(key=lambda d: -d["cost_delta_pct"])

    return {
        "objectives": list(result.objectives),
        "scenarios": list(result.scenarios),
        "seed": result.seed,
        "evaluations": result.evaluations,
        "history": result.history,
        "front": front,
        "baseline": {sc: {k: row[k] for k in ("cost", "mean_pending_s",
                                              "avg_ram_ratio", "lost_work_s",
                                              "completed")}
                     for sc, row in baseline.items()},
        "dominations": dominations,
    }


def summarize(report: dict) -> List[str]:
    """Human-readable summary lines ("beats the paper's defaults by
    X% on scenario Y")."""
    lines = [f"Pareto front: {len(report['front'])} configs "
             f"({report['evaluations']} distinct configs simulated, "
             f"seed {report['seed']})"]
    if not report["dominations"]:
        lines.append("no searched config strictly dominates the paper "
                     "default on any scenario (front still traces the "
                     "cost/latency/utilization trade-off)")
        return lines
    seen = set()
    for dom in report["dominations"]:
        if dom["scenario"] in seen:
            continue
        seen.add(dom["scenario"])
        cfg = dom["config"]
        lines.append(
            f"beats the paper's Alg. 5/6 defaults by "
            f"{dom['cost_delta_pct']:.1f}% cost on {dom['scenario']} "
            f"(also no worse on pending time and utilization) — "
            f"rescheduler={cfg['rescheduler']} autoscaler={cfg['autoscaler']}"
            f" template={cfg['template']}")
    return lines
