"""Policy search: parallel cell runner + multi-objective NSGA-II.

* `repro_torch.search.runner` — hermetic `CellSpec` cells on a process pool,
  bit-identical to the serial path with stable result ordering;
* `repro_torch.search.paramspace` — typed parameter space with exact
  encode/decode to flat vectors and seeded sampling;
* `repro_torch.search.nsga2` — seeded NSGA-II over (cost, mean pending time,
  −utilization) across scenario families;
* `repro_torch.search.report` — Pareto-front JSON artifact + "beats the
  paper's defaults by X% on scenario Y" comparison.
"""
from repro_torch.search.nsga2 import (DEFAULT_OBJECTIVES, Individual,
                                      SearchResult, crowding_distance,
                                      dominates, fast_non_dominated_sort,
                                      mutate, run_search, sbx_crossover)
from repro_torch.search.paramspace import (ChoiceParam, FloatParam,
                                           PAPER_DEFAULT_CONFIG, ParamSpace,
                                           default_space, predictive_space,
                                           to_cell_spec)
from repro_torch.search.report import baseline_rows, build_report, summarize
from repro_torch.search.runner import CellError, CellSpec, run_cell, run_cells

__all__ = [
    "CellError", "CellSpec", "ChoiceParam", "DEFAULT_OBJECTIVES",
    "FloatParam", "Individual", "PAPER_DEFAULT_CONFIG", "ParamSpace",
    "SearchResult", "baseline_rows", "build_report", "crowding_distance",
    "default_space", "dominates", "fast_non_dominated_sort", "mutate",
    "predictive_space",
    "run_cell", "run_cells", "run_search", "sbx_crossover", "summarize",
    "to_cell_spec",
]
