"""Seeded NSGA-II over policy configurations.

Multi-objective search (Deb et al. 2002) for scheduler/rescheduler/
autoscaler policies: fast non-dominated sorting, crowding distance with
``+inf`` boundary points, crowded-comparison binary tournaments, SBX
crossover on continuous genes + uniform swap on categorical genes, and
bounded polynomial mutation (categoricals re-draw uniformly).

Determinism contract: every stochastic step draws from one
``np.random.Generator(PCG64(seed))`` owned by the main process, and all
evaluation goes through `repro_torch.search.runner` whose cells are hermetic —
so the whole search is a pure function of ``(space, scenarios, seed,
generations, pop_size, ...)``, and the Pareto front is bit-identical
whether cells run serially or on a process pool.

Objectives are minimized; utilization enters negated (maximize) as
``neg_avg_ram_ratio``.  Each config's objective vector is the *mean over
scenario families* of the per-scenario metric — one policy has to do
well across diurnal, flash-crowd MMPP, heavy-tail, ... simultaneously,
not overfit one trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.search.paramspace import (ChoiceParam, PAPER_DEFAULT_CONFIG,
                                           ParamSpace, to_cell_spec)
from repro_torch.search.runner import run_cells

Vector = Tuple[float, ...]

# Objective name -> (ExperimentResult row field, sign).  All minimized.
OBJECTIVES: Dict[str, Tuple[str, float]] = {
    "cost": ("cost", 1.0),
    "mean_pending_s": ("mean_pending_s", 1.0),
    "neg_avg_ram_ratio": ("avg_ram_ratio", -1.0),
    "lost_work_s": ("lost_work_s", 1.0),   # chaos cells only (else 0)
}
DEFAULT_OBJECTIVES = ("cost", "mean_pending_s", "neg_avg_ram_ratio")

# Added once per scenario a config fails to complete on: large enough to
# push any incomplete config behind every complete one on every axis,
# finite so crowding-distance normalization stays well-defined.
INCOMPLETE_PENALTY = 1e6


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff `a` is no worse than `b` everywhere and better somewhere
    (minimization)."""
    return (all(x <= y for x, y in zip(a, b))
            and any(x < y for x, y in zip(a, b)))


def fast_non_dominated_sort(objectives: Sequence[Sequence[float]]
                            ) -> List[List[int]]:
    """Partition indices into Pareto fronts, best first.

    Every index appears in exactly one front; front 0 is the
    non-dominated set; each member of front k is dominated by at least
    one member of front k-1.  Indices within a front stay ascending.
    """
    n = len(objectives)
    dominated_by: List[List[int]] = [[] for _ in range(n)]
    dom_count = [0] * n
    for i in range(n):
        for j in range(i + 1, n):
            if dominates(objectives[i], objectives[j]):
                dominated_by[i].append(j)
                dom_count[j] += 1
            elif dominates(objectives[j], objectives[i]):
                dominated_by[j].append(i)
                dom_count[i] += 1
    fronts = [[i for i in range(n) if dom_count[i] == 0]]
    while fronts[-1]:
        nxt = []
        for i in fronts[-1]:
            for j in dominated_by[i]:
                dom_count[j] -= 1
                if dom_count[j] == 0:
                    nxt.append(j)
        fronts.append(sorted(nxt))
    return fronts[:-1]


def crowding_distance(objectives: Sequence[Sequence[float]],
                      front: Sequence[int]) -> List[float]:
    """Per-member crowding distance, aligned with `front`'s order.

    Boundary members of every objective get ``+inf`` (they are always
    preserved); interior members accumulate normalized neighbor gaps.
    Ties in an objective sort break on index, keeping the result a pure
    function of the inputs.
    """
    k = len(front)
    dist = [0.0] * k
    if k <= 2:
        return [math.inf] * k
    for field_idx in range(len(objectives[front[0]])):
        order = sorted(range(k),
                       key=lambda i: (objectives[front[i]][field_idx],
                                      front[i]))
        lo = objectives[front[order[0]]][field_idx]
        hi = objectives[front[order[-1]]][field_idx]
        dist[order[0]] = dist[order[-1]] = math.inf
        span = hi - lo
        if span <= 0.0:
            continue
        for pos in range(1, k - 1):
            prev_v = objectives[front[order[pos - 1]]][field_idx]
            next_v = objectives[front[order[pos + 1]]][field_idx]
            if not math.isinf(dist[order[pos]]):
                dist[order[pos]] += (next_v - prev_v) / span
    return dist


def _tournament(rng, ranks: Sequence[int], crowd: Sequence[float]) -> int:
    """Binary crowded-comparison tournament: lower rank wins, then higher
    crowding, then lower index (deterministic tie-break)."""
    i = int(rng.integers(len(ranks)))
    j = int(rng.integers(len(ranks)))
    a = (ranks[i], -crowd[i], i)
    b = (ranks[j], -crowd[j], j)
    return i if a <= b else j


def sbx_crossover(rng, v1: Vector, v2: Vector, space: ParamSpace,
                  eta: float = 15.0, prob: float = 0.9
                  ) -> Tuple[Vector, Vector]:
    """Simulated binary crossover on float genes, uniform swap on choice
    genes; children are clipped to the space's vector bounds."""
    c1, c2 = list(v1), list(v2)
    if rng.random() < prob:
        for i, ((lo, hi), p) in enumerate(zip(space.bounds(), space.params)):
            if isinstance(p, ChoiceParam):
                if rng.random() < 0.5:
                    c1[i], c2[i] = c2[i], c1[i]
                continue
            if rng.random() < 0.5:
                continue
            x1, x2 = c1[i], c2[i]
            if abs(x1 - x2) < 1e-14:
                continue
            u = rng.random()
            if u <= 0.5:
                beta = (2.0 * u) ** (1.0 / (eta + 1.0))
            else:
                beta = (1.0 / (2.0 * (1.0 - u))) ** (1.0 / (eta + 1.0))
            a = 0.5 * ((1.0 + beta) * x1 + (1.0 - beta) * x2)
            b = 0.5 * ((1.0 - beta) * x1 + (1.0 + beta) * x2)
            c1[i] = min(max(a, lo), hi)
            c2[i] = min(max(b, lo), hi)
    return tuple(c1), tuple(c2)


def mutate(rng, vec: Vector, space: ParamSpace, eta: float = 20.0,
           prob: Optional[float] = None) -> Vector:
    """Bounded polynomial mutation on float genes; choice genes re-draw
    uniformly.  Output stays inside the space's vector bounds."""
    if prob is None:
        prob = 1.0 / len(vec)
    out = list(vec)
    for i, ((lo, hi), p) in enumerate(zip(space.bounds(), space.params)):
        if rng.random() >= prob:
            continue
        if isinstance(p, ChoiceParam):
            out[i] = float(rng.integers(len(p.choices)))
            continue
        u = rng.random()
        if u < 0.5:
            delta = (2.0 * u) ** (1.0 / (eta + 1.0)) - 1.0
        else:
            delta = 1.0 - (2.0 * (1.0 - u)) ** (1.0 / (eta + 1.0))
        out[i] = min(max(out[i] + delta * (hi - lo), lo), hi)
    return tuple(out)


@dataclasses.dataclass
class Individual:
    vector: Vector
    config: Dict[str, object]
    objectives: Tuple[float, ...]
    per_scenario: Dict[str, dict]


@dataclasses.dataclass
class SearchResult:
    front: List[Individual]          # final non-dominated set, vector-sorted
    population: List[Individual]     # final population (may repeat configs)
    history: List[dict]              # per-generation stats
    objectives: Tuple[str, ...]
    scenarios: Tuple[str, ...]
    seed: int
    evaluations: int                 # distinct configs actually simulated


def _canon(space: ParamSpace, vec: Vector) -> Vector:
    # decode→encode snaps mutated choice genes to exact indices and clips
    # floats, so the evaluation cache keys on canonical vectors and
    # encode/decode stay exact inverses on everything we evaluate.
    return space.encode(space.decode(vec))


def run_search(space: ParamSpace, scenarios: Sequence[str], *,
               generations: int = 8, pop_size: int = 12, seed: int = 0,
               workers: int = 1, n_jobs: Optional[int] = None,
               engine: Optional[str] = None,
               objectives: Sequence[str] = DEFAULT_OBJECTIVES,
               chaos: bool = False, warm_start: bool = True,
               log: Optional[Callable[[str], None]] = None) -> SearchResult:
    """Run a seeded NSGA-II search; see module docstring for the
    determinism contract.  ``workers`` only changes wall-clock time."""
    if pop_size < 2:
        raise ValueError("pop_size must be >= 2")
    for name in objectives:
        if name not in OBJECTIVES:
            raise KeyError(f"unknown objective {name!r}; one of "
                           f"{sorted(OBJECTIVES)}")
    scenarios = tuple(scenarios)
    objectives = tuple(objectives)
    rng = np.random.Generator(np.random.PCG64(seed))
    cache: Dict[Vector, Tuple[Tuple[float, ...], Dict[str, dict]]] = {}

    def evaluate(vectors: Sequence[Vector]) -> None:
        todo = [v for v in dict.fromkeys(vectors) if v not in cache]
        if not todo:
            return
        cells = [to_cell_spec(space.decode(v), sc, seed=seed, n_jobs=n_jobs,
                              engine=engine, chaos=chaos)
                 for v in todo for sc in scenarios]
        rows = run_cells(cells, workers=workers)
        for i, v in enumerate(todo):
            chunk = rows[i * len(scenarios):(i + 1) * len(scenarios)]
            per_scenario = dict(zip(scenarios, chunk))
            objs = []
            for name in objectives:
                field, sign = OBJECTIVES[name]
                objs.append(math.fsum(sign * row[field] for row in chunk)
                            / len(chunk))
            penalty = INCOMPLETE_PENALTY * sum(
                not row["completed"] for row in chunk)
            cache[v] = (tuple(o + penalty for o in objs), per_scenario)

    def make_individual(vec: Vector) -> Individual:
        objs, per_scenario = cache[vec]
        return Individual(vector=vec, config=space.decode(vec),
                          objectives=objs, per_scenario=per_scenario)

    pop_vecs: List[Vector] = []
    if warm_start:
        # Individual 0 is the paper's Table-4 chain expressed in this
        # space, so the front can only match or beat the paper defaults.
        pop_vecs.append(space.encode(PAPER_DEFAULT_CONFIG))
    while len(pop_vecs) < pop_size:
        pop_vecs.append(space.encode(space.sample(rng)))
    evaluate(pop_vecs)

    history: List[dict] = []
    for gen in range(generations):
        objs = [cache[v][0] for v in pop_vecs]
        fronts = fast_non_dominated_sort(objs)
        ranks = [0] * len(pop_vecs)
        crowd = [0.0] * len(pop_vecs)
        for r, front in enumerate(fronts):
            dists = crowding_distance(objs, front)
            for idx, d in zip(front, dists):
                ranks[idx] = r
                crowd[idx] = d

        children: List[Vector] = []
        while len(children) < pop_size:
            p1 = pop_vecs[_tournament(rng, ranks, crowd)]
            p2 = pop_vecs[_tournament(rng, ranks, crowd)]
            c1, c2 = sbx_crossover(rng, p1, p2, space)
            children.append(_canon(space, mutate(rng, c1, space)))
            if len(children) < pop_size:
                children.append(_canon(space, mutate(rng, c2, space)))
        evaluate(children)

        combined = pop_vecs + children
        comb_objs = [cache[v][0] for v in combined]
        next_vecs: List[Vector] = []
        for front in fast_non_dominated_sort(comb_objs):
            if len(next_vecs) + len(front) <= pop_size:
                next_vecs.extend(front)
            else:
                dists = crowding_distance(comb_objs, front)
                # Highest crowding first; index breaks ties exactly.
                order = sorted(range(len(front)),
                               key=lambda i: (-dists[i], front[i]))
                keep = order[:pop_size - len(next_vecs)]
                next_vecs.extend(front[i] for i in keep)
                break
        pop_vecs = [combined[i] for i in next_vecs]

        final_objs = [cache[v][0] for v in pop_vecs]
        front0 = fast_non_dominated_sort(final_objs)[0]
        stats = {"generation": gen, "front_size": len(front0),
                 "evaluations": len(cache)}
        for k, name in enumerate(objectives):
            stats[f"best_{name}"] = min(o[k] for o in final_objs)
        history.append(stats)
        if log is not None:
            best = ", ".join(f"{name}={stats[f'best_{name}']:.4g}"
                             for name in objectives)
            log(f"gen {gen}: front={len(front0)} evals={len(cache)} {best}")

    final_objs = [cache[v][0] for v in pop_vecs]
    front_idx = fast_non_dominated_sort(final_objs)[0]
    front_vecs = sorted(set(pop_vecs[i] for i in front_idx))
    return SearchResult(
        front=[make_individual(v) for v in front_vecs],
        population=[make_individual(v) for v in pop_vecs],
        history=history, objectives=objectives, scenarios=scenarios,
        seed=seed, evaluations=len(cache))
