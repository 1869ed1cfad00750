"""Lane-batched cell evaluator: ``run_cells`` rows from the lane engine.

``run_cells_lanes`` is the backend behind
``repro_torch.search.runner.run_cells(cells, workers="lanes")``: it returns
one row dict per cell, in the order given, evaluating every cell inside
batched lane programs (:mod:`repro_torch.manyworld.lanes`).

**Eligibility** is the lane engine's relaxed-semantics envelope — the
void/void static-cluster regime (:func:`lane_eligible`).  The serial
simulator is not ported, so a cell outside it raises ``ValueError``
naming the cell instead of running serially.

**Exactness.**  Rows are bit-identical to the reference's serial
``run_cell`` except ``wall_s``, which is the lane's share of its batch's
wall time.  The lane program reproduces the bind sequence exactly; the
remaining ``ExperimentResult`` metrics are rebuilt on the host by
replaying the serial event semantics over the lane outputs
(:func:`_lane_metrics`, a verbatim copy of the reference's replay):

* pending intervals are ``bind_time - submit_time`` per bound row in
  row order;
* the 20 s utilisation samples are replayed with a pointer walk over the
  bind/completion events in serial processing order, with the serial
  sample-tie rules;
* cost/node-seconds use the serial CostModel formulas for a static fleet
  billed from t=0 (one ``ceil`` per node, left-to-right accumulation).

Buckets: lanes group by ``(scheduler, pod-pad, node-pad)`` with
power-of-two pads, so mixed workloads share a batch.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.manyworld import lane_kernel
from repro_torch.manyworld import lanes as _lanes
from repro_torch.manyworld.lanes import (CYCLE_PERIOD_S, HORIZON_S,
                                         SCHEDULERS, next_pow2)

SAMPLE_PERIOD_S = 20.0

# Seconds by stage of the last run_cells_lanes call: traces and lane
# arrays built on the host ("prepare_s"), batches stacked and uploaded,
# the lane program (the kernel on the card, to its end), outputs copied
# back, and the host replay of the rows (_lane_metrics).
stage_s: dict = {}


def lane_eligible(cell) -> bool:
    """True when ``cell`` is inside the lane engine's relaxed envelope:
    a void/void static cluster (no autoscaler, no rescheduler, no chaos)
    on the array engine with a supported scheduler and valid weights."""
    if cell.autoscaler != "void" or cell.rescheduler != "void":
        return False
    if cell.chaos:
        return False
    if cell.engine not in (None, "array"):
        return False
    if cell.scheduler not in SCHEDULERS:
        return False
    if cell.initial_workers < 1:
        return False
    w = cell.scheduler_weights
    if w is not None:
        if cell.scheduler != "weighted" or len(w) != 3:
            return False
        if not (sum(w) > 0.0) or min(w) < 0.0:
            return False
    return True


_CELL_FIELDS: tuple = ()


def _cell_dict(cell) -> dict:
    """``dataclasses.asdict(cell)`` without the deepcopy walk: every
    ``CellSpec`` field is a primitive or a flat tuple, so a getattr sweep
    builds an ``==``-identical dict."""
    global _CELL_FIELDS
    if not _CELL_FIELDS:
        _CELL_FIELDS = tuple(f.name for f in dataclasses.fields(cell))
    return {name: getattr(cell, name) for name in _CELL_FIELDS}


def _base_row(cell, trace, infeasible: bool) -> dict:
    from repro_torch.search.runner import _RESULT_FIELDS
    row = {"label": cell.label, "cell": _cell_dict(cell),
           "n_jobs": trace.n, "infeasible": infeasible}
    if infeasible:
        for field in _RESULT_FIELDS:
            row[field] = False if field == "completed" else 0
        row["wall_s"] = 0.0
    return row


def _on_grid(t: float) -> bool:
    return math.fmod(t, SAMPLE_PERIOD_S) == 0.0


def _lane_metrics(cell, trace, template, o: dict) -> dict:
    """Reconstruct one cell's ExperimentResult fields from lane outputs.

    ``o`` holds this lane's slices: per-pod ``bound`` / ``bind_node`` /
    ``bind_seq`` / ``bind_cycle`` / ``done_t`` / ``done_committed`` and
    per-lane ``completed`` / ``done_time`` / ``done_is_cycle`` /
    ``scale_outs``.  Every formula below is the serial one, applied in
    the serial order.
    """
    n = trace.n
    n_nodes = cell.initial_workers
    alloc_cpu = float(template.allocatable.cpu_m)
    alloc_mem = float(template.allocatable.mem_mb)
    price = float(template.price_per_s)

    bound = o["bound"][:n]
    committed = o["done_committed"][:n]
    bind_t = o["bind_cycle"][:n].astype(np.float64) * CYCLE_PERIOD_S
    done_t = o["done_t"][:n]
    seq = o["bind_seq"][:n]
    node = o["bind_node"][:n]
    cpu = trace.cpu_m.astype(np.float64)
    mem = trace.mem_mb.astype(np.float64)
    completed = bool(o["completed"])
    done_time = float(o["done_time"])

    # -- end of run (simulation.run: last_batch_done wins when truthy) --
    if completed:
        lbd = float(done_t[committed].max()) if committed.any() else 0.0
        end = lbd if lbd else done_time
        te = done_time
    else:
        end = HORIZON_S            # samples run the clock to the horizon
        te = None

    arr0 = float(trace.arrival_time[0]) if n else None
    start = arr0 if (arr0 is not None and arr0 <= HORIZON_S) else 0.0

    # -- pending intervals (store.pending_intervals_all: bound rows only,
    # row order; void/void never rebinds so one interval per pod) --------
    pend = (bind_t[bound] - trace.arrival_time[bound].astype(np.float64)
            ).tolist()

    # -- utilisation sample replay --------------------------------------
    # Events in serial processing order: (time, kind, bind_seq) with
    # POD_DONE (0) before the cycle's binds (1) at equal times; equal-time
    # completions fire in scheduling-push order == ascending bind_seq.
    # Each event carries the first sample time that can see it:
    # * a bind at cycle tc is visible from the next grid point after tc
    #   (SAMPLE(t) runs before CYCLE(t) for t>0) — except cycle 0, whose
    #   binds sample at t=0 (run() pushes CYCLE(0) before SAMPLE(0));
    # * a completion at td is visible from td itself when td is on-grid
    #   and its POD_DONE was pushed (at its bind cycle tc) before
    #   SAMPLE(td) was (at td-20) — i.e. tc < td-20, or the cycle-0
    #   corner tc==0, td==20 — else from the next grid point after td.
    SP = SAMPLE_PERIOD_S
    bi = np.nonzero(bound)[0]
    tb = bind_t[bi]
    sv_b = np.where(tb == 0.0, 0.0, (np.floor(tb / SP) + 1.0) * SP)
    di = np.nonzero(committed)[0]
    td_a = done_t[di]
    tc_a = bind_t[di]
    done_early = ((np.fmod(td_a, SP) == 0.0)
                  & ((tc_a < td_a - SP) | ((tc_a == 0.0) & (td_a == SP))))
    sv_d = np.where(done_early, td_a, (np.floor(td_a / SP) + 1.0) * SP)
    ev_t = np.concatenate([td_a, tb])
    ev_kind = np.concatenate([np.zeros(di.size, np.int8),
                              np.ones(bi.size, np.int8)])
    ev_seq = np.concatenate([seq[di], seq[bi]])
    order = np.lexsort((ev_seq, ev_kind, ev_t))
    ev_sv = np.concatenate([sv_d, sv_b])[order].tolist()
    ev_node = np.concatenate([node[di], node[bi]])[order].tolist()
    ev_dcpu = np.concatenate([-cpu[di], cpu[bi]])[order].tolist()
    ev_dmem = np.concatenate([-mem[di], mem[bi]])[order].tolist()
    ev_dp = np.concatenate([np.full(di.size, -1), np.ones(bi.size)]
                           )[order].astype(np.int64).tolist()
    n_ev = len(ev_sv)

    # Which samples were recorded before the run ended?  Non-completed
    # lanes sample the whole horizon.  A completed lane breaks on its
    # trigger event at te: every grid point strictly before te is in; the
    # grid point *at* te is in iff the trigger ran after SAMPLE(te) —
    # for a CYCLE trigger that is every te>0, for a POD_DONE trigger it
    # is the complement of the completion-visibility push rule above,
    # judged on the trigger pod (the last-committed one).
    if not completed:
        last_s = HORIZON_S
    else:
        if _on_grid(te) and te > 0.0:
            if o["done_is_cycle"]:
                last_s = te
            else:
                ic = np.nonzero(committed)[0]
                trig = ic[np.lexsort((seq[ic], done_t[ic]))[-1]]
                tc = float(bind_t[trig])
                pod_done_first = (tc < te - SAMPLE_PERIOD_S
                                  or (tc == 0.0 and te == SAMPLE_PERIOD_S))
                last_s = te if not pod_done_first else te - SAMPLE_PERIOD_S
        else:
            last_s = (math.ceil(te / SAMPLE_PERIOD_S) - 1.0) * SAMPLE_PERIOD_S
            if _on_grid(te):       # te == 0: CYCLE(0) broke before SAMPLE(0)
                last_s = te - SAMPLE_PERIOD_S

    ram_vals: List[float] = []
    cpu_vals: List[float] = []
    ppn_vals: List[float] = []
    used_cpu = [0.0] * n_nodes
    used_mem = [0.0] * n_nodes
    pods = 0
    acpu = max(alloc_cpu, 1)       # serial: np.maximum(alloc_cpu, 1)
    ptr = 0
    s = 0.0
    while s <= last_s:
        while ptr < n_ev and ev_sv[ptr] <= s:
            nd = ev_node[ptr]
            used_cpu[nd] += ev_dcpu[ptr]
            used_mem[nd] += ev_dmem[ptr]
            pods += ev_dp[ptr]
            ptr += 1
        # Serial sampler: exact fsum of per-node IEEE ratios, / n.
        cur_ram = math.fsum(u / alloc_mem for u in used_mem) / n_nodes
        cur_cpu = math.fsum(u / acpu for u in used_cpu) / n_nodes
        cur_ppn = float(pods) / n_nodes
        # `ev_sv` is non-decreasing in commit order, so the state stays
        # constant until the next event becomes visible (or the run
        # ends): emit the whole constant run of samples in one extend.
        if ptr == n_ev or ev_sv[ptr] > last_s:
            run_end = last_s
        else:
            run_end = ev_sv[ptr] - SAMPLE_PERIOD_S
        m = int((run_end - s) / SAMPLE_PERIOD_S) + 1
        ram_vals.extend([cur_ram] * m)
        cpu_vals.extend([cur_cpu] * m)
        ppn_vals.extend([cur_ppn] * m)
        s += m * SAMPLE_PERIOD_S

    # -- cost (CostModel: N static nodes billed 0 -> end, ceil'd, summed
    # left-to-right in record order) ------------------------------------
    secs = float(np.ceil(np.maximum(0.0, np.float64(end))))
    term = float(np.float64(secs) * np.float64(price))
    cost = 0.0
    for _ in range(n_nodes):
        cost += term
    node_seconds = int(secs * n_nodes)

    return {
        "completed": completed,
        "cost": cost,
        "duration_s": end - start,
        "mean_pending_s": statistics.fmean(pend) if pend else 0.0,
        "median_pending_s": statistics.median(pend) if pend else 0.0,
        "max_pending_s": max(pend) if pend else 0.0,
        "avg_ram_ratio": statistics.fmean(ram_vals) if ram_vals else 0.0,
        "avg_cpu_ratio": statistics.fmean(cpu_vals) if cpu_vals else 0.0,
        "avg_pods_per_node": statistics.fmean(ppn_vals) if ppn_vals else 0.0,
        "max_nodes": n_nodes if ram_vals else 0,
        "node_seconds": node_seconds,
        "evictions": 0,
        "scale_outs": int(o["scale_outs"]),
        "scale_ins": 0,
        "failures_injected": 0,
        "preemption_notices": 0,
        "lost_work_s": 0.0,
    }


def _zero_pod_metrics(cell, template) -> dict:
    """A lane with an empty trace never completes: the empty static
    cluster just samples flat zeros to the horizon (handled on the host)."""
    o = {"bound": np.zeros(0, bool), "done_committed": np.zeros(0, bool),
         "bind_cycle": np.zeros(0, np.int32), "done_t": np.zeros(0),
         "bind_seq": np.zeros(0, np.int32), "bind_node": np.zeros(0, np.int32),
         "completed": False, "done_time": HORIZON_S, "done_is_cycle": False,
         "scale_outs": 0}
    empty = _EmptyTrace()
    return _lane_metrics(cell, empty, template, o)


class _EmptyTrace:
    n = 0
    arrival_time = np.zeros(0)
    cpu_m = np.zeros(0, np.int64)
    mem_mb = np.zeros(0)


def run_cells_lanes(cells: Sequence, device=None) -> List[dict]:
    """Evaluate ``cells`` with the lane engine on ``device`` (``None``
    means CUDA); serial-identical rows in submission order.  A cell
    outside :func:`lane_eligible` raises ``ValueError``."""
    from repro_torch.search.runner import (CellError, _get_trace,
                                           _infeasible, _template_of)
    dev = resolve_device(device)
    stage_s.clear()
    stage_s.update(prepare_s=0.0, stack_upload_s=0.0, lane_program_s=0.0,
                   download_s=0.0, host_replay_s=0.0)
    t_prep = time.perf_counter()
    cells = list(cells)
    for cell in cells:
        if not lane_eligible(cell):
            raise ValueError(
                f"cell {cell.label} is outside the lane engine's envelope "
                "(void/void static cluster, array engine, one of "
                f"{SCHEDULERS}, valid weights); repro_torch has no serial "
                "simulator to run it")

    rows: List[Optional[dict]] = [None] * len(cells)
    buckets = {}                  # (sched, p_pad, n_pad) -> [entries]
    for idx, cell in enumerate(cells):
        try:
            trace = _get_trace(cell.scenario, cell.seed, cell.n_jobs)
            template = _template_of(cell)
            if _infeasible(cell, trace):
                rows[idx] = _base_row(cell, trace, infeasible=True)
                continue
            if trace.n == 0:
                t0 = time.perf_counter()
                row = _base_row(cell, trace, infeasible=False)
                row.update(_zero_pod_metrics(cell, template))
                row["wall_s"] = time.perf_counter() - t0
                rows[idx] = row
                continue
            lane = trace.to_lane_arrays()
            lane["n_nodes"] = cell.initial_workers
            lane["alloc_cpu"] = float(template.allocatable.cpu_m)
            lane["alloc_mem"] = float(template.allocatable.mem_mb)
            lane["weights"] = cell.scheduler_weights
            key = (cell.scheduler, next_pow2(trace.n),
                   next_pow2(cell.initial_workers))
            buckets.setdefault(key, []).append((idx, cell, trace, template,
                                                lane))
        except Exception as exc:
            raise CellError(f"cell {cell.label} failed: {exc!r}") from exc

    stage_s["prepare_s"] = time.perf_counter() - t_prep

    for (sched, p_pad, _n_pad), entries in buckets.items():
        t0 = time.perf_counter()
        batch = _lanes.stack_lanes([e[4] for e in entries], sched,
                                   p_pad=p_pad, device=dev)
        if dev.type == "cuda":
            # run_lane_batch's CUDA path, its stages timed apart.
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            res = lane_kernel.lane_program(batch)
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            out = lane_kernel.lane_outputs(res)
        else:
            t1 = time.perf_counter()
            out = _lanes.run_lane_batch(batch, device=dev)
            t2 = time.perf_counter()
        t3 = time.perf_counter()
        stage_s["stack_upload_s"] += t1 - t0
        stage_s["lane_program_s"] += t2 - t1
        stage_s["download_s"] += t3 - t2
        share = (t3 - t0) / len(entries)
        for li, (idx, cell, trace, template, _lane) in enumerate(entries):
            o = {key: val[li] for key, val in out.items()
                 if key != "n_cycles"}
            try:
                row = _base_row(cell, trace, infeasible=False)
                row.update(_lane_metrics(cell, trace, template, o))
                row["wall_s"] = share
                rows[idx] = row
            except Exception as exc:
                raise CellError(
                    f"cell {cell.label} failed: {exc!r}") from exc
        stage_s["host_replay_s"] += time.perf_counter() - t3
    return rows
