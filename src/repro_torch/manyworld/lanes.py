"""Many-world lane engine: thousands of simulations as one PyTorch program.

One *lane* is one full static-cluster experiment — trace, scheduler,
fleet size — and a batch of lanes runs over stacked ``(lane, node)`` /
``(lane, pod)`` tensors.  :func:`run_lane_batch` runs a batch on the card
as ONE launch of the CUDA kernel ``csrc/lane_program.cu``
(:mod:`repro_torch.manyworld.lane_kernel`), in which each lane runs its
own cycle loop; on the CPU it runs :func:`run_lane_batch_lockstep`.

:func:`run_lane_batch_lockstep` is the kernel's plain PyTorch version: an
eager, lockstep port of the JAX program in ``repro/manyworld/lanes.py``,
the same state, the same steps in the same order, with each
``lax.while_loop`` become a Python ``while`` on ``bool(t.any())`` and the
state updated in place on the device:

* the cycle loop advances the 10 s scheduling cycle for all lanes
  together until every lane is finished (completed, stuck or quiescent)
  or the 48 h horizon is reached;
* a completion loop commits due batch completions one pod per lane per
  step in ``(done_time, bind_seq)`` order, the serial event order, so the
  per-node ``used_*`` floats stay bit-identical to the serial engine's;
* a bind loop walks the pending pods in row (FIFO) order, one pod per lane
  per step: feasibility mask, scheduler score, masked-argmin select
  (:mod:`repro_torch.manyworld.select`, a CUDA kernel on the card), then
  ``used += req``.

**Float discipline.**  Everything the serial engine does in float64 is
done in float64.  Eager PyTorch runs one operation per kernel, so nothing
contracts ``a*b + c`` into a fused multiply-add; the score path uses no
fused operator (``addcmul``, ``lerp``, ``torch.compile``).  Divisors are
tensors, except the ``/ 2.0`` of the blend, which CUDA may turn into
``* 0.5`` — exact.  The outputs are bit-identical to the JAX program's.

**Host syncs.**  Every loop condition of the lockstep program copies one
flag to the host: one sync per inner step.  ``host_syncs`` counts them;
the kernel makes none.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.manyworld.select import (masked_argmin,
                                          masked_argmin_plain)

CYCLE_PERIOD_S = 10.0
HORIZON_S = 48 * 3600.0          # SimConfig.max_sim_time_s default
MAX_CYCLES = int(HORIZON_S / CYCLE_PERIOD_S)   # cycle at t == horizon runs

SCHEDULERS = ("best-fit", "worst-fit", "first-fit", "k8s-default", "weighted")

# bind_seq fill for "no completion candidate" (any value > every real seq).
_SEQ_INF = 2**31 - 1

# Device-to-host syncs made by loop conditions since the last reset.
host_syncs = 0

# The batch's input arrays, in the JAX program's argument order.
BATCH_FIELDS = ("arrival_t", "cpu_m", "mem_mb", "duration_s", "is_batch",
                "valid", "n_nodes", "alloc_cpu", "alloc_mem", "weights")


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1), the padding quantum."""
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


@dataclasses.dataclass
class LaneBatch:
    """Stacked fixed-shape inputs for one lane program, as tensors on one
    device.  The pod axis is padded to ``p_pad`` (``valid`` masks real
    rows), the node axis to ``n_pad`` (``n_nodes`` masks real nodes); all
    lanes share one scheduler.  Build with :func:`stack_lanes` or
    :func:`lane_batch_from_numpy`."""

    scheduler: str
    arrival_t: torch.Tensor   # (L, P) f64, +inf padded
    cpu_m: torch.Tensor       # (L, P) f64
    mem_mb: torch.Tensor      # (L, P) f64
    duration_s: torch.Tensor  # (L, P) f64
    is_batch: torch.Tensor    # (L, P) bool
    valid: torch.Tensor       # (L, P) bool
    n_nodes: torch.Tensor     # (L,)  i32
    alloc_cpu: torch.Tensor   # (L,)  f64
    alloc_mem: torch.Tensor   # (L,)  f64
    weights: torch.Tensor     # (L, 3) f64 (weighted scheduler; else pack)
    n_pad: int

    @property
    def p_pad(self) -> int:
        return self.arrival_t.shape[1]


def lane_batch_from_numpy(batch, device=None) -> LaneBatch:
    """The port's batch on ``device`` from any object with the reference
    ``LaneBatch``'s numpy fields (``scheduler`` and the ten arrays)."""
    dev = resolve_device(device)
    arrays = {}
    for name in BATCH_FIELDS:
        a = np.asarray(getattr(batch, name))
        arrays[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n_nodes = np.asarray(batch.n_nodes)
    n_pad = next_pow2(int(n_nodes.max()) if n_nodes.size else 1)
    return LaneBatch(batch.scheduler, n_pad=n_pad, **arrays)


def stack_lanes(lanes, scheduler: str, p_pad: Optional[int] = None,
                device=None) -> LaneBatch:
    """Stack per-lane dicts (``TraceStore.to_lane_arrays`` output plus the
    cluster scalars ``n_nodes`` / ``alloc_cpu`` / ``alloc_mem`` and an
    optional ``weights`` 3-tuple) into one padded batch on ``device``."""
    if scheduler not in SCHEDULERS:
        raise ValueError(f"unsupported lane scheduler {scheduler!r}")
    n_max = max((int(d["arrival_t"].size) for d in lanes), default=0)
    P = p_pad if p_pad is not None else next_pow2(n_max)
    if n_max > P:
        raise ValueError(f"p_pad={P} < largest lane ({n_max} pods)")
    L = len(lanes)
    arr = np.full((L, P), np.inf)
    cpu = np.zeros((L, P))
    mem = np.zeros((L, P))
    dur = np.zeros((L, P))
    isb = np.zeros((L, P), bool)
    val = np.zeros((L, P), bool)
    n_nodes = np.zeros(L, np.int32)
    a_cpu = np.zeros(L)
    a_mem = np.zeros(L)
    wts = np.zeros((L, 3))
    for i, d in enumerate(lanes):
        n = int(d["arrival_t"].size)
        arr[i, :n] = d["arrival_t"]
        cpu[i, :n] = d["cpu_m"]
        mem[i, :n] = d["mem_mb"]
        dur[i, :n] = d["duration_s"]
        isb[i, :n] = d["is_batch"]
        val[i, :n] = True
        n_nodes[i] = d["n_nodes"]
        a_cpu[i] = d["alloc_cpu"]
        a_mem[i] = d["alloc_mem"]
        w = d.get("weights")
        wts[i] = (1.0, 0.0, 0.0) if w is None else tuple(w)
    return lane_batch_from_numpy(
        SimpleNamespace(scheduler=scheduler, arrival_t=arr, cpu_m=cpu,
                        mem_mb=mem, duration_s=dur, is_batch=isb, valid=val,
                        n_nodes=n_nodes, alloc_cpu=a_cpu, alloc_mem=a_mem,
                        weights=wts), device)


def _wave_scores(sched: str, free_cpu, free_mem, alloc_cpu, alloc_mem,
                 pc, pm, weights):
    """Per-node scores for one pod per lane, **negated for max-mode** so a
    single masked-argmin select serves every policy.  The serial
    ``Scheduler.wave_scores`` formulas, operation by operation, in float64;
    ``pc``/``pm`` are the pod's request as ``(L, 1)``."""
    if sched == "best-fit":
        return free_mem                       # min free_mem
    if sched == "worst-fit":
        return -free_mem                      # max free_mem
    if sched == "first-fit":
        return torch.zeros_like(free_mem)     # first feasible rank
    cpu_frac = (free_cpu - pc) / torch.clamp_min(alloc_cpu, 1.0)
    mem_frac = (free_mem - pm) / torch.clamp_min(alloc_mem, 1e-9)
    least_requested = 10.0 * (cpu_frac + mem_frac) / 2.0
    balanced = 10.0 * (1.0 - torch.abs(cpu_frac - mem_frac))
    if sched == "k8s-default":
        return -((least_requested + balanced) / 2.0)
    # weighted: w_pack*pack + w_lr*lr + w_bal*bal, left-to-right adds.
    pack = 10.0 * (1.0 - mem_frac)
    s = ((weights[:, 0:1] * pack + weights[:, 1:2] * least_requested)
         + weights[:, 2:3] * balanced)
    return -s


def _any(t: torch.Tensor) -> bool:
    global host_syncs
    host_syncs += 1
    return bool(t.any())


def run_lane_batch(batch: LaneBatch, device=None) -> dict:
    """Execute one :class:`LaneBatch` on ``device`` (``None`` means CUDA;
    the batch is moved there if it lies elsewhere); returns numpy lane
    outputs with the JAX program's keys and dtypes (see
    :func:`run_lane_batch_lockstep`).  On CUDA this is one launch of the
    lane-program kernel and no host sync until the outputs are copied
    back; on the CPU it is the lockstep program with the plain select."""
    from repro_torch.manyworld import lane_kernel   # builds on this module
    dev = resolve_device(device)
    if dev.type != "cuda":
        return run_lane_batch_lockstep(batch, dev, select=masked_argmin_plain)
    on_dev = dataclasses.replace(
        batch, **{name: getattr(batch, name).to(dev) for name in BATCH_FIELDS})
    return lane_kernel.lane_outputs(lane_kernel.lane_program(on_dev))


def run_lane_batch_lockstep(batch: LaneBatch, device=None,
                            select: Callable = masked_argmin) -> dict:
    """Execute one :class:`LaneBatch` in lockstep, one eager step for all
    lanes at a time; returns numpy lane outputs with the JAX program's
    keys and dtypes.

    Per lane: ``completed`` / ``done_time`` / ``done_is_cycle`` /
    ``scale_outs``; per pod: ``bound``, ``bind_node`` (node rank),
    ``bind_seq`` (per-lane bind order), ``bind_cycle`` (bind time is
    ``bind_cycle * 10.0``), ``done_t`` and ``done_committed``; per node:
    ``used_cpu`` / ``used_mem`` / ``pcount``; and ``n_cycles``.
    ``device=None`` means CUDA; the batch is moved there if it lies
    elsewhere.  ``select`` is the placement select (the kernel wrapper;
    a comparison run may pass ``masked_argmin_plain``).
    """
    dev = resolve_device(device)
    b = {name: getattr(batch, name).to(dev) for name in BATCH_FIELDS}
    arr_t, cpu, mem, dur = b["arrival_t"], b["cpu_m"], b["mem_mb"], \
        b["duration_s"]
    isb, valid = b["is_batch"], b["valid"]
    weights = b["weights"]
    sched, n_pad = batch.scheduler, batch.n_pad
    L, P = arr_t.shape
    i32, f64 = torch.int32, torch.float64
    inf = float("inf")

    li = torch.arange(L, device=dev)
    node_active = (torch.arange(n_pad, dtype=i32, device=dev)[None, :]
                   < b["n_nodes"][:, None])                  # (L, N)
    ac = b["alloc_cpu"][:, None]
    am = b["alloc_mem"][:, None]
    # Lane columns that never change inside a run.
    not_valid = ~valid
    valid_batch = valid & isb
    no_batch_wait = not_valid | ~isb       # rows a lane never waits to commit
    svc_rows = not_valid | isb             # rows a lane never waits to bind

    used_cpu = torch.zeros((L, n_pad), dtype=f64, device=dev)
    used_mem = torch.zeros((L, n_pad), dtype=f64, device=dev)
    pcount = torch.zeros((L, n_pad), dtype=i32, device=dev)
    done_c = torch.zeros((L, P), dtype=torch.bool, device=dev)
    done_t = torch.full((L, P), inf, dtype=f64, device=dev)
    bound = torch.zeros((L, P), dtype=torch.bool, device=dev)
    bind_node = torch.full((L, P), -1, dtype=i32, device=dev)
    bind_seq = torch.full((L, P), -1, dtype=i32, device=dev)
    bind_cycle = torch.full((L, P), -1, dtype=i32, device=dev)
    active = valid.any(dim=1)
    completed = torch.zeros(L, dtype=torch.bool, device=dev)
    done_time = torch.full((L,), HORIZON_S, dtype=f64, device=dev)
    done_is_cycle = torch.zeros(L, dtype=torch.bool, device=dev)
    seq_ctr = torch.zeros(L, dtype=i32, device=dev)
    scale_outs = torch.zeros(L, dtype=i32, device=dev)

    k = 0
    while k <= MAX_CYCLES and _any(active):
        t = k * CYCLE_PERIOD_S

        # -- completions: POD_DONE events at times <= t fire before
        # CYCLE(t), one pod per lane per step, in (done_time, bind_seq)
        # order (the serial heap order).
        due = valid_batch & bound & ~done_c & (done_t <= t) & active[:, None]
        while _any(due):
            has = due.any(dim=1)
            # Two-stage extremum: earliest done_time, then lowest bind_seq
            # among its ties (seq is unique per lane).
            t1 = torch.where(due, done_t, inf)
            tmin = t1.amin(dim=1, keepdim=True)
            s1 = torch.where(due & (t1 == tmin), bind_seq, _SEQ_INF)
            p = torch.argmin(s1, dim=1)
            node = torch.where(has, bind_node[li, p], 0).long()
            dc = torch.where(has, cpu[li, p], 0.0)
            dm = torch.where(has, mem[li, p], 0.0)
            # serial: node._used_* -= req, one pod at a time.
            used_cpu[li, node] = used_cpu[li, node] + (-dc)
            used_mem[li, node] = used_mem[li, node] + (-dm)
            pcount[li, node] = pcount[li, node] - has.to(i32)
            done_c[li, p] = done_c[li, p] | has
            # _done() after this POD_DONE: all arrived at the event's
            # time, every batch row committed, every service bound.
            td = torch.where(has, done_t[li, p], inf)
            arrived_td = (not_valid | (arr_t <= td[:, None])).all(dim=1)
            batch_done = (no_batch_wait | done_c).all(dim=1)
            svc_bound = (svc_rows | bound).all(dim=1)
            now_done = has & active & arrived_td & batch_done & svc_bound
            completed |= now_done
            done_time = torch.where(now_done, td, done_time)
            active &= ~now_done
            due = (valid_batch & bound & ~done_c & (done_t <= t)
                   & active[:, None])

        # -- wave: walk the pending snapshot in row (FIFO) order, one pod
        # per lane per step; blocked pods are counted and skipped.
        arrived = valid & (arr_t <= t)
        attempted = torch.zeros_like(bound)
        placed = torch.zeros(L, dtype=i32, device=dev)
        blocked = torch.zeros(L, dtype=i32, device=dev)
        cand = arrived & ~bound & active[:, None]
        while _any(cand):
            has = cand.any(dim=1)
            p = torch.argmax(cand.to(torch.uint8), dim=1)   # first pending
            pc = cpu[li, p][:, None]
            pm = mem[li, p][:, None]
            # serial WavePlacer: free = alloc - used;
            # fits = (free_cpu >= cpu) & (free_mem + 1e-9 >= mem).
            free_cpu = ac - used_cpu
            free_mem = am - used_mem
            mask = (free_cpu >= pc) & ((free_mem + 1e-9) >= pm) & node_active
            scores = _wave_scores(sched, free_cpu, free_mem, ac, am, pc, pm,
                                  weights)
            r = select(scores, mask)
            feas = mask.any(dim=1)
            do = has & feas
            blk = has & ~feas
            r_g = torch.where(do, r, 0).to(i32)
            r_i = r_g.long()
            add_c = torch.where(do, pc[:, 0], 0.0)
            add_m = torch.where(do, pm[:, 0], 0.0)
            do_i = do.to(i32)
            used_cpu[li, r_i] = used_cpu[li, r_i] + add_c
            used_mem[li, r_i] = used_mem[li, r_i] + add_m
            pcount[li, r_i] = pcount[li, r_i] + do_i
            bound[li, p] = bound[li, p] | do
            bind_node[li, p] = torch.where(do, r_g, bind_node[li, p])
            bind_seq[li, p] = torch.where(do, seq_ctr, bind_seq[li, p])
            bind_cycle[li, p] = torch.where(do, k, bind_cycle[li, p])
            # Completion timestamp: now + duration (speed factor 1);
            # services never complete (+inf).
            td = torch.where(do & isb[li, p], t + dur[li, p], inf)
            done_t[li, p] = torch.where(do, td, done_t[li, p])
            seq_ctr += do_i
            placed += do_i
            blocked += blk.to(i32)
            attempted[li, p] = attempted[li, p] | has
            cand = arrived & ~bound & ~attempted & active[:, None]
        scale_outs += blocked

        # -- post-cycle bookkeeping (serial order: wave stats, the _done()
        # check after the CYCLE event, then stuck detection).
        all_arrived = (not_valid | (arr_t <= t)).all(dim=1)
        pending_after = (arrived & ~bound).any(dim=1)
        running_batch = (valid_batch & bound & ~done_c).any(dim=1)
        batch_done = (no_batch_wait | done_c).all(dim=1)
        svc_bound = (svc_rows | bound).all(dim=1)
        has_pods = valid.any(dim=1)
        done_b = active & has_pods & all_arrived & batch_done & svc_bound
        completed |= done_b
        done_time = torch.where(done_b, t, done_time)
        done_is_cycle |= done_b
        active &= ~done_b
        # _permanently_stuck: static cluster, everything arrived, nothing
        # placed, something blocked, nothing running.
        stuck_now = (active & all_arrived & (placed == 0) & (blocked > 0)
                     & ~running_batch & pending_after)
        active &= ~stuck_now
        # Quiescent: all arrived, nothing pending, nothing running, not
        # done (zero-pod lanes) — the lane just samples to the horizon.
        quies = active & all_arrived & ~pending_after & ~running_batch
        active &= ~quies
        k += 1

    out = {
        "bound": bound, "done_committed": done_c,
        "bind_node": bind_node, "bind_seq": bind_seq,
        "bind_cycle": bind_cycle, "done_t": done_t,
        "completed": completed, "done_time": done_time,
        "done_is_cycle": done_is_cycle, "scale_outs": scale_outs,
        "used_cpu": used_cpu, "used_mem": used_mem, "pcount": pcount,
    }
    res = {key: v.cpu().numpy() for key, v in out.items()}
    res["n_cycles"] = np.asarray(k, np.int32)
    return res
