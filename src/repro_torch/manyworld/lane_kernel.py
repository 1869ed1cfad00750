"""The lane program as one CUDA kernel: ``csrc/lane_program.cu``.

:func:`lane_program` runs a whole :class:`~repro_torch.manyworld.lanes.LaneBatch`
in one launch: one warp per lane runs that lane's entire cycle loop on the
card (completions, the FIFO wave with the masked argmin inlined, the done /
stuck / quiescent checks), with no host sync.  Its outputs are
bit-identical to the lockstep program
(:func:`repro_torch.manyworld.lanes.run_lane_batch_lockstep`), its plain
PyTorch version, and to the JAX program.

:func:`lane_program_plain` is the kernel's own algorithm in NumPy, one lane
at a time: the same per-lane counters (latest arrival, uncommitted batch
rows, unbound service rows, running batch pods), the same row pointer and
early stop of the wave, the same swap-removed list of running pods and the
same ``n_cycles`` rule.  The CPU tests hold it to the lockstep and JAX
programs; on the card its ``lane_stats`` must equal the kernel's.

``launches`` counts kernel launches, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from repro_torch import _build
from repro_torch.manyworld.lanes import (BATCH_FIELDS, CYCLE_PERIOD_S,
                                         HORIZON_S, MAX_CYCLES, SCHEDULERS,
                                         LaneBatch)

launches = 0

# Node columns of one lane live in shared memory: 20 B a node, so 8192
# nodes (n_pad is a power of two) take 160 KB of a block's 227 KB.
MAX_NODES = 8192

# The kernel's outputs in the lockstep program's key order, with their
# shapes ("P" per pod, "L" per lane, "N" per node) and dtypes.
OUTPUTS = (("bound", "P", torch.bool), ("done_committed", "P", torch.bool),
           ("bind_node", "P", torch.int32), ("bind_seq", "P", torch.int32),
           ("bind_cycle", "P", torch.int32), ("done_t", "P", torch.float64),
           ("completed", "L", torch.bool), ("done_time", "L", torch.float64),
           ("done_is_cycle", "L", torch.bool),
           ("scale_outs", "L", torch.int32),
           ("used_cpu", "N", torch.float64), ("used_mem", "N", torch.float64),
           ("pcount", "N", torch.int32))
# Per lane: cycles run, completions committed, wave attempts (the lane's
# chain of dependent steps).
STATS = ("cycles", "completions", "attempts")

_INPUT_DTYPES = {"arrival_t": torch.float64, "cpu_m": torch.float64,
                 "mem_mb": torch.float64, "duration_s": torch.float64,
                 "is_batch": torch.bool, "valid": torch.bool,
                 "n_nodes": torch.int32, "alloc_cpu": torch.float64,
                 "alloc_mem": torch.float64, "weights": torch.float64}


def _check(batch: LaneBatch) -> None:
    """What the kernel takes; raises before any build or launch."""
    if batch.scheduler not in SCHEDULERS:
        raise ValueError(f"lane_program: unsupported scheduler "
                         f"{batch.scheduler!r}")
    L, P = batch.arrival_t.shape
    shapes = {"n_nodes": (L,), "alloc_cpu": (L,), "alloc_mem": (L,),
              "weights": (L, 3)}
    for name in BATCH_FIELDS:
        t = getattr(batch, name)
        if t.dtype != _INPUT_DTYPES[name]:
            raise TypeError(f"lane_program: {name} must be "
                            f"{_INPUT_DTYPES[name]}, got {t.dtype}")
        if tuple(t.shape) != shapes.get(name, (L, P)):
            raise ValueError(f"lane_program: {name} has shape "
                             f"{tuple(t.shape)}, expected "
                             f"{shapes.get(name, (L, P))}")
    if not 1 <= batch.n_pad <= MAX_NODES:
        raise ValueError(f"lane_program: n_pad={batch.n_pad} is past the "
                         f"kernel's limit of {MAX_NODES} nodes (a lane's node "
                         "columns must fit in one block's shared memory)")
    if P >= 2**31:
        raise ValueError(f"lane_program: {P} pod rows do not fit int32")
    dev = batch.arrival_t.device
    for name in BATCH_FIELDS:
        t = getattr(batch, name)
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("lane_program: every batch tensor must lie on "
                             f"one CUDA device; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"lane_program: {name} must be contiguous")


def _kernel():
    fn = _build.load("lane_program").lane_program_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _empty_outputs(L: int, P: int, n_pad: int, device) -> Dict[str,
                                                                torch.Tensor]:
    dims = {"P": (L, P), "L": (L,), "N": (L, n_pad)}
    out = {key: torch.empty(dims[kind], dtype=dtype, device=device)
           for key, kind, dtype in OUTPUTS}
    out["lane_stats"] = torch.empty((L, len(STATS)), dtype=torch.int64,
                                    device=device)
    return out


def lane_program(batch: LaneBatch) -> Dict[str, torch.Tensor]:
    """Run ``batch`` (every tensor on one CUDA device) in one kernel launch.

    Returns the lane outputs as tensors on the card, under the lockstep
    program's keys, plus ``lane_stats`` ``(L, 3)`` int64 (:data:`STATS`);
    nothing is synchronised.  :func:`lane_outputs` turns them into the
    numpy outputs of ``run_lane_batch``.  A zero-lane batch returns empty
    outputs without launching.
    """
    global launches
    _check(batch)
    L, P = batch.arrival_t.shape
    dev = batch.arrival_t.device
    out = _empty_outputs(L, P, batch.n_pad, dev)
    if L == 0:
        return out
    running = torch.empty((L, P), dtype=torch.int32, device=dev)
    tensors = ([getattr(batch, name) for name in BATCH_FIELDS]
               + [out[key] for key, _, _ in OUTPUTS]
               + [out["lane_stats"], running])
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    launch = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(ptrs, L, P, batch.n_pad,
                    SCHEDULERS.index(batch.scheduler), MAX_CYCLES,
                    CYCLE_PERIOD_S, HORIZON_S, stream)
    if rc != 0:
        raise RuntimeError(f"lane_program: kernel launch failed with "
                           f"cudaError {rc}")
    launches += 1
    return out


def lane_outputs(res: Dict[str, torch.Tensor]) -> dict:
    """The numpy outputs of ``run_lane_batch`` from :func:`lane_program` or
    :func:`lane_program_plain` results: ``n_cycles`` is the lockstep loop's
    count, the most cycles any lane ran (0 when no lane ran one)."""
    out = {key: res[key].cpu().numpy() for key, _, _ in OUTPUTS}
    cycles = res["lane_stats"].cpu().numpy()[:, 0]
    out["n_cycles"] = np.asarray(cycles.max() if cycles.size else 0, np.int32)
    return out


# ---------------------------------------------------------------------------
# The kernel's algorithm in plain NumPy, for the tests.

_WARP = 32


def _scores(sched, fc, fm, pc, pm, den_cpu, den_mem, w):
    """``lanes._wave_scores`` for one pod over the lane's nodes (negated
    for max-mode), in the same operation order."""
    if sched == "best-fit":
        return fm
    if sched == "worst-fit":
        return -fm
    if sched == "first-fit":
        return np.zeros_like(fm)
    cpu_frac = (fc - pc) / den_cpu
    mem_frac = (fm - pm) / den_mem
    lr = 10.0 * (cpu_frac + mem_frac) / 2.0
    bal = 10.0 * (1.0 - np.abs(cpu_frac - mem_frac))
    if sched == "k8s-default":
        return -((lr + bal) / 2.0)
    pack = 10.0 * (1.0 - mem_frac)
    return -((w[0] * pack + w[1] * lr) + w[2] * bal)


def _plain_lane(sched, n_pad, c, o, li):
    """One lane of :func:`lane_program_plain`: ``c`` holds the batch's
    numpy columns, ``o`` the output arrays, written in place at row
    ``li``; the steps are the kernel's, one warp's work at a time."""
    arr, cpu, mem, dur = (c["arrival_t"][li], c["cpu_m"][li],
                          c["mem_mb"][li], c["duration_s"][li])
    isb, valid = c["is_batch"][li], c["valid"][li]
    bound, done_c = o["bound"][li], o["done_committed"][li]
    bind_node, bind_seq = o["bind_node"][li], o["bind_seq"][li]
    bind_cycle, done_t = o["bind_cycle"][li], o["done_t"][li]
    ucpu, umem, pcnt = o["used_cpu"][li], o["used_mem"][li], o["pcount"][li]
    P = arr.shape[0]
    ac, am = float(c["alloc_cpu"][li]), float(c["alloc_mem"][li])
    den_cpu = 1.0 if ac < 1.0 else ac
    den_mem = 1e-9 if am < 1e-9 else am
    w = c["weights"][li]
    nn = min(int(c["n_nodes"][li]), n_pad)

    vrows = np.nonzero(valid)[0]
    n_valid = vrows.size
    n_batch = int((valid & isb).sum())
    va = arr[valid]
    max_arr = (float("nan") if np.isnan(va).any() else float(va.max())
               ) if n_valid else -np.inf
    hi = int(vrows[-1]) + 1 if n_valid else 0
    head = arr[:n_valid]
    in_order = bool(valid[:n_valid].all()
                    and np.all(head[:-1] <= head[1:]))

    n_unc, n_svc, n_run = n_batch, n_valid - n_batch, 0
    running = np.zeros(P, np.int32)
    seq = scale_outs = 0
    active, completed, is_cycle = n_valid > 0, False, False
    done_time = HORIZON_S
    lo = commits = attempts = k = cycles = 0
    while active and k <= MAX_CYCLES:
        cycles = k + 1
        tt = k * CYCLE_PERIOD_S
        # -- completions, least (done_t, bind_seq) first.
        while n_run > 0:
            lst = running[:n_run]
            i = int(np.lexsort((bind_seq[lst], done_t[lst]))[0])
            p = int(lst[i])
            td = float(done_t[p])
            if not td <= tt:
                break
            node = bind_node[p]
            ucpu[node] += -cpu[p]
            umem[node] += -mem[p]
            pcnt[node] -= 1
            done_c[p] = True
            running[i] = running[n_run - 1]
            n_run -= 1
            n_unc -= 1
            commits += 1
            if max_arr <= td and n_unc == 0 and n_svc == 0:
                completed, done_time, active = True, td, False
                break
        if not active:
            break
        # -- the wave, 32 rows at a time from lo.
        placed = blocked = 0
        base = lo & ~(_WARP - 1)
        while base < hi:
            j = np.arange(base, min(base + _WARP, P))
            rows = (j >= lo) & (j < hi) & valid[j]
            arrived = arr[j] <= tt
            cand = j[rows & arrived & ~bound[j]]
            stop = in_order and bool((rows & ~arrived).any())
            for p in cand.tolist():
                attempts += 1
                pc, pm = cpu[p], mem[p]
                fc = ac - ucpu[:nn]
                fm = am - umem[:nn]
                ok = (fc >= pc) & ((fm + 1e-9) >= pm)
                if ok.any():
                    v = np.where(ok, _scores(sched, fc, fm, pc, pm, den_cpu,
                                             den_mem, w), np.inf)
                    r = int(np.argmin(v))
                    ucpu[r] += pc
                    umem[r] += pm
                    pcnt[r] += 1
                    bound[p] = True
                    bind_node[p] = r
                    bind_seq[p] = seq
                    bind_cycle[p] = k
                    if isb[p]:
                        done_t[p] = tt + dur[p]
                        running[n_run] = p
                        n_run += 1
                    else:
                        n_svc -= 1
                    seq += 1
                    placed += 1
                else:
                    blocked += 1
            if stop:
                break
            base += _WARP
        scale_outs += blocked
        # -- done, stuck, quiescent.
        all_arrived = max_arr <= tt
        if all_arrived and n_unc == 0 and n_svc == 0:
            completed, done_time, is_cycle, active = True, tt, True, False
        elif (all_arrived and placed == 0 and blocked > 0 and n_run == 0):
            active = False
        elif all_arrived and blocked == 0 and n_run == 0:
            active = False
        while lo < hi:
            base = lo & ~(_WARP - 1)
            j = np.arange(base, min(base + _WARP, P))
            open_rows = j[(j >= lo) & (j < hi) & valid[j] & ~bound[j]]
            if open_rows.size:
                lo = int(open_rows[0])
                break
            lo = base + _WARP
        k += 1
    o["completed"][li] = completed
    o["done_time"][li] = done_time
    o["done_is_cycle"][li] = is_cycle
    o["scale_outs"][li] = scale_outs
    o["lane_stats"][li] = (cycles, commits, attempts)


def lane_program_plain(batch: LaneBatch) -> Dict[str, torch.Tensor]:
    """:func:`lane_program`'s algorithm in NumPy, one lane at a time, on
    the CPU; the same keys, as CPU tensors."""
    if batch.scheduler not in SCHEDULERS:
        raise ValueError(f"lane_program_plain: unsupported scheduler "
                         f"{batch.scheduler!r}")
    c = {name: getattr(batch, name).cpu().numpy() for name in BATCH_FIELDS}
    L, P = c["arrival_t"].shape
    o = {key: t.numpy() for key, t in
         _empty_outputs(L, P, batch.n_pad, "cpu").items()}
    fills = {"bound": False, "done_committed": False, "bind_node": -1,
             "bind_seq": -1, "bind_cycle": -1, "done_t": np.inf,
             "used_cpu": 0.0, "used_mem": 0.0, "pcount": 0}
    for key, val in fills.items():
        o[key][...] = val
    for li in range(L):
        _plain_lane(batch.scheduler, batch.n_pad, c, o, li)
    return {key: torch.from_numpy(v) for key, v in o.items()}

