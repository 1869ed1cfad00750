"""TraceStore: a columnar (SoA) workload trace, as ``repro/scenarios/trace.py``.

A :class:`TraceStore` holds one arrival per *row* across NumPy columns
(arrival time, request sizes, duration, kind/moveable/checkpointable flags,
template id) plus a small **template table** of interned :class:`PodSpec`
objects.  Traces are generated (``repro_torch.scenarios.generators``),
loaded from external task logs (``repro_torch.scenarios.adapter``),
saved/loaded as compact JSON or NPZ, sliced, composed — and replayed
*directly* into the engine:

* **array engine** — ``Simulation``/``Timeline`` batch over the trace's
  ``arrival_time`` column and ``Orchestrator.submit_trace`` bulk-ingests
  each batch straight into the SoA ``engine.PodStore`` columns
  (``PodStore.ingest_trace``) with **zero per-arrival Python objects**;
* **object engine** — :meth:`TraceStore.to_arrivals` materializes the
  classic ``List[Arrival]`` once;
* **lane engine** — :meth:`TraceStore.to_lane_arrays` hands the columns to
  ``repro_torch.manyworld.lanes.stack_lanes``.

Replay is bit-compatible with the ``List[Arrival]`` path: the columns store
the identical floats the arrivals carry, and the template table preserves
spec *identity* (``trace.templates[tid] is arrival.spec``).

**Per-row durations.**  ``duration_s`` is a real column: heavy-tailed
scenario families draw a distinct duration per job while sharing one
template.  A ``Pod`` shell materialized for such a row carries a
``dataclasses.replace``-d spec with the row's true duration.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.pods import PodKind, PodSpec
from repro_torch.core.resources import Resources
from repro_torch.core.workload import Arrival

# Row kind codes (the ``kind`` column; one byte per row).
KIND_BATCH = 0
KIND_SERVICE = 1

_KIND_CODE = {PodKind.BATCH: KIND_BATCH, PodKind.SERVICE: KIND_SERVICE}


def _spec_to_dict(spec: PodSpec) -> Dict:
    return {
        "type_name": spec.type_name,
        "kind": spec.kind.value,
        "cpu_m": spec.requests.cpu_m,
        "mem_mb": spec.requests.mem_mb,
        "duration_s": spec.duration_s,
        "moveable": spec.moveable,
        "checkpointable": spec.checkpointable,
        "checkpoint_interval_s": spec.checkpoint_interval_s,
        "scheduler_name": spec.scheduler_name,
    }


def _spec_from_dict(d: Dict) -> PodSpec:
    return PodSpec(
        type_name=d["type_name"], kind=PodKind(d["kind"]),
        requests=Resources(int(d["cpu_m"]), float(d["mem_mb"])),
        duration_s=float(d["duration_s"]), moveable=bool(d["moveable"]),
        checkpointable=bool(d["checkpointable"]),
        checkpoint_interval_s=float(d["checkpoint_interval_s"]),
        scheduler_name=d.get("scheduler_name", "customScheduler"))


class TraceStore:
    """One workload trace as SoA columns + an interned template table.

    Rows are sorted by ``arrival_time`` (stable — equal-time rows keep
    their construction order, matching ``Simulation``'s stable sort of
    ``List[Arrival]`` input).  Columns:

    | column            | dtype   | contents                               |
    |-------------------|---------|----------------------------------------|
    | ``arrival_time``  | float64 | submission instant (nondecreasing)     |
    | ``template_id``   | int32   | row into :attr:`templates`             |
    | ``cpu_m``         | int64   | request, denormalized from template    |
    | ``mem_mb``        | float64 | request, denormalized from template    |
    | ``duration_s``    | float64 | per-row runtime (template's by default)|
    | ``kind``          | int8    | ``KIND_BATCH`` / ``KIND_SERVICE``      |
    | ``moveable``      | bool    | from template                          |
    | ``checkpointable``| bool    | from template                          |
    """

    def __init__(self, templates: Sequence[PodSpec],
                 template_id, arrival_time,
                 duration_s=None, name: str = "trace"):
        self.name = name
        self.templates: List[PodSpec] = list(templates)
        tid = np.asarray(template_id, np.int32)
        times = np.asarray(arrival_time, np.float64)
        if tid.shape != times.shape or tid.ndim != 1:
            raise ValueError("template_id and arrival_time must be equal-"
                             f"length 1-D, got {tid.shape} vs {times.shape}")
        if len(self.templates) == 0 and tid.size:
            raise ValueError("non-empty trace with an empty template table")
        if tid.size and (tid.min() < 0 or tid.max() >= len(self.templates)):
            raise ValueError("template_id out of range")
        # Template-derived per-row columns (vectorized fancy indexing).
        t_cpu = np.asarray([s.requests.cpu_m for s in self.templates],
                           np.int64)
        t_mem = np.asarray([s.requests.mem_mb for s in self.templates],
                           np.float64)
        t_dur = np.asarray([s.duration_s for s in self.templates], np.float64)
        t_kind = np.asarray([_KIND_CODE[s.kind] for s in self.templates],
                            np.int8)
        t_move = np.asarray([s.moveable for s in self.templates], bool)
        t_ckpt = np.asarray([s.checkpointable for s in self.templates], bool)
        if duration_s is None:
            dur = t_dur[tid] if tid.size else np.zeros(0, np.float64)
        else:
            dur = np.asarray(duration_s, np.float64)
            if dur.shape != times.shape:
                raise ValueError("duration_s must match arrival_time length")
        if times.size and np.any(np.diff(times) < 0):
            order = np.argsort(times, kind="stable")
            times, tid, dur = times[order], tid[order], dur[order]
        self.arrival_time = times
        self.template_id = tid
        self.duration_s = dur
        if tid.size:
            self.cpu_m = t_cpu[tid]
            self.mem_mb = t_mem[tid]
            self.kind = t_kind[tid]
            self.moveable = t_move[tid]
            self.checkpointable = t_ckpt[tid]
        else:
            self.cpu_m = np.zeros(0, np.int64)
            self.mem_mb = np.zeros(0, np.float64)
            self.kind = np.zeros(0, np.int8)
            self.moveable = np.zeros(0, bool)
            self.checkpointable = np.zeros(0, bool)

    # -- basic views -----------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.arrival_time.size)

    def __len__(self) -> int:
        return self.n

    def __repr__(self):
        span = (f", t=[{self.arrival_time[0]:.0f}, "
                f"{self.arrival_time[-1]:.0f}]s" if self.n else "")
        return (f"TraceStore({self.name!r}, n={self.n}, "
                f"templates={len(self.templates)}{span})")

    def count_kinds(self, lo: int = 0, hi: Optional[int] = None):
        """``(n_batch, n_service)`` over rows ``[lo, hi)`` — one vector pass
        (the per-batch counter update of ``Orchestrator.submit_trace``)."""
        k = self.kind[lo:hi if hi is not None else self.n]
        return int((k == KIND_BATCH).sum()), int((k == KIND_SERVICE).sum())

    # -- interop with the List[Arrival] path -----------------------------------
    @classmethod
    def from_arrivals(cls, arrivals: Sequence[Arrival],
                      name: str = "trace") -> "TraceStore":
        """Columnarize a classic arrival list.

        Spec *identity* is preserved — each distinct ``PodSpec`` object
        becomes one template row, so replay hands the engine the identical
        spec objects the arrival path would have (bit-compatibility)."""
        templates: List[PodSpec] = []
        tmap: Dict[int, int] = {}
        tid = np.empty(len(arrivals), np.int32)
        times = np.empty(len(arrivals), np.float64)
        for i, a in enumerate(arrivals):
            j = tmap.get(id(a.spec))
            if j is None:
                j = len(templates)
                templates.append(a.spec)
                tmap[id(a.spec)] = j
            tid[i] = j
            times[i] = a.time
        return cls(templates, tid, times, name=name)

    def to_arrivals(self) -> List[Arrival]:
        """Materialize the classic ``List[Arrival]`` (object-engine replay,
        tests).  Rows whose duration column overrides the template's get a
        per-row ``dataclasses.replace``-d spec carrying the true duration —
        the same spec the engine's shell materialization would build."""
        t_dur = [s.duration_s for s in self.templates]
        out: List[Arrival] = []
        templates = self.templates
        for t, tid, d in zip(self.arrival_time.tolist(),
                             self.template_id.tolist(),
                             self.duration_s.tolist()):
            spec = templates[tid]
            if d != t_dur[tid]:
                spec = dataclasses.replace(spec, duration_s=d)
            out.append(Arrival(t, spec))
        return out

    def arrivals_slice(self, lo: int, hi: int) -> List[Arrival]:
        """``to_arrivals`` over rows ``[lo, hi)`` (object-engine fallback of
        ``Orchestrator.submit_trace``)."""
        return self.slice(lo, hi).to_arrivals()

    def to_lane_arrays(self) -> Dict:
        """Per-lane workload columns for the many-world engine
        (`repro_torch.manyworld.lanes.stack_lanes`): float64 request/duration
        columns plus the batch-kind mask, in trace row order.  The caller
        adds the cluster scalars (``n_nodes`` / ``alloc_*`` / weights);
        ``stack_lanes`` pads the pod axis across lanes.  Integer CPU
        milli-units are exact in float64 (far below 2^53), so the lane
        program's comparisons and divisions match the serial engine
        bit-for-bit."""
        return {
            "arrival_t": self.arrival_time.astype(np.float64),
            "cpu_m": self.cpu_m.astype(np.float64),
            "mem_mb": self.mem_mb.astype(np.float64),
            "duration_s": self.duration_s.astype(np.float64),
            "is_batch": self.kind == KIND_BATCH,
        }

    # -- slicing / composition -------------------------------------------------
    def slice(self, lo: int, hi: Optional[int] = None) -> "TraceStore":
        """Row-range copy keeping the full template table (columns are
        copied, not views — mutating the parent never corrupts a slice)."""
        hi = self.n if hi is None else hi
        return TraceStore(self.templates, self.template_id[lo:hi].copy(),
                          self.arrival_time[lo:hi].copy(),
                          self.duration_s[lo:hi].copy(), name=self.name)

    def time_window(self, t0: float, t1: float) -> "TraceStore":
        """Rows with ``t0 <= arrival_time < t1``."""
        lo = int(np.searchsorted(self.arrival_time, t0, side="left"))
        hi = int(np.searchsorted(self.arrival_time, t1, side="left"))
        return self.slice(lo, hi)

    @classmethod
    def merge(cls, traces: Sequence["TraceStore"],
              name: str = "merged") -> "TraceStore":
        """Multi-tenant composition: interleave independent streams into one
        time-sorted trace (stable — equal-time rows keep stream order).
        Templates are deduplicated by object identity."""
        templates: List[PodSpec] = []
        tmap: Dict[int, int] = {}
        tids, times, durs = [], [], []
        for tr in traces:
            remap = np.empty(max(len(tr.templates), 1), np.int32)
            for i, s in enumerate(tr.templates):
                j = tmap.get(id(s))
                if j is None:
                    j = len(templates)
                    templates.append(s)
                    tmap[id(s)] = j
                remap[i] = j
            tids.append(remap[tr.template_id])
            times.append(tr.arrival_time)
            durs.append(tr.duration_s)
        if not times:
            return cls([], [], [], name=name)
        return cls(templates, np.concatenate(tids), np.concatenate(times),
                   np.concatenate(durs), name=name)

    # -- persistence -----------------------------------------------------------
    def save(self, path: str) -> None:
        """Write the trace to ``path`` — compact JSON (``.json``, exact
        float round-trip via repr) or compressed NPZ (``.npz``, exact
        binary) by suffix."""
        if str(path).endswith(".npz"):
            np.savez_compressed(
                path,
                template_id=self.template_id,
                arrival_time=self.arrival_time,
                duration_s=self.duration_s,
                meta=np.asarray(json.dumps({
                    "name": self.name,
                    "templates": [_spec_to_dict(s) for s in self.templates],
                })))
            return
        with open(path, "w") as f:
            json.dump({
                "name": self.name,
                "templates": [_spec_to_dict(s) for s in self.templates],
                "template_id": self.template_id.tolist(),
                "arrival_time": self.arrival_time.tolist(),
                "duration_s": self.duration_s.tolist(),
            }, f)

    @classmethod
    def load(cls, path: str) -> "TraceStore":
        if str(path).endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"]))
                return cls([_spec_from_dict(d) for d in meta["templates"]],
                           z["template_id"], z["arrival_time"],
                           z["duration_s"], name=meta.get("name", "trace"))
        with open(path) as f:
            d = json.load(f)
        return cls([_spec_from_dict(t) for t in d["templates"]],
                   d["template_id"], d["arrival_time"], d["duration_s"],
                   name=d.get("name", "trace"))
