"""TraceStore: a columnar (SoA) workload trace.

A lean copy of ``repro/scenarios/trace.py``: one arrival per row across
NumPy columns, built from a template table and per-row template ids,
arrival times and (optionally) durations.  It keeps what the lane engine
needs — the columns, ``n``, ``slice``, ``merge`` and ``to_lane_arrays`` —
and none of the serial engine's replay or persistence helpers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.workload import BATCH, SERVICE, JobType

# Row kind codes (the ``kind`` column; one byte per row).
KIND_BATCH = 0
KIND_SERVICE = 1

_KIND_CODE = {BATCH: KIND_BATCH, SERVICE: KIND_SERVICE}


class TraceStore:
    """One workload trace as SoA columns + a template table.

    Rows are sorted by ``arrival_time`` (stable).  Columns:
    ``arrival_time`` float64, ``template_id`` int32, ``cpu_m`` int64,
    ``mem_mb`` float64, ``duration_s`` float64, ``kind`` int8.
    """

    def __init__(self, templates: Sequence[JobType], template_id,
                 arrival_time, duration_s=None, name: str = "trace"):
        self.name = name
        self.templates: List[JobType] = list(templates)
        tid = np.asarray(template_id, np.int32)
        times = np.asarray(arrival_time, np.float64)
        if tid.shape != times.shape or tid.ndim != 1:
            raise ValueError("template_id and arrival_time must be equal-"
                             f"length 1-D, got {tid.shape} vs {times.shape}")
        if len(self.templates) == 0 and tid.size:
            raise ValueError("non-empty trace with an empty template table")
        if tid.size and (tid.min() < 0 or tid.max() >= len(self.templates)):
            raise ValueError("template_id out of range")
        t_cpu = np.asarray([s.requests.cpu_m for s in self.templates],
                           np.int64)
        t_mem = np.asarray([s.requests.mem_mb for s in self.templates],
                           np.float64)
        t_dur = np.asarray([s.duration_s for s in self.templates], np.float64)
        t_kind = np.asarray([_KIND_CODE[s.kind] for s in self.templates],
                            np.int8)
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
        else:
            self.cpu_m = np.zeros(0, np.int64)
            self.mem_mb = np.zeros(0, np.float64)
            self.kind = np.zeros(0, np.int8)

    @property
    def n(self) -> int:
        return int(self.arrival_time.size)

    def to_lane_arrays(self) -> Dict:
        """Per-lane workload columns for ``manyworld.lanes.stack_lanes``:
        float64 request/duration columns plus the batch-kind mask, in row
        order.  Integer CPU milli-units are exact in float64."""
        return {
            "arrival_t": self.arrival_time.astype(np.float64),
            "cpu_m": self.cpu_m.astype(np.float64),
            "mem_mb": self.mem_mb.astype(np.float64),
            "duration_s": self.duration_s.astype(np.float64),
            "is_batch": self.kind == KIND_BATCH,
        }

    def slice(self, lo: int, hi: Optional[int] = None) -> "TraceStore":
        """Row-range copy keeping the full template table."""
        hi = self.n if hi is None else hi
        return TraceStore(self.templates, self.template_id[lo:hi].copy(),
                          self.arrival_time[lo:hi].copy(),
                          self.duration_s[lo:hi].copy(), name=self.name)

    @classmethod
    def merge(cls, traces: Sequence["TraceStore"],
              name: str = "merged") -> "TraceStore":
        """Interleave independent streams into one time-sorted trace
        (stable: equal-time rows keep stream order).  Templates are
        deduplicated by object identity."""
        templates: List[JobType] = []
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
