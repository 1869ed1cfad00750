"""Cycle-phase profiler.

``perf_counter`` spans around the hot-path phases of one simulated run —
timeline drain, arrival ingest, wave selection (scoring + select kernel),
bind commit, reschedule (including the shadow-capacity plan), autoscaler
step, scale-in, completion scheduling/commit, metrics sampling — each
aggregated into a per-phase histogram (count / total / min / max + log2
duration buckets) plus a bounded span ring for timeline inspection.

``chrome_trace`` renders the span ring as Chrome-trace/Perfetto JSON
(``chrome://tracing`` / https://ui.perfetto.dev): one complete-event
(``"ph": "X"``) per span, timestamps in microseconds relative to the first
recorded span, with the simulated time attached as an arg so wall-clock
hotspots can be correlated with simulation phases.

The profiler never touches simulation state — it reads the monotonic
clock and writes its own arrays — so profiling cannot perturb results.
"""
from __future__ import annotations

from time import perf_counter
from typing import Dict, List, Optional

import numpy as np

#: log2 duration buckets: bucket ``b`` holds spans with duration in
#: ``[2**(b-1), 2**b)`` microseconds (bucket 0: < 1 µs; bucket 31: the
#: catch-all for anything ≥ ~17.9 min).
N_BUCKETS = 32


class PhaseProfiler:
    """Named-phase span aggregation + a bounded raw-span ring.

    Usage at an instrumented site::

        t0 = prof.start()
        ... the phase body ...
        prof.stop("wave_select", t0, sim_now)

    ``stop`` is O(1): a dict lookup, four scalar updates, one histogram
    increment, and a ring write.  Phases are interned on first use.
    """

    __slots__ = ("max_spans", "n_spans_seen", "_agg", "_names",
                 "sp_name", "sp_t0", "sp_dur", "sp_sim")

    def __init__(self, max_spans: int = 1 << 16):
        self.max_spans = max_spans
        self.n_spans_seen = 0
        # name -> [count, total_s, min_s, max_s, hist(np.int64[32]), idx]
        self._agg: Dict[str, list] = {}
        self._names: List[str] = []
        self.sp_name = np.zeros(max_spans, np.int16)
        self.sp_t0 = np.zeros(max_spans, np.float64)
        self.sp_dur = np.zeros(max_spans, np.float64)
        self.sp_sim = np.zeros(max_spans, np.float64)

    @staticmethod
    def start() -> float:
        return perf_counter()

    def stop(self, name: str, t0: float, sim_now: float = 0.0) -> None:
        dur = perf_counter() - t0
        agg = self._agg.get(name)
        if agg is None:
            agg = self._agg[name] = [0, 0.0, np.inf, 0.0,
                                     np.zeros(N_BUCKETS, np.int64),
                                     len(self._names)]
            self._names.append(name)
        agg[0] += 1
        agg[1] += dur
        if dur < agg[2]:
            agg[2] = dur
        if dur > agg[3]:
            agg[3] = dur
        b = int(dur * 1e6).bit_length()
        agg[4][b if b < N_BUCKETS else N_BUCKETS - 1] += 1
        i = self.n_spans_seen % self.max_spans
        self.n_spans_seen += 1
        self.sp_name[i] = agg[5]
        self.sp_t0[i] = t0
        self.sp_dur[i] = dur
        self.sp_sim[i] = sim_now

    # -- reading -------------------------------------------------------------
    def phases(self) -> Dict[str, dict]:
        """Aggregates per phase, in first-use order."""
        return {name: {"count": agg[0], "total_s": agg[1],
                       "min_s": (0.0 if agg[0] == 0 else agg[2]),
                       "max_s": agg[3], "hist": agg[4].copy()}
                for name, agg in self._agg.items()}

    def _spans_unrolled(self):
        n = min(self.n_spans_seen, self.max_spans)
        if self.n_spans_seen <= self.max_spans:
            sl = slice(0, n)
            return (self.sp_name[sl].copy(), self.sp_t0[sl].copy(),
                    self.sp_dur[sl].copy(), self.sp_sim[sl].copy())
        head = self.n_spans_seen % self.max_spans
        order = np.r_[head:self.max_spans, 0:head]
        return (self.sp_name[order], self.sp_t0[order],
                self.sp_dur[order], self.sp_sim[order])

    def to_payload(self) -> Dict:
        names = list(self._names)
        count = np.asarray([self._agg[n][0] for n in names], np.int64)
        total = np.asarray([self._agg[n][1] for n in names], np.float64)
        mn = np.asarray([0.0 if self._agg[n][0] == 0 else self._agg[n][2]
                         for n in names], np.float64)
        mx = np.asarray([self._agg[n][3] for n in names], np.float64)
        hist = (np.stack([self._agg[n][4] for n in names])
                if names else np.zeros((0, N_BUCKETS), np.int64))
        sp_name, sp_t0, sp_dur, sp_sim = self._spans_unrolled()
        return {"names": names, "n_spans_seen": self.n_spans_seen,
                "count": count, "total_s": total, "min_s": mn, "max_s": mx,
                "hist": hist,
                "spans": {"name": sp_name, "t0": sp_t0, "dur_s": sp_dur,
                          "sim_s": sp_sim}}


def chrome_trace(profile: Dict, pid: int = 0, tid: int = 0) -> List[dict]:
    """Chrome-trace/Perfetto JSON event list from a profiler payload
    (live ``PhaseProfiler.to_payload()`` or the ``"profile"`` entry of a
    loaded obs bundle)."""
    names = profile["names"]
    spans = profile["spans"]
    sp_name = np.asarray(spans["name"])
    sp_t0 = np.asarray(spans["t0"], np.float64)
    sp_dur = np.asarray(spans["dur_s"], np.float64)
    sp_sim = np.asarray(spans["sim_s"], np.float64)
    if sp_t0.size == 0:
        return []
    epoch = float(sp_t0.min())
    return [{"name": names[int(sp_name[i])], "ph": "X", "pid": pid,
             "tid": tid, "ts": (float(sp_t0[i]) - epoch) * 1e6,
             "dur": float(sp_dur[i]) * 1e6,
             "args": {"sim_s": float(sp_sim[i])}}
            for i in range(sp_t0.size)]
