"""Flight recorder: a columnar, ring-buffered event log with decision
attribution.

``EventLog`` stores typed records — binds, evictions, scale-outs/ins,
preemption notices, rescheduler outcomes, forecaster predictions — as SoA
columns in the ``PodStore`` style: preallocated numpy arrays indexed by a
monotone event counter modulo a fixed capacity, so memory stays bounded on
arbitrarily long runs and the *latest* ``capacity`` events are always
available in chronological order.  Each record carries the inputs that
drove the decision (pending queue depth, mean RAM utilization, forecast
rate/confidence, headroom, rate-limiter state), so any decision in any run
can be replayed and explained without re-running the simulation.

``ObsRecorder`` is the hub threaded through the stack by
``repro_torch.core.experiment.build_simulation`` when ``ExperimentSpec.obs`` is
set: it owns the event log and the cycle-phase profiler
(``repro_torch.obs.profiler``), holds back-references for passive attribution
reads, and knows how to persist the whole run as a single NPZ/JSON bundle.

Bit-identity contract: recording is strictly passive.  Every helper only
*reads* simulation state — and the only mid-run aggregate it touches,
``Cluster.utilization_totals()``, is documented flush-order independent
(exact fsum reduction) — so an ``ExperimentResult`` produced with the
recorder attached is bit-identical to one produced without it
(``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

SCHEMA_VERSION = 1

# -- event kinds -------------------------------------------------------------
(EV_BIND, EV_EVICT, EV_SCALE_OUT, EV_SCALE_IN, EV_NOTICE, EV_RESCHED,
 EV_FORECAST) = range(7)
KIND_NAMES = ("bind", "evict", "scale_out", "scale_in", "preempt_notice",
              "resched", "forecast")

# -- eviction reasons (EVICT detail ``v2``) ----------------------------------
(R_UNSPEC, R_RESCHED, R_CONSOLIDATE, R_NODE_FAIL, R_STRAGGLER,
 R_CRASH) = range(6)
REASON_NAMES = ("unspecified", "reschedule", "scale_in_consolidation",
                "node_fail", "straggler", "crash_loop")

# -- scale-out dispositions (SCALE_OUT detail ``v1``) ------------------------
(SO_LIMITED, SO_LAUNCH, SO_ABSORBED, SO_ASSOCIATED, SO_PRELAUNCH) = range(5)
SCALE_OUT_NAMES = ("rate_limited", "launched", "absorbed_by_booting",
                   "already_associated", "predictive_prelaunch")

# -- rescheduler outcomes (RESCHED detail ``v1``) ----------------------------
(RS_WAIT, RS_RESCHEDULED, RS_FAILED) = range(3)
RESCHED_NAMES = ("wait", "rescheduled", "failed")

#: Float attribution columns, in storage order.  ``v1``/``v2`` are
#: kind-specific details (see docs/ARCHITECTURE.md "Observability" for the
#: full schema table); the rest are the decision inputs.
FCOLS = ("pending", "util", "rate", "conf", "headroom", "v1", "v2")

_NAN = float("nan")


class EventLog:
    """Columnar ring buffer of typed, attributed events.

    Writes go to slot ``n_seen % capacity`` — O(1), bounded memory; once
    the log wraps, the oldest events are overwritten and ``n_seen`` keeps
    counting so consumers can tell how many were dropped.  ``columns()``
    unrolls the ring into chronological per-column arrays.

    Node ids (strings like ``node-17``) are interned into ``node_table``
    so the ``node`` column stays a compact int32 index.
    """

    __slots__ = ("capacity", "n_seen", "t", "kind", "cycle", "uid", "node",
                 "f", "node_table", "_node_idx")

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.n_seen = 0
        self.t = np.zeros(capacity, np.float64)
        self.kind = np.zeros(capacity, np.int16)
        self.cycle = np.full(capacity, -1, np.int32)
        self.uid = np.full(capacity, -1, np.int64)
        self.node = np.full(capacity, -1, np.int32)
        self.f = np.full((capacity, len(FCOLS)), _NAN, np.float64)
        self.node_table: List[str] = []
        self._node_idx: Dict[str, int] = {}

    # -- recording -----------------------------------------------------------
    def intern_node(self, node_id: Optional[str]) -> int:
        if node_id is None:
            return -1
        idx = self._node_idx.get(node_id)
        if idx is None:
            idx = self._node_idx[node_id] = len(self.node_table)
            self.node_table.append(node_id)
        return idx

    def record(self, t: float, kind: int, *, cycle: int = -1, uid: int = -1,
               node: Optional[str] = None, pending: float = _NAN,
               util: float = _NAN, rate: float = _NAN, conf: float = _NAN,
               headroom: float = _NAN, v1: float = _NAN,
               v2: float = _NAN) -> None:
        i = self.n_seen % self.capacity
        self.n_seen += 1
        self.t[i] = t
        self.kind[i] = kind
        self.cycle[i] = cycle
        self.uid[i] = uid
        self.node[i] = self.intern_node(node)
        self.f[i] = (pending, util, rate, conf, headroom, v1, v2)

    # -- reading -------------------------------------------------------------
    def __len__(self) -> int:
        """Events currently held (≤ capacity; ``n_seen`` counts all ever)."""
        return min(self.n_seen, self.capacity)

    def _unroll(self, arr: np.ndarray) -> np.ndarray:
        n = len(self)
        if self.n_seen <= self.capacity:
            return arr[:n].copy()
        head = self.n_seen % self.capacity
        return np.concatenate([arr[head:], arr[:head]])

    def columns(self) -> Dict[str, np.ndarray]:
        """Chronological per-column view of the retained events."""
        out = {"t": self._unroll(self.t), "kind": self._unroll(self.kind),
               "cycle": self._unroll(self.cycle),
               "uid": self._unroll(self.uid),
               "node": self._unroll(self.node)}
        f = self._unroll(self.f)
        for j, name in enumerate(FCOLS):
            out[name] = f[:, j]
        return out

    def same_as(self, other: "EventLog") -> bool:
        """Bit-exact logical equality: same retained events (values and NaN
        pattern), same total count, same node intern table."""
        if (self.n_seen != other.n_seen or self.capacity != other.capacity
                or self.node_table != other.node_table):
            return False
        a, b = self.columns(), other.columns()
        for name in a:
            x, y = a[name], b[name]
            if np.issubdtype(x.dtype, np.floating):
                if not np.array_equal(x, y, equal_nan=True):
                    return False
            elif not np.array_equal(x, y):
                return False
        return True

    # -- persistence (TraceStore idiom: NPZ or exact-round-trip JSON) --------
    def to_payload(self) -> Dict:
        cols = self.columns()
        return {"schema": SCHEMA_VERSION, "n_seen": self.n_seen,
                "capacity": self.capacity, "node_table": list(self.node_table),
                "columns": cols}

    @classmethod
    def from_payload(cls, payload: Dict) -> "EventLog":
        cols = payload["columns"]
        n = len(cols["t"])
        log = cls(capacity=int(payload["capacity"]))
        log.n_seen = int(payload["n_seen"])
        head = log.n_seen % log.capacity if log.n_seen > log.capacity else 0
        # Re-lay the chronological arrays into the ring so columns() (and
        # therefore same_as) reproduce the saved view exactly.
        order = (np.r_[head:n, 0:head] if log.n_seen > log.capacity
                 else np.arange(n))
        log.t[order] = np.asarray(cols["t"], np.float64)
        log.kind[order] = np.asarray(cols["kind"], np.int16)
        log.cycle[order] = np.asarray(cols["cycle"], np.int32)
        log.uid[order] = np.asarray(cols["uid"], np.int64)
        log.node[order] = np.asarray(cols["node"], np.int32)
        for j, name in enumerate(FCOLS):
            log.f[order, j] = np.asarray(cols[name], np.float64)
        log.node_table = [str(s) for s in payload["node_table"]]
        log._node_idx = {s: i for i, s in enumerate(log.node_table)}
        return log

    def save(self, path: str) -> None:
        """Write the log to ``path`` (.npz: compressed columns + JSON meta;
        .json: exact float round-trip via repr)."""
        payload = self.to_payload()
        if str(path).endswith(".json"):
            with open(path, "w") as fh:
                json.dump(_jsonable(payload), fh)
            return
        meta = {k: payload[k] for k in
                ("schema", "n_seen", "capacity", "node_table")}
        np.savez_compressed(path, meta=np.asarray(json.dumps(meta)),
                            **payload["columns"])

    @classmethod
    def load(cls, path: str) -> "EventLog":
        if str(path).endswith(".json"):
            with open(path) as fh:
                return cls.from_payload(json.load(fh))
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cols = {name: z[name]
                    for name in ("t", "kind", "cycle", "uid", "node") + FCOLS}
        meta["columns"] = cols
        return cls.from_payload(meta)


def _jsonable(obj):
    """Recursively convert numpy containers to exact JSON-native values
    (floats round-trip via repr; NaN survives as the JSON-extension token,
    matching the TraceStore persistence contract)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


@dataclasses.dataclass
class ObsConfig:
    """Observability knobs on ``ExperimentSpec.obs`` (None = fully off:
    every hook in the hot path degenerates to one ``is not None`` test)."""

    events: bool = True          # flight recorder (EventLog)
    profile: bool = True         # cycle-phase profiler (perf_counter spans)
    capacity: int = 1 << 16      # event ring slots
    max_spans: int = 1 << 16     # profiler span ring slots (Chrome trace)


class ObsRecorder:
    """The recorder hub attached to one ``Simulation``.

    Instrumented objects (cluster, orchestrator, simulation, autoscaler,
    rescheduler) each carry an ``obs`` attribute defaulting to ``None``;
    ``attach`` points them all here.  Event helpers no-op when the event
    pillar is disabled, so a profile-only recorder costs nothing extra.

    ``reason`` is the eviction-attribution context: the code path about to
    trigger evictions (rescheduler, Alg. 6 consolidation, node failure,
    straggler mitigation, crash loop) sets it around the unbind calls and
    restores it after, so ``Cluster.unbind`` can stamp *why* without any
    plumbing through the call chain.
    """

    def __init__(self, config: Optional[ObsConfig] = None):
        self.config = config or ObsConfig()
        self.events: Optional[EventLog] = (
            EventLog(self.config.capacity) if self.config.events else None)
        if self.config.profile:
            from repro_torch.obs.profiler import PhaseProfiler
            self.prof = PhaseProfiler(max_spans=self.config.max_spans)
        else:
            self.prof = None
        self.reason = R_UNSPEC
        self.meta: Dict = {}
        self._sim = None
        self._orch = None
        self._cluster = None

    # -- wiring --------------------------------------------------------------
    def attach(self, sim) -> "ObsRecorder":
        """Thread this recorder through one built simulation."""
        self._sim = sim
        self._orch = sim.orch
        self._cluster = sim.cluster
        sim.obs = self
        sim.orch.obs = self
        sim.cluster.obs = self
        sim.orch.autoscaler.obs = self
        sim.orch.rescheduler.obs = self
        return self

    # -- passive attribution reads -------------------------------------------
    def pending_depth(self) -> float:
        orch = self._orch
        return float(orch.n_pending) if orch is not None else _NAN

    def utilization(self) -> float:
        """Mean RAM req/cap ratio right now.  ``utilization_totals`` is
        incremental and its fsum reduction is flush-order independent, so
        this read cannot perturb the 20 s sampler (bit-identity contract)."""
        cluster = self._cluster
        if cluster is None:
            return _NAN
        n, ram_sum, _cpu, _ppn = cluster.utilization_totals()
        return ram_sum / n if n else 0.0

    def _cycle(self) -> int:
        orch = self._orch
        return orch._cycle_count if orch is not None else -1

    # -- event helpers (each maps to one call site in the stack) -------------
    def bind(self, now: float, uid: int, node_id: str, wait_s: float,
             incarnation: int) -> None:
        ev = self.events
        if ev is None:
            return
        ev.record(now, EV_BIND, cycle=self._cycle(), uid=int(uid),
                  node=node_id, pending=self.pending_depth(),
                  v1=float(wait_s), v2=float(incarnation))

    def evict(self, now: float, uid: int, node_id: Optional[str],
              incarnation: int, failed: bool) -> None:
        ev = self.events
        if ev is None:
            return
        ev.record(now, EV_EVICT, cycle=self._cycle(), uid=int(uid),
                  node=node_id, pending=self.pending_depth(),
                  v1=float(incarnation),
                  v2=float(self.reason if self.reason != R_UNSPEC
                           else (R_NODE_FAIL if failed else R_UNSPEC)))

    def scale_out(self, now: float, uid: int, node_id: Optional[str],
                  disposition: int, *, rate: float = _NAN, conf: float = _NAN,
                  headroom: float = _NAN, detail: float = _NAN) -> None:
        ev = self.events
        if ev is None:
            return
        ev.record(now, EV_SCALE_OUT, cycle=self._cycle(), uid=int(uid),
                  node=node_id, pending=self.pending_depth(),
                  util=self.utilization(), rate=rate, conf=conf,
                  headroom=headroom, v1=float(disposition), v2=detail)

    def scale_in(self, now: float, node_id: str, step: int,
                 n_moved: int = 0) -> None:
        ev = self.events
        if ev is None:
            return
        ev.record(now, EV_SCALE_IN, cycle=self._cycle(), node=node_id,
                  pending=self.pending_depth(), util=self.utilization(),
                  v1=float(step), v2=float(n_moved))

    def preempt_notice(self, now: float, node_id: str, residents: int,
                       kill_delay_s: float) -> None:
        ev = self.events
        if ev is None:
            return
        ev.record(now, EV_NOTICE, cycle=self._cycle(), node=node_id,
                  pending=self.pending_depth(), v1=float(residents),
                  v2=float(kill_delay_s))

    def resched(self, now: float, uid: int, outcome: int,
                victim: Optional[str] = None, n_moved: int = 0) -> None:
        ev = self.events
        if ev is None:
            return
        ev.record(now, EV_RESCHED, cycle=self._cycle(), uid=int(uid),
                  node=victim, pending=self.pending_depth(),
                  v1=float(outcome), v2=float(n_moved))

    def forecast(self, now: float, rate: float, conf: float,
                 overloaded: bool, slow_rate: float) -> None:
        ev = self.events
        if ev is None:
            return
        ev.record(now, EV_FORECAST, cycle=self._cycle(),
                  pending=self.pending_depth(), util=self.utilization(),
                  rate=float(rate), conf=float(conf),
                  v1=float(bool(overloaded)), v2=float(slow_rate))

    # -- export ---------------------------------------------------------------
    def bundle(self) -> Dict:
        """The whole run as one plain dict of arrays/lists: events +
        profiler aggregates + span ring + the MetricsCollector series the
        obs path exposes (node-count series, pending intervals) — the
        input format of ``repro_torch.obs.report``."""
        out = {"schema": SCHEMA_VERSION, "meta": dict(self.meta),
               "kind_names": list(KIND_NAMES),
               "reason_names": list(REASON_NAMES),
               "scale_out_names": list(SCALE_OUT_NAMES),
               "resched_names": list(RESCHED_NAMES)}
        if self.events is not None:
            out["events"] = self.events.to_payload()
        if self.prof is not None:
            out["profile"] = self.prof.to_payload()
        sim = self._sim
        if sim is not None:
            series = sim.metrics.node_count_series
            out["node_count_t"] = np.asarray([s[0] for s in series],
                                             np.float64)
            out["node_count_n"] = np.asarray([s[1] for s in series], np.int64)
            out["pending_intervals"] = np.asarray(
                sim.metrics.pending_intervals, np.float64)
        return out

    def export(self, path: str) -> None:
        save_bundle(self.bundle(), path)


def save_bundle(bundle: Dict, path: str) -> None:
    """Persist a recorder bundle (.npz or exact-round-trip .json)."""
    if str(path).endswith(".json"):
        with open(path, "w") as fh:
            json.dump(_jsonable(bundle), fh)
        return
    arrays: Dict[str, np.ndarray] = {}
    meta = {"schema": bundle["schema"], "meta": bundle["meta"],
            "kind_names": bundle["kind_names"],
            "reason_names": bundle["reason_names"],
            "scale_out_names": bundle["scale_out_names"],
            "resched_names": bundle["resched_names"]}
    ev = bundle.get("events")
    if ev is not None:
        meta["events"] = {k: ev[k] for k in
                          ("schema", "n_seen", "capacity", "node_table")}
        for name, col in ev["columns"].items():
            arrays[f"ev_{name}"] = np.asarray(col)
    prof = bundle.get("profile")
    if prof is not None:
        meta["profile_names"] = prof["names"]
        meta["profile_n_spans_seen"] = prof["n_spans_seen"]
        for key in ("count", "total_s", "min_s", "max_s", "hist"):
            arrays[f"ph_{key}"] = np.asarray(prof[key])
        for key in ("name", "t0", "dur_s", "sim_s"):
            arrays[f"sp_{key}"] = np.asarray(prof["spans"][key])
    for key in ("node_count_t", "node_count_n", "pending_intervals"):
        if key in bundle:
            arrays[key] = np.asarray(bundle[key])
    np.savez_compressed(path, meta=np.asarray(json.dumps(meta)), **arrays)


def load_bundle(path: str) -> Dict:
    """Inverse of :func:`save_bundle`; returns the same dict shape
    ``ObsRecorder.bundle()`` produces (arrays come back as numpy)."""
    if str(path).endswith(".json"):
        with open(path) as fh:
            bundle = json.load(fh)
        if "events" in bundle:
            cols = bundle["events"]["columns"]
            for name in ("t",) + FCOLS:
                cols[name] = np.asarray(cols[name], np.float64)
            for name, dt in (("kind", np.int16), ("cycle", np.int32),
                             ("uid", np.int64), ("node", np.int32)):
                cols[name] = np.asarray(cols[name], dt)
        if "profile" in bundle:
            prof = bundle["profile"]
            for key in ("count", "total_s", "min_s", "max_s", "hist"):
                prof[key] = np.asarray(prof[key])
            for key in ("name", "t0", "dur_s", "sim_s"):
                prof["spans"][key] = np.asarray(prof["spans"][key])
        for key in ("node_count_t", "node_count_n", "pending_intervals"):
            if key in bundle:
                bundle[key] = np.asarray(bundle[key])
        return bundle
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        bundle = {k: meta[k] for k in
                  ("schema", "meta", "kind_names", "reason_names",
                   "scale_out_names", "resched_names")}
        if "events" in meta:
            ev = meta["events"]
            ev["columns"] = {name: z[f"ev_{name}"]
                             for name in ("t", "kind", "cycle", "uid",
                                          "node") + FCOLS}
            bundle["events"] = ev
        if "profile_names" in meta:
            bundle["profile"] = {
                "names": meta["profile_names"],
                "n_spans_seen": meta["profile_n_spans_seen"],
                **{key: z[f"ph_{key}"]
                   for key in ("count", "total_s", "min_s", "max_s", "hist")},
                "spans": {key: z[f"sp_{key}"]
                          for key in ("name", "t0", "dur_s", "sim_s")}}
        for key in ("node_count_t", "node_count_n", "pending_intervals"):
            if key in z:
                bundle[key] = z[key]
    return bundle
