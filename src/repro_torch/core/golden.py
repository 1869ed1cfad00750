"""Replay of the orchestrator's fixtures, shared by the tests and
``chip_smoke.py``.

* :func:`capture_trace` runs one golden workload through the port's
  ``build_simulation`` and returns its full event log in the layout of
  ``tests/data/golden_trace*.json`` (the reference's
  ``tests/test_golden_trace.py`` writes those files; they are read here
  unchanged).
* :class:`RecordingForecaster` wraps a forecaster and records every
  ``predict`` call as ``(now, rate, conf)``, its latency, and whether it
  reached the model (a full history window); :func:`run_recorded` drives
  one experiment with it.  Both take the package's ``build_simulation``
  as an argument, so one helper records either package's run.
* :func:`result_row` is an ``ExperimentResult`` as the JSON fixture
  ``tests/data/torch_orchestrate_golden.json`` stores it.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DATA = Path(__file__).resolve().parents[3] / "tests" / "data"

# The reference's two pinned golden workloads (tests/test_golden_trace.py):
# the non-binding rescheduler and autoscaler, and the binding rescheduler.
GOLDEN_TRACE_CASES: Dict[str, Tuple[dict, str]] = {
    "nbr-nbas": (dict(workload="mixed", seed=3, scheduler="best-fit",
                      rescheduler="non-binding", autoscaler="non-binding",
                      initial_workers=1), "golden_trace.json"),
    "br-nbas": (dict(workload="mixed", seed=3, scheduler="best-fit",
                     rescheduler="binding", autoscaler="non-binding",
                     initial_workers=1), "golden_trace_binding.json"),
}

ORCHESTRATE_FIXTURE = DATA / "torch_orchestrate_golden.json"
FIG3_WORKLOADS = ("bursty", "slow", "mixed")
# The learned forecaster's cell: flash-crowd at its family length (2000
# jobs), seed 0, best-fit, void rescheduler, the predictive autoscaler.
LEARNED_SPEC = dict(scenario="flash-crowd", seed=0, scheduler="best-fit",
                    rescheduler="void", autoscaler="predictive")


def result_row(result) -> dict:
    """Every ``ExperimentResult`` field, JSON round-tripped (floats
    survive bit-exactly), so ``==`` against a loaded fixture row is a
    bit-exact comparison."""
    return json.loads(json.dumps(dataclasses.asdict(result)))


def load_trace_fixture(case: str) -> dict:
    spec, name = GOLDEN_TRACE_CASES[case]
    with open(DATA / name) as f:
        return json.load(f)


def capture_trace(engine: str, spec: dict) -> dict:
    """Run one golden workload on the port's ``engine`` and capture the
    full event log: binds, evictions, completions, terminations, the
    Table-5 samples, the node-count series and the result row."""
    from repro_torch.core import ExperimentSpec, reset_id_counters
    from repro_torch.core.experiment import build_simulation
    reset_id_counters()
    sim = build_simulation(ExperimentSpec(engine=engine, **spec))
    binds, evictions, completions = [], [], []
    cluster = sim.cluster
    inner_bind = cluster.on_bind
    inner_unbind = cluster.on_unbind
    inner_complete = cluster.on_complete

    def on_bind(pod):
        binds.append([pod.uid, pod.incarnation, pod.node_id, pod.bound_time])
        inner_bind(pod)

    def on_unbind(pod):
        evictions.append([pod.uid, pod.incarnation, pod.pending_since])
        inner_unbind(pod)

    def on_complete(pod):
        completions.append([pod.uid, pod.node_id, pod.finish_time])
        inner_complete(pod)

    cluster.on_bind = on_bind
    cluster.on_unbind = on_unbind
    cluster.on_complete = on_complete
    result = sim.run()
    trace = {
        "spec": spec,
        "binds": binds,
        "evictions": evictions,
        "completions": completions,
        "scale_events": [[n.node_id, n.terminate_time]
                         for n in cluster.terminated],
        "samples": [list(dataclasses.astuple(s)) for s in sim.metrics.samples],
        "node_counts": [list(x) for x in sim.metrics.node_count_series],
        "result": dataclasses.asdict(result),
    }
    return json.loads(json.dumps(trace))


class RecordingForecaster:
    """A forecaster wrapper that records each ``predict`` call.

    ``calls`` holds ``[now, rate, conf]`` (``now`` read from ``clock``,
    set once the simulation exists), ``latency_s`` each call's host wall
    time, ``model_calls`` the calls that had a full history window, i.e.
    reached the model, and ``model_latency_s`` their wall times.
    ``replay`` (a list of ``[now, rate, conf]``) makes it return those
    forecasts in order instead of asking ``inner``; each replayed ``now``
    must match the call's."""

    def __init__(self, inner=None, replay: Optional[List] = None):
        self.inner = inner
        self.replay = replay
        self.clock = None
        self.calls: List[List[float]] = []
        self.latency_s: List[float] = []
        self.model_latency_s: List[float] = []
        self.model_calls = 0

    def observe_bin(self, rate: float) -> None:
        if self.inner is not None:
            self.inner.observe_bin(rate)

    def predict(self) -> Tuple[float, float]:
        now = self.clock()
        if self.replay is not None:
            t, rate, conf = self.replay[len(self.calls)]
            if t != now:
                raise AssertionError(
                    f"replayed call {len(self.calls)} was made at {t}, "
                    f"this run asks at {now}")
        else:
            inner = self.inner
            reached = len(inner._hist) >= inner.window.history_bins
            t0 = time.perf_counter()
            rate, conf = inner.predict()
            dt = time.perf_counter() - t0
            self.latency_s.append(dt)
            if reached:
                self.model_calls += 1
                self.model_latency_s.append(dt)
        self.calls.append([now, rate, conf])
        return rate, conf


def run_recorded(build_simulation, spec, forecaster: RecordingForecaster):
    """Run ``spec`` (whose ``forecaster_obj`` is ``forecaster``) through
    the given package's ``build_simulation``; returns the result row and
    the run's wall seconds."""
    sim = build_simulation(spec)
    forecaster.clock = lambda: sim.now
    t0 = time.perf_counter()
    result = sim.run()
    wall = time.perf_counter() - t0
    result.workload = spec.workload_label()
    return result_row(result), wall
