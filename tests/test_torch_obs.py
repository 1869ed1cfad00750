"""PyTorch port, the flight recorder (``repro_torch.obs``) on the CPU.

* ``tests/test_obs.py``'s cases on the port: the event ring's wrap, the
  JSON and NPZ round trips, ``same_as``, the profiler's span ring, the
  ``chrome_trace`` shape, rows with the recorder on ``==`` rows with it
  off on both engines, the bundle round trip, ``render_report`` and
  ``CellSpec(obs_dir=...)``;
* the port's event columns and node table ``==`` the reference's for the
  same run (both engines), logs saved by one package loaded by the other;
  profiler spans are wall times, so they are compared by name and count.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import repro.core as R
import repro.obs as RO

import repro_torch.core as P
import repro_torch.obs as PO
from repro_torch.obs.recorder import (EV_FORECAST, EV_SCALE_IN, EV_SCALE_OUT,
                                      SO_PRELAUNCH)

N_JOBS = 60


def _spec(pkg, engine, obs=None, autoscaler="predictive"):
    return pkg.ExperimentSpec(scenario="flash-crowd", scenario_jobs=N_JOBS,
                              autoscaler=autoscaler,
                              rescheduler="non-binding", seed=3,
                              engine=engine, obs=obs)


def _fill(log, n):
    for i in range(n):
        log.record(float(i), i % 3, cycle=i, uid=i, node=f"node-{i % 5}",
                   pending=float(i), v1=float(i) * 0.5,
                   v2=float("nan") if i % 4 == 0 else float(i))


def test_ring_wraps_and_retains_latest():
    log = PO.EventLog(capacity=8)
    _fill(log, 20)
    assert log.n_seen == 20 and len(log) == 8
    cols = log.columns()
    assert cols["t"].tolist() == [float(i) for i in range(12, 20)]
    assert cols["uid"].tolist() == list(range(12, 20))
    assert log.node_table == [f"node-{i}" for i in range(5)]
    small = PO.EventLog(capacity=32)
    _fill(small, 10)
    assert small.n_seen == len(small) == 10
    ref = RO.EventLog(capacity=8)
    _fill(ref, 20)
    for name, col in ref.columns().items():
        assert np.array_equal(log.columns()[name], col, equal_nan=True), name


@pytest.mark.parametrize("suffix", [".npz", ".json"])
@pytest.mark.parametrize("n", [10, 20])          # unwrapped and wrapped
def test_log_round_trip_bit_exact_both_ways(tmp_path, suffix, n):
    log = PO.EventLog(capacity=16)
    _fill(log, n)
    path = str(tmp_path / f"events{suffix}")
    log.save(path)
    back = PO.EventLog.load(path)
    assert log.same_as(back) and back.same_as(log)
    back.record(99.0, 0, uid=99)
    assert back.n_seen == n + 1 and back.columns()["uid"][-1] == 99
    # The reference reads the port's file, and the port the reference's.
    ref_back = RO.EventLog.load(path)
    ref_log = RO.EventLog(capacity=16)
    _fill(ref_log, n)
    assert ref_back.same_as(ref_log)
    ref_path = str(tmp_path / f"ref{suffix}")
    ref_log.save(ref_path)
    assert PO.EventLog.load(ref_path).same_as(log)


def test_same_as_detects_drift():
    a, b = PO.EventLog(capacity=8), PO.EventLog(capacity=8)
    _fill(a, 6), _fill(b, 6)
    assert a.same_as(b)
    b.f[3, 0] += 1e-12
    assert not a.same_as(b)


def test_profiler_ring_and_chrome_trace():
    prof = PO.PhaseProfiler(max_spans=4)
    for _ in range(10):
        prof.stop("phase_a", prof.start(), 1.0)
    payload = prof.to_payload()
    assert prof.n_spans_seen == 10
    assert payload["count"].tolist() == [10]
    assert len(payload["spans"]["dur_s"]) == 4
    assert int(payload["hist"].sum()) == 10
    prof = PO.PhaseProfiler(max_spans=8)
    for name in ("alpha", "beta", "alpha"):
        prof.stop(name, prof.start(), 2.5)
    events = PO.chrome_trace(prof.to_payload())
    assert len(events) == 3 and {e["name"] for e in events} == {"alpha",
                                                               "beta"}
    for e in events:
        assert e["ph"] == "X" and e["ts"] >= 0.0 and e["dur"] >= 0.0
        assert e["args"]["sim_s"] == 2.5
    # The same spans through the reference's exporter: same events but
    # for the wall-time fields.
    ref = RO.chrome_trace(prof.to_payload())
    strip = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
             for e in events]
    assert strip == [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                     for e in ref]


@pytest.fixture(scope="module")
def recorded():
    """The port's and the reference's recorded run on each engine."""
    out = {}
    for engine in ("array", "object"):
        R.reset_id_counters()
        ref = RO.run_recorded(_spec(R, engine))
        P.reset_id_counters()
        port = PO.run_recorded(_spec(P, engine))
        out[engine] = (ref, port)
    return out


@pytest.mark.parametrize("engine", ["array", "object"])
def test_rows_obs_on_equal_obs_off(engine, recorded):
    P.reset_id_counters()
    off = P.run_experiment(_spec(P, engine))
    (_ref, (on, rec)) = recorded[engine]
    assert dataclasses.asdict(on) == dataclasses.asdict(off)
    assert rec.events.n_seen > 0 and rec.prof.n_spans_seen > 0
    P.reset_id_counters()
    also = P.run_experiment(_spec(P, engine, obs=True))
    assert dataclasses.asdict(also) == dataclasses.asdict(off)


@pytest.mark.parametrize("engine", ["array", "object"])
def test_event_columns_and_nodes_equal_reference(engine, recorded):
    (ref_result, ref_rec), (result, rec) = recorded[engine]
    assert dataclasses.asdict(result) == dataclasses.asdict(ref_result)
    assert rec.events.n_seen == ref_rec.events.n_seen
    assert rec.events.node_table == ref_rec.events.node_table
    want, got = ref_rec.events.columns(), rec.events.columns()
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name], equal_nan=True), name
    bundle, ref_bundle = rec.bundle(), ref_rec.bundle()
    assert bundle["meta"] == ref_bundle["meta"]
    for key in ("node_count_t", "node_count_n"):
        assert np.array_equal(bundle[key], ref_bundle[key]), key
    # Spans are wall times: the same phases, counted alike.
    prof, ref_prof = bundle["profile"], ref_bundle["profile"]
    assert prof["names"] == ref_prof["names"]
    assert np.array_equal(prof["count"], ref_prof["count"])
    assert rec.prof.n_spans_seen == ref_rec.prof.n_spans_seen


def test_attribution_complete_on_the_port(recorded):
    _ref, (result, rec) = recorded["array"]
    cols = rec.events.columns()
    assert rec.events.n_seen <= rec.events.capacity
    so = cols["kind"] == EV_SCALE_OUT
    assert int((so & (cols["v1"] != SO_PRELAUNCH)).sum()) == result.scale_outs
    assert int((cols["kind"] == EV_SCALE_IN).sum()) == result.scale_ins
    fc = cols["kind"] == EV_FORECAST
    assert fc.any() and np.isfinite(cols["rate"][fc]).all()
    assert np.isfinite(cols["pending"][so]).all()
    assert (np.diff(cols["t"]) >= 0).all()


@pytest.mark.parametrize("suffix", [".npz", ".json"])
def test_bundle_round_trip_and_report(tmp_path, recorded, suffix):
    (_r, ref_rec), (_result, rec) = recorded["array"]
    path = str(tmp_path / f"bundle{suffix}")
    rec.export(path)
    back = PO.load_bundle(path)
    assert PO.EventLog.from_payload(back["events"]).same_as(rec.events)
    live = rec.prof.to_payload()
    assert back["profile"]["names"] == live["names"]
    assert np.array_equal(back["profile"]["count"], live["count"])
    assert np.array_equal(back["profile"]["spans"]["dur_s"],
                          live["spans"]["dur_s"])
    assert back["meta"]["engine"] == "array"
    assert back["meta"]["autoscaler"] == "predictive"
    # The reference reads the port's bundle.
    ref_back = RO.load_bundle(path)
    assert RO.EventLog.from_payload(ref_back["events"]).same_as(
        ref_rec.events)
    again = str(tmp_path / f"again{suffix}")
    PO.save_bundle(back, again)
    assert PO.EventLog.from_payload(
        PO.load_bundle(again)["events"]).same_as(rec.events)
    text = PO.render_report(back, limit=5)
    assert "cycle-phase profile" in text and "scale_out" in text
    # Every section but the wall-time profile equals the reference's.
    assert PO.decision_summary(back) == RO.decision_summary(ref_back)
    assert (PO.explain_events(back, limit=20)
            == RO.explain_events(ref_back, limit=20))
    from repro.obs.report import node_count_summary as ref_nodes
    from repro_torch.obs.report import node_count_summary
    assert node_count_summary(back) == ref_nodes(ref_back)
    table = PO.phase_table(back)
    assert all(name in table for name in back["profile"]["names"])


def test_chrome_trace_from_bundle(tmp_path, recorded):
    _ref, (_result, rec) = recorded["array"]
    events = PO.chrome_trace(rec.bundle()["profile"])
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    loaded = json.loads(path.read_text())["traceEvents"]
    assert len(loaded) == min(rec.prof.n_spans_seen, rec.prof.max_spans)
    assert all(e["ph"] == "X" and e["dur"] >= 0.0 for e in loaded)


def test_obs_dir_row_identical_and_bundle_written(tmp_path):
    from repro.search.runner import CellSpec as RefCell
    from repro.search.runner import run_cell as ref_run_cell
    from repro_torch.search.runner import CellSpec, run_cell
    base = dict(scenario="flash-crowd", scheduler="best-fit",
                autoscaler="predictive", rescheduler="non-binding", seed=3,
                n_jobs=N_JOBS)
    plain = run_cell(CellSpec(**base))
    captured = run_cell(CellSpec(**base, obs_dir=str(tmp_path / "port")))
    path = os.path.join(str(tmp_path / "port"), f"{CellSpec(**base).label}.npz")
    assert os.path.exists(path)
    bundle = PO.load_bundle(path)
    assert bundle["events"]["n_seen"] > 0
    ref_dir = str(tmp_path / "ref")
    ref_run_cell(RefCell(**base, obs_dir=ref_dir))
    ref_bundle = RO.load_bundle(os.path.join(ref_dir, os.path.basename(path)))
    assert PO.EventLog.from_payload(bundle["events"]).same_as(
        PO.EventLog.from_payload(ref_bundle["events"]))
    plain.pop("wall_s"), captured.pop("wall_s")
    captured["cell"].pop("obs_dir"), plain["cell"].pop("obs_dir")
    assert captured == plain
