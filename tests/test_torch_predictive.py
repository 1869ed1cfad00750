"""PyTorch port, the predictive autoscaler in the loop: the port's
``PredictiveAutoscaler`` against the reference's, with the online EWMA
forecaster and with the learned mLSTM forecaster of
``tests/data/torch_forecaster_golden/checkpoint`` (both packages load it).

The learned forecaster is checked in two steps on the CPU:

* **replay** — the JAX forecaster's recorded ``(rate, conf)`` sequence is
  handed to the port's autoscaler; its row and the number of ``predict``
  calls must be ``==`` the reference's;
* **live** — the port's ``LearnedForecaster`` gives each call's
  ``(rate, conf)`` within ``chip_smoke.FORECAST_TOL`` of JAX's, and the
  row is ``==`` the reference's.

The fixture ``tests/data/torch_orchestrate_golden.json`` (the reference's
Fig. 3 rows at seed 0, the three Fig. 4 baselines, the learned cell at
its full 2000 jobs with every ``predict`` call, and the same trace under
the non-binding autoscaler) is what ``chip_smoke.py`` phase 31 holds the
card to; these tests hold the port on the CPU to it.  Regenerate it from
the JAX package after an intentional semantic change::

    PYTHONPATH=src python tests/test_torch_predictive.py --regen
"""
import importlib.util
import json
import sys
from pathlib import Path

if __name__ == "__main__":          # --regen entry point
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R
from repro.core.experiment import build_simulation as ref_build
from repro.forecast import model as ref_fmodel

import repro_torch.core as P
from repro_torch.core import golden
from repro_torch.core.experiment import build_simulation as port_build
from repro_torch.forecast import model as port_fmodel

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "tests" / "data" / "torch_forecaster_golden" / "checkpoint"
LEARNED_JOBS = 400


def _chip_smoke_forecast_tol() -> dict:
    """``chip_smoke.FORECAST_TOL``: the card is held to the same bound."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FORECAST_TOL


FORECAST_TOL = _chip_smoke_forecast_tol()


def _reset():
    R.reset_id_counters()
    P.reset_id_counters()


@pytest.fixture
def one_thread():
    """Per-bin forecasts are batch-1 passes of tiny ops; on a shared CPU
    torch's intra-op threads cost ten times the work."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_forecast_tol_is_chip_smokes():
    assert FORECAST_TOL == dict(atol=2e-5, rtol=2e-5)


# The object engine scans every node per pod: flash-crowd's fleet of
# hundreds of nodes takes it minutes, so it runs on scale-stress only.
@pytest.mark.parametrize("scenario,engine", [
    ("flash-crowd", "array"), ("scale-stress", "array"),
    ("scale-stress", "object")])
def test_predictive_ewma_rows_equal_reference(scenario, engine):
    kw = dict(scenario=scenario, scenario_jobs=400, seed=0,
              autoscaler="predictive", rescheduler="non-binding",
              engine=engine)
    _reset()
    want = golden.result_row(R.run_experiment(R.ExperimentSpec(**kw)))
    _reset()
    got = golden.result_row(P.run_experiment(P.ExperimentSpec(**kw)))
    assert got == want
    assert got["completed"] and got["scale_outs"] > 0


def test_predictive_without_forecaster_is_non_binding():
    """The fallback contract: ``forecaster=None`` is the non-binding
    autoscaler bit for bit (and so is the reference's)."""
    kw = dict(scenario="flash-crowd", scenario_jobs=300, seed=1)
    rows = []
    for pkg in (R, P):
        for auto, fc in (("predictive", None), ("non-binding", "ewma")):
            pkg.reset_id_counters()
            r = golden.result_row(pkg.run_experiment(pkg.ExperimentSpec(
                autoscaler=auto, forecaster=fc, **kw)))
            r.pop("autoscaler")
            rows.append(r)
    assert rows[0] == rows[1] == rows[2] == rows[3]


def _learned_spec(pkg, forecaster, n_jobs=LEARNED_JOBS, **extra):
    kw = dict(golden.LEARNED_SPEC, forecaster_obj=forecaster, **extra)
    if n_jobs is not None:
        kw["scenario_jobs"] = n_jobs
    return pkg.ExperimentSpec(**kw)


@pytest.fixture(scope="module")
def jax_learned():
    """The reference's learned cell at LEARNED_JOBS: its row, every
    ``predict`` call and the calls that reached the model."""
    rec = golden.RecordingForecaster(
        ref_fmodel.load_forecaster(str(CKPT)))
    R.reset_id_counters()
    row, _ = golden.run_recorded(ref_build, _learned_spec(R, rec), rec)
    return row, rec.calls, rec.model_calls


def test_learned_replay_rows_equal_reference(jax_learned):
    want_row, calls, model_calls = jax_learned
    assert model_calls > 100
    rec = golden.RecordingForecaster(replay=calls)
    P.reset_id_counters()
    row, _ = golden.run_recorded(port_build, _learned_spec(P, rec), rec)
    assert len(rec.calls) == len(calls)
    assert row == want_row
    assert row["completed"] and row["autoscaler"] == "predictive"


def test_learned_live_within_tol_and_row_equal(jax_learned, one_thread):
    want_row, calls, model_calls = jax_learned
    rec = golden.RecordingForecaster(
        port_fmodel.load_forecaster(str(CKPT), device="cpu"))
    P.reset_id_counters()
    row, _ = golden.run_recorded(port_build, _learned_spec(P, rec), rec)
    got, want = np.asarray(rec.calls), np.asarray(calls)
    assert got.shape == want.shape
    assert rec.model_calls == model_calls
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], **FORECAST_TOL)
    assert row == want_row


@pytest.fixture(scope="module")
def fixture():
    with open(golden.ORCHESTRATE_FIXTURE) as f:
        return json.load(f)


def test_fixture_fig3_fig4_rows_on_cpu(fixture):
    assert sorted(fixture["fig3"]) == sorted(golden.FIG3_WORKLOADS)
    for w in golden.FIG3_WORKLOADS:
        P.reset_id_counters()
        got = [golden.result_row(r) for r in P.run_all_combos(w, 0)]
        assert got == fixture["fig3"][w], w
        assert golden.result_row(P.run_k8s_baseline(w, 0)) \
            == fixture["fig4"][w], w


def test_fixture_learned_cell_on_cpu(fixture, one_thread):
    """The full-size learned cell (2000 jobs), live on the CPU: what
    phase 31 asks of the card."""
    want = fixture["learned"]
    assert want["spec"] == golden.LEARNED_SPEC
    rec = golden.RecordingForecaster(
        port_fmodel.load_forecaster(str(CKPT), device="cpu"))
    P.reset_id_counters()
    row, _ = golden.run_recorded(port_build, _learned_spec(P, rec, None),
                                 rec)
    got, calls = np.asarray(rec.calls), np.asarray(want["calls"])
    assert got.shape == calls.shape and rec.model_calls == want["model_calls"]
    np.testing.assert_array_equal(got[:, 0], calls[:, 0])
    np.testing.assert_allclose(got[:, 1:], calls[:, 1:], **FORECAST_TOL)
    assert row == want["row"]
    assert row["completed"] and row["cost"] < fixture["non_binding"]["cost"]
    P.reset_id_counters()
    nb = P.run_experiment(_learned_spec(P, None, None,
                                        autoscaler="non-binding"))
    assert golden.result_row(nb) == fixture["non_binding"]


def _regen() -> None:
    out = {"fig3": {}, "fig4": {}}
    for w in golden.FIG3_WORKLOADS:
        R.reset_id_counters()
        out["fig3"][w] = [golden.result_row(r)
                          for r in R.run_all_combos(w, 0)]
        out["fig4"][w] = golden.result_row(R.run_k8s_baseline(w, 0))
    rec = golden.RecordingForecaster(ref_fmodel.load_forecaster(str(CKPT)))
    R.reset_id_counters()
    row, wall = golden.run_recorded(ref_build, _learned_spec(R, rec, None),
                                    rec)
    out["learned"] = {"spec": golden.LEARNED_SPEC, "row": row,
                      "model_calls": rec.model_calls, "calls": rec.calls}
    R.reset_id_counters()
    out["non_binding"] = golden.result_row(R.run_experiment(
        _learned_spec(R, None, None, autoscaler="non-binding")))
    with open(golden.ORCHESTRATE_FIXTURE, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(f"wrote {golden.ORCHESTRATE_FIXTURE}: learned cell "
          f"{len(rec.calls)} predict calls ({rec.model_calls} reached the "
          f"model), cost {row['cost']} vs non-binding "
          f"{out['non_binding']['cost']}, {wall:.1f} s")


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        print(__doc__)
        sys.exit(2)
    _regen()
