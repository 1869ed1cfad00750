"""PyTorch port, the serial orchestrator (``repro_torch.core``,
``repro_torch.search.runner``) against the reference's, on the CPU.

Every comparison holds every ``ExperimentResult`` field ``==`` (floats
bit for bit), after resetting both packages' id counters: node ids order
lexicographically, so a run's tie-breaks depend on where the counters
start.  Runner rows are compared on every key but ``wall_s``.

* Fig. 3: ``run_all_combos`` on the three workloads, seeds 0-2, both
  engines;
* Fig. 4: ``run_k8s_baseline`` on the three workloads, both searches;
* policies and sources: every scheduler, the policy-search knobs, a
  ``trace=``, a ``scenario=`` source, ``static_workers`` and a template;
* the golden event logs ``tests/data/golden_trace*.json`` replayed
  through the port's ``build_simulation`` on both engines;
* the runner: ``run_cells(workers=1)`` against the reference's, a pool of
  2 against ``workers=1``, lanes against serial on void/void cells;
* the package rules: nothing of ``repro`` or JAX imported, no
  environment variable read.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as R
from repro.scenarios import build_scenario as ref_scenario
from repro.search import runner as ref_runner

import repro_torch.core as P
from repro_torch.core import golden
from repro_torch.scenarios import build_scenario as port_scenario
from repro_torch.search import runner as port_runner

REPO = Path(__file__).resolve().parent.parent


def _reset():
    R.reset_id_counters()
    P.reset_id_counters()


def _rows(results):
    return [golden.result_row(r) for r in results]


def _both(**kw):
    """One experiment through both packages: (reference row, port row)."""
    _reset()
    want = golden.result_row(R.run_experiment(R.ExperimentSpec(**kw)))
    _reset()
    got = golden.result_row(P.run_experiment(P.ExperimentSpec(**kw)))
    return want, got


@pytest.mark.parametrize("engine", ["array", "object"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("workload", golden.FIG3_WORKLOADS)
def test_fig3_combos_equal_reference(workload, seed, engine):
    _reset()
    want = _rows(R.run_all_combos(workload, seed, engine=engine))
    _reset()
    got = _rows(P.run_all_combos(workload, seed, engine=engine))
    assert len(got) == 6
    assert got == want


@pytest.mark.parametrize("search", ["bisect", "linear"])
@pytest.mark.parametrize("workload", golden.FIG3_WORKLOADS)
def test_fig4_k8s_baseline_equal_reference(workload, search):
    want = R.run_k8s_baseline(workload, 0, search=search)
    got = P.run_k8s_baseline(workload, 0, search=search)
    assert got.max_nodes == want.max_nodes
    assert golden.result_row(got) == golden.result_row(want)
    assert got.completed and got.max_pending_s <= 10.0 + 1e-9


@pytest.mark.parametrize("engine", ["array", "object"])
@pytest.mark.parametrize("scheduler", sorted(R.SCHEDULERS))
def test_each_scheduler_equals_reference(scheduler, engine):
    assert sorted(P.SCHEDULERS) == sorted(R.SCHEDULERS)
    want, got = _both(workload="mixed", seed=1, scheduler=scheduler,
                      rescheduler="binding", autoscaler="non-binding",
                      engine=engine)
    assert got == want and got["completed"]


@pytest.mark.parametrize("autoscaler", ["non-binding", "binding"])
def test_policy_knobs_equal_reference(autoscaler):
    want, got = _both(workload="bursty", seed=2, scheduler="weighted",
                      scheduler_weights=(0.5, 0.2, 0.3),
                      rescheduler="non-binding", autoscaler=autoscaler,
                      scale_out_bypass_util=(0.4 if autoscaler ==
                                             "non-binding" else None),
                      scale_in_util_ceiling=0.6, max_pod_age_s=30.0,
                      provisioning_interval_s=45.0)
    assert got == want


def test_sources_equal_reference():
    trace_rows = []
    for pkg, build in ((R, ref_scenario), (P, port_scenario)):
        pkg.reset_id_counters()
        trace = build("diurnal", seed=4, n_jobs=150)
        trace_rows.append(golden.result_row(pkg.run_experiment(
            pkg.ExperimentSpec(trace=trace, rescheduler="binding"))))
    assert trace_rows[0] == trace_rows[1]
    want, got = _both(scenario="heavy-tail", scenario_jobs=120, seed=3,
                      autoscaler="non-binding", template_name="m2.medium")
    assert got == want and got["workload"] == "heavy-tail"
    want, got = _both(workload="slow", seed=0, scheduler="k8s-default",
                      autoscaler="void", static_workers=4,
                      engine="object")
    assert got == want and got["max_nodes"] == 4
    want, got = _both(scenario="paper-mixed", seed=5, wave_select="segtree")
    assert got == want


def test_run_length_and_wave_kernels_are_decision_identical():
    """The port's explicit switches (the reference reads them from the
    environment): the run-length fast path off and each wave kernel give
    the default row."""
    kw = dict(scenario="flash-crowd", scenario_jobs=200, seed=2,
              autoscaler="non-binding")
    base = None
    for extra in ({}, {"wave_runlen": False}, {"wave_select": "argmin"},
                  {"wave_select": "segtree"}, {"engine": "object"}):
        P.reset_id_counters()
        row = golden.result_row(P.run_experiment(
            P.ExperimentSpec(**kw, **extra)))
        base = base or row
        assert row == base, extra
    with pytest.raises(ValueError, match="wave_select"):
        P.run_experiment(P.ExperimentSpec(**kw, wave_select="nope"))


@pytest.mark.parametrize("engine", ["array", "object"])
@pytest.mark.parametrize("case", sorted(golden.GOLDEN_TRACE_CASES))
def test_golden_event_log_equals_fixture(case, engine):
    want = golden.load_trace_fixture(case)
    spec, _ = golden.GOLDEN_TRACE_CASES[case]
    got = golden.capture_trace(engine, spec)
    for key in want:
        assert got[key] == want[key], (case, engine, key)
    assert got == want


def _cells(mod):
    C = mod.CellSpec
    return [C(scenario="paper-mixed", seed=1),
            C(scenario="flash-crowd", n_jobs=150, autoscaler="non-binding",
              rescheduler="binding", seed=2),
            C(scenario="scale-stress", n_jobs=150, autoscaler="predictive",
              seed=0),
            C(scenario="scale-stress", n_jobs=150, autoscaler="predictive",
              forecaster=None, seed=0),
            C(scenario="heavy-tail", n_jobs=60, autoscaler="void",
              initial_workers=3, scheduler="k8s-default"),
            C(scenario="diurnal", n_jobs=100, scheduler="weighted",
              scheduler_weights=(0.3, 0.3, 0.4), engine="object"),
            C(scenario="paper-bursty", template_name="m2.tiny")]


def _strip(rows):
    out = []
    for r in rows:
        r = dict(r)
        assert isinstance(r.pop("wall_s"), float)
        out.append(r)
    return out


def test_run_cells_serial_equals_reference():
    want = _strip(ref_runner.run_cells(_cells(ref_runner), workers=1))
    got = _strip(port_runner.run_cells(_cells(port_runner), workers=1))
    assert got == want
    assert got[-1]["infeasible"] and not got[0]["infeasible"]


def test_run_cells_pool_equals_serial():
    cells = _cells(port_runner)
    serial = _strip(port_runner.run_cells(cells, workers=1))
    assert _strip(port_runner.run_cells(cells, workers=2)) == serial


def test_lanes_equal_serial_on_void_void_cells():
    pytest.importorskip("torch")
    C = port_runner.CellSpec
    cells = [C(scenario="heavy-tail", autoscaler="void", n_jobs=40,
               initial_workers=4, seed=s, engine="array") for s in (0, 1)]
    cells.append(C(scenario="diurnal", scheduler="k8s-default",
                   autoscaler="void", n_jobs=24, initial_workers=3))
    lanes = _strip(port_runner.run_cells(cells, workers="lanes",
                                         device="cpu"))
    assert lanes == _strip(port_runner.run_cells(cells, workers=1))


def test_unported_options_raise_naming_roadmap(tmp_path):
    """The options that once raised naming ROADMAP.md now run as the
    reference's: a chaos cell, a cell's ``obs_dir``, ``obs=True`` and the
    chaos families in the registry."""
    changes = (dict(scenario="spot-spike", n_jobs=60, chaos=True),
               dict(scenario="paper-mixed", obs_dir=str(tmp_path)))
    for change in changes:
        cell = port_runner.CellSpec(**change)
        got = port_runner.run_cells([cell], workers=1)
        if "obs_dir" in change:
            assert (tmp_path / f"{cell.label}.npz").exists()
        want = ref_runner.run_cells(
            [ref_runner.CellSpec(**change)], workers=1)
        assert _strip(got) == _strip(want)
    want, got = _both(workload="mixed", obs=True)
    assert got == want
    want = ref_scenario("zone-outage", seed=1, n_jobs=30)
    assert (port_scenario("zone-outage", seed=1, n_jobs=30).arrival_time
            == want.arrival_time).all()


def test_port_sources_import_neither_jax_nor_repro_nor_read_environ():
    imports = re.compile(
        r"^\s*(import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)\b)"
        r"|^\s*(import|from)\s+repro\.", re.M)
    environ = re.compile(r"os\.environ|getenv\(|environ\[")
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 40
    for path in files:
        text = path.read_text()
        assert not imports.search(text), path
        assert not environ.search(text), path
    assert not imports.search((REPO / "chip_smoke.py").read_text())


def test_orchestrator_runs_without_jax_or_repro():
    code = (
        "import sys\n"
        "from repro_torch.core import ExperimentSpec, run_experiment\n"
        "from repro_torch.search.runner import CellSpec, run_cells\n"
        "r = run_experiment(ExperimentSpec(workload='bursty'))\n"
        "assert r.completed\n"
        "rows = run_cells([CellSpec(scenario='paper-slow')], workers=1)\n"
        "assert rows[0]['completed']\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.') or m == 'torch')\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
