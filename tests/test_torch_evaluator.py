"""PyTorch port, cell rows: ``repro_torch.search.runner.run_cells(cells,
workers="lanes", device="cpu")`` against the reference's serial
``run_cells(cells, workers=1)`` (a mixed batch's cells outside the lane
envelope run serially in place), and the port's package rules (device
resolution, no JAX and nothing of ``repro`` imported)."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.search import runner as ref_runner

from repro_torch.device import resolve_device
from repro_torch.search import runner as port_runner

REPO = Path(__file__).resolve().parent.parent

# The eligible cells of the reference suite's TestEvaluatorRows plus the
# zero-pod case of its padding tests.
CELL_KWARGS = [
    dict(scenario="heavy-tail", scheduler="best-fit", autoscaler="void",
         rescheduler="void", seed=0, n_jobs=40, engine="array",
         initial_workers=4),
    dict(scenario="diurnal", scheduler="k8s-default", autoscaler="void",
         rescheduler="void", seed=0, n_jobs=24, engine="array",
         initial_workers=3),
    dict(scenario="heavy-tail", scheduler="weighted", autoscaler="void",
         rescheduler="void", seed=1, n_jobs=40, engine="array",
         initial_workers=5, scheduler_weights=(0.2, 0.5, 0.3)),
    # infeasible short-circuit: heavy-tail pods exceed m2.tiny
    dict(scenario="heavy-tail", scheduler="best-fit", autoscaler="void",
         rescheduler="void", seed=0, n_jobs=40, engine="array",
         initial_workers=2, template_name="m2.tiny"),
    # zero-pod lane beside a real one
    dict(scenario="heavy-tail", scheduler="best-fit", autoscaler="void",
         rescheduler="void", seed=0, n_jobs=0, engine="array",
         initial_workers=2),
    dict(scenario="heavy-tail", scheduler="best-fit", autoscaler="void",
         rescheduler="void", seed=0, n_jobs=40, engine="array",
         initial_workers=2),
]


def test_rows_equal_serial_reference_rows():
    serial = ref_runner.run_cells(
        [ref_runner.CellSpec(**kw) for kw in CELL_KWARGS], workers=1)
    rows = port_runner.run_cells(
        [port_runner.CellSpec(**kw) for kw in CELL_KWARGS], workers="lanes",
        device="cpu")
    assert len(rows) == len(serial)
    for s, r in zip(serial, rows):
        for field in port_runner._RESULT_FIELDS:
            assert type(s[field]) is type(r[field]), (s["label"], field)
            assert s[field] == r[field], (s["label"], field)
        for key in ("label", "infeasible", "n_jobs", "cell"):
            assert s[key] == r[key], (s["label"], key)
        assert set(r) == set(s)
    assert rows[4]["completed"] is False and rows[4]["max_nodes"] == 2


# Cells outside the lane envelope, mixed in between the eligible ones: an
# autoscaler, a rescheduler, the object engine and a chaos cell.
INELIGIBLE_KWARGS = [
    dict(CELL_KWARGS[0], autoscaler="binding"),
    dict(CELL_KWARGS[1], rescheduler="non-binding", autoscaler="binding",
         seed=2),
    dict(CELL_KWARGS[0], engine="object", n_jobs=24),
    dict(scenario="spot-spike", scheduler="best-fit", autoscaler="binding",
         rescheduler="non-binding", seed=0, n_jobs=40, chaos=True),
]


def test_ineligible_cell_raises_naming_it():
    """A mixed batch (eligible, ineligible, infeasible and zero-pod
    cells): the lane engine runs the cells outside its envelope through
    the serial ``run_cell`` in place, and every row equals the
    reference's ``run_cells(workers=1)`` row, in submission order."""
    kwargs = []
    for i, kw in enumerate(CELL_KWARGS):
        kwargs.append(kw)
        if i < len(INELIGIBLE_KWARGS):
            kwargs.append(INELIGIBLE_KWARGS[i])
    serial = ref_runner.run_cells(
        [ref_runner.CellSpec(**kw) for kw in kwargs], workers=1)
    cells = [port_runner.CellSpec(**kw) for kw in kwargs]
    rows = port_runner.run_cells(cells, workers="lanes", device="cpu")
    assert [r["label"] for r in rows] == [c.label for c in cells]
    for s, r in zip(serial, rows):
        for field in port_runner._RESULT_FIELDS:
            assert type(s[field]) is type(r[field]), (s["label"], field)
            assert s[field] == r[field], (s["label"], field)
        for key in ("label", "infeasible", "n_jobs", "cell"):
            assert s[key] == r[key], (s["label"], key)
    from repro_torch.manyworld import evaluator
    assert evaluator.stage_s["serial_s"] > 0.0
    assert rows[1]["completed"] and rows[7]["failures_injected"] > 0
    # Without an eligible cell no device is resolved: nothing launches.
    bad = [port_runner.CellSpec(**kw) for kw in INELIGIBLE_KWARGS[:2]]
    assert (_strip(port_runner.run_cells(bad, workers="lanes"))
            == _strip(port_runner.run_cells(bad)))


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]


def test_device_none_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_runner.run_cells([port_runner.CellSpec(**CELL_KWARGS[0])],
                              workers="lanes")
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.core.disruption, repro_torch.core.estimator\n"
        "import repro_torch.core.heterogeneous, repro_torch.k8s.objects\n"
        "import repro_torch.obs.profiler, repro_torch.obs.recorder\n"
        "import repro_torch.obs.report, repro_torch.scenarios.adapter\n"
        "import repro_torch.scenarios.chaos, repro_torch.search.nsga2\n"
        "import repro_torch.search.paramspace, repro_torch.search.report\n"
        "import repro_torch.k8s, repro_torch.obs, repro_torch.search\n"
        "from repro_torch.search.runner import CellSpec, run_cells\n"
        "rows = run_cells([CellSpec(scenario='heavy-tail', autoscaler='void',"
        " n_jobs=8, initial_workers=2)], workers='lanes', device='cpu')\n"
        "assert rows[0]['completed'] in (True, False)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_or_repro_import_in_port_sources():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)\b)"
        r"|^\s*(import|from)\s+repro\.", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        assert not pattern.search(path.read_text()), path
