"""PyTorch port, cell rows: ``repro_torch.search.runner.run_cells(cells,
workers="lanes", device="cpu")`` against the reference's serial
``run_cells(cells, workers=1)``, and the port's package rules (device
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


def test_ineligible_cell_raises_naming_it():
    ok = port_runner.CellSpec(**CELL_KWARGS[0])
    bad = dataclasses.replace(ok, autoscaler="binding")
    with pytest.raises(ValueError, match=re.escape(bad.label)):
        port_runner.run_cells([ok, bad], device="cpu")
    with pytest.raises(NotImplementedError):
        port_runner.run_cells([ok], workers=1, device="cpu")


def test_device_none_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_runner.run_cells([port_runner.CellSpec(**CELL_KWARGS[0])])
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "from repro_torch.search.runner import CellSpec, run_cells\n"
        "rows = run_cells([CellSpec(scenario='heavy-tail', autoscaler='void',"
        " n_jobs=8, initial_workers=2)], device='cpu')\n"
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
