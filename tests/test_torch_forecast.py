"""PyTorch port, forecaster serving path: ``repro_torch.forecast`` against
``repro.forecast``, and the golden forecaster fixture.

``tests/data/torch_forecaster_golden/`` holds a forecaster trained by the
JAX package at ``FORECAST_eval.json``'s configuration (6 families × 48
seeds, 1000 steps, d_model 32, train seed 0, window 30 s / 16 / 2) and
saved with its ``save_forecaster`` (``checkpoint/``), plus
``expected.npz``: the JAX ``apply_forecast`` outputs on all windows of
that dataset (train then val), the JAX val log-MSE, a sha256 of the
dataset, and the JAX ``LearnedForecaster`` ``(rate, conf)`` after each
bin of one flash-crowd trace.  ``chip_smoke.py`` holds the port on the
card to it, rebuilding the dataset with the port's generators (JAX is not
installed there).  Here the fixture is held to the JAX package, and the
port to both on the CPU.

Tolerances: model outputs (log1p rates, float32) ``atol 2e-5, rtol
2e-5`` — the same float32 arithmetic summed in another order; val
log-MSE ``1e-4``; per-bin rates ``rtol 1e-4`` after ``expm1``.

Regenerate after an intentional change::

    PYTHONPATH=src python tests/test_torch_forecast.py --regen
"""
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.experiment import ExperimentSpec, run_experiment
from repro.forecast import baseline as ref_baseline
from repro.forecast import features as ref_features
from repro.forecast import model as ref_fmodel
from repro.models import params as ref_params
from repro.scenarios import build_scenario as ref_build

from repro_torch.forecast import baseline as port_baseline
from repro_torch.forecast import features as port_features
from repro_torch.forecast import model as port_fmodel
from repro_torch.models import params as port_params
from repro_torch.scenarios import build_scenario as port_build
from repro_torch.train import checkpoint as port_ckpt

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "torch_forecaster_golden"
CKPT = GOLDEN / "checkpoint"
EXPECTED = GOLDEN / "expected.npz"
FAMILIES = ("diurnal", "flash-crowd", "heavy-tail", "mix-ramp",
            "scale-stress", "multi-tenant")
SEEDS = 48
STEPS = 1000
TRAIN_SEED = 0
FLASH_SEED = 0          # the trace of the per-bin (rate, conf) sequence
OUT_TOL = dict(atol=2e-5, rtol=2e-5)


def dataset_digest(data) -> str:
    """sha256 over the dataset's four arrays (float64, C order)."""
    h = hashlib.sha256()
    for key in ("X_train", "y_train", "X_val", "y_val"):
        h.update(np.ascontiguousarray(data[key], np.float64).tobytes())
    return h.hexdigest()


def all_windows(data) -> np.ndarray:
    """Every window of the dataset as float32 log1p rates, train then val."""
    X = np.concatenate([data["X_train"], data["X_val"]])
    return np.log1p(X.astype(np.float32))


def per_bin(fc, rates) -> np.ndarray:
    """(rate, conf) after each bin of ``rates`` fed to a fresh forecaster."""
    out = []
    for r in rates:
        fc.observe_bin(r)
        out.append(fc.predict())
    return np.asarray(out, np.float64)


def build_fixture() -> dict:
    window = ref_features.WindowConfig()
    data = ref_features.make_dataset(FAMILIES, range(SEEDS), window)
    result = ref_fmodel.train_forecaster(
        data["X_train"], data["y_train"], window=window,
        X_val=data["X_val"], y_val=data["y_val"], seed=TRAIN_SEED,
        steps=STEPS, d_model=32)
    shutil.rmtree(CKPT, ignore_errors=True)
    ref_fmodel.save_forecaster(str(CKPT), result, step=STEPS)
    fc = ref_fmodel.load_forecaster(str(CKPT))
    outputs = np.asarray(ref_fmodel.apply_forecast(
        fc.params, jnp.asarray(all_windows(data)), fc.arch))
    rates = ref_features.bin_rates(
        ref_build("flash-crowd", seed=FLASH_SEED).arrival_time, window.bin_s)
    return {"outputs": outputs, "val_log_mse": np.float64(result.val_mse),
            "n_train": np.int64(data["X_train"].shape[0]),
            "digest": np.asarray(dataset_digest(data)),
            "flash_rates": rates, "per_bin": per_bin(fc, rates)}


def val_log_mse(outputs, data) -> float:
    n_train = data["X_train"].shape[0]
    y = np.log1p(data["y_val"].astype(np.float32))
    return float(np.mean((outputs[n_train:] - y) ** 2))


@pytest.fixture(scope="module")
def expected():
    with np.load(EXPECTED, allow_pickle=False) as z:
        return {key: z[key] for key in z.files}


@pytest.fixture(scope="module")
def ref_data():
    return ref_features.make_dataset(FAMILIES, range(SEEDS),
                                     ref_features.WindowConfig())


@pytest.fixture
def one_thread():
    """Per-bin forecasts are batch-1 passes of tiny ops; on a shared CPU
    torch's intra-op threads cost ten times the work."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def port_forecaster():
    return port_fmodel.load_forecaster(str(CKPT), device="cpu")


# -- the fixture against the JAX package --------------------------------------

def test_fixture_is_what_the_jax_package_computes(expected, ref_data):
    assert str(expected["digest"]) == dataset_digest(ref_data)
    assert int(expected["n_train"]) == ref_data["X_train"].shape[0] == 6543
    assert ref_data["X_val"].shape[0] == 2125
    fc = ref_fmodel.load_forecaster(str(CKPT))
    out = np.asarray(ref_fmodel.apply_forecast(
        fc.params, jnp.asarray(all_windows(ref_data)), fc.arch))
    np.testing.assert_allclose(out, expected["outputs"], atol=1e-6,
                               rtol=1e-6)
    assert abs(val_log_mse(out, ref_data)
               - float(expected["val_log_mse"])) < 1e-6
    rates = ref_features.bin_rates(
        ref_build("flash-crowd", seed=FLASH_SEED).arrival_time, 30.0)
    assert np.array_equal(rates, expected["flash_rates"])
    np.testing.assert_allclose(per_bin(fc, rates[:40]),
                               expected["per_bin"][:40], rtol=1e-6)


# -- the port against the fixture and the JAX package -------------------------

def test_port_dataset_equals_reference(expected, ref_data):
    data = port_features.make_dataset(FAMILIES, range(SEEDS),
                                      port_features.WindowConfig())
    for key in ref_data:
        assert data[key].dtype == ref_data[key].dtype, key
        assert np.array_equal(data[key], ref_data[key]), key
    assert dataset_digest(data) == str(expected["digest"])


def test_port_apply_forecast_matches_fixture(expected, ref_data,
                                             port_forecaster):
    fc = port_forecaster
    assert fc.device == torch.device("cpu")
    with torch.inference_mode():
        out = port_fmodel.apply_forecast(
            fc.params, torch.from_numpy(all_windows(ref_data)), fc.arch)
    assert out.dtype == torch.float32 and out.shape == (8668,)
    np.testing.assert_allclose(out.numpy(), expected["outputs"], **OUT_TOL)
    assert abs(val_log_mse(out.numpy(), ref_data)
               - float(expected["val_log_mse"])) < 1e-4


def test_port_per_bin_sequence_matches_fixture(expected, one_thread):
    fc = port_fmodel.load_forecaster(str(CKPT), device="cpu")
    rates = port_features.bin_rates(
        port_build("flash-crowd", seed=FLASH_SEED).arrival_time, 30.0)
    assert np.array_equal(rates, expected["flash_rates"])
    got = per_bin(fc, rates)
    want = expected["per_bin"]
    assert got.shape == want.shape and (got[:15] == 0.0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_load_forecaster_reads_a_jax_saved_checkpoint(tmp_path, one_thread):
    window = ref_features.WindowConfig()
    data = ref_features.make_dataset(("flash-crowd", "scale-stress"),
                                     range(4), window, n_jobs=300)
    result = ref_fmodel.train_forecaster(
        data["X_train"], data["y_train"], window=window, seed=1, steps=5,
        d_model=16, num_heads=4)
    ref_fmodel.save_forecaster(str(tmp_path / "ck"), result, step=5)
    want = ref_fmodel.load_forecaster(str(tmp_path / "ck"))
    got = port_fmodel.load_forecaster(str(tmp_path / "ck"), device="cpu")
    assert got.arch.d_model == 16 and got.arch.num_heads == 4
    assert got.window == port_features.WindowConfig()
    for path, leaf in port_params.leaves_with_paths(got.params):
        ref_leaf = want.params
        for key in path:
            ref_leaf = ref_leaf[key]
        assert leaf.dtype == torch.float32
        assert np.array_equal(leaf.numpy(), np.asarray(ref_leaf)), path
    rates = np.random.default_rng(0).gamma(2.0, 0.7, 40)
    np.testing.assert_allclose(per_bin(got, rates), per_bin(want, rates),
                               rtol=1e-4, atol=1e-6)


def test_apply_forecast_matches_jax_on_shared_params():
    ref_cfg = ref_fmodel.forecast_arch()
    tree = ref_params.init_params(jax.random.key(3),
                                  ref_fmodel.forecast_specs(ref_cfg))
    params = port_params.params_from_numpy(jax.tree.map(np.asarray, tree),
                                           device="cpu")
    x = np.log1p(np.random.default_rng(9).gamma(1.5, 1.0, (64, 16))).astype(
        np.float32)
    want = ref_fmodel.apply_forecast(tree, jnp.asarray(x), ref_cfg)
    got = port_fmodel.apply_forecast(params, torch.from_numpy(x),
                                     port_fmodel.forecast_arch())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fmodel.load_forecaster(str(CKPT))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_params.params_from_numpy({"w": np.zeros(2)})


# -- the numpy copies ---------------------------------------------------------

def test_features_equal_reference():
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0, 3000, 500))
    for n_bins in (None, 50, 200):
        assert np.array_equal(port_features.bin_rates(t, 30.0, n_bins),
                              ref_features.bin_rates(t, 30.0, n_bins))
    rates = rng.gamma(2.0, 1.0, 40)
    for cfg in (dict(), dict(history_bins=4, horizon_bins=3),
                dict(history_bins=40)):
        got = port_features.windowed_examples(
            rates, port_features.WindowConfig(**cfg))
        want = ref_features.windowed_examples(
            rates, ref_features.WindowConfig(**cfg))
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for seed in range(8):
        assert port_features.is_val_seed(seed) == ref_features.is_val_seed(seed)
    with pytest.raises(ValueError):
        port_features.WindowConfig(bin_s=0.0)


def test_baselines_equal_reference(ref_data):
    got, want = port_baseline.EwmaForecaster(), ref_baseline.EwmaForecaster()
    rates = np.random.default_rng(5).gamma(2.0, 0.5, 60)
    assert np.array_equal(per_bin(got, rates), per_bin(want, rates))
    fit = port_baseline.Ar1Baseline.fit(ref_data["X_train"],
                                        ref_data["y_train"])
    ref_fit = ref_baseline.Ar1Baseline.fit(ref_data["X_train"],
                                           ref_data["y_train"])
    assert (fit.mu, fit.phi) == (ref_fit.mu, ref_fit.phi)
    assert np.array_equal(fit.predict_batch(ref_data["X_val"]),
                          ref_fit.predict_batch(ref_data["X_val"]))
    assert port_baseline._EPS == ref_baseline._EPS


# -- the checkpoint reader ----------------------------------------------------

def test_checkpoint_reader_steps_and_recovery(tmp_path):
    specs = port_fmodel.forecast_specs(port_fmodel.forecast_arch())
    assert port_ckpt.latest_step(str(tmp_path / "missing")) is None
    shutil.copytree(CKPT, tmp_path / "ck")
    d = tmp_path / "ck"
    assert port_ckpt.latest_step(str(d)) == STEPS
    (d / "LATEST").unlink()
    shutil.copytree(d / f"step_{STEPS:08d}", d / "step_00000003")
    assert port_ckpt.all_steps(str(d)) == [3, STEPS]
    assert port_ckpt.latest_step(str(d)) == STEPS
    # A re-save that crashed after parking the old copy: heal on read.
    os.rename(d / f"step_{STEPS:08d}", d / f".step_{STEPS:08d}.old")
    (d / "LATEST").write_text(f"step_{STEPS:08d}")
    tree, step, extra = port_ckpt.restore(str(d), specs)
    assert step == STEPS and extra["history_bins"] == 16
    assert tree["block"]["w_q"].shape == (64, 2, 32)
    assert tree["block"]["w_q"].dtype == np.float32
    bad = port_fmodel.forecast_specs(port_fmodel.forecast_arch(d_model=16))
    with pytest.raises(ValueError, match="shape"):
        port_ckpt.restore(str(d), bad)


# -- end to end, through the reference's PredictiveAutoscaler -----------------

class Recording:
    """A forecaster that records every prediction of the one it wraps."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.seen = []

    def observe_bin(self, rate):
        self.inner.observe_bin(rate)

    def predict(self):
        out = self.inner.predict()
        self.seen.append(out)
        return out


def _predictive_flash(forecaster) -> dict:
    """``BENCH_sched.json`` ``predictive_flash``: flash-crowd, 600 jobs,
    seed 0, best-fit, non-binding rescheduler, predictive autoscaler."""
    spec = ExperimentSpec(scenario="flash-crowd", scenario_jobs=600,
                          scheduler="best-fit", rescheduler="non-binding",
                          autoscaler="predictive", forecaster_obj=forecaster,
                          seed=0)
    return run_experiment(spec).as_dict()


def test_predictive_flash_cell_same_with_either_forecaster(one_thread):
    ref = Recording(ref_fmodel.load_forecaster(str(CKPT)))
    port = Recording(port_fmodel.load_forecaster(str(CKPT), device="cpu"))
    want, got = _predictive_flash(ref), _predictive_flash(port)
    assert len(port.seen) == len(ref.seen) > 100
    np.testing.assert_allclose(np.asarray(port.seen), np.asarray(ref.seen),
                               rtol=1e-4, atol=1e-6)
    for key in ("cost", "mean_pending_s", "completed", "max_nodes"):
        assert got[key] == want[key], key


def test_forecast_path_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "from repro_torch.forecast.model import load_forecaster\n"
        f"fc = load_forecaster({str(CKPT)!r}, device='cpu')\n"
        "for r in range(20):\n"
        "    fc.observe_bin(0.1 * r)\n"
        "rate, conf = fc.predict()\n"
        "assert rate > 0 and 0 < conf <= 1\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_forecast.py --regen")
    GOLDEN.mkdir(parents=True, exist_ok=True)
    arrays = build_fixture()
    np.savez_compressed(EXPECTED, **arrays)
    size = sum(p.stat().st_size for p in GOLDEN.rglob("*") if p.is_file())
    print(f"wrote {GOLDEN} ({size} bytes); JAX val log-MSE "
          f"{float(arrays['val_log_mse']):.6f}")
