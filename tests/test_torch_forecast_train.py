"""PyTorch port, forecaster training: ``repro_torch.forecast.model``
(``train_forecaster``, ``save_forecaster``) against the JAX package's on
the CPU.

The port draws its initial parameters from a ``torch.Generator``, which
JAX's init cannot match, and its batch order from
``np.random.default_rng(seed)`` as the reference does.  So the training
loop is held to JAX's from JAX's own initial parameters (passed through
``params_from_numpy``): the first 20 losses within ``rtol 2e-6`` (the
same float32 updates, summed in other orders; 5e-7 seen).  With its own
init the port is held to the gate the forecaster exists for: trained on
the golden dataset at ``FORECAST_eval.json``'s configuration (6 families
x 48 seeds, 1000 steps, batch 64, lr 3e-3) it beats the AR(1) baseline
on the val split, as JAX's does.  At ``train_forecaster``'s 300-step
default neither package beats AR(1) on every seed, and on smaller
datasets (550 to 1065 training windows) neither beats it at all
(``scripts/forecast_steps_torch.py``), so the gate is taken where the
reference meets it.  A forecaster the port saves loads in the reference
and predicts the same, within the forecaster fixture's ``atol 2e-5,
rtol 2e-5``.
"""
import tempfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.forecast import baseline as ref_baseline
from repro.forecast import features as ref_features
from repro.forecast import model as ref_fmodel
from repro.models import params as ref_params

from repro_torch.forecast import model as port_fmodel
from repro_torch.models.params import params_from_numpy

FAMILIES = ("diurnal", "flash-crowd", "heavy-tail", "mix-ramp",
            "scale-stress", "multi-tenant")
SEEDS = 48
OUT_TOL = dict(atol=2e-5, rtol=2e-5)
LOSS_RTOL = 2e-6
EVAL_STEPS = 1000        # FORECAST_eval.json's steps


def _golden_data():
    return ref_features.make_dataset(FAMILIES, range(SEEDS),
                                     ref_features.WindowConfig())


@pytest.fixture(scope="module")
def golden():
    return _golden_data()


@pytest.fixture(scope="module")
def small():
    return ref_features.make_dataset(FAMILIES[:3], range(6),
                                     ref_features.WindowConfig())


@pytest.mark.parametrize("seed", [0, 3])
def test_loss_curve_follows_jax_from_shared_params(small, seed):
    window = ref_features.WindowConfig()
    ref = ref_fmodel.train_forecaster(small["X_train"], small["y_train"],
                                      window=window, seed=seed, steps=20)
    arch = ref_fmodel.forecast_arch()
    init = ref_params.init_params(jax.random.key(seed),
                                  ref_fmodel.forecast_specs(arch))
    port = port_fmodel.train_forecaster(
        small["X_train"], small["y_train"], window=window, seed=seed,
        steps=20, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, init), "cpu"))
    assert port.losses.shape == (20,)
    np.testing.assert_allclose(port.losses, ref.losses, rtol=LOSS_RTOL)


def test_torch_init_beats_ar1_on_golden_val(golden):
    res = port_fmodel.train_forecaster(
        golden["X_train"], golden["y_train"],
        window=ref_features.WindowConfig(), X_val=golden["X_val"],
        y_val=golden["y_val"], seed=0, steps=EVAL_STEPS, device="cpu")
    ar1 = ref_baseline.Ar1Baseline.fit(golden["X_train"], golden["y_train"])
    ar1_mse = float(np.mean(
        (np.log1p(np.maximum(ar1.predict_batch(golden["X_val"]), 0.0))
         - np.log1p(golden["y_val"])) ** 2))
    assert np.isfinite(res.losses).all()
    assert res.losses.shape == (EVAL_STEPS,)
    assert np.mean(res.losses[-10:]) < np.mean(res.losses[:10])
    assert res.val_mse < ar1_mse


def test_port_save_loads_in_reference_and_predicts_same(small):
    window = ref_features.WindowConfig()
    res = port_fmodel.train_forecaster(small["X_train"], small["y_train"],
                                       window=window, steps=5, device="cpu")
    X = np.log1p(small["X_val"].astype(np.float32))
    with tempfile.TemporaryDirectory() as d:
        port_fmodel.save_forecaster(d, res, step=5)
        ref = ref_fmodel.load_forecaster(d)
        back = port_fmodel.load_forecaster(d, device="cpu")
    assert ref.window == window and ref.arch.d_model == res.arch.d_model
    with torch.no_grad():
        want = port_fmodel.apply_forecast(res.params, torch.from_numpy(X),
                                          res.arch).numpy()
        again = port_fmodel.apply_forecast(back.params, torch.from_numpy(X),
                                           back.arch).numpy()
    got = np.asarray(ref_fmodel.apply_forecast(ref.params, jnp.asarray(X),
                                               ref.arch))
    np.testing.assert_allclose(got, want, **OUT_TOL)
    np.testing.assert_array_equal(again, want)


def test_train_forecaster_without_card_raises(small):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fmodel.train_forecaster(small["X_train"], small["y_train"],
                                     window=ref_features.WindowConfig(),
                                     steps=1)
