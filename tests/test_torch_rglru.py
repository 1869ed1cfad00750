"""PyTorch port, RG-LRU: ``repro_torch.kernels.rglru_scan`` and
``repro_torch.models.rglru`` (with the conv's decode step) against the
JAX package.

The same numpy inputs go through the JAX oracle
``repro.kernels.ref.rglru_scan_ref``, the Pallas kernel in interpret
mode and the port's plain version (the function the CUDA kernel
computes; the kernel itself runs only on the card,
``tests/test_torch_gpu.py``).  Tolerances: float32 ``atol 1e-5, rtol
1e-5`` for the scan (the sequential walk of every version, FMA-free on
the CPU), ``atol 1e-5, rtol 1e-4`` for the block (projections, and the
reference's associative scan in another order), and for bfloat16 a
bound stated at each test.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config
from repro.kernels import ref as ref_kernels
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
from repro.models import conv as ref_conv
from repro.models import params as ref_params
from repro.models import rglru as ref_rglru
from repro.models import transformer as ref_tf

from repro_torch.configs import get_config
from repro_torch.kernels import rglru_scan as port_scan
from repro_torch.models import conv as port_conv
from repro_torch.models import params as port_params
from repro_torch.models import rglru as port_rglru
from repro_torch.models import transformer as port_tf

SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK_TOL = dict(atol=1e-5, rtol=1e-4)


def _ab(B, T, R, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 0.999, (B, T, R)).astype(np.float32),
            (0.3 * rng.standard_normal((B, T, R))).astype(np.float32))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("shape", [(2, 128, 256), (1, 512, 1024)])
def test_plain_scan_matches_oracle_and_pallas(shape):
    a, b = _ab(*shape)
    got = port_scan.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    want = ref_kernels.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    pallas = pallas_rglru(jnp.asarray(a), jnp.asarray(b), block_r=128,
                          chunk_t=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **SCAN_TOL)


@pytest.mark.parametrize("shape", [(3, 1, 7), (2, 37, 100), (1, 300, 33)])
def test_plain_scan_matches_oracle_at_ragged_shapes(shape):
    a, b = _ab(*shape, seed=2)
    got = port_scan.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b))
    want = ref_kernels.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


def test_plain_scan_dtypes():
    """bfloat16 inputs walk a float32 carry and come out in a's dtype;
    ``out_dtype`` rounds the float32 walk once (the model path's cast)."""
    a, b = _ab(2, 40, 64, seed=4)
    ja, jb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (a, b))
    ta, tb = (torch.from_numpy(x).bfloat16() for x in (a, b))
    got = port_scan.rglru_scan(ta, tb)
    assert got.dtype == torch.bfloat16
    want = ref_kernels.rglru_scan_ref(ja, jb)
    # the same float32 walk rounded once: equal but for float32 ties
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-2, rtol=1e-2)
    f32_walk = port_scan.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    to_bf16 = port_scan.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                                   out_dtype=torch.bfloat16)
    assert torch.equal(to_bf16, f32_walk.bfloat16())
    before = port_scan.launches
    port_scan.rglru_scan(ta, tb)
    assert port_scan.launches == before          # CPU: no kernel


@pytest.mark.parametrize("T, chunked", [(768, True), (769, False)])
def test_kernel_choice_by_input_size(T, chunked):
    """Inputs (a and b) of up to 24 MB take the chunked kernel, larger
    ones the ring kernel; the choice follows the bytes, so bfloat16
    inputs of twice the steps choose alike.  The CPU path launches
    neither."""
    for dtype, steps in ((torch.float32, T), (torch.bfloat16, 2 * T)):
        a = torch.empty((1, steps, 4096), dtype=dtype)
        assert port_scan.takes_chunked_kernel(a) == chunked
    before = (port_scan.launches, port_scan.chunked_launches)
    a, b = (torch.from_numpy(x) for x in _ab(1, 3, 8))
    port_scan.rglru_scan(a, b)
    assert (port_scan.launches, port_scan.chunked_launches) == before


def test_softplus_is_jaxs_everywhere():
    x = np.linspace(-60, 60, 2001).astype(np.float32)
    np.testing.assert_allclose(
        port_rglru.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def _setup(dtype, seed=0):
    ref_cfg = dataclasses.replace(ref_get_config("recurrentgemma-9b",
                                                 tiny=True), dtype=dtype)
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", tiny=True),
                              dtype=dtype)
    tree = ref_params.init_params(jax.random.key(seed),
                                  {"m": ref_rglru.rglru_specs(ref_cfg)})["m"]
    # non-zero biases and conv bias, so their casts are exercised
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, tree)
    for key in ("b_a", "b_x"):
        tree[key] = (0.1 * rng.standard_normal(tree[key].shape)).astype(
            np.float32)
    tree["conv"]["b"] = (0.1 * rng.standard_normal(
        tree["conv"]["b"].shape)).astype(np.float32)
    p = port_params.params_from_numpy(tree, "cpu",
                                      dtype=port_tf.serving_dtype(cfg))
    B, T = 2, 12
    x = (0.5 * rng.standard_normal((B, T, cfg.d_model))).astype(np.float32)
    return ref_cfg, cfg, tree, p, x


def test_lambda_init_matches_reference_range():
    cfg = get_config("recurrentgemma-9b", tiny=True)
    g = torch.Generator().manual_seed(0)
    lam = port_params.init_params({"l": port_rglru.rglru_specs(cfg)["lam"]},
                                  g, "cpu")["l"]
    a = torch.exp(-8.0 * port_rglru.softplus(lam))
    assert lam.dtype == torch.float32
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    ref = ref_params.init_params(
        jax.random.key(0), {"l": ref_rglru.rglru_specs(
            ref_get_config("recurrentgemma-9b", tiny=True))["lam"]})["l"]
    ref_a = np.exp(-8.0 * np.asarray(jax.nn.softplus(ref)))
    assert ref_a.min() >= 0.9 - 1e-6 and ref_a.max() <= 0.999 + 1e-6


def test_apply_rglru_matches_jax_float32():
    ref_cfg, cfg, tree, p, x = _setup("float32")
    want = ref_rglru.apply_rglru(tree, jnp.asarray(x), ref_cfg)
    got = port_rglru.apply_rglru(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_apply_rglru_matches_jax_bfloat16():
    """bfloat16 activations, as served: within 2 % of the output scale
    (bfloat16 rounds after every op in both, XLA's fusions keep some
    intermediates in float32)."""
    ref_cfg, cfg, tree, p, x = _setup("bfloat16", seed=1)
    assert p["w_in"].dtype == torch.bfloat16
    assert p["w_a"].dtype == p["lam"].dtype == torch.float32
    want = _f32(ref_rglru.apply_rglru(
        tree, jnp.asarray(x).astype(jnp.bfloat16), ref_cfg))
    got = port_rglru.apply_rglru(p, torch.from_numpy(x).bfloat16(), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want,
                               atol=2e-2 * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_state_then_decode_match_jax(dtype):
    """``_rglru_prefill``'s state (h rounded to the activation dtype by the
    scan, then widened to float32; the conv tail in the activation dtype),
    then decode steps from it with the float32 state, as the engine runs
    them (the conv tail widened to float32 on insert)."""
    ref_cfg, cfg, tree, p, x = _setup(dtype, seed=2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    j_out, j_st = ref_tf._rglru_prefill(tree, jx[:, :8], ref_cfg)
    t_out, t_st = port_tf._rglru_prefill(p, tx[:, :8], cfg)
    assert t_st["h"].dtype == torch.float32 and t_st["conv"].dtype == tdt
    tol = BLOCK_TOL if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(_f32(t_out), _f32(j_out), **tol)
    np.testing.assert_allclose(_f32(t_st["h"]), _f32(j_st["h"]), **tol)
    np.testing.assert_allclose(_f32(t_st["conv"]), _f32(j_st["conv"]), **tol)
    if dtype == "bfloat16":
        # the float32 state holds a bfloat16-rounded value
        assert torch.equal(t_st["h"], t_st["h"].bfloat16().float())
    # decode from the widened state, float32 as the engine holds it
    j_dec = {"h": j_st["h"], "conv": j_st["conv"].astype(jnp.float32)}
    t_dec = {"h": t_st["h"], "conv": t_st["conv"].float()}
    for t in range(8, 12):
        j_y, j_dec = ref_rglru.apply_rglru_decode(tree, jx[:, t:t + 1],
                                                  ref_cfg, j_dec)
        t_y, t_dec = port_rglru.apply_rglru_decode(p, tx[:, t:t + 1], cfg,
                                                   t_dec)
        assert t_dec["h"].dtype == t_dec["conv"].dtype == torch.float32
        assert t_y.dtype == tdt
        np.testing.assert_allclose(_f32(t_y), _f32(j_y), **tol)
        np.testing.assert_allclose(_f32(t_dec["h"]), _f32(j_dec["h"]), **tol)


def test_conv_step_matches_jax_and_widens():
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((4, 16)).astype(np.float32),
         "b": rng.standard_normal(16).astype(np.float32)}
    x = rng.standard_normal((3, 1, 16)).astype(np.float32)
    st = rng.standard_normal((3, 3, 16)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = port_params.params_from_numpy(p, "cpu")
    for x_dt, st_dt in (("float32", "float32"), ("bfloat16", "float32"),
                        ("bfloat16", "bfloat16")):
        j_out, j_st = ref_conv.causal_conv1d_step(
            jp, jnp.asarray(x).astype(getattr(jnp, x_dt)),
            jnp.asarray(st).astype(getattr(jnp, st_dt)))
        t_out, t_st = port_conv.causal_conv1d_step(
            tp, torch.from_numpy(x).to(getattr(torch, x_dt)),
            torch.from_numpy(st).to(getattr(torch, st_dt)))
        assert str(t_out.dtype).split(".")[1] == str(j_out.dtype)
        assert str(t_st.dtype).split(".")[1] == str(j_st.dtype)
        # float32 windows sum four products in another order; a bfloat16
        # window rounds the sum to bfloat16
        tol = dict(atol=2e-2, rtol=1e-2) if st_dt == "bfloat16" else \
            dict(atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(_f32(t_out), _f32(j_out), **tol)
        np.testing.assert_allclose(_f32(t_st), _f32(j_st), rtol=0, atol=0)
    init = port_conv.conv_decode_init(2, 16, 4, dtype=torch.float32)
    assert init.shape == (2, 3, 16) and not init.any()
