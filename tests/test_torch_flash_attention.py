"""PyTorch port, flash attention: ``repro_torch.kernels.flash_attention``
and the attention layer of ``repro_torch.models.layers`` against the JAX
package.

The same numpy inputs go through the JAX oracle
``repro.kernels.ref.attention_ref``, the Pallas kernel in interpret mode
and the port's plain version (the function the CUDA kernel computes; the
kernel itself runs only on the card, ``tests/test_torch_gpu.py``).
Tolerances: the JAX kernel test's (``tests/test_kernels.py:22``),
float32 ``atol 2e-5, rtol 2e-5`` and bfloat16 ``2e-2`` (sums in another
order, outputs rounded); the attention layer in float32 ``atol 1e-4``
(projections and RoPE around the core).  An emulation of the bfloat16
kernel's arithmetic (weights rounded to bf16 for p.v) is held to the
oracle and the Pallas kernel at the bfloat16 tolerance.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config
from repro.kernels import ref as ref_kernels
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as ref_layers
from repro.models import params as ref_params

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.models import layers as port_layers
from repro_torch.models import params as port_params

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _qkv(B, Hq, Hkv, T, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, T, hd)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, hd)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, hd)).astype(np.float32))


def _both(arrays, dtype):
    """The arrays as JAX and torch inputs of ``dtype`` (bfloat16 rounds
    the same float32 values in both)."""
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# tests/test_kernels.py:26-67: the causal sweep, windows, non-causal.
SWEEP = [
    # (B, Hq, Hkv, T, hd, causal, window)
    (1, 1, 1, 128, 64, True, 0),
    (2, 4, 4, 256, 64, True, 0),
    (2, 8, 2, 256, 128, True, 0),
    (1, 6, 1, 384, 256, True, 0),
    (2, 2, 2, 256, 64, True, 64),
    (2, 2, 2, 256, 64, True, 128),
    (1, 2, 2, 128, 64, False, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWEEP)
def test_plain_matches_oracle_and_pallas(case, dtype):
    B, Hq, Hkv, T, hd, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, Hq, Hkv, T, T, hd), dtype)
    got = port_flash.flash_attention(tq, tk, tv, causal=causal,
                                     window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = ref_kernels.attention_ref(jq, jk, jv, causal=causal,
                                     window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    pallas = pallas_flash(jq, jk, jv, causal=causal, window=window,
                          interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])


@pytest.mark.parametrize("case", [
    # T not a multiple of any block, a window wider than T, T = 1, S > T
    (1, 4, 1, 200, 200, 32, True, 0),
    (2, 2, 1, 77, 77, 48, True, 300),
    (1, 3, 1, 1, 1, 16, True, 8),
    (1, 2, 2, 50, 90, 32, False, 20),
])
def test_plain_matches_oracle_at_ragged_shapes(case):
    B, Hq, Hkv, T, S, hd, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, Hq, Hkv, T, S, hd, seed=3),
                                       "float32")
    got = port_flash.flash_attention_plain(tq, tk, tv, causal=causal,
                                           window=window, sm_scale=0.3)
    want = ref_kernels.attention_ref(jq, jk, jv, causal=causal,
                                     window=window, sm_scale=0.3)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


def _bf16_kernel_emulation(q, k, v, *, causal, window, block_k=64,
                           softcap=0.0):
    """The bfloat16 CUDA kernel's arithmetic in plain PyTorch (float32):
    per tile of 64 keys, logits from the bf16 q and k scaled by
    ``sm_scale * log2(e)`` (one float32 product, as the kernel forms
    it), hidden logits at -2**30, a base-2 online softmax with float32
    running max and sum, the weights rounded to bf16 after the running
    max for p.v (float32 sums), l over the unrounded weights, and
    ``o = acc / max(l, 1e-30)`` in q's dtype.  With ``softcap > 0`` the
    logits are capped as the kernel caps them, on every tile before the
    mask: ``cap_log2 * (1 - 2 / (1 + 2^(s * c)))`` with the float32
    constants ``c = 2 sm_scale log2(e) / softcap`` and ``cap_log2 =
    softcap log2(e)``, which is ``log2(e) softcap tanh(sm_scale s /
    softcap)``."""
    B, Hq, T, hd = q.shape
    _, Hkv, S, _ = k.shape
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    log2e = f32(np.log2(np.e))
    c = f32(hd ** -0.5) * log2e
    if softcap > 0:
        c = f32(2.0) * f32(hd ** -0.5) * log2e / f32(softcap)
        cap_log2 = f32(softcap) * log2e
    qf = q.float().reshape(B, Hkv, Hq // Hkv, T, hd)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    mask = port_flash._mask(T, S, causal, window, q.device)
    m = torch.full((B, Hkv, Hq // Hkv, T), port_flash.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for kt in range(0, S, block_k):
        x = (qf @ kf[..., kt:kt + block_k, :].transpose(-1, -2)) * c
        if softcap > 0:
            x = cap_log2 - 2 * cap_log2 / (1 + torch.exp2(x))
        x = x.masked_fill(~mask[:, kt:kt + block_k], port_flash.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + (
            p.bfloat16().float() @ vf[..., kt:kt + block_k, :])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, T, hd).to(q.dtype)


@pytest.mark.parametrize("case", SWEEP + [(1, 8, 1, 384, 256, True, 100)])
def test_bf16_kernel_numerics_match_oracle_and_pallas(case):
    """Rounding the softmax weights to bf16 per key tile (and exp2 on
    prescaled logits), as the bf16 kernel does, stays within the bf16
    tolerance of the float32-weight oracle and the Pallas kernel; the
    last case is the serving path's MQA at hd 256 with a window edge
    inside a tile."""
    B, Hq, Hkv, T, hd, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, Hq, Hkv, T, T, hd, seed=7),
                                       "bfloat16")
    got = _bf16_kernel_emulation(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    want = ref_kernels.attention_ref(jq, jk, jv, causal=causal,
                                     window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["bfloat16"])
    pallas = pallas_flash(jq, jk, jv, causal=causal, window=window,
                          interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL["bfloat16"])


def test_cpu_tensors_take_the_plain_version():
    (_, _, _), (tq, tk, tv) = _both(_qkv(1, 2, 1, 16, 16, 8), "float32")
    before = port_flash.launches
    got = port_flash.flash_attention(tq, tk, tv, window=4)
    assert port_flash.launches == before
    assert torch.equal(got, port_flash.flash_attention_plain(tq, tk, tv,
                                                             window=4))


def _attn_setup(dtype, seed=0):
    ref_cfg = dataclasses.replace(ref_get_config("recurrentgemma-9b",
                                                 tiny=True), dtype=dtype)
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", tiny=True),
                              dtype=dtype)
    tree = ref_params.init_params(jax.random.key(seed),
                                  {"a": ref_layers.attn_specs(ref_cfg)})["a"]
    ntree = jax.tree.map(np.asarray, tree)
    p = port_params.params_from_numpy(ntree, "cpu")
    B, T = 2, 20
    x = (0.5 * np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model))).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    return ref_cfg, cfg, tree, p, x, pos


@pytest.mark.parametrize("window", [0, 8])
def test_attention_layer_matches_jax_float32(window):
    """The layer (projections, RoPE, scale, kernel core, output) on shared
    parameters; T = 20 > window = 8 exercises the sliding mask."""
    ref_cfg, cfg, tree, p, x, pos = _attn_setup("float32")
    want = ref_layers.attention(tree, jnp.asarray(x), ref_cfg,
                                positions=jnp.asarray(pos), window=window)
    got = port_layers.attention(p, torch.from_numpy(x), cfg,
                                positions=torch.from_numpy(pos.copy()),
                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_attention_layer_matches_jax_bfloat16():
    """bfloat16: the reference rounds the softmax weights to bfloat16
    before the weighted sum, the plain version that the CPU runs does not
    (the bf16 CUDA kernel does); outputs within 2 % of the output's
    scale."""
    ref_cfg, cfg, tree, p, x, pos = _attn_setup("bfloat16", seed=1)
    want = _f32(ref_layers.attention(
        tree, jnp.asarray(x).astype(jnp.bfloat16), ref_cfg,
        positions=jnp.asarray(pos), window=8))
    got = port_layers.attention(p, torch.from_numpy(x).bfloat16(), cfg,
                                positions=torch.from_numpy(pos.copy()),
                                window=8)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_f32(got), want, atol=2e-2 * scale, rtol=0)


@pytest.mark.parametrize("window", [0, 8])
def test_padded_heads_attention_matches_jax(window):
    """``pad_heads_to`` 8 on the twin's 4 query heads over 1 kv head: k
    and v repeated to every query head, zero heads appended, the kernel
    run on 8 heads and the 4 real ones kept, against the reference's
    padded ``attention`` in float32."""
    ref_cfg, cfg, tree, p, x, pos = _attn_setup("float32", seed=2)
    ref_cfg, cfg = (dataclasses.replace(c, pad_heads_to=8)
                    for c in (ref_cfg, cfg))
    assert cfg.num_heads == 4 and cfg.num_kv_heads == 1
    want = ref_layers.attention(tree, jnp.asarray(x), ref_cfg,
                                positions=jnp.asarray(pos), window=window)
    got = port_layers.attention(p, torch.from_numpy(x), cfg,
                                positions=torch.from_numpy(pos.copy()),
                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("window", [0, 8])
def test_quantised_decode_attention_matches_jax(window):
    """``kv_quant``: 10 decode steps into an int8 cache of 16 (a ring of 8
    with ``window``) against the reference's quantised
    ``decode_attention``: outputs in float32 at ``atol 1e-5``, the int8
    payloads and float16 scales ``==``."""
    ref_cfg, cfg, tree, p, _, _ = _attn_setup("float32", seed=3)
    ref_cfg, cfg = (dataclasses.replace(c, kv_quant=True)
                    for c in (ref_cfg, cfg))
    jc = ref_layers.init_kv_cache(ref_cfg, 2, 16, window=window)
    tc = port_layers.init_kv_cache(cfg, 2, 16, window=window, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(10):
        x = (0.5 * rng.standard_normal((2, 1, cfg.d_model))).astype(
            np.float32)
        jo, jc = ref_layers.decode_attention(tree, jnp.asarray(x), ref_cfg,
                                             jc, window=window)
        to, tc = port_layers.decode_attention(p, torch.from_numpy(x), cfg,
                                              tc, window=window)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                                   rtol=1e-5)
    for key in ("k", "v", "k_scale", "v_scale", "pos"):
        assert tc[key].dtype == getattr(torch, str(jc[key].dtype)), key
        assert np.array_equal(tc[key].numpy(), np.asarray(jc[key])), key
