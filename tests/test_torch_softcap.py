"""PyTorch port, attention logit soft-capping (``cfg.attn_logit_softcap``)
against the JAX package on the CPU, and the golden fixture
``tests/data/torch_softcap_serve_golden/expected.npz``.

The reference caps the float32 logits to ``cap * tanh(s / cap)`` after
the scale and before the mask (``repro/models/layers.py:167-176``
``_softcap`` in ``_mha``, and ``:362`` in ``decode_attention``).  The
Pallas flash kernel has no cap, so the oracle of every case is the
reference's model layer: ``_mha``, ``attention``, ``decode_attention``,
``cross_attention``, ``prefill`` / ``decode_step`` and the ``Trainer``.
Inputs are drawn from seeds with numpy; parameters cross as
``models.params.numpy_params`` trees.

Every case sets the cap at the scale of its own logits (unit-scale
logits under a cap of 50 hardly bend: ``tanh(x/50)*50 ~ x - x^3/7500``)
and asserts that the capped reference differs from the uncapped one by
at least 10x its tolerance, so that a port ignoring the cap fails it.

Tolerances: flash ``TOL`` of ``tests/test_torch_flash_attention.py``
(float32 ``atol 2e-5, rtol 2e-5``; bfloat16 ``2e-2``: the reference
rounds the softmax weights to bfloat16, the plain version does not); the
attention layer in float32 ``atol 1e-4`` and in bfloat16 within 2 % of
the output's scale, as that file's layer tests; decode and cross
attention as the dense and Whisper tests hold them (float32 ``atol
1e-5, rtol 1e-4``); the Whisper twin's logits ``atol 1e-4, rtol 1e-3``
(``golden.TOL``); the dense twin's ``Trainer`` losses ``rtol 1e-5`` and
grad norms ``rtol 1e-4``, as ``tests/test_torch_train.py``.  CPU time
of the file: ~35 s in one process.  The suite neither rebuilds the
fixture with JAX (``--regen`` does, ~30 s) nor replays it (up to half
a minute on a CPU; the Whisper fixture's replay covers the same model
uncapped): ``chip_smoke.py`` phase 34 and ``tests/test_torch_gpu.py``
replay it on the card.

Regenerate the fixture after an intentional change::

    PYTHONPATH=src python tests/test_torch_softcap.py --regen
"""
import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import torch_serve_fixture  # noqa: E402
from test_torch_flash_attention import TOL, _bf16_kernel_emulation  # noqa: E402
from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.train import checkpoint as ref_ckpt
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro.train import trainer as ref_trainer
from repro.train import train_step as ref_ts

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.models import layers as port_layers
from repro_torch.models import params as port_params
from repro_torch.models import transformer as port_tf
from repro_torch.models.params import numpy_params
from repro_torch.serve import golden
from repro_torch.train import data as port_data
from repro_torch.train import optimizer as port_opt
from repro_torch.train.trainer import Trainer, TrainerConfig

GOLDEN = Path(__file__).resolve().parent / "data" / \
    "torch_softcap_serve_golden"
LAYER_TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_REL = 2e-2
TRAIN_TOL = dict(loss=1e-5, grad_norm=1e-4)
VACUITY = 10     # the cap must move the reference by 10x the tolerance


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bent(capped, uncapped, atol, rtol=0.0):
    """The largest move of the reference under the cap, as a share of the
    tolerance ``atol + rtol |uncapped|``."""
    capped, uncapped = _np(capped), _np(uncapped)
    return float((np.abs(capped - uncapped)
                  / (atol + rtol * np.abs(uncapped))).max())


def _configs(name, dtype="float32", **overrides):
    ref = dataclasses.replace(ref_get_config(name, tiny=True), dtype=dtype,
                              **overrides)
    port = dataclasses.replace(get_config(name, tiny=True), dtype=dtype,
                               **overrides)
    return ref, port


def _uncapped(cfg):
    return dataclasses.replace(cfg, attn_logit_softcap=0.0)


# --------------------------------------------------------------------------- #
# the plain flash version and the bf16 kernel's arithmetic against _mha
# --------------------------------------------------------------------------- #

# (B, Hq, Hkv, T, S, hd, causal, window, cap): causal, a window, GQA, no
# mask with T != S.  q is drawn at 3x unit scale, so the logits (q
# pre-scaled by hd**-0.5, as the models call the kernel) are ~N(0, 9).
FLASH_CASES = [
    (1, 4, 4, 96, 96, 64, True, 0, 2.0),
    (2, 2, 2, 80, 80, 16, True, 24, 1.5),
    (1, 8, 2, 70, 70, 64, True, 0, 3.0),
    (1, 2, 2, 20, 90, 16, False, 0, 2.0),
]


def _flash_inputs(case, dtype, seed=0):
    """q (pre-scaled), k, v as JAX (B, T, H, hd) with k, v repeated to
    every query head, the reference's mask, and torch (B, H, T, hd)."""
    B, Hq, Hkv, T, S, hd, causal, window, _ = case
    rng = np.random.default_rng(seed)
    q = (3.0 * rng.standard_normal((B, Hq, T, hd)) * hd ** -0.5).astype(
        np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
            for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    G = Hq // Hkv
    jq, jk, jv = (jnp.asarray(a.transpose(0, 2, 1, 3)).astype(jdt)
                  for a in (q, k, v))
    jk, jv = (jnp.repeat(t, G, axis=2) for t in (jk, jv))
    pos = lambda n: jnp.broadcast_to(jnp.arange(n), (B, n))  # noqa: E731
    mask = ref_layers._mask(pos(T), pos(S), causal, window)
    return (jq, jk, jv, mask), [torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)]


def _ref_mha(jin, cap):
    cfg = dataclasses.replace(ref_get_config("deepseek-7b", tiny=True),
                              attn_logit_softcap=cap)
    return jnp.swapaxes(ref_layers._mha(*jin, cfg), 1, 2)   # (B, H, T, hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_flash_matches_reference_mha(case, dtype):
    """``flash_attention`` on CPU tensors (the plain version, no launch)
    with a cap against the reference's ``_mha`` on the same q, k, v and
    mask, at the flash tolerances."""
    causal, window, cap = case[6:]
    jin, (tq, tk, tv) = _flash_inputs(case, dtype)
    want = _ref_mha(jin, cap)
    assert _bent(want, _ref_mha(jin, 0.0), **TOL[dtype]) >= VACUITY
    before = port_flash.launches
    got = port_flash.flash_attention(tq, tk, tv, causal=causal,
                                     window=window, sm_scale=1.0,
                                     softcap=cap)
    assert port_flash.launches == before
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_default_scale_and_nonpositive_caps():
    """The cap applies after the default ``sm_scale`` (hd**-0.5 of the
    unscaled q), and a cap <= 0 is none, as the reference's
    ``_softcap``."""
    case = FLASH_CASES[0]
    jin, (tq, tk, tv) = _flash_inputs(case, "float32", seed=4)
    hd, cap = case[5], case[8]
    got = port_flash.flash_attention(tq / hd ** -0.5, tk, tv, softcap=cap)
    np.testing.assert_allclose(_np(got), _np(_ref_mha(jin, cap)),
                               **TOL["float32"])
    plain = port_flash.flash_attention(tq, tk, tv, sm_scale=1.0)
    for off in (0.0, -1.0):
        assert torch.equal(port_flash.flash_attention(
            tq, tk, tv, sm_scale=1.0, softcap=off), plain)


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root, as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", [
    (1, 4, 4, 384, 1500, 64, False, 0, "bfloat16"),
    (1, 4, 1, 512, 512, 256, True, 200, "bfloat16")])
def test_row_scaled_flash_tolerance_rejects_a_wrong_cap(case):
    """The card's capped bf16 cases (``chip_smoke.py`` phase 9 and
    ``tests/test_torch_gpu.py``) spread the softmax over many keys, so
    their rows lie far below unit scale; the tolerance scaled to each
    row's rms (``chip_smoke._row_scaled_check``) must reject a capped
    logit off by 3 %, here the plain version with its capped logits
    scaled by 1.03 (``cap' tanh(s' / cap') = 1.03 cap tanh(s / cap)`` for
    ``s' = 1.03 s``, ``cap' = 1.03 cap``) at the phase's inputs and cap."""
    cs = _chip_smoke()
    causal, window, dtype = case[6:]
    q, k, v = cs._capped_inputs(torch, np, case, "cpu")
    cap, scale = cs.FLASH_SOFTCAP, case[5] ** -0.5
    kw = dict(causal=causal, window=window)
    want = port_flash.flash_attention_plain(q, k, v, softcap=cap, **kw)
    off = port_flash.flash_attention_plain(q, k, v, sm_scale=1.03 * scale,
                                           softcap=1.03 * cap, **kw)
    within, worst = cs._row_scaled_check(off.float(), want.float(),
                                         cs.FLASH_TOL[dtype])
    assert not within and worst > 2 * cs.FLASH_TOL[dtype]["atol"]


@pytest.mark.parametrize("case", [
    (1, 4, 4, 96, 96, 64, True, 0, 2.0),
    (1, 8, 2, 200, 200, 64, True, 70, 2.0),     # window edge inside a tile
    (1, 2, 1, 50, 130, 16, False, 0, 1.0),     # a partial last key tile
])
def test_bf16_kernel_emulation_matches_reference_mha(case):
    """The bf16 kernel's arithmetic with the cap
    (``_bf16_kernel_emulation``: the tanh from a base-2 exponential on
    every tile before the mask) within the bf16 tolerance of ``_mha``.
    hd**-0.5 is a power of two here, so the emulation's unscaled bf16 q
    and the reference's pre-scaled one are the same values."""
    causal, window, cap = case[6:]
    hd = case[5]
    jin, (tq, tk, tv) = _flash_inputs(case, "bfloat16", seed=7)
    want = _ref_mha(jin, cap)
    assert _bent(want, _ref_mha(jin, 0.0), **TOL["bfloat16"]) >= VACUITY
    got = _bf16_kernel_emulation(tq.float().mul(hd ** 0.5).bfloat16(), tk,
                                 tv, causal=causal, window=window,
                                 softcap=cap)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bfloat16"])


def test_gradient_through_the_cap_matches_jax():
    """The wrapper's backward (the plain version's autograd, through
    ``cap * (1 - tanh^2)``) against ``jax.vjp`` of ``_mha`` for a seeded
    cotangent, float32."""
    case = FLASH_CASES[2]
    causal, window, cap = case[6:]
    jin, (tq, tk, tv) = _flash_inputs(case, "float32", seed=5)
    G = case[1] // case[2]
    cot = np.random.default_rng(6).standard_normal(tq.shape).astype(
        np.float32)
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = port_flash.flash_attention(*ins, causal=causal, window=window,
                                     sm_scale=1.0, softcap=cap)
    got = torch.autograd.grad(out, ins, torch.from_numpy(cot))

    def ref_grads(c):
        def ref(q, k, v):
            return _ref_mha((q, jnp.repeat(k, G, 2), jnp.repeat(v, G, 2),
                             jin[3]), c)
        jq, jk, jv = (jnp.asarray(t.numpy().transpose(0, 2, 1, 3))
                      for t in (tq, tk, tv))
        return jax.vjp(ref, jq, jk, jv)[1](jnp.asarray(cot))
    want = ref_grads(cap)
    assert _bent(want[0], ref_grads(0.0)[0], 1e-4) >= VACUITY
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w).transpose(0, 2, 1, 3),
                                   atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------- #
# the layers against JAX
# --------------------------------------------------------------------------- #

def _attn_parts(name, dtype, cap, seed, x_scale, T=20, B=2):
    ref_cfg, cfg = _configs(name, dtype, attn_logit_softcap=cap)
    tree = numpy_params(port_layers.attn_specs(cfg), seed)
    p = port_params.params_from_numpy(tree, "cpu")
    x = (x_scale * np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model))).astype(np.float32)
    return ref_cfg, cfg, tree, p, x


@pytest.mark.parametrize("dtype,window", [("float32", 0), ("float32", 8),
                                          ("bfloat16", 8)])
def test_attention_layer_matches_jax(dtype, window):
    """``attention`` (projections, RoPE, the capped kernel core, output)
    of RecurrentGemma's twin (4 query heads over 1 kv head) with a cap of
    1 on logits of scale ~3 (x at 2x unit scale)."""
    ref_cfg, cfg, tree, p, x = _attn_parts("recurrentgemma-9b", dtype, 1.0,
                                           1, 2.0)
    T = x.shape[1]
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))

    def ref(c):
        return ref_layers.attention(tree, jx, c, positions=jnp.asarray(pos),
                                    window=window)
    want = ref(ref_cfg)
    got = port_layers.attention(p, torch.from_numpy(x).to(getattr(
        torch, dtype)), cfg, positions=torch.from_numpy(pos.copy()),
        window=window)
    if dtype == "float32":
        assert _bent(want, ref(_uncapped(ref_cfg)), 1e-4) >= VACUITY
        np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    else:
        tol = BF16_REL * float(np.abs(_np(want)).max())
        assert _bent(want, ref(_uncapped(ref_cfg)), tol) >= VACUITY
        assert np.abs(_np(got) - _np(want)).max() <= tol


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_decode_attention_matches_jax(cache, window):
    """10 decode steps into a cache of 16 (a ring of 8 with ``window``),
    capped after the int8 cache's key scale and before the mask: the
    bf16 cache with bf16 activations (within 2 % of the output's scale),
    the int8 cache (``kv_quant``) with float32 activations (``atol
    1e-5``, payloads and scales ``==``)."""
    quant = cache == "int8"
    dtype = "float32" if quant else "bfloat16"
    ref_cfg, cfg, tree, p, _ = _attn_parts("recurrentgemma-9b", dtype, 1.0,
                                           3, 2.0)
    if quant:
        ref_cfg, cfg = (dataclasses.replace(c, kv_quant=True)
                        for c in (ref_cfg, cfg))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    caches = {c: ref_layers.init_kv_cache(c, 2, 16, window=window)
              for c in (ref_cfg, _uncapped(ref_cfg))}
    tc = port_layers.init_kv_cache(cfg, 2, 16, window=window, dtype=tdt,
                                   device="cpu")
    rng = np.random.default_rng(3)
    bent = 0.0
    for _ in range(10):
        x = (2.0 * rng.standard_normal((2, 1, cfg.d_model))).astype(
            np.float32)
        outs = {}
        for c in caches:
            outs[c], caches[c] = ref_layers.decode_attention(
                tree, jnp.asarray(x).astype(jdt), c, caches[c],
                window=window)
        want, unc = outs[ref_cfg], outs[_uncapped(ref_cfg)]
        got, tc = port_layers.decode_attention(
            p, torch.from_numpy(x).to(tdt), cfg, tc, window=window)
        assert got.dtype == tdt
        if quant:
            np.testing.assert_allclose(_np(got), _np(want), **STEP_TOL)
            bent = max(bent, _bent(want, unc, **STEP_TOL))
        else:
            tol = BF16_REL * float(np.abs(_np(want)).max())
            assert np.abs(_np(got) - _np(want)).max() <= tol
            bent = max(bent, _bent(want, unc, tol))
    assert bent >= VACUITY
    jc = caches[ref_cfg]
    for key in jc:
        assert np.array_equal(_np(tc[key]), _np(jc[key])), key


@pytest.mark.parametrize("T", [1, 7])
def test_cross_attention_matches_jax(T):
    """Whisper's cross attention over the encoder's k, v with a cap: T = 7
    (the flash path, no mask, T != S) and T = 1 (the decode path),
    float32, on logits of scale ~3 under a cap of 1."""
    ref_cfg, cfg = _configs("whisper-medium", attn_logit_softcap=1.0)
    tree = numpy_params(port_layers.cross_attn_specs(cfg), 6)
    p = port_params.params_from_numpy(tree, "cpu")
    rng = np.random.default_rng(3)
    enc = (2.0 * rng.standard_normal((2, cfg.encoder_seq, cfg.d_model))
           ).astype(np.float32)
    x = (2.0 * rng.standard_normal((2, T, cfg.d_model))).astype(np.float32)
    jkv = ref_layers.encode_cross_kv(tree, jnp.asarray(enc), ref_cfg)
    want = ref_layers.cross_attention(tree, jnp.asarray(x), ref_cfg, jkv)
    unc = ref_layers.cross_attention(tree, jnp.asarray(x),
                                     _uncapped(ref_cfg), jkv)
    assert _bent(want, unc, **STEP_TOL) >= VACUITY
    got = port_layers.cross_attention(
        p, torch.from_numpy(x), cfg,
        port_layers.encode_cross_kv(p, torch.from_numpy(enc), cfg))
    np.testing.assert_allclose(_np(got), _np(want), **STEP_TOL)


# --------------------------------------------------------------------------- #
# the models against JAX
# --------------------------------------------------------------------------- #

def test_whisper_twin_prefill_and_decode_match_jax():
    """Whisper's TINY twin with a cap of 0.5 (its logits' largest is
    ~1): a 12-token prefill over the frames and 8 decode steps, float32
    logits within ``golden.TOL`` of JAX's, through every capped place
    (the encoder, causal self attention, cross attention at prefill, and
    decode self and cross attention)."""
    ref_cfg, cfg = _configs("whisper-medium", attn_logit_softcap=0.5)
    tree = numpy_params(port_tf.model_specs(cfg), 2)
    params = port_params.params_from_numpy(tree, "cpu")
    frames = np.random.default_rng(9).standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 20))
    fx = dataclasses.replace(golden.WHISPER, prefill=12, decode=8,
                             cache_len=32)

    def run(prefill, decode, p, c, wrap, f):
        return golden.logits(fx, prefill, decode, p, c, tokens, wrap,
                             {"audio_embeds": f})
    ref = (torch_serve_fixture.REF_PREFILL, torch_serve_fixture.REF_DECODE,
           tree)
    want = run(*ref, ref_cfg, jnp.asarray, jnp.asarray(frames))
    unc = run(*ref, _uncapped(ref_cfg), jnp.asarray, jnp.asarray(frames))
    assert max(_bent(w, u, **golden.TOL)
               for w, u in zip(want, unc)) >= VACUITY
    got = run(port_tf.prefill, port_tf.decode_step, params, cfg,
              torch.from_numpy, torch.from_numpy(frames))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **golden.TOL)


def _ref_trainer(cfg, opt, dc):
    return ref_trainer.Trainer(cfg, opt, dc, ref_trainer.TrainerConfig(
        total_steps=3, checkpoint_every=0, log_every=1),
        log_fn=lambda s: None)


def test_dense_twin_trainer_3_steps_match_jax():
    """DeepSeek-7B's TINY twin with a cap of 0.25 (its attention logits'
    largest is ~0.3): the port's ``Trainer`` resumed from the reference's
    initial train state (a JAX checkpoint at step 0) runs 3 AdamW steps
    whose losses and grad norms equal the reference ``Trainer``'s, so the
    gradient through the cap is ``jax.grad``'s."""
    ref_cfg, cfg = _configs("deepseek-7b", attn_logit_softcap=0.25)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    dc = dict(batch_size=2, seq_len=16, accum=1)
    want = _ref_trainer(ref_cfg, ref_opt.OptimizerConfig(**kw),
                        ref_data.DataConfig(**dc))
    unc = _ref_trainer(_uncapped(ref_cfg), ref_opt.OptimizerConfig(**kw),
                       ref_data.DataConfig(**dc))
    want.run(), unc.run()
    assert max(_bent(a["loss"], b["loss"], 0, TRAIN_TOL["loss"])
               for a, b in zip(want.history, unc.history)) >= VACUITY
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.CheckpointManager(d).save(0, ref_ts.init_train_state(
            jax.random.key(0), ref_cfg))
        got = Trainer(cfg, port_opt.OptimizerConfig(**kw),
                      port_data.DataConfig(**dc), TrainerConfig(
                          total_steps=3, checkpoint_every=0,
                          checkpoint_dir=d, log_every=1),
                      log_fn=lambda s: None, device="cpu")
        assert got.step == 0
        assert got.run()["completed"] == 1.0
    assert len(got.history) == len(want.history) == 3
    for a, b in zip(want.history, got.history):
        for key, rel in TRAIN_TOL.items():
            assert b[key] == pytest.approx(a[key], rel=rel), key


# --------------------------------------------------------------------------- #
# the golden fixture
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def committed():
    with np.load(GOLDEN / "expected.npz", allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_fixture_holds_the_helpers_inputs_and_bends(committed):
    """The fixture is Whisper-medium's float32 twin at full width (2 + 2
    layers, 1500 frames) with ``golden.SOFTCAP_CAP``, on the helpers'
    inputs.  Its parameters, frames and tokens are the Whisper fixture's
    (the cap draws nothing), so the uncapped reference is that fixture:
    the cap moves JAX's logits by at least 10x ``golden.TOL``."""
    fixture = golden.SOFTCAP
    cfg = golden.config(fixture)
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim_, cfg.num_layers,
            cfg.encoder_layers, cfg.encoder_seq, cfg.attn_logit_softcap) \
        == (1024, 16, 64, 2, 2, 1500, golden.SOFTCAP_CAP)
    tokens, prompts = golden.inputs(fixture)
    assert np.array_equal(committed["tokens"], tokens)
    assert np.array_equal(committed["engine_prompts"],
                          np.concatenate(prompts))
    with np.load(GOLDEN.parent / "torch_whisper_serve_golden" /
                 "expected.npz", allow_pickle=False) as z:
        plain = {k: z[k] for k in z.files}
    for key in ("seed", "params_digest", "extra_digest", "tokens"):
        assert np.array_equal(committed[key], plain[key]), key
    assert max(_bent(committed[k], plain[k], **golden.TOL)
               for k in ("prefill_logits", "decode_logits")) >= VACUITY


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_softcap.py --regen")
    GOLDEN.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN / "expected.npz",
                        **torch_serve_fixture.build(golden.SOFTCAP))
    size = (GOLDEN / "expected.npz").stat().st_size
    print(f"wrote {GOLDEN / 'expected.npz'} ({size} bytes)")
