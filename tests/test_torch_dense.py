"""PyTorch port, the dense configs with parallel blocks and padded heads:
Command-R-35B (``parallel_block``: attention and MLP on one shared
LayerNorm) and Qwen1.5-32B (``pad_heads_to``: 40 heads padded to 48 in
prefill and training), the int8 KV cache (``kv_quant``), and
``ArchConfig.param_count`` / ``active_param_count``, all against the JAX
package on the CPU; and the golden fixture
``tests/data/torch_dense_serve_golden/expected.npz``.

Parameters cross as numpy arrays drawn by
``repro_torch.models.params.numpy_params``.  The fixture is a float32
twin at Command-R-35B's widths (d_model 8192, 64 query heads over 8 kv
heads of 128, d_ff 22528, LayerNorm, parallel blocks, tied embeddings,
RoPE theta 8e6) cut to 2 layers and a vocab of 512: it stores the seed,
the parameters' digest, JAX's logits for a 512-token prefill and 8
decode steps of 2 sequences and a JAX ``ServeEngine`` run's greedy
tokens.  Its 1.41 G float32 parameters take 5.6 GB, so the suite replays
it with the port and does not rebuild it with JAX (``--regen`` does).

Tolerances: float32 logits ``atol 1e-4, rtol 1e-3``, as the other serve
tests (sums over wide heads and several layers in other orders); in
bfloat16 within 2 % of the logits' scale (one bfloat16 ulp is 0.4 %, and
the two frameworks round at other places: the port keeps prefill's
softmax weights in float32 on the CPU where the reference rounds them);
the int8 cache's payloads ``==`` and its float16 scales ``==``; greedy
tokens ``==``.  CPU time of the file: ~110 s in one process, ~50 s of
it the fixture's replay (6 GB; ~38 s of that is numpy's draw of its
1.41 G parameters).

Regenerate the fixture after an intentional change::

    PYTHONPATH=src python tests/test_torch_dense.py --regen
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models import layers as ref_layers
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as port_layers
from repro_torch.models import params as port_params
from repro_torch.models import transformer as port_tf
from repro_torch.models.params import leaves_with_paths, numpy_params
from repro_torch.serve import engine as port_engine
from repro_torch.serve import golden

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_dense_serve_golden"
ARCHS = ("command-r-35b", "qwen1.5-32b")
F32_TOL = dict(atol=1e-4, rtol=1e-3)
BF16_REL = 2e-2
# count_params of the full configs' spec trees (the reference's), and the
# reference's param_count approximations.
FULL_PARAMS = {"command-r-35b": 30_283_546_624,
               "qwen1.5-32b": 35_197_096_960}
APPROX_PARAMS = {"command-r-35b": 30_282_874_880,
                 "qwen1.5-32b": 35_195_453_440}
SOURCES = {"command-r-35b": "hf:CohereForAI/c4ai-command-r-v01",
           "qwen1.5-32b": "hf:Qwen/Qwen1.5-32B"}


def _configs(name, dtype="float32", **overrides):
    ref = dataclasses.replace(ref_get_config(name, tiny=True), dtype=dtype,
                              **overrides)
    port = dataclasses.replace(get_config(name, tiny=True), dtype=dtype,
                               **overrides)
    return ref, port


def _shared(cfg, seed=2):
    tree = numpy_params(port_tf.model_specs(cfg), seed)
    return tree, port_params.params_from_numpy(
        tree, "cpu", dtype=port_tf.serving_dtype(cfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_int8_cache_close(tc, jc):
    """A whole model's int8 cache against JAX's: k and v enter
    ``quantize_kv`` after layers of float32 sums taken in another order,
    so a value on a rounding boundary may land one step away (1 of 4,608
    payload values seen in the engine test) and an amax one float16 ulp
    away; no more.  (Fed the same k and v, the payloads and scales are
    ``==``: the layer tests.)"""
    for key in ("k", "v"):
        got, want = tc[key].numpy().astype(int), np.asarray(jc[key]).astype(
            int)
        assert tc[key].dtype == torch.int8
        assert np.abs(got - want).max() <= 1, key
        assert (got != want).mean() <= 1e-3, key
    for key in ("k_scale", "v_scale"):
        assert tc[key].dtype == torch.float16
        np.testing.assert_allclose(tc[key].float().numpy(), _np(jc[key]),
                                   rtol=2.0 ** -10, atol=0)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# --------------------------------------------------------------------------- #
# configs, specs and counts
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tiny", [True, False])
@pytest.mark.parametrize("name", ARCHS)
def test_plan_specs_and_count_match_jax(name, tiny):
    """The spec tree's keys and shapes (a parallel block has no
    ``norm2``), the parameter count, and the fields the port carries."""
    ref_cfg, cfg = ref_get_config(name, tiny=tiny), get_config(name,
                                                               tiny=tiny)
    ref_specs = ref_tf.model_specs(ref_cfg)
    ref_shapes = {p: s.shape for p, s in leaves_with_paths(jax.tree.map(
        lambda s: s, ref_specs, is_leaf=ref_params.is_spec))}
    specs = port_tf.model_specs(cfg)
    assert {p: s.shape for p, s in leaves_with_paths(specs)} == ref_shapes
    n = port_params.count_params(specs)
    assert n == ref_params.count_params(ref_specs)
    block = specs["segments"][0]["block0"]
    assert ("norm2" in block) == (not cfg.parallel_block)
    for field in ("parallel_block", "pad_heads_to", "kv_quant", "norm_type",
                  "tie_embeddings", "qkv_bias", "rope_theta", "ce_chunk",
                  "train_accum"):
        assert getattr(cfg, field) == getattr(ref_cfg, field), field
    if not tiny:
        assert n == FULL_PARAMS[name] and cfg.source == SOURCES[name]


@pytest.mark.parametrize("tiny", [True, False])
@pytest.mark.parametrize("name", sorted(
    set(list_archs()) | set(ARCHS)))
def test_param_counts_equal_the_reference(name, tiny):
    """``param_count`` and ``active_param_count`` of every config the
    port registers, full and tiny, ``==`` the reference's."""
    assert name in ref_list_archs()
    ref_cfg, cfg = ref_get_config(name, tiny=tiny), get_config(name,
                                                               tiny=tiny)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    if name in APPROX_PARAMS and not tiny:
        assert cfg.param_count() == APPROX_PARAMS[name]
    if cfg.n_experts:
        assert cfg.active_param_count() < cfg.param_count()


def test_init_params_draws_a_large_leaf_in_pieces(monkeypatch):
    """A leaf of more than ``_INIT_PIECE`` values is drawn a run of
    leading rows at a time, each cast into the preallocated leaf, with the
    std of the whole leaf's fan-in: its values are those draws in order.
    A leaf at or below the size is one draw, as before."""
    monkeypatch.setattr(port_params, "_INIT_PIECE", 1000)
    specs = {"a": port_params.ParamSpec((9, 10, 20), (None,) * 3),
             "b": port_params.ParamSpec((10, 100), (None, None))}
    got = port_params.init_params(specs, torch.Generator().manual_seed(5),
                                  "cpu", dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    want_a = torch.cat([torch.randn((n, 10, 20), generator=g)
                        * (90 ** -0.5) for n in (5, 4)])
    want_b = torch.randn((10, 100), generator=g) * (10 ** -0.5)
    assert torch.equal(got["a"], want_a.bfloat16())
    assert torch.equal(got["b"], want_b.bfloat16())


# --------------------------------------------------------------------------- #
# the model against JAX
# --------------------------------------------------------------------------- #

# The reference's entry points jitted (the same functions; eager, their
# op-by-op dispatch takes seconds a step on the CPU).
_REF_PREFILL = jax.jit(ref_tf.prefill, static_argnums=(2, 3))
_REF_DECODE = jax.jit(ref_tf.decode_step, static_argnums=(3,))
_REF_TRAIN = jax.jit(ref_tf.forward_train, static_argnums=(2,))
_REF_DECODE_ATTN = jax.jit(ref_layers.decode_attention, static_argnums=(2,),
                           static_argnames=("window",))


def _serve_logits(prefill, decode_step, params, cfg, tokens, wrap, P=16,
                  steps=8):
    """Prefill P tokens, then ``steps`` decode steps: the logit rows."""
    lg, st = prefill(params, {"tokens": wrap(tokens[:, :P])}, cfg, 64)
    out = [lg]
    for i in range(P, P + steps):
        lg, st = decode_step(params, wrap(tokens[:, i:i + 1]), st, cfg)
        out.append(lg)
    return out, st


# (arch, overrides): the two twins as registered, with the int8 cache,
# and padded: Qwen's MHA twin 4 -> 6 heads, Command-R's GQA twin (8 query
# heads over 2 kv heads, repeated before padding) 8 -> 12.
MODEL_CASES = [("command-r-35b", {}), ("qwen1.5-32b", {}),
               ("command-r-35b", {"kv_quant": True}),
               ("qwen1.5-32b", {"kv_quant": True}),
               ("qwen1.5-32b", {"pad_heads_to": 6}),
               ("command-r-35b", {"pad_heads_to": 12})]


def _case_id(case):
    name, over = case
    return name + "".join(f"-{k}={v}" for k, v in over.items())


@pytest.mark.parametrize("case", MODEL_CASES, ids=_case_id)
def test_forward_train_matches_jax(case):
    name, overrides = case
    ref_cfg, cfg = _configs(name, **overrides)
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40))
    jl, _ = _REF_TRAIN(tree, {"tokens": jnp.asarray(tokens)}, ref_cfg)
    tl, aux = port_tf.forward_train(params,
                                    {"tokens": torch.from_numpy(tokens)}, cfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_case_id)
def test_prefill_and_8_decode_steps_match_jax(case):
    """Float32 prefill logits and 8 decode steps' logits; with the int8
    cache, the payloads and float16 scales of the cache after the last
    step as JAX's (``_assert_int8_cache_close``)."""
    name, overrides = case
    ref_cfg, cfg = _configs(name, **overrides)
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24))
    want, jst = _serve_logits(_REF_PREFILL, _REF_DECODE, tree, ref_cfg,
                              tokens, jnp.asarray)
    got, tst = _serve_logits(port_tf.prefill, port_tf.decode_step, params,
                             cfg, tokens, torch.from_numpy)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)
    jc, tc = jst[0]["block0"], tst[0]["block0"]
    assert sorted(tc) == sorted(jc)
    if cfg.kv_quant:
        _assert_int8_cache_close(tc, jc)


@pytest.mark.parametrize("name", ARCHS)
def test_bfloat16_twin_within_2_percent(name):
    """bfloat16 twins: prefill, 8 decode steps and teacher forcing within
    2 % of the logits' scale of JAX's."""
    ref_cfg, cfg = _configs(name, "bfloat16")
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 24))
    want, _ = _serve_logits(_REF_PREFILL, _REF_DECODE, tree, ref_cfg,
                            tokens, jnp.asarray)
    got, _ = _serve_logits(port_tf.prefill, port_tf.decode_step, params,
                           cfg, tokens, torch.from_numpy)
    jl, _ = _REF_TRAIN(tree, {"tokens": jnp.asarray(tokens)}, ref_cfg)
    tl, _ = port_tf.forward_train(params,
                                  {"tokens": torch.from_numpy(tokens)}, cfg)
    for g, w in [*zip(got, want), (tl, jl)]:
        assert g.dtype == torch.bfloat16
        w = _np(w)
        assert np.abs(_np(g) - w).max() <= BF16_REL * np.abs(w).max()


def test_padded_heads_leave_the_real_heads_unchanged():
    """Zero heads attend to nothing and are sliced off: the padded
    attention core's real heads equal the unpadded core's (within float32
    rounding: on the CPU the plain version's sums are blocked by head
    count; on the card the kernel computes each head apart, and
    ``chip_smoke.py`` holds them ``==``)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 20, h, 8)).astype(
        np.float32)) for h in (8, 2, 2))
    plain = port_layers.attention_from_qkv(q, k, v)
    padded = port_layers.attention_from_qkv(q, k, v, pad_heads_to=12)
    assert padded.shape == plain.shape
    torch.testing.assert_close(padded, plain, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------- #
# the int8 KV cache
# --------------------------------------------------------------------------- #

def test_quantize_kv_rounds_with_the_float32_scale_half_to_even():
    """Two of the reference's traps, pinned: the payload is rounded with
    the float32 scale although the float16 one is stored (a batch where
    the two round differently), and rounding is half to even."""
    x = np.random.default_rng(0).standard_normal((4096, 128)).astype(
        np.float32)
    jq, js = ref_layers.quantize_kv(jnp.asarray(x))
    tq, ts = port_layers.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    scale16 = ts.float().numpy()[:, None]
    with_f16 = np.clip(np.round(x / scale16), -127, 127)
    assert (with_f16 != tq.numpy()).any()
    # max-abs 127 gives the scale 1 exactly: halves round to even
    halves = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5]],
                      np.float32)
    jq, _ = ref_layers.quantize_kv(jnp.asarray(halves))
    tq, ts = port_layers.quantize_kv(torch.from_numpy(halves))
    assert float(ts) == 1.0
    assert tq.tolist() == [[127, 0, 2, 2, 0, -2, 4, -126]]
    assert np.array_equal(tq.numpy(), np.asarray(jq))


def _identity_out(cfg, tree):
    """w_o as the identity (d_model = heads x head_dim in the twins), so
    the attention layer returns its core's output as it is."""
    H, hd = cfg.num_heads, cfg.head_dim_
    tree = dict(tree)
    tree["w_o"] = np.eye(H * hd, dtype=np.float32).reshape(H, hd, H * hd)
    return tree


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("name", ARCHS)
def test_quantised_decode_matches_jax_at_ragged_positions(name, window):
    """``decode_attention`` with the int8 cache from per-slot positions 0,
    5 and 11 (a ring of 8 wraps with ``window``): each step's output in
    float32 against JAX's, the payloads and float16 scales ``==``.  With
    ``w_o`` the identity the output is the attention core's: rounding
    the scale-folded softmax weights to bfloat16 (the reference's third
    trap, whatever the activation dtype) moves it far more than the
    frameworks' float32 sums differ."""
    ref_cfg, cfg = _configs(name, kv_quant=True)
    tree = _identity_out(cfg, numpy_params(port_layers.attn_specs(cfg), 6))
    p = port_params.params_from_numpy(tree, "cpu")
    B, S, pos0 = 3, 16, np.array([0, 5, 11], np.int32)
    jc = ref_layers.init_kv_cache(ref_cfg, B, S, window=window)
    jc["pos"] = jnp.asarray(pos0)
    tc = port_layers.init_kv_cache(cfg, B, S, window=window, device="cpu")
    tc["pos"].copy_(torch.from_numpy(pos0))
    rng = np.random.default_rng(7)
    for _ in range(12):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jo, jc = _REF_DECODE_ATTN(tree, jnp.asarray(x), ref_cfg, jc,
                                  window=window)
        to, tc = port_layers.decode_attention(p, torch.from_numpy(x), cfg,
                                              tc, window=window)
        want, scale = _np(jo), float(np.abs(_np(jo)).max())
        assert np.abs(_np(to) - want).max() <= 1e-5 * scale
        for key in ("k", "v", "k_scale", "v_scale", "pos"):
            assert np.array_equal(tc[key].numpy(), np.asarray(jc[key])), key
    # the same read without the bfloat16 rounding of the weights
    G, hd = cfg.q_per_kv, cfg.head_dim_
    q, _, _ = port_layers._project_qkv(p, torch.from_numpy(x), cfg,
                                       (tc["pos"] - 1).reshape(B, 1), True)
    qg = q.reshape(B, cfg.num_kv_heads, G, hd)
    s = torch.einsum("bkgh,bksh->bkgs", qg, tc["k"].float()) \
        * tc["k_scale"].float()[:, :, None, :]
    valid = _valid(tc["pos"] - 1, tc["k"].shape[2], window)
    w = torch.softmax(s.masked_fill(~valid[:, None, None, :],
                                    port_layers.NEG_INF), -1)
    unrounded = torch.einsum("bkgs,bksh->bkgh",
                             w * tc["v_scale"].float()[:, :, None, :],
                             tc["v"].float()).reshape(B, 1, -1)
    assert np.abs(_np(unrounded) - want).max() > 1e-4 * scale


def _valid(pos, S, window):
    ids = torch.arange(S)[None, :]
    pb = pos.reshape(-1, 1)
    if window:
        return pb - torch.remainder(pb - ids, S) >= 0
    return ids <= pb


def test_windowed_prefill_past_the_window_leaves_int8_scales_at_zero():
    """The reference's quirk, reproduced: a local-attention layer with
    ``kv_quant`` whose prompt overruns its window gets its ring's int8
    payload but never its scales (transformer.py:255-262), so its decode
    reads scales of 0.  RecurrentGemma's twin (window 8), a 13-token
    prompt: the local layer's payloads nonzero and as JAX's, its
    scales 0 in both, and the logits of 4 decode steps as JAX's."""
    ref_cfg, cfg = _configs("recurrentgemma-9b", kv_quant=True)
    tree = jax.tree.map(np.asarray, ref_params.init_params(
        jax.random.key(2), ref_tf.model_specs(ref_cfg)))
    params = port_params.params_from_numpy(tree, "cpu",
                                           dtype=port_tf.serving_dtype(cfg))
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 17))
    jlg, jst = _REF_PREFILL(tree, {"tokens": jnp.asarray(tokens[:, :13])},
                            ref_cfg, 64)
    tlg, tst = port_tf.prefill(params, {"tokens": torch.from_numpy(
        tokens[:, :13])}, cfg, 64)
    j = [b.mixer for b in cfg.layer_plan()[0].blocks].index("local_attn")
    jl, tl = jst[0][f"block{j}"], tst[0][f"block{j}"]
    assert tl["k"].shape[-2] == cfg.sliding_window < 13
    assert bool(tl["k"].any()) and bool(tl["v"].any())
    _assert_int8_cache_close(tl, jl)
    for key in ("k_scale", "v_scale"):
        assert not tl[key].any() and not np.asarray(jl[key]).any(), key
    for i in range(13, 17):
        np.testing.assert_allclose(_np(tlg), _np(jlg), **F32_TOL)
        jlg, jst = _REF_DECODE(tree, jnp.asarray(tokens[:, i:i + 1]), jst,
                               ref_cfg)
        tlg, tst = port_tf.decode_step(
            params, torch.from_numpy(tokens[:, i:i + 1]), tst, cfg)
    np.testing.assert_allclose(_np(tlg), _np(jlg), **F32_TOL)


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root, as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [0, 1])
def test_chip_int8_check_passes_the_cache_and_fails_planted_faults(seed):
    """``chip_smoke.py``'s int8 check (phase 24) on the CPU, float32, at
    Qwen's head dim 128 (d_model 512, 2 layers, a 512-token prompt): the
    int8 prefill writes ``quantize_kv`` of the unquantised cache, the
    int8 decode stays within what that cache moved by half an int8 step
    on every element does, and both planted scale faults exceed that
    limit."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(
        get_config("qwen1.5-32b", tiny=True), d_model=512, num_heads=4,
        num_kv_heads=4, head_dim=128, pad_heads_to=0, d_ff=1024,
        num_layers=2, vocab_size=4096, dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    params = port_params.init_params(port_tf.model_specs(cfg), gen, "cpu",
                                     dtype=torch.float32)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, 512).astype(np.int32)
    r = cs._kv_quant_consistency(torch, np, port_tf, port_layers, params,
                                 cfg, prompt,
                                 np.random.default_rng(seed + 1))
    assert r["prefill_equal"]
    assert 0 < r["max_abs_err"] <= r["limit"], r
    assert r["faults_exceed_limit"], r


# --------------------------------------------------------------------------- #
# the engine and the CLIs
# --------------------------------------------------------------------------- #

def _engine_run(module, cfg, params, prompts, reqs, **kw):
    clock, sleep = golden.virtual_clock()
    eng = module.ServeEngine(cfg, params, module.EngineConfig(
        num_slots=3, cache_len=48), clock=clock, **kw)
    rs = [module.Request(uid=i, prompt=prompts[i], max_new_tokens=new,
                         submitted_at=at)
          for i, (_, new, at) in enumerate(reqs)]
    metrics = module.run_server(eng, rs, log=lambda s: None, clock=clock,
                                sleep=sleep)
    return rs, metrics, eng


@pytest.mark.parametrize("case", MODEL_CASES[:4], ids=_case_id)
def test_engine_greedy_tokens_equal_jax(case):
    """Staggered admission on 3 slots (slots at ragged depths in every
    decode step): greedy tokens, stamps and metrics ``==`` JAX's engine;
    with the int8 cache, its payloads and scales as JAX's."""
    name, overrides = case
    ref_cfg, cfg = _configs(name, **overrides)
    tree, params = _shared(cfg, seed=3)
    reqs = ((9, 6, 0.0), (4, 8, 0.0), (13, 5, 0.5), (6, 4, 2.0))
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _, _ in reqs]
    want, wm, jeng = _engine_run(ref_engine, ref_cfg, tree, prompts, reqs)
    got, gm, teng = _engine_run(port_engine, cfg, params, prompts, reqs,
                                device="cpu")
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, g.uid
        assert (g.first_token_at, g.done_at) == (w.first_token_at,
                                                 w.done_at)
    assert [gm[k] for k in golden.METRIC_KEYS] == \
        [wm[k] for k in golden.METRIC_KEYS]
    if cfg.kv_quant:
        _assert_int8_cache_close(teng.states[0]["block0"],
                                 jeng.states[0]["block0"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    metrics = serve_cli.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--slots", "2",
                              "--max-new-tokens", "4",
                              "--mean-interarrival-s", "0"])
    assert metrics["requests"] == 3 and metrics["tokens"] == 12
    assert "[serve]" in capsys.readouterr().out


class _Parsed(Exception):
    pass


def _default_arch(main, monkeypatch) -> str:
    """The ``--arch`` default of a CLI's ``main``, read from its parser
    (``parse_args`` stops the run)."""
    seen = {}

    def parse_args(self, *args, **kwargs):
        seen["arch"] = self.get_default("arch")
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Parsed):
            main()
    return seen["arch"]


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_cli_default_arch_is_the_reference_one(cli, monkeypatch):
    """The port's serve and train CLIs default to the arch the
    reference's do (deepseek-7b)."""
    import importlib
    ref = importlib.import_module(f"repro.launch.{cli}")
    port = importlib.import_module(f"repro_torch.launch.{cli}")
    want = _default_arch(ref.main, monkeypatch)
    assert want == "deepseek-7b"
    assert _default_arch(port.main, monkeypatch) == want


# --------------------------------------------------------------------------- #
# the golden fixture
# --------------------------------------------------------------------------- #

def _to_jax(tree) -> None:
    """Each numpy leaf replaced by a JAX array in place, so the numpy
    arrays are freed one by one."""
    for key, val in list(tree.items() if isinstance(tree, dict)
                         else enumerate(tree)):
        if isinstance(val, (dict, list)):
            _to_jax(val)
        else:
            tree[key] = jnp.asarray(val)


def build_fixture() -> dict:
    """The fixture's arrays, computed by the JAX package on the CPU from
    the parameters and inputs of ``golden.DENSE``."""
    fixture = golden.DENSE
    ref_cfg = golden.config(fixture, ref_get_config(fixture.arch))
    tree = golden.parameters(fixture)
    digest = port_params.tree_digest(tree)
    _to_jax(tree)
    tokens, prompts = golden.inputs(fixture)
    lg, *decode = golden.logits(fixture, _REF_PREFILL, _REF_DECODE, tree,
                                ref_cfg, tokens, jnp.asarray)
    clock, sleep = golden.virtual_clock()
    eng = ref_engine.ServeEngine(ref_cfg, tree, ref_engine.EngineConfig(
        num_slots=fixture.slots, cache_len=fixture.cache_len), clock=clock)
    reqs = golden.requests(fixture, ref_engine, prompts)
    metrics = ref_engine.run_server(eng, reqs, log=lambda s: None,
                                    clock=clock, sleep=sleep)
    width = max(len(r.tokens) for r in reqs)
    return {
        "seed": np.asarray(fixture.seed), "params_digest": np.asarray(digest),
        "tokens": tokens, "prefill_logits": np.asarray(lg),
        "decode_logits": np.stack([np.asarray(d) for d in decode]),
        "engine_prompts": np.concatenate(prompts),
        "engine_tokens": np.asarray(
            [r.tokens + [-1] * (width - len(r.tokens)) for r in reqs],
            np.int32),
        "engine_stamps": np.asarray([(r.first_token_at, r.done_at)
                                     for r in reqs]),
        "engine_metrics": np.asarray([metrics[k]
                                      for k in golden.METRIC_KEYS])}


@pytest.fixture(scope="module")
def committed():
    with np.load(GOLDEN / "expected.npz", allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_fixture_holds_the_helpers_inputs(committed):
    """The committed inputs are the helpers' (so the replay and a
    rebuild read the same), at Command-R's widths cut to 2 layers."""
    fixture = golden.DENSE
    cfg = golden.config(fixture)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.num_layers, cfg.parallel_block) == (8192, 64, 8, 22528, 2,
                                                    True)
    tokens, prompts = golden.inputs(fixture)
    assert np.array_equal(committed["tokens"], tokens)
    assert np.array_equal(committed["engine_prompts"],
                          np.concatenate(prompts))
    assert committed["prefill_logits"].shape == (2, 512)
    assert committed["decode_logits"].shape == (fixture.decode, 2, 512)
    assert (GOLDEN / "expected.npz").stat().st_size < 1_500_000


def test_port_reproduces_fixture_on_cpu(committed):
    report = golden.replay(golden.DENSE, committed, "cpu")
    print(report)
    assert report["digest_ok"]
    assert report["worst_share_of_tol"] <= 1.0, report
    assert report["engine_tokens_equal"] and report["engine_stamps_equal"]
    assert report["engine_metrics_equal"] and report["ok"]


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_dense.py --regen")
    GOLDEN.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN / "expected.npz", **build_fixture())
    size = (GOLDEN / "expected.npz").stat().st_size
    print(f"wrote {GOLDEN / 'expected.npz'} ({size} bytes)")
