"""PyTorch port, the encoder-decoder family: Whisper-medium (an encoder
tower over frame embeddings, cross attention in every decoder block,
sinusoidal positions) against the JAX package on the CPU, and the golden
fixture ``tests/data/torch_whisper_serve_golden/expected.npz``.

Parameters cross as numpy arrays drawn by
``repro_torch.models.params.numpy_params``; the modality input
``audio_embeds`` is drawn with numpy and fed to both packages.  The
fixture is a float32 twin at Whisper-medium's widths (d_model 1024, 16
heads of 64, d_ff 4096, LayerNorm, GeLU, biases, tied embeddings) cut
to 2 encoder + 2 decoder layers and a vocab of 512, its encoder over all
1500 frames: it stores the seed and the digests of the parameters and of
the frames, JAX's logits for a 64-token prefill and 8 decode steps of 2
sequences and a JAX ``ServeEngine`` run's greedy tokens.

Tolerances: float32 logits ``atol 1e-4, rtol 1e-3`` (the other serve
tests'); the layers in float32 ``atol 1e-5, rtol 1e-4``; the sinusoids
within two float32 ulps of their largest angle (the angle ``pos * freq``
is a float32 product of an ``exp`` that the two libraries may round one
ulp apart: 1.2e-4 seen at position 1499, 2.4e-4 at 4095); in bfloat16
within 2 % of the output's scale (one bfloat16 ulp is 0.4 %, and the
port's plain flash keeps prefill's softmax weights in float32 on the CPU
where the reference rounds them); greedy tokens ``==``. CPU time of the
file: ~35 s in one process, ~11 s of it the fixture rebuilt with JAX.

Regenerate the fixture after an intentional change::

    PYTHONPATH=src python tests/test_torch_whisper.py --regen
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import torch_serve_fixture  # noqa: E402
from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as port_layers
from repro_torch.models import params as port_params
from repro_torch.models import transformer as port_tf
from repro_torch.models.params import leaves_with_paths, numpy_params
from repro_torch.serve import engine as port_engine
from repro_torch.serve import golden

NAME = "whisper-medium"
GOLDEN = Path(__file__).resolve().parent / "data" / \
    "torch_whisper_serve_golden"
F32_TOL = dict(atol=1e-4, rtol=1e-3)
LAYER_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_REL = 2e-2
FULL_PARAMS = 758_837_248          # count_params of the full spec tree
APPROX_PARAMS = 757_752_832        # the reference's param_count



def _sin_atol(max_pos: int) -> float:
    """Two float32 ulps of the largest angle (frequency 1 at ``max_pos``),
    and 1e-6 for the ``sin`` / ``cos`` themselves."""
    return 2 * max_pos * 2.0 ** -23 + 1e-6


_REF_TRAIN = jax.jit(ref_tf.forward_train, static_argnums=(2,))
_REF_CROSS = jax.jit(ref_layers.cross_attention, static_argnums=(2,))


def _configs(dtype="float32", **overrides):
    ref = dataclasses.replace(ref_get_config(NAME, tiny=True), dtype=dtype,
                              **overrides)
    port = dataclasses.replace(get_config(NAME, tiny=True), dtype=dtype,
                               **overrides)
    return ref, port


def _shared(cfg, seed=2):
    tree = numpy_params(port_tf.model_specs(cfg), seed)
    return tree, port_params.params_from_numpy(
        tree, "cpu", dtype=port_tf.serving_dtype(cfg))


def _frames(cfg, B=2, seed=9):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _plan(plan):
    return [(seg.repeats, [(b.mixer, b.mlp, b.cross_attn)
                           for b in seg.blocks]) for seg in plan]


# --------------------------------------------------------------------------- #
# configs, specs and counts
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tiny", [True, False])
def test_plans_specs_and_counts_match_jax(tiny):
    """``layer_plan`` (dense blocks with cross attention), the
    ``encoder_plan``, the spec tree's keys and shapes (``norm_cross``,
    ``cross``, the ``encoder`` subtree), ``count_params``,
    ``param_count`` and ``active_param_count``, and the fields the port
    carries."""
    ref_cfg, cfg = ref_get_config(NAME, tiny=tiny), get_config(NAME,
                                                               tiny=tiny)
    assert _plan(cfg.layer_plan()) == _plan(ref_cfg.layer_plan())
    assert _plan(cfg.encoder_plan()) == _plan(ref_cfg.encoder_plan())
    assert cfg.layer_plan()[0].blocks[0].cross_attn
    ref_specs = ref_tf.model_specs(ref_cfg)
    ref_shapes = {p: s.shape for p, s in leaves_with_paths(jax.tree.map(
        lambda s: s, ref_specs, is_leaf=ref_params.is_spec))}
    specs = port_tf.model_specs(cfg)
    assert {p: s.shape for p, s in leaves_with_paths(specs)} == ref_shapes
    block = specs["segments"][0]["block0"]
    assert {"norm_cross", "cross"} <= set(block)
    assert "encoder" in specs
    n = port_params.count_params(specs)
    assert n == ref_params.count_params(ref_specs)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    for field in ("is_encoder_decoder", "encoder_layers", "encoder_seq",
                  "use_rope", "norm_type", "act", "gated_mlp", "mlp_bias",
                  "qkv_bias", "tie_embeddings", "vocab_size", "source"):
        assert getattr(cfg, field) == getattr(ref_cfg, field), field
    if not tiny:
        assert n == FULL_PARAMS
        assert cfg.param_count() == APPROX_PARAMS
        assert cfg.num_layers == cfg.encoder_layers == 24


def test_serving_dtype_of_encoder_and_cross_leaves():
    """Norm scales and biases (``norm_cross`` and the encoder's among
    them) are held in float32, every projection and bias of the encoder
    and the cross attention in the activation dtype."""
    cfg = get_config(NAME, tiny=True)
    dtype = port_tf.serving_dtype(cfg)
    for path, _ in leaves_with_paths(port_tf.model_specs(cfg)):
        want = torch.float32 if path[-1] in ("scale", "bias") else \
            torch.bfloat16
        assert dtype(path) == want, path
    assert dtype(("segments", 0, "block0", "norm_cross", "bias")) == \
        torch.float32
    assert dtype(("encoder", "segments", 0, "block0", "mixer", "b_q")) == \
        torch.bfloat16


# --------------------------------------------------------------------------- #
# layers against JAX
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("length,d", [(1500, 1024), (16, 64), (7, 10)])
def test_sinusoidal_embeddings_match_jax(length, d):
    """The full-sequence table in float32 and bfloat16."""
    want = np.asarray(ref_layers.sinusoidal_embeddings(length, d))
    got = port_layers.sinusoidal_embeddings(length, d)
    assert got.shape == (length, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               atol=_sin_atol(length - 1), rtol=0)
    want16 = _np(ref_layers.sinusoidal_embeddings(length, d, jnp.bfloat16))
    got16 = port_layers.sinusoidal_embeddings(length, d, torch.bfloat16)
    assert np.abs(_np(got16) - want16).max() <= 2 ** -8 + _sin_atol(
        length - 1)


@pytest.mark.parametrize("d", [1024, 64])
def test_decode_sinusoid_matches_the_reference_formula(d):
    """``sinusoid_at``: the inline rows of the reference's
    ``decode_step`` (``log`` taken in float32), at slot positions up to
    Whisper's decoder context and past the encoder's 1500."""
    pos = np.array([0, 1, 63, 447, 1499, 4095], np.int32)
    half = d // 2
    freqs = jnp.exp(-jnp.log(10_000.0) * jnp.arange(half) / (half - 1))
    angles = jnp.reshape(jnp.asarray(pos), (-1, 1)).astype(jnp.float32) \
        * freqs[None]
    want = np.asarray(jnp.concatenate([jnp.sin(angles), jnp.cos(angles)],
                                      axis=-1))
    got = port_layers.sinusoid_at(torch.from_numpy(pos), d, torch.float32)
    atol = _sin_atol(int(pos.max()))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    table = port_layers.sinusoidal_embeddings(4096, d)
    np.testing.assert_allclose(got.numpy(), table[pos].numpy(), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 7])
def test_cross_attention_and_its_kv_match_jax(T, dtype):
    """``encode_cross_kv`` (k, v with their biases, in the encoder
    output's dtype) and ``cross_attention`` over them at T = 7 (the
    flash path, non-causal, T != S) and T = 1 (the decode path, the
    softmax weights rounded to the activation dtype)."""
    ref_cfg, cfg = _configs(dtype)
    tree = numpy_params(port_layers.cross_attn_specs(cfg), 6)
    rng = np.random.default_rng(3)
    for name in ("b_q", "b_k", "b_v"):       # nonzero biases
        tree[name] = 0.1 * rng.standard_normal(tree[name].shape).astype(
            np.float32)
    p = port_params.params_from_numpy(tree, "cpu")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    jkv = ref_layers.encode_cross_kv(tree, jnp.asarray(enc).astype(jdt),
                                     ref_cfg)
    tkv = port_layers.encode_cross_kv(p, torch.from_numpy(enc).to(tdt), cfg)
    want = _np(_REF_CROSS(tree, jnp.asarray(x).astype(jdt), ref_cfg, jkv))
    got = port_layers.cross_attention(p, torch.from_numpy(x).to(tdt), cfg,
                                      tkv)
    assert got.dtype == tdt and got.shape == (2, T, cfg.d_model)
    for g, w in [*zip(tkv, jkv), (got, want)]:
        assert g.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(w), **LAYER_TOL)
        else:
            w = _np(w)
            assert np.abs(_np(g) - w).max() <= BF16_REL * np.abs(w).max()


# --------------------------------------------------------------------------- #
# the model against JAX
# --------------------------------------------------------------------------- #

def _serve_logits(prefill, decode_step, params, cfg, tokens, wrap, frames,
                  P=12, steps=8):
    """Prefill P tokens over the frames, then ``steps`` decode steps:
    the logit rows and the final state."""
    lg, st = prefill(params, {"tokens": wrap(tokens[:, :P]),
                              "audio_embeds": frames}, cfg, 32)
    out = [lg]
    for i in range(P, P + steps):
        lg, st = decode_step(params, wrap(tokens[:, i:i + 1]), st, cfg)
        out.append(lg)
    return out, st


def test_forward_train_matches_jax():
    ref_cfg, cfg = _configs()
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    frames = _frames(cfg)
    jl, _ = _REF_TRAIN(tree, {"tokens": jnp.asarray(tokens),
                              "audio_embeds": jnp.asarray(frames)}, ref_cfg)
    tl, aux = port_tf.forward_train(
        params, {"tokens": torch.from_numpy(tokens),
                 "audio_embeds": torch.from_numpy(frames)}, cfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)


def test_prefill_and_8_decode_steps_match_jax():
    """Float32 logits of a prefill and 8 decode steps (each decode token
    at its slot's sinusoid), and the cross k, v the prefill keeps
    (B, encoder_seq, Kv, hd), stacked on the layer axis, as JAX's."""
    ref_cfg, cfg = _configs()
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 20))
    frames = _frames(cfg)
    want, jst = _serve_logits(torch_serve_fixture.REF_PREFILL,
                              torch_serve_fixture.REF_DECODE, tree, ref_cfg,
                              tokens, jnp.asarray, jnp.asarray(frames))
    got, tst = _serve_logits(port_tf.prefill, port_tf.decode_step, params,
                             cfg, tokens, torch.from_numpy,
                             torch.from_numpy(frames))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)
    jc, tc = jst[0]["block0"], tst[0]["block0"]
    assert sorted(tc) == sorted(jc)
    hd = cfg.head_dim_
    for key in port_tf.CROSS_KEYS:
        assert tuple(tc[key].shape) == (cfg.num_layers, 2, cfg.encoder_seq,
                                        cfg.num_kv_heads, hd)
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **LAYER_TOL)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_agrees_with_teacher_forcing():
    """The port alone: prefill + 8 decode steps give ``forward_train``'s
    logits at the same positions, so the first decode token's sinusoid
    is at the prompt's length, not one off."""
    _, cfg = _configs()
    _, params = _shared(cfg)
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20)))
    frames = torch.from_numpy(_frames(cfg))
    full, _ = port_tf.forward_train(params, {"tokens": tokens,
                                             "audio_embeds": frames}, cfg)
    got, _ = _serve_logits(port_tf.prefill, port_tf.decode_step, params,
                           cfg, tokens.numpy(), torch.from_numpy, frames)
    torch.testing.assert_close(torch.stack(got, 1), full[:, 11:20],
                               **LAYER_TOL)


def test_bfloat16_twin_within_2_percent():
    """The bfloat16 twin: prefill, 8 decode steps and teacher forcing
    within 2 % of the logits' scale of JAX's."""
    ref_cfg, cfg = _configs("bfloat16")
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 20))
    frames = _frames(cfg)
    want, _ = _serve_logits(torch_serve_fixture.REF_PREFILL,
                            torch_serve_fixture.REF_DECODE, tree, ref_cfg,
                            tokens, jnp.asarray, jnp.asarray(frames))
    got, _ = _serve_logits(port_tf.prefill, port_tf.decode_step, params,
                           cfg, tokens, torch.from_numpy,
                           torch.from_numpy(frames))
    jl, _ = _REF_TRAIN(tree, {"tokens": jnp.asarray(tokens),
                              "audio_embeds": jnp.asarray(frames)}, ref_cfg)
    tl, _ = port_tf.forward_train(
        params, {"tokens": torch.from_numpy(tokens),
                 "audio_embeds": torch.from_numpy(frames)}, cfg)
    for g, w in [*zip(got, want), (tl, jl)]:
        assert g.dtype == torch.bfloat16
        w = _np(w)
        assert np.abs(_np(g) - w).max() <= BF16_REL * np.abs(w).max()


def _engine_run(module, cfg, params, extra, **kw):
    clock, sleep = golden.virtual_clock()
    eng = module.ServeEngine(cfg, params, module.EngineConfig(
        num_slots=2, cache_len=32), extra_inputs=extra, clock=clock, **kw)
    rng = np.random.default_rng(6)
    reqs = [module.Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                           max_new_tokens=new, submitted_at=at)
            for i, (n, new, at) in enumerate(((5, 6, 0.0), (13, 4, 0.0),
                                              (3, 7, 1.0)))]
    metrics = module.run_server(eng, reqs, log=lambda s: None, clock=clock,
                                sleep=sleep)
    return reqs, metrics, eng


def test_engine_tokens_equal_jax():
    """Greedy ``ServeEngine`` runs of both packages with the same
    ``extra_inputs`` (one set of frames for every request): tokens,
    stamps and metrics ``==``."""
    ref_cfg, cfg = _configs()
    tree, params = _shared(cfg)
    extra = {"audio_embeds": _frames(cfg, B=1)[0]}
    want, wm, _ = _engine_run(ref_engine, ref_cfg, tree, extra)
    got, gm, eng = _engine_run(port_engine, cfg, params, extra,
                               device="cpu")
    assert eng.extra["audio_embeds"].shape == (1, cfg.encoder_seq,
                                               cfg.d_model)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert (g.first_token_at, g.done_at) == (w.first_token_at, w.done_at)
    assert gm == wm


def test_snapshot_and_restore_carry_the_cross_states():
    """An engine moved mid-generation (``snapshot`` -> a new engine's
    ``restore``) finishes with the tokens of one that was not: the cross
    k, v of each busy slot travel with the snapshot."""
    _, cfg = _configs()
    _, params = _shared(cfg)
    extra = {"audio_embeds": _frames(cfg, B=1)[0]}
    ecfg = port_engine.EngineConfig(num_slots=2, cache_len=32)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9))

    def start():
        eng = port_engine.ServeEngine(cfg, params, ecfg, extra_inputs=extra,
                                      device="cpu")
        reqs = [port_engine.Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.admit(r)
        eng.step()
        return eng, reqs

    solo, solo_reqs = start()
    for _ in range(4):
        solo.step()
    moving, _ = start()
    snap = moving.snapshot()
    cross = snap["states"][0]["block0"]["cross_k"]
    assert cross.shape == (cfg.num_layers, 2, cfg.encoder_seq,
                           cfg.num_kv_heads, cfg.head_dim_)
    assert np.abs(cross).max() > 0
    del moving
    moved = port_engine.ServeEngine(cfg, params, ecfg, extra_inputs=extra,
                                    device="cpu")
    moved.restore(snap)
    moved_reqs = list(moved.active)
    for _ in range(4):
        moved.step()
    assert all(r is None for r in moved.active)
    assert [len(r.tokens) for r in solo_reqs] == [6, 6]
    assert [r.tokens for r in moved_reqs] == [r.tokens for r in solo_reqs]


def test_cli_serves_on_cpu():
    metrics = serve_cli.main(["--arch", NAME, "--device", "cpu",
                              "--requests", "3", "--max-new-tokens", "4",
                              "--mean-interarrival-s", "0"])
    assert metrics["requests"] == 3 and metrics["tokens"] == 12
    extra = serve_cli.extra_inputs(get_config(NAME, tiny=True))
    want = 0.02 * np.random.default_rng(0).standard_normal(
        (16, 64)).astype(np.float32)
    assert np.array_equal(extra["audio_embeds"], want)


# --------------------------------------------------------------------------- #
# the golden fixture
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def committed():
    with np.load(GOLDEN / "expected.npz", allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_fixture_holds_the_helpers_inputs(committed):
    """The committed inputs are the helpers' (so the replay and a
    rebuild read the same), at Whisper-medium's widths cut to 2 + 2
    layers, the encoder over 1500 frames."""
    fixture = golden.WHISPER
    cfg = golden.config(fixture)
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim_, cfg.d_ff,
            cfg.num_layers, cfg.encoder_layers, cfg.encoder_seq) == (
        1024, 16, 64, 4096, 2, 2, 1500)
    tokens, prompts = golden.inputs(fixture)
    assert np.array_equal(committed["tokens"], tokens)
    assert np.array_equal(committed["engine_prompts"],
                          np.concatenate(prompts))
    extra = golden.extra_inputs(fixture)
    assert extra["audio_embeds"].shape == (1500, 1024)
    assert str(committed["extra_digest"]) == port_params.tree_digest(extra)
    assert committed["prefill_logits"].shape == (2, 512)
    assert committed["decode_logits"].shape == (fixture.decode, 2, 512)


def test_fixture_matches_jax_reference(committed):
    """The committed fixture is what the JAX package computes today from
    the helpers' parameters, frames and tokens (``--regen``'s path),
    array for array."""
    rebuilt = torch_serve_fixture.build(golden.WHISPER)
    assert sorted(rebuilt) == sorted(committed)
    for key, want in committed.items():
        assert np.array_equal(rebuilt[key], want), key


def test_port_reproduces_fixture_on_cpu(committed):
    report = golden.replay(golden.WHISPER, committed, "cpu")
    print(report)
    assert report["digest_ok"]
    assert report["worst_share_of_tol"] <= 1.0, report
    assert report["engine_tokens_equal"] and report["engine_stamps_equal"]
    assert report["engine_metrics_equal"] and report["ok"]


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_whisper.py --regen")
    GOLDEN.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN / "expected.npz",
                        **torch_serve_fixture.build(golden.WHISPER))
    size = (GOLDEN / "expected.npz").stat().st_size
    print(f"wrote {GOLDEN / 'expected.npz'} ({size} bytes)")
