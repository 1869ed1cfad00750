"""PyTorch port, the vision-language family: InternVL2-26B (patch
embeddings ahead of the tokens, GQA 6:1) against the JAX package on the
CPU, and the golden fixture
``tests/data/torch_vlm_serve_golden/expected.npz``.

Parameters cross as numpy arrays drawn by
``repro_torch.models.params.numpy_params``; the modality input
``pixel_embeds`` is drawn with numpy and fed to both packages.  The
fixture is a float32 twin at InternVL2-26B's widths (d_model 6144, 48
query heads over 8 kv heads of 128, d_ff 16384) cut to 2 layers and a
vocab of 512, its vision prefix cut from 1024 to 256 patches (a length
cut, so that the replay fits its time here): it stores the seed and the
digests of the parameters and of the patches, JAX's logits for a
32-token prefill after the patches and 8 decode steps of 2 sequences
and a JAX ``ServeEngine`` run's greedy tokens.

Tolerances: float32 logits ``atol 1e-4, rtol 1e-3`` (the other serve
tests'); the loss ``rtol 1e-6`` (as ``test_torch_train.py``'s); in
bfloat16 within 2 % of the logits' scale (one bfloat16 ulp is 0.4 %, and
the port's plain flash keeps prefill's softmax weights in float32 on the
CPU where the reference rounds them); greedy tokens ``==``.  CPU time of
the file: ~90 s in one process, ~60 s of it the fixture's replay (its
786 M float32 parameters take 3.1 GB).

Regenerate the fixture after an intentional change (~1.5 min, ~10 GB)::

    PYTHONPATH=src python tests/test_torch_vlm.py --regen
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
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine
from repro.train import train_step as ref_ts

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import params as port_params
from repro_torch.models import transformer as port_tf
from repro_torch.models.params import leaves_with_paths, numpy_params
from repro_torch.serve import engine as port_engine
from repro_torch.serve import golden
from repro_torch.train import train_step as port_ts

NAME = "internvl2-26b"
GOLDEN = Path(__file__).resolve().parent / "data" / "torch_vlm_serve_golden"
F32_TOL = dict(atol=1e-4, rtol=1e-3)
BF16_REL = 2e-2
FULL_PARAMS = 19_862_722_560       # count_params of the full spec tree
APPROX_PARAMS = 19_860_664_320     # the reference's param_count

_REF_TRAIN = jax.jit(ref_tf.forward_train, static_argnums=(2,))


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


def _patches(cfg, B=2, seed=9):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --------------------------------------------------------------------------- #
# configs, specs and counts
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tiny", [True, False])
def test_plan_specs_and_counts_match_jax(tiny):
    """The dense plan, the spec tree's keys and shapes, ``count_params``,
    ``param_count`` and ``active_param_count``, and the fields the port
    carries (the training knobs among them)."""
    ref_cfg, cfg = ref_get_config(NAME, tiny=tiny), get_config(NAME,
                                                               tiny=tiny)
    (seg,), (ref_seg,) = cfg.layer_plan(), ref_cfg.layer_plan()
    assert seg.repeats == ref_seg.repeats == cfg.num_layers
    assert [(b.mixer, b.mlp, b.cross_attn) for b in seg.blocks] == \
        [(b.mixer, b.mlp, b.cross_attn) for b in ref_seg.blocks] == \
        [("attn", "dense", False)]
    ref_specs = ref_tf.model_specs(ref_cfg)
    ref_shapes = {p: s.shape for p, s in leaves_with_paths(jax.tree.map(
        lambda s: s, ref_specs, is_leaf=ref_params.is_spec))}
    specs = port_tf.model_specs(cfg)
    assert {p: s.shape for p, s in leaves_with_paths(specs)} == ref_shapes
    n = port_params.count_params(specs)
    assert n == ref_params.count_params(ref_specs)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    for field in ("family", "vision_prefix_len", "num_heads", "num_kv_heads",
                  "rope_theta", "ce_chunk", "train_accum", "tie_embeddings",
                  "vocab_size", "source"):
        assert getattr(cfg, field) == getattr(ref_cfg, field), field
    if not tiny:
        assert n == FULL_PARAMS and cfg.param_count() == APPROX_PARAMS
        assert (cfg.q_per_kv, cfg.vision_prefix_len) == (6, 1024)
        assert (cfg.ce_chunk, cfg.train_accum) == (1024, 2)


# --------------------------------------------------------------------------- #
# the model against JAX
# --------------------------------------------------------------------------- #

def _serve_logits(prefill, decode_step, params, cfg, tokens, wrap, patches,
                  P=12, steps=8, cache_len=40):
    """Prefill the patches and P tokens, then ``steps`` decode steps: the
    logit rows and the final state."""
    lg, st = prefill(params, {"tokens": wrap(tokens[:, :P]),
                              "pixel_embeds": patches}, cfg, cache_len)
    out = [lg]
    for i in range(P, P + steps):
        lg, st = decode_step(params, wrap(tokens[:, i:i + 1]), st, cfg)
        out.append(lg)
    return out, st


def test_forward_train_matches_jax():
    """Logits over [patches, tokens] (the patches' rows included), and
    the same without ``pixel_embeds`` (tokens only)."""
    ref_cfg, cfg = _configs()
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    patches = _patches(cfg)
    for extra in ({"pixel_embeds": patches}, {}):
        jl, _ = _REF_TRAIN(tree, {"tokens": jnp.asarray(tokens),
                                  **{k: jnp.asarray(v)
                                     for k, v in extra.items()}}, ref_cfg)
        tl, aux = port_tf.forward_train(
            params, {"tokens": torch.from_numpy(tokens),
                     **{k: torch.from_numpy(v) for k, v in extra.items()}},
            cfg)
        assert float(aux) == 0.0
        assert tl.shape[1] == 24 + (cfg.vision_prefix_len if extra else 0)
        np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)


def test_prefill_and_8_decode_steps_match_jax():
    """Float32 logits of a prefill over the patches and 12 tokens and 8
    decode steps, and the cache after them (its positions count the
    patches), as JAX's."""
    ref_cfg, cfg = _configs()
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 20))
    patches = _patches(cfg)
    want, jst = _serve_logits(torch_serve_fixture.REF_PREFILL,
                              torch_serve_fixture.REF_DECODE, tree, ref_cfg,
                              tokens, jnp.asarray, jnp.asarray(patches))
    got, tst = _serve_logits(port_tf.prefill, port_tf.decode_step, params,
                             cfg, tokens, torch.from_numpy,
                             torch.from_numpy(patches))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)
    jc, tc = jst[0]["block0"], tst[0]["block0"]
    assert sorted(tc) == sorted(jc) == ["k", "pos", "v"]
    assert (tc["pos"] == cfg.vision_prefix_len + 12 + 8).all()
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), atol=1e-5,
                                   rtol=1e-4)


def test_cache_must_hold_the_patches_and_the_prompt():
    """The prefill writes patches and prompt into the cache: a cache of
    the prompt's length alone is refused."""
    _, cfg = _configs()
    _, params = _shared(cfg)
    tokens = torch.zeros((1, 12), dtype=torch.int64)
    batch = {"tokens": tokens,
             "pixel_embeds": torch.from_numpy(_patches(cfg, B=1))}
    with pytest.raises(ValueError, match="exceeds the cache"):
        port_tf.prefill(params, batch, cfg, 16)
    _, st = port_tf.prefill(params, batch, cfg, cfg.vision_prefix_len + 12)
    assert (st[0]["block0"]["pos"] == cfg.vision_prefix_len + 12).all()


def test_decode_agrees_with_teacher_forcing():
    """The port alone: prefill + 8 decode steps give ``forward_train``'s
    logits at the same positions (RoPE positions from 0 on the first
    patch, the causal mask over the patches)."""
    _, cfg = _configs()
    _, params = _shared(cfg)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20))
    patches = torch.from_numpy(_patches(cfg))
    full, _ = port_tf.forward_train(params, {
        "tokens": torch.from_numpy(tokens), "pixel_embeds": patches}, cfg)
    got, _ = _serve_logits(port_tf.prefill, port_tf.decode_step, params,
                           cfg, tokens, torch.from_numpy, patches)
    P = cfg.vision_prefix_len
    torch.testing.assert_close(torch.stack(got, 1), full[:, P + 11:P + 20],
                               atol=1e-5, rtol=1e-4)


def test_bfloat16_twin_within_2_percent():
    ref_cfg, cfg = _configs("bfloat16")
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 20))
    patches = _patches(cfg)
    want, _ = _serve_logits(torch_serve_fixture.REF_PREFILL,
                            torch_serve_fixture.REF_DECODE, tree, ref_cfg,
                            tokens, jnp.asarray, jnp.asarray(patches))
    got, _ = _serve_logits(port_tf.prefill, port_tf.decode_step, params,
                           cfg, tokens, torch.from_numpy,
                           torch.from_numpy(patches))
    jl, _ = _REF_TRAIN(tree, {"tokens": jnp.asarray(tokens),
                              "pixel_embeds": jnp.asarray(patches)}, ref_cfg)
    tl, _ = port_tf.forward_train(
        params, {"tokens": torch.from_numpy(tokens),
                 "pixel_embeds": torch.from_numpy(patches)}, cfg)
    for g, w in [*zip(got, want), (tl, jl)]:
        assert g.dtype == torch.bfloat16
        w = _np(w)
        assert np.abs(_np(g) - w).max() <= BF16_REL * np.abs(w).max()


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_loss_drops_the_patches_on_both_paths(ce_chunk):
    """``_loss_fn`` over a batch with patches: the loss reads only the
    token positions, on the full-logits path and the chunked one, as
    JAX's (``rtol 1e-6``), and equals cross-entropy over the token rows
    of ``forward_train``."""
    ref_cfg, cfg = _configs(ce_chunk=ce_chunk)
    tree, params = _shared(cfg, seed=4)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "pixel_embeds": _patches(cfg)}
    jl, _ = jax.jit(lambda p, b: ref_ts._loss_fn(p, b, ref_cfg, False))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, metrics = port_ts._loss_fn(params, tb, cfg, False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(metrics["tokens"]) == 2 * 16
    logits, _ = port_tf.forward_train(params, tb, cfg)
    rows = logits[:, cfg.vision_prefix_len:, :cfg.vocab_size]
    want = torch.nn.functional.cross_entropy(
        rows.reshape(-1, cfg.vocab_size), tb["labels"].reshape(-1).long())
    np.testing.assert_allclose(float(tl), float(want), rtol=1e-6)


def _engine_run(module, cfg, params, extra, **kw):
    clock, sleep = golden.virtual_clock()
    eng = module.ServeEngine(cfg, params, module.EngineConfig(
        num_slots=2, cache_len=40), extra_inputs=extra, clock=clock, **kw)
    rng = np.random.default_rng(6)
    reqs = [module.Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                           max_new_tokens=new, submitted_at=at)
            for i, (n, new, at) in enumerate(((5, 6, 0.0), (13, 4, 0.0),
                                              (3, 7, 1.0)))]
    metrics = module.run_server(eng, reqs, log=lambda s: None, clock=clock,
                                sleep=sleep)
    return reqs, metrics


def test_engine_tokens_equal_jax():
    """Greedy ``ServeEngine`` runs of both packages with the same
    ``extra_inputs`` (one set of patches for every request): tokens,
    stamps and metrics ``==``."""
    ref_cfg, cfg = _configs()
    tree, params = _shared(cfg)
    extra = {"pixel_embeds": _patches(cfg, B=1)[0]}
    want, wm = _engine_run(ref_engine, ref_cfg, tree, extra)
    got, gm = _engine_run(port_engine, cfg, params, extra, device="cpu")
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert (g.first_token_at, g.done_at) == (w.first_token_at, w.done_at)
    assert gm == wm


def test_cli_serves_on_cpu():
    metrics = serve_cli.main(["--arch", NAME, "--device", "cpu",
                              "--requests", "3", "--max-new-tokens", "4",
                              "--mean-interarrival-s", "0"])
    assert metrics["requests"] == 3 and metrics["tokens"] == 12
    extra = serve_cli.extra_inputs(get_config(NAME, tiny=True))
    want = 0.02 * np.random.default_rng(0).standard_normal(
        (8, 64)).astype(np.float32)
    assert np.array_equal(extra["pixel_embeds"], want)


# --------------------------------------------------------------------------- #
# the golden fixture
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def committed():
    with np.load(GOLDEN / "expected.npz", allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_fixture_holds_the_helpers_inputs(committed):
    """The committed inputs are the helpers' (so the replay and a
    rebuild read the same), at InternVL2-26B's widths cut to 2 layers,
    256 patches."""
    fixture = golden.VLM
    cfg = golden.config(fixture)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
            cfg.d_ff, cfg.num_layers, cfg.vision_prefix_len) == (
        6144, 48, 8, 128, 16384, 2, 256)
    tokens, prompts = golden.inputs(fixture)
    assert np.array_equal(committed["tokens"], tokens)
    assert np.array_equal(committed["engine_prompts"],
                          np.concatenate(prompts))
    extra = golden.extra_inputs(fixture)
    assert extra["pixel_embeds"].shape == (256, 6144)
    assert str(committed["extra_digest"]) == port_params.tree_digest(extra)
    assert committed["prefill_logits"].shape == (2, 512)
    assert committed["decode_logits"].shape == (fixture.decode, 2, 512)


def test_port_reproduces_fixture_on_cpu(committed):
    report = golden.replay(golden.VLM, committed, "cpu")
    print(report)
    assert report["digest_ok"]
    assert report["worst_share_of_tol"] <= 1.0, report
    assert report["engine_tokens_equal"] and report["engine_stamps_equal"]
    assert report["engine_metrics_equal"] and report["ok"]


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_vlm.py --regen")
    GOLDEN.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN / "expected.npz",
                        **torch_serve_fixture.build(golden.VLM))
    size = (GOLDEN / "expected.npz").stat().st_size
    print(f"wrote {GOLDEN / 'expected.npz'} ({size} bytes)")
