"""PyTorch port, the MoE family: ``repro_torch.models.moe`` (routing,
capacity, ``apply_moe``), the MoE layer plan and blocks in
``repro_torch.models.transformer``, ``ServeEngine`` over them, the
registered configs (DeepSeekMoE-16B, Granite-3.0-1B-A400M, and the dense
DeepSeek-7B and GLM-4-9B), and the golden fixture
``tests/data/torch_moe_serve_golden/expected.npz``, all against the JAX
package on the CPU.

Parameters cross as numpy arrays drawn by
``repro_torch.models.params.numpy_params``.  JAX's routing is read from
the reference's own ``apply_moe`` by recording what it passes through
``jax.lax.top_k`` (the chosen experts) and ``shard`` (its ``dispatch``
one-hots, which give each choice's capacity position and whether it was
kept).

The fixture is a float32 twin at DeepSeekMoE-16B's widths (d_model 2048,
16 heads of 128, 64 experts 1408 wide, top-6, 2 shared experts, a first
dense layer 10944 wide) cut to 3 layers and a vocab of 512: it stores the
seed, the parameters' digest, JAX's chosen experts, prefill and decode
logits for a 1024-token prefill (two groups at capacity 60, choices
dropped) and a JAX ``ServeEngine`` run's greedy tokens.  Its 1.26 G
float32 parameters take 5 GB, so the suite replays it with the port and
does not rebuild it with JAX (``--regen`` does, with ~12 GB).

Tolerances: ``apply_moe`` and its aux in float32 ``atol 1e-5`` (the same
float32 arithmetic, sums in another order); in bfloat16 the same
routing and outputs within 2 % of the output's scale (one bfloat16 ulp
is 0.4 %; the two frameworks round the expert products at other
places); float32 logits ``atol 1e-4, rtol 1e-3`` as the other serve
tests; greedy tokens equal.  CPU time of the file: ~100 s in one
process, ~45 s of it the fixture's replay (6 GB).

Regenerate the fixture after an intentional change::

    PYTHONPATH=src python tests/test_torch_moe.py --regen
"""
import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import moe as port_moe
from repro_torch.models import params as port_params
from repro_torch.models import transformer as port_tf
from repro_torch.models.params import leaves_with_paths, numpy_params
from repro_torch.serve import engine as port_engine
from repro_torch.serve import golden

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_moe_serve_golden"
MOE_ARCHS = ("deepseek-moe-16b", "granite-moe-1b-a400m")
DENSE_ARCHS = ("deepseek-7b", "glm4-9b")
MOE_TOL = dict(atol=1e-5, rtol=0)
BF16_REL = 2e-2
F32_TOL = dict(atol=1e-4, rtol=1e-3)
# The full configs' parameter counts (the reference's count_params).
FULL_PARAMS = {"deepseek-moe-16b": 16_375_728_128,
               "granite-moe-1b-a400m": 1_335_149_568,
               "deepseek-7b": 6_910_365_696,
               "glm4-9b": 9_399_951_360}
SOURCES = {"deepseek-moe-16b":
           "arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base",
           "granite-moe-1b-a400m": "hf:ibm-granite/granite-3.0-1b-a400m-base",
           "deepseek-7b":
           "arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-7b-base",
           "glm4-9b": "hf:THUDM/glm-4-9b"}


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


# --------------------------------------------------------------------------- #
# configs and specs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tiny", [True, False])
@pytest.mark.parametrize("name", MOE_ARCHS + DENSE_ARCHS)
def test_plan_specs_and_count_match_jax(name, tiny):
    """The layer plan, the spec tree's keys and shapes, and the parameter
    count (the full configurations by shapes only)."""
    ref_cfg, cfg = ref_get_config(name, tiny=tiny), get_config(name,
                                                               tiny=tiny)
    assert [(s.repeats, [(b.mixer, b.mlp) for b in s.blocks])
            for s in cfg.layer_plan()] == [
        (s.repeats, [(b.mixer, b.mlp) for b in s.blocks])
        for s in ref_cfg.layer_plan()]
    ref_specs = ref_tf.model_specs(ref_cfg)
    ref_shapes = {p: s.shape for p, s in leaves_with_paths(jax.tree.map(
        lambda s: s, ref_specs, is_leaf=ref_params.is_spec))}
    specs = port_tf.model_specs(cfg)
    assert {p: s.shape for p, s in leaves_with_paths(specs)} == ref_shapes
    n = port_params.count_params(specs)
    assert n == ref_params.count_params(ref_specs)
    if not tiny:
        assert n == FULL_PARAMS[name] and cfg.source == SOURCES[name]


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_numpy_params_on_draws_numpy_params_and_its_digest(monkeypatch,
                                                         name):
    """Drawn in pieces (of 1000 values here, so leaves split), the tensors
    are ``numpy_params``'s numbers and the digest is their
    ``tree_digest``: the fixtures' digests are made one way and checked
    the other."""
    specs = port_tf.model_specs(get_config(name, tiny=True))
    monkeypatch.setattr(port_params, "_DRAW_PIECE", 1000)
    got, digest = port_params.numpy_params_on(specs, 3, "cpu")
    want = numpy_params(specs, 3)
    assert digest == port_params.tree_digest(want)
    for (path, g), (_, w) in zip(leaves_with_paths(got),
                                 leaves_with_paths(want)):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w), path


def test_numpy_params_on_raises_and_ends_its_drawing_thread(monkeypatch):
    """A leaf with no numpy draw raises in the caller, after the pieces
    before it, and the thread that draws ahead ends with the call."""
    import threading
    monkeypatch.setattr(port_params, "_DRAW_PIECE", 1000)
    specs = {"a": port_params.ParamSpec((3000,), (None,)),
             "b": port_params.ParamSpec((2500,), (None,), init="bogus"),
             "c": port_params.ParamSpec((4000,), (None,))}
    before = threading.active_count()
    with pytest.raises(ValueError, match="bogus"):
        port_params.numpy_params_on(specs, 0, "cpu")
    assert threading.active_count() == before


def test_deepseek_moe_plan_and_widths():
    cfg = get_config("deepseek-moe-16b")
    dense, moe_seg = cfg.layer_plan()
    assert (dense.repeats, moe_seg.repeats) == (1, 27)
    assert dense.blocks[0].mlp == "dense" and moe_seg.blocks[0].mlp == "moe"
    specs = port_tf.model_specs(cfg)["segments"]
    assert specs[0]["block0"]["mlp"]["w_up"].shape == (2048, 10944)
    mlp = specs[1]["block0"]["mlp"]
    assert mlp["w_gate"].shape == (27, 64, 2048, 1408)
    assert mlp["shared_down"].shape == (27, 2816, 2048)
    assert mlp["w_router"].shape == (27, 2048, 64)
    granite = port_tf.model_specs(get_config("granite-moe-1b-a400m"))
    assert "lm_head" not in granite and granite["embed"].shape == (49664,
                                                                   1024)


@pytest.mark.parametrize("group_len", [1, 7, 100, 512])
@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0])
def test_group_capacity_matches_jax(name, group_len, cf):
    ref = dataclasses.replace(ref_get_config(name), capacity_factor=cf)
    port = dataclasses.replace(get_config(name), capacity_factor=cf)
    assert port_moe.group_capacity(port, group_len) == \
        ref_moe.group_capacity(ref, group_len)
    assert port_moe.MOE_GROUP_SIZE == ref_moe.MOE_GROUP_SIZE


# --------------------------------------------------------------------------- #
# apply_moe against the reference's
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def _jax_recorded(monkeypatch):
    """Record every ``jax.lax.top_k`` call's (input, values, indices) and
    every array the reference MoE passes to ``shard``."""
    seen = {"top_k": [], "shard": []}
    top_k = jax.lax.top_k

    def rec_top_k(a, k):
        out = top_k(a, k)
        seen["top_k"].append((a, *out))
        return out

    def rec_shard(a, axes):
        seen["shard"].append(a)
        return a
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", rec_top_k)
        m.setattr(ref_moe, "shard", rec_shard)
        yield seen


def _boundary_gap(probs, K) -> float:
    """The smallest gap between a token's K-th and (K+1)-th probability."""
    top = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    return float((top[..., K - 1] - top[..., K]).min())


# (arch, B, T, overrides): T = 1 (decode), T < 512 (one group), T = 1024
# (two groups) with the capacity cut to force overflow, and no shared
# experts (Granite's twin; DeepSeek's has two).
MOE_CASES = [
    ("deepseek-moe-16b", 4, 1, {}),
    ("deepseek-moe-16b", 2, 100, {}),
    ("deepseek-moe-16b", 2, 1024, {"capacity_factor": 0.5}),
    ("granite-moe-1b-a400m", 3, 64, {}),
    ("granite-moe-1b-a400m", 1, 1024, {"capacity_factor": 0.5}),
]


def _moe_run(monkeypatch, name, B, T, overrides, dtype="float32", seed=0,
             tree=None):
    ref_cfg, cfg = _configs(name, dtype, **overrides)
    if tree is None:
        tree = numpy_params(port_moe.moe_specs(cfg), seed)
    x = np.random.default_rng(seed + 100).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    with _jax_recorded(monkeypatch) as seen:
        jo, ja = ref_moe.apply_moe(tree, jnp.asarray(x).astype(dtype),
                                   ref_cfg)
    p = port_params.params_from_numpy(tree, "cpu",
                                      dtype=getattr(torch, dtype))
    to, r = port_moe.apply_moe(
        p, torch.from_numpy(x).to(getattr(torch, dtype)), cfg)
    return cfg, seen, r, (jo, ja), (to, port_moe.aux_loss(r, cfg))


def _jax_positions(seen, gate_idx):
    """JAX's (keep, pos) of each choice, from its dispatch one-hots
    (B, G, Sg, E, C)."""
    dispatch = np.asarray(seen["shard"][0].astype(jnp.float32))
    slots = np.take_along_axis(dispatch, gate_idx[..., None], axis=3)
    return slots.sum(-1) > 0, slots.argmax(-1)


@pytest.mark.parametrize("name,B,T,overrides", MOE_CASES)
def test_routing_equals_jax(monkeypatch, name, B, T, overrides):
    """Chosen experts, their order and renormalised weights, capacity
    positions and kept flags, against what the reference's apply_moe
    computes."""
    cfg, seen, r, _, _ = _moe_run(monkeypatch, name, B, T, overrides)
    probs, vals, idx = seen["top_k"][0]
    print(f"{name} T={T}: smallest K-th boundary gap "
          f"{_boundary_gap(probs, cfg.experts_per_token):.3e}")
    np.testing.assert_array_equal(r.gate_idx.numpy(), np.asarray(idx))
    keep, pos = _jax_positions(seen, np.asarray(idx))
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.pos.numpy()[keep], pos[keep])
    gates = np.asarray(vals) / (np.asarray(vals).sum(-1, keepdims=True)
                                + 1e-9)
    np.testing.assert_allclose(r.gate_vals.numpy(), gates, atol=1e-6)
    if overrides.get("capacity_factor") == 0.5:
        assert not keep.all()       # overflow was forced
    if T == 1:
        assert keep.all()           # C = K: a lone token never overflows


@pytest.mark.parametrize("name,B,T,overrides", MOE_CASES)
def test_apply_moe_float32_matches_jax(monkeypatch, name, B, T, overrides):
    """Outputs and the aux loss in float32: dropped choices give no
    routed output, shared experts are added after it."""
    _, _, _, (jo, ja), (to, ta) = _moe_run(monkeypatch, name, B, T,
                                           overrides)
    assert to.dtype == torch.float32 and ta.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **MOE_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **MOE_TOL)


@pytest.mark.parametrize("name,B,T,overrides", MOE_CASES)
def test_apply_moe_bfloat16_matches_jax(monkeypatch, name, B, T,
                                        overrides):
    """bfloat16: the same routing, outputs within 2 % of their scale."""
    _, seen, r, (jo, ja), (to, ta) = _moe_run(monkeypatch, name, B, T,
                                              overrides, "bfloat16")
    np.testing.assert_array_equal(r.gate_idx.numpy(),
                                  np.asarray(seen["top_k"][0][2]))
    assert to.dtype == torch.bfloat16
    want = _np(jo)
    assert np.abs(_np(to) - want).max() <= BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_dropped_choices_give_no_routed_output(monkeypatch):
    """At capacity 2 of a group of 64, most choices are dropped; a token
    whose choices were all dropped gets only the shared experts."""
    name = "deepseek-moe-16b"
    cfg, seen, r, (jo, _), (to, _) = _moe_run(
        monkeypatch, name, 1, 64, {"capacity_factor": 0.1})
    assert port_moe.group_capacity(cfg, 64) == 2
    none_kept = ~r.keep.numpy().any(-1).reshape(-1)
    assert none_kept.any()
    tree = numpy_params(port_moe.moe_specs(cfg), 0)
    p = port_params.params_from_numpy(tree, "cpu")
    x = torch.from_numpy(np.random.default_rng(100).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32))
    shared = torch.nn.functional.silu(x @ p["shared_gate"]) * \
        (x @ p["shared_up"]) @ p["shared_down"]
    torch.testing.assert_close(to[0, none_kept], shared[0, none_kept])
    np.testing.assert_allclose(_np(to), _np(jo), **MOE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_ties_go_to_the_lower_index(monkeypatch, dtype):
    """Router columns built to tie (each of 4 distinct columns twice, top
    3 of 8): every probability ties with another, inside the choices and
    at the K-th boundary, and among equals the lower expert index is
    chosen first, as jax.lax.top_k orders them."""
    name = "deepseek-moe-16b"
    _, cfg = _configs(name, experts_per_token=3)
    tree = numpy_params(port_moe.moe_specs(cfg), 4)
    w = tree["w_router"]
    tree["w_router"] = np.concatenate([w[:, :4], w[:, :4]], axis=1)
    cfg, seen, r, (jo, _), (to, _) = _moe_run(
        monkeypatch, name, 2, 48, {"experts_per_token": 3}, dtype,
        tree=tree)
    probs, _, idx = (np.asarray(a) for a in seen["top_k"][0])
    got = r.gate_idx.numpy()
    np.testing.assert_array_equal(got, idx)
    chosen = np.take_along_axis(probs, got, -1)
    steps = np.diff(chosen, axis=-1)
    assert (steps <= 0).all() and (steps == 0).any()
    assert (np.diff(got, axis=-1)[steps == 0] > 0).all()
    left = np.ones(probs.shape, bool)
    np.put_along_axis(left, got, False, -1)
    at_kth = left & (probs == chosen[..., -1:])
    assert at_kth.any()
    below = np.arange(cfg.n_experts) < got[..., -1:]
    assert not (at_kth & below).any()
    if dtype == "float32":
        np.testing.assert_allclose(_np(to), _np(jo), **MOE_TOL)


def test_a_sequence_not_a_whole_number_of_groups_is_refused():
    """T = 700 > 512 is not a multiple of the group: the reference's
    assertion, the port's ValueError."""
    ref_cfg, cfg = _configs("granite-moe-1b-a400m")
    tree = numpy_params(port_moe.moe_specs(cfg), 0)
    x = np.zeros((1, 700, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        ref_moe.apply_moe(tree, jnp.asarray(x), ref_cfg)
    p = port_params.params_from_numpy(tree, "cpu")
    with pytest.raises(ValueError, match="MoE group"):
        port_moe.apply_moe(p, torch.from_numpy(x), cfg)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("T", [64, 1024])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_forward_train_logits_and_aux_match_jax(name, T):
    """Teacher forcing: logits, and aux summed over the MoE layers."""
    ref_cfg, cfg = _configs(name)
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, T))
    jl, ja = ref_tf.forward_train(tree, {"tokens": jnp.asarray(tokens)},
                                  ref_cfg)
    tl, ta = port_tf.forward_train(params,
                                   {"tokens": torch.from_numpy(tokens)}, cfg)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **MOE_TOL)
    assert float(ta) > 0


def test_train_step_carries_the_aux_loss():
    """The port's train step adds the MoE aux loss to the loss and
    reports it; JAX's train step reports the same."""
    from repro.train import train_step as ref_step
    from repro_torch.train import train_step as port_step
    ref_cfg, cfg = _configs("deepseek-moe-16b")
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    _, jm = jax.jit(ref_step._loss_fn, static_argnums=(2, 3))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg, False)
    _, tm = port_step._loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
        False)
    assert float(tm["aux_loss"]) > 0
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               **MOE_TOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5)


# The reference's entry points jitted (the same functions; eager, their
# op-by-op dispatch takes seconds a step on the CPU).
_REF_PREFILL = jax.jit(ref_tf.prefill, static_argnums=(2, 3))
_REF_DECODE = jax.jit(ref_tf.decode_step, static_argnums=(3,))


def _serve_logits(prefill, decode_step, params, cfg, tokens, wrap, P=16,
                  steps=8):
    """Prefill P tokens, then ``steps`` decode steps: the logit rows."""
    lg, st = prefill(params, {"tokens": wrap(tokens[:, :P])}, cfg, 64)
    out = [lg]
    for i in range(P, P + steps):
        lg, st = decode_step(params, wrap(tokens[:, i:i + 1]), st, cfg)
        out.append(lg)
    return out


@pytest.mark.parametrize("name", MOE_ARCHS + DENSE_ARCHS)
def test_prefill_and_8_decode_steps_match_jax(name):
    """TINY twins, float32: prefill logits and 8 decode steps' logits."""
    ref_cfg, cfg = _configs(name)
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24))
    want = _serve_logits(_REF_PREFILL, _REF_DECODE, tree, ref_cfg, tokens,
                         jnp.asarray)
    got = _serve_logits(port_tf.prefill, port_tf.decode_step, params, cfg,
                        tokens, torch.from_numpy)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_matches_teacher_forcing_at_a_high_capacity(name):
    """With a capacity no token overflows (capacity_factor 8.0, as the
    reference's consistency test), prefill + decode equals
    ``forward_train`` at each position."""
    _, cfg = _configs(name, capacity_factor=8.0)
    _, params = _shared(cfg)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 40)))
    full, _ = port_tf.forward_train(params, {"tokens": tokens}, cfg)
    lg, st = port_tf.prefill(params, {"tokens": tokens[:, :32]}, cfg, 64)
    torch.testing.assert_close(lg, full[:, 31], **F32_TOL)
    for i in range(32, 40):
        lg, st = port_tf.decode_step(params, tokens[:, i:i + 1], st, cfg)
        torch.testing.assert_close(lg, full[:, i], **F32_TOL)


def test_prompt_over_512_not_a_multiple_of_512_raises():
    ref_cfg, cfg = _configs("granite-moe-1b-a400m")
    tree, params = _shared(cfg)
    tokens = np.zeros((1, 700), np.int32)
    with pytest.raises(AssertionError):
        ref_tf.prefill(tree, {"tokens": jnp.asarray(tokens)}, ref_cfg, 1024)
    with pytest.raises(ValueError, match="MoE group"):
        port_tf.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                        1024)
    lg, _ = port_tf.prefill(params, {"tokens": torch.from_numpy(
        tokens[:, :512])}, cfg, 1024)
    assert lg.shape == (1, 512)


# --------------------------------------------------------------------------- #
# the engine and the CLI
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
    return rs, metrics


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_engine_greedy_tokens_equal_jax(name):
    """Staggered admission on 3 slots: greedy tokens, stamps and metrics
    ``==`` JAX's engine."""
    ref_cfg, cfg = _configs(name)
    tree, params = _shared(cfg, seed=3)
    reqs = ((9, 6, 0.0), (4, 8, 0.0), (13, 5, 0.5), (6, 4, 2.0))
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _, _ in reqs]
    want, wm = _engine_run(ref_engine, ref_cfg, tree, prompts, reqs)
    got, gm = _engine_run(port_engine, cfg, params, prompts, reqs,
                          device="cpu")
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, g.uid
        assert (g.first_token_at, g.done_at) == (w.first_token_at,
                                                 w.done_at)
    assert [gm[k] for k in golden.METRIC_KEYS] == \
        [wm[k] for k in golden.METRIC_KEYS]


def test_engine_needs_a_card_without_device(monkeypatch):
    _, cfg = _configs("deepseek-moe-16b")
    _, params = _shared(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_engine.ServeEngine(cfg, params, port_engine.EngineConfig())


@pytest.mark.parametrize("arch", MOE_ARCHS + DENSE_ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    metrics = serve_cli.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--slots", "2",
                              "--max-new-tokens", "4",
                              "--mean-interarrival-s", "0"])
    assert metrics["requests"] == 3 and metrics["tokens"] == 12
    assert "[serve]" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# the golden fixture
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def _jax_top_k_recorded():
    seen = []
    top_k = jax.lax.top_k

    def rec(a, k):
        out = top_k(a, k)
        seen.append((a, *out))
        return out
    jax.lax.top_k = rec
    try:
        yield seen
    finally:
        jax.lax.top_k = top_k


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
    the parameters and inputs of ``golden.MOE``.  The prefill and decode
    run with ``unroll_layers`` (the reference's layer loop in place of its
    scan, the same arithmetic), so its routing can be read eagerly."""
    fixture = golden.MOE
    ref_cfg = dataclasses.replace(
        golden.config(fixture, ref_get_config(fixture.arch)),
        unroll_layers=True)
    tree = golden.parameters(fixture)
    digest = port_params.tree_digest(tree)
    _to_jax(tree)
    tokens, prompts = golden.inputs(fixture)
    with _jax_top_k_recorded() as seen:
        lg, *decode = golden.logits(fixture, ref_tf.prefill,
                                    ref_tf.decode_step, tree, ref_cfg,
                                    tokens, jnp.asarray)
    K = ref_cfg.experts_per_token
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
        "routing": golden.routing_rows([idx for _, _, idx in seen], 2),
        "routing_min_gap": np.asarray(min(_boundary_gap(a, K)
                                          for a, _, _ in seen)),
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
    rebuild read the same), and the routing covers 2 MoE layers of the
    prefill and of each decode step."""
    fixture = golden.MOE
    tokens, prompts = golden.inputs(fixture)
    assert np.array_equal(committed["tokens"], tokens)
    assert np.array_equal(committed["engine_prompts"],
                          np.concatenate(prompts))
    assert committed["routing"].shape == (
        2, 2 * (fixture.prefill + fixture.decode), 6)
    assert committed["prefill_logits"].shape == (2, 512)
    assert (GOLDEN / "expected.npz").stat().st_size < 1_500_000


def replay_recording_routing(monkeypatch, fx, device) -> dict:
    """``golden.replay`` of the MoE fixture, with the port's routing read
    by wrapping ``moe.route`` and compared by ``golden.routing_report``."""
    seen, route = [], port_moe.route

    def recording(p, xg, cfg):
        seen.append(route(p, xg, cfg))
        return seen[-1]
    monkeypatch.setattr(port_moe, "route", recording)
    report = golden.replay(golden.MOE, fx, device)
    return {**report, **golden.routing_report(golden.MOE, fx, seen)}


def test_port_reproduces_fixture_on_cpu(monkeypatch, committed):
    report = replay_recording_routing(monkeypatch, committed, "cpu")
    print(f"smallest K-th boundary gap in JAX's routing "
          f"{float(committed['routing_min_gap']):.3e}; {report}")
    assert report["digest_ok"] and report["routing_equal"]
    assert report["dropped_choices"] > 0
    assert report["worst_share_of_tol"] <= 1.0, report
    assert report["engine_tokens_equal"] and report["engine_stamps_equal"]
    assert report["engine_metrics_equal"] and report["ok"]


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_moe.py --regen")
    GOLDEN.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN / "expected.npz", **build_fixture())
    size = (GOLDEN / "expected.npz").stat().st_size
    print(f"wrote {GOLDEN / 'expected.npz'} ({size} bytes)")
