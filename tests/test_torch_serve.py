"""PyTorch port, RecurrentGemma serving path: ``repro_torch.models
.transformer`` (``prefill``, ``decode_step``, ``forward_train``) and
``repro_torch.serve`` (``ServeEngine``, ``run_server``, ``sample``)
against the JAX package, and the serve golden fixture
``tests/data/torch_serve_golden/``.

The fixture holds the float32 parameters of a narrow 8-layer
RecurrentGemma twin (one stacked segment of two Griffin superblocks and
a trailing pair of recurrent blocks), prompts longer than its 8-token
window, JAX's ``prefill`` and ``decode_step`` logits, and the greedy
tokens and metrics of a JAX ``ServeEngine`` run with staggered admission
on a virtual clock.  ``chip_smoke.py`` holds the port on the card to it
(the card has no JAX); the test here recomputes it with JAX and requires
the committed file, and runs the port on the CPU against it.

Tolerances: float32 logits ``atol 1e-4, rtol 1e-3`` (sums in another
order; ``tests/test_models_consistency.py``'s bound for prefill is
``2e-4, 2e-3``); bfloat16 logits no farther from JAX's float32 logits
than 1.5 times JAX's own bfloat16 logits are, and within ``4e-2 *
max|logit|`` of those (bfloat16 rounds at other places in the two
frameworks, and the kernel keeps the softmax weights in float32 where
the reference rounds them; over 8 layers the two bfloat16 runs drift
apart by up to 2.8 % of the largest logit, each about 1.4 % from
float32); greedy tokens equal.

Regenerate after an intentional change::

    PYTHONPATH=src python tests/test_torch_serve.py --regen
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine

from repro_torch.configs import get_config
from repro_torch.models import params as port_params
from repro_torch.models import transformer as port_tf
from repro_torch.models.params import leaves_with_paths
from repro_torch.serve import engine as port_engine
from repro_torch.serve.sampling import SamplingConfig, sample

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_serve_golden"
F32_TOL = dict(atol=1e-4, rtol=1e-3)
NAME = "recurrentgemma-9b"
# The fixture's engine run: (prompt length, max_new_tokens, submitted_at).
ENGINE_REQS = ((13, 6, 0.0), (4, 8, 0.0), (21, 5, 1.0), (9, 7, 2.5),
               (17, 4, 2.5))
ENGINE_SLOTS, ENGINE_CACHE = 2, 40
PREFILL_LEN, DECODE_STEPS, PREFILL_CACHE = 13, 5, 32
METRIC_KEYS = ("elapsed_s", "mean_ttft_s", "requests", "tokens",
               "tokens_per_s")


def _configs(dtype="float32", **overrides):
    ref = dataclasses.replace(ref_get_config(NAME, tiny=True), dtype=dtype,
                              **overrides)
    port = dataclasses.replace(get_config(NAME, tiny=True), dtype=dtype,
                               **overrides)
    return ref, port


def _twin(dtype="float32"):
    return _configs(dtype, num_layers=8)


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _flat(tree) -> dict:
    return {_key(p): np.asarray(a) for p, a in leaves_with_paths(tree)}


def _port_params(flat: dict, cfg, dtype=None):
    tree = port_params.map_tree(lambda path, _: flat[_key(path)],
                                port_tf.model_specs(cfg))
    return port_params.params_from_numpy(
        tree, "cpu", dtype=dtype or port_tf.serving_dtype(cfg))


def _virtual_clock(tick=0.25):
    now = [0.0]

    def clock():
        now[0] += tick
        return now[0]

    def sleep(dt):
        now[0] += dt
    return clock, sleep


def _engine_requests(prompts, module):
    return [module.Request(uid=i, prompt=prompts[i], max_new_tokens=new,
                           submitted_at=at)
            for i, (_, new, at) in enumerate(ENGINE_REQS)]


def _prompts(vocab):
    rng = np.random.default_rng(0)
    prefill = rng.integers(0, vocab, (2, PREFILL_LEN + DECODE_STEPS))
    engine = [rng.integers(0, vocab, n).astype(np.int32)
              for n, _, _ in ENGINE_REQS]
    return prefill.astype(np.int32), engine


def build_fixture() -> dict:
    """The fixture's arrays, computed by the JAX package on the CPU."""
    cfg, _ = _twin()
    params = ref_params.init_params(jax.random.key(0),
                                    ref_tf.model_specs(cfg))
    tokens, prompts = _prompts(cfg.vocab_size)
    lg, states = ref_tf.prefill(params,
                                {"tokens": jnp.asarray(tokens[:, :PREFILL_LEN])},
                                cfg, PREFILL_CACHE)
    decode = []
    for i in range(PREFILL_LEN, PREFILL_LEN + DECODE_STEPS):
        d, states = ref_tf.decode_step(params, jnp.asarray(tokens[:, i:i + 1]),
                                       states, cfg)
        decode.append(np.asarray(d))
    clock, sleep = _virtual_clock()
    eng = ref_engine.ServeEngine(cfg, params, ref_engine.EngineConfig(
        num_slots=ENGINE_SLOTS, cache_len=ENGINE_CACHE), clock=clock)
    reqs = _engine_requests(prompts, ref_engine)
    metrics = ref_engine.run_server(eng, reqs, log=lambda s: None,
                                    clock=clock, sleep=sleep)
    width = max(len(r.tokens) for r in reqs)
    out = {f"param/{k}": v for k, v in _flat(params).items()}
    out.update(
        tokens=tokens, prefill_logits=np.asarray(lg),
        decode_logits=np.stack(decode),
        engine_prompts=np.concatenate(prompts),
        # ragged token lists, padded with -1
        engine_tokens=np.asarray([r.tokens + [-1] * (width - len(r.tokens))
                                  for r in reqs], np.int32),
        engine_stamps=np.asarray([(r.first_token_at, r.done_at)
                                  for r in reqs]),
        engine_metrics=np.asarray([metrics[k] for k in METRIC_KEYS]))
    return out


def load_fixture() -> dict:
    with np.load(GOLDEN / "expected.npz", allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def committed():
    return load_fixture()


def test_fixture_matches_jax_reference(committed):
    fresh = build_fixture()
    assert set(fresh) == set(committed)
    for key, want in committed.items():
        if key.startswith("param/") or key in ("tokens", "engine_prompts",
                                               "engine_tokens",
                                               "engine_stamps",
                                               "engine_metrics"):
            assert np.array_equal(fresh[key], want), key
        else:
            np.testing.assert_allclose(fresh[key], want, rtol=1e-6,
                                       atol=1e-6, err_msg=key)
    assert sum(v.nbytes for v in committed.values()) < 2 * 1024 * 1024


def _engine_prompts(fx):
    out, at = [], 0
    for n, _, _ in ENGINE_REQS:
        out.append(fx["engine_prompts"][at:at + n])
        at += n
    return out


def test_port_reproduces_fixture_on_cpu(committed):
    fx = committed
    _, cfg = _twin()
    params = _port_params({k[6:]: v for k, v in fx.items()
                           if k.startswith("param/")}, cfg)
    tokens = torch.from_numpy(fx["tokens"]).long()
    lg, states = port_tf.prefill(params, {"tokens": tokens[:, :PREFILL_LEN]},
                                 cfg, PREFILL_CACHE)
    np.testing.assert_allclose(lg.numpy(), fx["prefill_logits"], **F32_TOL)
    for s, i in enumerate(range(PREFILL_LEN, PREFILL_LEN + DECODE_STEPS)):
        lg, states = port_tf.decode_step(params, tokens[:, i:i + 1], states,
                                         cfg)
        np.testing.assert_allclose(lg.numpy(), fx["decode_logits"][s],
                                   **F32_TOL, err_msg=f"decode step {s}")
    clock, sleep = _virtual_clock()
    eng = port_engine.ServeEngine(cfg, params, port_engine.EngineConfig(
        num_slots=ENGINE_SLOTS, cache_len=ENGINE_CACHE), clock=clock,
        device="cpu")
    reqs = _engine_requests(_engine_prompts(fx), port_engine)
    metrics = port_engine.run_server(eng, reqs, log=lambda s: None,
                                     clock=clock, sleep=sleep)
    for r, want in zip(reqs, fx["engine_tokens"]):
        assert r.tokens == [int(t) for t in want if t >= 0], r.uid
    assert np.array_equal(np.asarray([(r.first_token_at, r.done_at)
                                      for r in reqs]), fx["engine_stamps"])
    assert [metrics[k] for k in METRIC_KEYS] == \
        fx["engine_metrics"].tolist()


def _shared_params(ref_cfg, cfg, seed=2, dtype=None):
    tree = ref_params.init_params(jax.random.key(seed),
                                  ref_tf.model_specs(ref_cfg))
    return tree, _port_params(_flat(tree), cfg, dtype)


def _serve_logits(prefill, decode_step, params, cfg, tokens, wrap):
    """Prefill 12 tokens (past the 8-token window), then 3 decode steps:
    the four logit rows as float32 numpy."""
    lg, st = prefill(params, {"tokens": wrap(tokens[:, :12])}, cfg, 20)
    out = [lg]
    for i in range(12, 15):
        lg, st = decode_step(params, wrap(tokens[:, i:i + 1]), st, cfg)
        out.append(lg)
    return out


@pytest.mark.parametrize("twin", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(twin, dtype):
    """TINY (3 layers, one superblock) and the 8-layer twin.  bfloat16:
    the port's distance from JAX's float32 logits is at most 1.5 times
    JAX's own bfloat16 distance from them (plus 2e-3 * max|logit|), and
    the port is within 4e-2 * max|logit| of JAX's bfloat16 logits (both
    round at every layer, at other places)."""
    ref_cfg, cfg = _twin(dtype) if twin else _configs(dtype)
    tree, params = _shared_params(ref_cfg, cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    want = [np.asarray(x.astype(jnp.float32)) for x in _serve_logits(
        ref_tf.prefill, ref_tf.decode_step, tree, ref_cfg, tokens,
        jnp.asarray)]
    got = _serve_logits(port_tf.prefill, port_tf.decode_step, params, cfg,
                        tokens, torch.from_numpy)
    assert all(g.dtype == getattr(torch, dtype) for g in got)
    got = [g.float().numpy() for g in got]
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **F32_TOL)
        return
    f32 = [np.asarray(x) for x in _serve_logits(
        ref_tf.prefill, ref_tf.decode_step, tree,
        dataclasses.replace(ref_cfg, dtype="float32"), tokens, jnp.asarray)]
    for g, w, ref in zip(got, want, f32):
        scale = float(np.abs(ref).max())
        assert np.abs(g - ref).max() <= (1.5 * np.abs(w - ref).max()
                                         + 2e-3 * scale)
        np.testing.assert_allclose(g, w, atol=4e-2 * scale, rtol=0)


def test_decode_matches_teacher_forcing_and_ring_wraps():
    """Prefill 12 tokens (window 8: the ring holds positions 4..11, split
    at the wrap point), then decode: logits equal ``forward_train``'s at
    every position (tests/test_models_consistency.py:42,102)."""
    _, cfg = _twin()
    g = torch.Generator().manual_seed(0)
    params = port_params.init_params(port_tf.model_specs(cfg), g, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=g)
    full, _ = port_tf.forward_train(params, {"tokens": tokens}, cfg)
    lg, states = port_tf.prefill(params, {"tokens": tokens[:, :12]}, cfg,
                                 cache_len=24)
    local = states[0]["block2"]
    assert local["k"].shape[3] == cfg.sliding_window   # ring of 8 slots
    assert local["pos"].tolist() == [[12, 12], [12, 12]]
    torch.testing.assert_close(lg, full[:, 11], atol=2e-4, rtol=2e-3)
    for i in range(12, 19):
        lg, states = port_tf.decode_step(params, tokens[:, i:i + 1], states,
                                         cfg)
        torch.testing.assert_close(lg, full[:, i], atol=5e-4, rtol=5e-3)
    assert local["pos"].tolist() == [[19, 19], [19, 19]]


def _engine_parts():
    _, cfg = _configs()
    g = torch.Generator().manual_seed(1)
    return cfg, port_params.init_params(port_tf.model_specs(cfg), g, "cpu")


def test_staggered_admission_isolation_and_snapshot_restore():
    """A request admitted later generates what it generates alone (slots
    leak no state), and a snapshot restored into a new engine continues
    identically."""
    cfg, params = _engine_parts()
    ecfg = port_engine.EngineConfig(num_slots=2, cache_len=32)
    prompt = (np.arange(10) * 7) % 50

    solo = port_engine.ServeEngine(cfg, params, ecfg, device="cpu")
    r_solo = port_engine.Request(uid=0, prompt=prompt, max_new_tokens=6)
    solo.admit(r_solo)
    while any(solo.active):
        solo.step()

    mixed = port_engine.ServeEngine(cfg, params, ecfg, device="cpu")
    other = port_engine.Request(uid=1, prompt=np.arange(9) % 50,
                                max_new_tokens=12)
    mixed.admit(other)
    mixed.step()
    mixed.step()
    r_mixed = port_engine.Request(uid=2, prompt=prompt, max_new_tokens=6)
    mixed.admit(r_mixed)
    mixed.step()
    snap = mixed.snapshot()
    while r_mixed.done_at is None:
        mixed.step()
    assert r_mixed.tokens == r_solo.tokens

    moved = port_engine.ServeEngine(cfg, params, ecfg, device="cpu")
    moved.restore(snap)
    r_moved = moved.active[1]
    assert r_moved.tokens == r_solo.tokens[:2]
    while r_moved.done_at is None:
        moved.step()
    assert r_moved.tokens == r_solo.tokens
    assert moved.active[0].tokens == other.tokens[:len(moved.active[0].tokens)]


def test_sampling_contract():
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0, 9.0, 9.0]])
    g = torch.Generator().manual_seed(0)
    assert sample(g, logits, SamplingConfig()).tolist() == [4]
    assert sample(g, logits, SamplingConfig(vocab_size=4)).tolist() == [1]
    big = torch.tensor(np.random.default_rng(0).standard_normal((64, 40)),
                       dtype=torch.float32)
    big[:, 30:] = 50.0                       # padded columns, never drawn
    draws = torch.stack([sample(g, big, SamplingConfig(
        temperature=1.0, top_k=3, vocab_size=30)) for _ in range(50)])
    top3 = torch.topk(big[:, :30], 3, dim=-1).indices
    assert draws.dtype == torch.int32
    assert bool((draws < 30).all())
    assert bool((draws[..., None] == top3[None]).any(-1).all())
    again = torch.Generator().manual_seed(7)
    a = sample(again, big, SamplingConfig(temperature=0.7))
    again.manual_seed(7)
    assert torch.equal(a, sample(again, big, SamplingConfig(temperature=0.7)))


@pytest.mark.parametrize("tiny", [True, False])
def test_specs_match_jax_and_count_params(tiny):
    """The port's spec tree has the reference's keys and shapes (the full
    configuration by shapes only: nothing is allocated), and
    ``count_params`` agrees."""
    ref_cfg = ref_get_config(NAME, tiny=tiny)
    cfg = get_config(NAME, tiny=tiny)
    ref_specs = ref_tf.model_specs(ref_cfg)
    ref_shapes = {_key(p): s.shape for p, s in leaves_with_paths(
        jax.tree.map(lambda s: s, ref_specs,
                     is_leaf=ref_params.is_spec))}
    shapes = {_key(p): s.shape
              for p, s in leaves_with_paths(port_tf.model_specs(cfg))}
    assert shapes == ref_shapes
    n = port_params.count_params(port_tf.model_specs(cfg))
    assert n == ref_params.count_params(ref_specs)
    if not tiny:
        assert n == 8_578_519_040
        assert cfg.layer_plan()[0].repeats == 12
        assert [b.mixer for b in cfg.layer_plan()[1].blocks] == ["rglru"] * 2


def test_init_params_serving_dtypes_and_shapes():
    _, cfg = _configs("bfloat16")
    g = torch.Generator().manual_seed(0)
    specs = port_tf.model_specs(cfg)
    params = port_params.init_params(specs, g, "cpu",
                                     dtype=port_tf.serving_dtype(cfg))
    for (path, spec), (_, t) in zip(leaves_with_paths(specs),
                                    leaves_with_paths(params)):
        assert tuple(t.shape) == spec.shape, path
        f32 = path[-1] in port_tf.FLOAT32_LEAVES
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), path
    seg = params["segments"][0]["block0"]
    assert tuple(seg["mixer"]["w_in"].shape) == (64, 64)   # one repeat
    assert not seg["mixer"]["b_a"].any() and bool((seg["norm1"]["scale"]
                                                    == 1).all())
    _, twin = _twin()
    stacked = port_tf.model_specs(twin)["segments"][0]["block0"]
    assert stacked["mixer"]["w_in"].shape == (2, 64, 64)   # layer axis


def test_entry_points_default_to_the_card_and_unported_raise():
    cfg, params = _engine_parts()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_engine.ServeEngine(cfg, params, port_engine.EngineConfig())
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_serve.py --regen")
    GOLDEN.mkdir(parents=True, exist_ok=True)
    arrays = build_fixture()
    np.savez_compressed(GOLDEN / "expected.npz", **arrays)
    size = (GOLDEN / "expected.npz").stat().st_size
    print(f"wrote {GOLDEN / 'expected.npz'} ({size} bytes)")
