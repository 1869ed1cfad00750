"""PyTorch port, training path: ``repro_torch.train`` (synthetic data,
AdamW, losses, the train step, the ``Trainer``) and the training side of
``repro_torch.models.transformer`` against the JAX package on the CPU,
and the train golden fixture ``tests/data/torch_train_golden.npz``.

The fixture holds a 3-layer float32 RecurrentGemma twin's initial
parameters (JAX's init), the loss, grad norm and lr of 3 JAX AdamW steps
on ``SyntheticLM`` batches (accum 2, ``ce_chunk`` 8 over 32 tokens) and
the parameters after step 3.  ``chip_smoke.py`` holds the port on the card
to it (the card has no JAX); here it is recomputed with JAX, and the
port runs on the CPU against it.

Tolerances, each against JAX on the same parameters and batches:
* float32 twin: loss ``rtol 1e-5``, grad norm ``rtol 1e-4``, lr ``rtol
  1e-6`` (sums in another order); the parameters' update ``p3 - p0``
  within 1e-3 of JAX's in norm (2e-5 to 7e-5 seen).  No bound per
  element: AdamW's ``m / (sqrt(v) + eps)`` maps a gradient near ``eps``
  onto a step anywhere between 0 and lr, so a float32 rounding there
  moves that element by a share of lr (3.2e-4 at lr 1e-2 seen);
* bfloat16 twin: loss ``rtol 3e-3``, grad norm ``rtol 3e-2``, accuracy
  within 1/32, and the parameters' update ``p3 - p0`` within 15 % of
  JAX's in norm: bfloat16 rounds at other places in the two frameworks,
  and the port keeps attention's softmax weights in float32 where the
  reference rounds them;
* AdamW alone and the losses: ``rtol 1e-6`` / ``atol 1e-6``.

Regenerate after an intentional change::

    PYTHONPATH=src python tests/test_torch_train.py --regen
"""
import dataclasses
import os
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config
from repro.train import data as ref_data
from repro.train import losses as ref_losses
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts

from repro_torch.configs import get_config
from repro_torch.models import transformer as port_tf
from repro_torch.models.params import (leaves_with_paths, map_tree,
                                       numpy_params, params_from_numpy)
from repro_torch.train import data as port_data
from repro_torch.train import golden
from repro_torch.train import losses as port_losses
from repro_torch.train import optimizer as port_opt
from repro_torch.train import train_step as port_ts
from repro_torch.train.trainer import Trainer, TrainerConfig

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_train_golden.npz"
NAME = "recurrentgemma-9b"
# The fixture's run.
FIX = dict(steps=3, ce_chunk=8, learning_rate=1e-2, warmup_steps=2,
           total_steps=10, batch_size=2, seq_len=32, accum=2)
F32 = dict(loss=1e-5, grad_norm=1e-4, lr=1e-6, update_rel=1e-3)
BF16 = dict(loss=3e-3, grad_norm=3e-2, accuracy=1 / 32, update_rel=0.15)


def _configs(dtype="float32", **overrides):
    ref = dataclasses.replace(ref_get_config(NAME, tiny=True), dtype=dtype,
                              **overrides)
    port = dataclasses.replace(get_config(NAME, tiny=True), dtype=dtype,
                               **overrides)
    return ref, port


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _ref_leaves(tree) -> dict:
    """JAX leaves keyed as the port's paths are ("segments/0/block0/...")."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf) for path, leaf in flat}


def _opt_cfgs(**kw):
    return ref_opt.OptimizerConfig(**kw), port_opt.OptimizerConfig(**kw)


def _run_both(dtype, accum, ce_chunk, layers=3, steps=3, seq_len=32,
              lr=1e-2):
    """``steps`` train steps of the reference (jitted) and the port (CPU)
    from JAX's initial parameters on the same batches."""
    rcfg, pcfg = _configs(dtype, num_layers=layers, ce_chunk=ce_chunk)
    roc, poc = _opt_cfgs(learning_rate=lr, warmup_steps=2, total_steps=10)
    dc = dict(batch_size=2, seq_len=seq_len, accum=accum)
    rstate = ref_ts.init_train_state(jax.random.key(0), rcfg)
    p0 = _ref_leaves(rstate.params)
    params = params_from_numpy(jax.tree.map(np.asarray, rstate.params),
                               "cpu")
    pstate = port_ts.TrainState(params, port_opt.init_opt_state(params))
    rstep = jax.jit(ref_ts.make_train_step(rcfg, roc, accum=accum))
    pstep = port_ts.make_train_step(pcfg, poc, accum=accum)
    rdata = ref_data.SyntheticLM(rcfg, ref_data.DataConfig(**dc))
    rm_all, pm_all = [], []
    for s in range(steps):
        batch = rdata.batch(s)
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        pstate, pm = pstep(pstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        rm_all.append({k: float(v) for k, v in rm.items()})
        pm_all.append({k: float(v) for k, v in pm.items()})
    p3 = {_key(path): t.numpy() for path, t in
          leaves_with_paths(pstate.params)}
    return rm_all, pm_all, p0, _ref_leaves(rstate.params), p3, rstate, pstate


# --------------------------------------------------------------------------- #
# data, schedule, optimizer, losses
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("accum,seed", [(1, 0), (2, 3)])
def test_synthetic_batches_equal_reference(accum, seed):
    rcfg, pcfg = _configs()
    dc = dict(batch_size=3, seq_len=40, accum=accum, seed=seed)
    ref = ref_data.SyntheticLM(rcfg, ref_data.DataConfig(**dc))
    port = port_data.SyntheticLM(pcfg, port_data.DataConfig(**dc))
    for step in (0, 1, 17):
        a, b = ref.batch(step), port.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name,key", [("internvl2-26b", "pixel_embeds"),
                                      ("whisper-medium", "audio_embeds")])
def test_synthetic_modality_batches_equal_reference(name, key, accum):
    """The vlm and audio families' batches: tokens, labels, mask and the
    modality input (drawn after the tokens from the same generator)
    ``==`` the reference's, bit for bit."""
    rcfg, pcfg = ref_get_config(name, tiny=True), get_config(name, tiny=True)
    dc = dict(batch_size=3, seq_len=40, accum=accum, seed=1)
    ref = ref_data.SyntheticLM(rcfg, ref_data.DataConfig(**dc))
    port = port_data.SyntheticLM(pcfg, port_data.DataConfig(**dc))
    for step in (0, 5):
        a, b = ref.batch(step), port.batch(step)
        assert a.keys() == b.keys() and key in b
        length = pcfg.vision_prefix_len if key == "pixel_embeds" else \
            pcfg.encoder_seq
        lead = (accum, 3) if accum > 1 else (3,)
        assert b[key].shape == lead + (length, pcfg.d_model)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("step", [0, 1, 7, 10, 55, 110, 200])
def test_schedule_matches_reference(step):
    roc, poc = _opt_cfgs(learning_rate=3e-3, warmup_steps=10,
                         total_steps=110, min_lr_ratio=0.1)
    want = float(ref_opt.schedule(roc, jnp.asarray(step, jnp.int32)))
    got = float(port_opt.schedule(poc, torch.tensor(step,
                                                    dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    if step == 1:
        assert got == pytest.approx(3e-3 / 10, rel=1e-6)


def _opt_tree(rng):
    """A stacked (2, d) norm scale, a 1-D leaf, a matrix and a stacked
    matrix: decay is by rank, so the stacked scale decays."""
    return {"segments": [{"norm": {"scale": rng.standard_normal((2, 5))}},
                         {"w": rng.standard_normal((2, 4, 3))}],
            "bias": rng.standard_normal((6,)),
            "w": rng.standard_normal((4, 6))}


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: a.astype(np.float32), _opt_tree(rng))
    roc, poc = _opt_cfgs(learning_rate=0.05, warmup_steps=2, total_steps=8,
                         weight_decay=0.3, clip_norm=1.5)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref_opt.init_opt_state(rp)
    pp = params_from_numpy(tree, "cpu")
    ps = port_opt.init_opt_state(pp)
    for step in range(5):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 2)
                         .astype(np.float32), tree)
        rp, rs, rm = ref_opt.adamw_update(roc, rp, jax.tree.map(
            jnp.asarray, g), rs)
        pp, ps, pm = port_opt.adamw_update(poc, pp, params_from_numpy(
            g, "cpu"), ps)
        assert float(pm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert int(ps.step) == int(rs.step) == step + 1
        assert ps.step.dtype == torch.int32
        for tree_r, tree_p in ((rp, pp), (rs.m, ps.m), (rs.v, ps.v)):
            want, got = _ref_leaves(tree_r), {
                _key(p): t.numpy() for p, t in leaves_with_paths(tree_p)}
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-7, err_msg=k)


def test_stacked_norm_scale_decays_and_vector_does_not():
    _, poc = _opt_cfgs(learning_rate=0.1, warmup_steps=1, weight_decay=10.0)
    params = {"scale": torch.ones(2, 3), "bias": torch.ones(3)}
    state = port_opt.init_opt_state(params)
    zeros = map_tree(lambda _, p: torch.zeros_like(p), params)
    port_opt.adamw_update(poc, params, zeros, state)
    assert torch.equal(params["bias"], torch.ones(3))
    assert float(params["scale"].max()) < 1.0


def test_clip_by_global_norm_scales_in_place():
    tree = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    clipped, norm = port_opt.clip_by_global_norm(tree, 1.0)
    assert clipped is tree and float(norm) == pytest.approx(5.0)
    assert float(port_opt.global_norm(tree)) == pytest.approx(1.0, rel=1e-6)


def _ce_inputs(rng, B=2, T=16, V=21, Vp=32, D=8):
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (rng.standard_normal((D, Vp)) * 0.7).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.8).astype(np.float32)
    return x, w, labels, mask, V


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_grad_match_jax(masked):
    rng = np.random.default_rng(1)
    x, w, labels, mask, V = _ce_inputs(rng)
    logits = np.einsum("btd,dv->btv", x, w)
    logits[0, 3, :V] = logits[0, 3, 5]           # a tie: first index wins
    m = mask if masked else None

    def ref_loss(lg):
        return ref_losses.cross_entropy(lg, jnp.asarray(labels),
                                        None if m is None else jnp.asarray(m),
                                        vocab_size=V)

    (rl, rm), rg = jax.value_and_grad(ref_loss, has_aux=True)(
        jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    pl, pm = port_losses.cross_entropy(
        lt, torch.from_numpy(labels),
        None if m is None else torch.from_numpy(m), vocab_size=V)
    pl.backward()
    assert float(pl.detach()) == pytest.approx(float(rl), rel=1e-6)
    for k in ("accuracy", "tokens"):
        assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(rg), atol=1e-6)
    assert np.all(lt.grad.numpy()[..., V:] == 0)


@pytest.mark.parametrize("dtype,chunk", [("float32", 4), ("float32", 0),
                                         ("float32", 5),
                                         ("bfloat16", 4)])
def test_chunked_ce_and_grads_match_jax(dtype, chunk):
    """Chunks when T > chunk and T % chunk == 0 (chunk 5 takes the whole
    logits); bfloat16 logits are rounded before the float32 loss on both
    sides."""
    rng = np.random.default_rng(2)
    x, w, labels, mask, V = _ce_inputs(rng)
    jdt = jnp.dtype(dtype)

    def ref_loss(xx, ww):
        return ref_losses.chunked_ce(xx.astype(jdt), ww, jnp.asarray(labels),
                                     jnp.asarray(mask), V, chunk)

    (rl, rm), (rgx, rgw) = jax.value_and_grad(ref_loss, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    pl, pm = port_losses.chunked_ce(xt.to(getattr(torch, dtype)), wt,
                                    torch.from_numpy(labels),
                                    torch.from_numpy(mask), V, chunk)
    pl.backward()
    tol = 1e-6 if dtype == "float32" else 2e-3
    assert float(pl.detach()) == pytest.approx(float(rl), rel=tol)
    assert float(pm["tokens"]) == float(rm["tokens"])
    assert float(pm["accuracy"]) == pytest.approx(float(rm["accuracy"]),
                                                  abs=1 / 32)
    gtol = dict(atol=1e-6, rtol=1e-5) if dtype == "float32" else \
        dict(atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rgx), **gtol)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(rgw), **gtol)


# --------------------------------------------------------------------------- #
# the train step against JAX
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("accum,ce_chunk,layers", [(1, 0, 3), (2, 8, 3),
                                                   (2, 8, 6)])
def test_train_step_float32_matches_jax(accum, ce_chunk, layers):
    """Three steps from the same parameters: 6 layers make a stacked
    segment (repeats 2), whose norm scales decay."""
    rm, pm, p0, r3, p3, _, pstate = _run_both("float32", accum, ce_chunk,
                                              layers)
    for a, b in zip(rm, pm):
        assert a.keys() == b.keys()
        for k in ("loss", "grad_norm", "lr"):
            assert b[k] == pytest.approx(a[k], rel=F32[k]), k
        assert b["tokens"] == a["tokens"]
        assert b["aux_loss"] == a["aux_loss"] == 0.0
    assert int(pstate.opt.step) == 3
    assert golden.update_rel(p0, r3, p3) <= F32["update_rel"]
    if layers == 6:
        scale = "segments/0/block0/norm1/scale"
        assert p3[scale].shape == (2, 64)
        assert not np.array_equal(p3[scale], p0[scale])


@pytest.mark.parametrize("accum,ce_chunk", [(1, 0), (2, 8)])
def test_train_step_bfloat16_matches_jax(accum, ce_chunk):
    rm, pm, p0, r3, p3, _, _ = _run_both("bfloat16", accum, ce_chunk)
    for a, b in zip(rm, pm):
        assert b["loss"] == pytest.approx(a["loss"], rel=BF16["loss"])
        assert b["grad_norm"] == pytest.approx(a["grad_norm"],
                                               rel=BF16["grad_norm"])
        assert b["accuracy"] == pytest.approx(a["accuracy"],
                                              abs=BF16["accuracy"])
        assert b["lr"] == pytest.approx(a["lr"], rel=F32["lr"])
    assert golden.update_rel(p0, r3, p3) <= BF16["update_rel"]


def test_forward_hidden_and_head_match_forward_train():
    """The chunked-CE path's pieces give forward_train's logits; remat
    changes no number and still reaches every parameter."""
    _, cfg = _configs(num_layers=6)
    gen = torch.Generator().manual_seed(0)
    params = port_ts.init_train_state(gen, cfg, "cpu").params
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    logits, aux = port_tf.forward_train(params, {"tokens": tokens}, cfg)
    x, aux2 = port_tf.forward_hidden(params, {"tokens": tokens}, cfg)
    torch.testing.assert_close(x @ port_tf.head_weights(params, cfg), logits)
    assert float(aux) == float(aux2) == 0.0
    p = map_tree(lambda _, t: t.detach().requires_grad_(), params)
    grads = []
    for remat in (True, False):
        lg, _ = port_tf.forward_train(p, {"tokens": tokens}, cfg, remat=remat)
        grads.append(torch.autograd.grad(lg.square().mean(), [
            t for _, t in leaves_with_paths(p)]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# the golden fixture (carried to the card)
# --------------------------------------------------------------------------- #

def build_fixture() -> dict:
    """The fixture's train-step arrays, computed by the JAX package."""
    rcfg, _ = _configs(ce_chunk=FIX["ce_chunk"])
    roc, _ = _opt_cfgs(learning_rate=FIX["learning_rate"],
                       warmup_steps=FIX["warmup_steps"],
                       total_steps=FIX["total_steps"])
    state = ref_ts.init_train_state(jax.random.key(0), rcfg)
    out = {f"init/{k}": v for k, v in _ref_leaves(state.params).items()}
    data = ref_data.SyntheticLM(rcfg, ref_data.DataConfig(
        batch_size=FIX["batch_size"], seq_len=FIX["seq_len"],
        accum=FIX["accum"]))
    step = jax.jit(ref_ts.make_train_step(rcfg, roc, accum=FIX["accum"]))
    ms = []
    for s in range(FIX["steps"]):
        state, m = step(state, jax.tree.map(jnp.asarray, data.batch(s)))
        ms.append(m)
    out.update({f"final/{k}": v
                for k, v in _ref_leaves(state.params).items()})
    for k in ("loss", "grad_norm", "lr"):
        out[k] = np.asarray([float(m[k]) for m in ms], np.float64)
    out.update({k: np.asarray(v) for k, v in FIX.items()})
    return out


def load_fixture() -> dict:
    with np.load(GOLDEN, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def committed():
    return load_fixture()


def test_fixture_matches_jax_reference(committed):
    fresh = build_fixture()
    assert set(fresh) == set(committed)
    for key, want in fresh.items():
        np.testing.assert_allclose(committed[key], want, rtol=1e-6,
                                   atol=1e-7, err_msg=key)


def test_port_reproduces_fixture_on_cpu(committed):
    """What chip_smoke.py's train_golden runs on the card, on the CPU:
    ``golden.replay`` of the committed fixture within ``golden.TOL``."""
    assert golden.TOL == F32
    r = golden.replay(committed, torch.device("cpu"))
    for s, got in enumerate(r["per_step"]):
        for k in ("loss", "grad_norm", "lr"):
            assert got[k] == pytest.approx(float(committed[k][s]),
                                           rel=F32[k]), k
    assert r["update_rel_err"] <= F32["update_rel"]
    assert max(r["worst_share_of_tol"].values()) <= 1.0


# --------------------------------------------------------------------------- #
# Trainer, CLI, device rules
# --------------------------------------------------------------------------- #

def _trainer(d, log=lambda s: None, steps=4):
    _, cfg = _configs(num_layers=6, ce_chunk=8)
    return Trainer(cfg, port_opt.OptimizerConfig(learning_rate=1e-3,
                                                 warmup_steps=2,
                                                 total_steps=steps),
                   port_data.DataConfig(batch_size=2, seq_len=32, accum=2),
                   TrainerConfig(total_steps=steps, checkpoint_every=2,
                                 checkpoint_dir=d, keep_checkpoints=1,
                                 log_every=1),
                   log_fn=log, device="cpu")


def test_trainer_preempt_and_resume_reproduce_losses():
    """Another thread sets the evict signal after step 2; the job
    checkpoints and returns; a new trainer resumes from step 2 and its
    losses equal an uninterrupted run's."""
    with tempfile.TemporaryDirectory() as d:
        full = _trainer(os.path.join(d, "full"))
        assert full.run()["completed"] == 1.0
        want = [h["loss"] for h in full.history]
        assert len(want) == 4 and want[-1] < want[0]
        assert sorted(os.listdir(os.path.join(d, "full"))) == [
            "LATEST", "step_00000004"]

        at_two, stop_set = threading.Event(), threading.Event()

        def log(msg):
            if msg.startswith("[trainer] step 2 "):
                at_two.set()
                stop_set.wait(300)

        tr = _trainer(os.path.join(d, "pre"), log=log)
        stopper = threading.Thread(target=lambda: (
            at_two.wait(300), tr.request_stop(), stop_set.set()))
        stopper.start()
        result = tr.run()
        stopper.join()
        assert tr.stopped and result == {"completed": 0.0, "step": 2.0}

        back = _trainer(os.path.join(d, "pre"))
        assert back.step == 2
        assert back.run()["completed"] == 1.0
        assert [h["loss"] for h in back.history] == want[2:]


def test_cli_trains_on_cpu_and_needs_a_card_otherwise(tmp_path):
    from repro_torch.launch import train as cli
    args = ["--steps", "2", "--batch-size", "2", "--seq-len", "16",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "1"]
    result = cli.main(args + ["--device", "cpu"])
    assert result["completed"] == 1.0 and result["step"] == 2.0
    assert sorted(os.listdir(tmp_path))[-1] == "step_00000002"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)


def test_trainer_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None takes it")
    _, cfg = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, port_opt.OptimizerConfig(), port_data.DataConfig(),
                TrainerConfig())


@pytest.mark.parametrize("name", ["xlstm-125m", "deepseek-moe-16b",
                                  "command-r-35b", "qwen1.5-32b",
                                  "whisper-medium", "internvl2-26b"])
def test_loss_and_every_gradient_match_jax(name):
    """``_loss_fn`` and its gradient on the float32 TINY twins of the
    xLSTM, MoE, parallel-block / padded-head, encoder-decoder and
    vision-prefix plans (the last two with their modality input drawn
    with numpy), against JAX's on shared parameters: the loss (the MoE aux included) to ``rtol 1e-6``
    (float32 sums in another order move its last digit: 0.5 to 3.5e-7
    seen), each gradient leaf within 1e-5 of that leaf's largest value
    (4.7e-6 seen), and a leaf JAX leaves at zero zero; a key bias
    without RoPE, whose gradient is zero analytically, below 1e-7 of the
    tree's largest gradient in both."""
    ref_cfg = dataclasses.replace(ref_get_config(name, tiny=True),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config(name, tiny=True), dtype="float32")
    tree = numpy_params(port_tf.model_specs(cfg), 4)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    rng = np.random.default_rng(6)
    if cfg.family == "audio":
        batch["audio_embeds"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["pixel_embeds"] = rng.standard_normal(
            (2, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_ts._loss_fn(p, b, ref_cfg, False), has_aux=True))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = map_tree(lambda _, t: t.requires_grad_(),
                      params_from_numpy(tree, "cpu"))
    tl, _ = port_ts._loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
        False)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jg)))
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, leaf in leaves_with_paths(params):
        got, w = leaf.grad.numpy(), want[path]
        if path[-1] == "b_k" and not cfg.use_rope:
            # Without RoPE a key bias adds q.b_k to every logit of a
            # query's row, which the softmax cancels: its gradient is 0
            # but for float32 rounding in both (Whisper: 1e-11 to 1.6e-10
            # seen, the largest gradient 0.062), held below float32's
            # epsilon of the largest gradient.
            assert max(np.abs(got).max(), np.abs(w).max()) <= 1e-7 * top
            continue
        assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), path


def test_training_configs_carry_reference_knobs():
    ref, port = ref_get_config(NAME), get_config(NAME)
    for k in ("ce_chunk", "train_accum"):
        assert getattr(port, k) == getattr(ref, k)
    assert (port.ce_chunk, port.train_accum) == (1024, 2)


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_train.py --regen")
    np.savez_compressed(GOLDEN, **build_fixture())
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
