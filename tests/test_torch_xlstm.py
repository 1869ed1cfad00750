"""PyTorch port, xLSTM-125M: ``repro_torch.models.xlstm`` (the mLSTM
decode path, the sLSTM), the xLSTM layer plan and blocks in
``repro_torch.models.transformer``, ``ServeEngine`` over them, the serve
CLI ``repro_torch.launch.serve``, and the golden fixture
``tests/data/torch_xlstm_serve_golden/expected.npz``, all against the JAX
package on the CPU.

Parameters cross as numpy arrays drawn by
``repro_torch.models.params.numpy_params`` (``numpy.random.default_rng``),
which both packages read.  The fixture is a float32 twin at
xLSTM-125M's widths (d_model 768, 4 heads, mLSTM heads 384 wide) cut to
8 layers and a vocab of 512: it stores the seed, the parameters' digest,
JAX's prefill and decode logits and a JAX ``ServeEngine`` run's greedy
tokens; ``chip_smoke.py`` redraws the parameters and holds the port on
the card (through the mLSTM kernel at dk 384) to it.

Tolerances: float32 cells and blocks ``atol 1e-5, rtol 1e-4`` (the same
float32 arithmetic; exp, log1p and sums in another order move the last
bits); float32 logits ``atol 1e-4, rtol 1e-3`` as the RecurrentGemma
serve tests (sums over 384-wide heads and 8 layers in another order);
bfloat16 logits no farther from JAX's float32 logits than 1.5 times
JAX's own bfloat16 logits are, plus ``2e-3 * max|logit|``: the two
frameworks round to bfloat16 at other places, and over the sLSTM's
exponential gates the two bfloat16 runs drift apart by up to 6 % of the
largest logit (each about as far from float32); greedy tokens equal.

Regenerate the fixture after an intentional change::

    PYTHONPATH=src python tests/test_torch_xlstm.py --regen
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
from repro.configs.base import BlockSpec as RefBlockSpec
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro.models import xlstm as ref_xlstm
from repro.serve import engine as ref_engine

from repro_torch.configs import get_config
from repro_torch.configs.base import BlockSpec
from repro_torch.launch import serve as serve_cli
from repro_torch.models import params as port_params
from repro_torch.models import transformer as port_tf
from repro_torch.models import xlstm as port_xlstm
from repro_torch.models.params import leaves_with_paths, numpy_params
from repro_torch.serve import engine as port_engine
from repro_torch.serve import golden

GOLDEN = Path(__file__).resolve().parent / "data" / \
    "torch_xlstm_serve_golden"
NAME = "xlstm-125m"
CELL_TOL = dict(atol=1e-5, rtol=1e-4)
F32_TOL = dict(atol=1e-4, rtol=1e-3)
METRIC_KEYS = ("elapsed_s", "mean_ttft_s", "requests", "tokens",
               "tokens_per_s")


def _configs(dtype="float32", **overrides):
    ref = dataclasses.replace(ref_get_config(NAME, tiny=True), dtype=dtype,
                              **overrides)
    port = dataclasses.replace(get_config(NAME, tiny=True), dtype=dtype,
                               **overrides)
    return ref, port


def _port_params(tree, cfg, dtype=None):
    return port_params.params_from_numpy(
        tree, "cpu", dtype=dtype or port_tf.serving_dtype(cfg))


def _shared(cfg, seed=2, dtype=None):
    tree = numpy_params(port_tf.model_specs(cfg), seed)
    return tree, _port_params(tree, cfg, dtype)


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") and \
        not isinstance(x, torch.Tensor) else x.float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# --------------------------------------------------------------------------- #
# config and specs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tiny", [True, False])
def test_plan_specs_and_count_match_jax(tiny):
    """The layer plan, the spec tree's keys and shapes, and the parameter
    count (the full configuration by shapes only)."""
    ref_cfg, cfg = ref_get_config(NAME, tiny=tiny), get_config(NAME,
                                                               tiny=tiny)
    plan = cfg.layer_plan()
    assert [(s.repeats, [(b.mixer, b.mlp) for b in s.blocks])
            for s in plan] == [
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
        assert n == 184_237_896
        assert cfg.source == "arXiv:2405.04517"
        assert plan[0].repeats == 3 and [b.mixer for b in plan[0].blocks] \
            == ["mlstm"] * 3 + ["slstm"]
        assert "norm2" not in specs["segments"][0]["block0"]


def test_plan_without_slstm_and_unported_plans_raise():
    _, cfg = _configs(num_layers=6)
    (seg,) = cfg.layer_plan()
    assert seg.repeats == 6 and seg.blocks == (BlockSpec("mlstm", "none"),)
    # the encoder-decoder plan is ported: cross attention in dense blocks
    for family in ("audio", "dense"):
        (enc_dec,) = dataclasses.replace(cfg, family=family,
                                         is_encoder_decoder=True).layer_plan()
        assert enc_dec.repeats == 6 and enc_dec.blocks == (
            BlockSpec("attn", "dense", cross_attn=True),)
    # a mixer that no reference config uses still raises, saying so
    with pytest.raises(NotImplementedError, match="no reference config"):
        port_tf._block_specs(BlockSpec("cross_attn", "dense"), cfg)


def test_serving_dtype_holds_slstm_leaves_in_the_activation_dtype():
    """Norm scales, the mLSTM's out-norm scale and RG-LRU's gate leaves
    stay float32; the sLSTM's ``w_x`` and ``bias``, which the reference
    reads only in ``cfg.dtype``, are held in it like every other leaf."""
    _, cfg = _configs("bfloat16", num_layers=8)
    g = torch.Generator().manual_seed(0)
    specs = port_tf.model_specs(cfg)
    params = port_params.init_params(specs, g, "cpu",
                                     dtype=port_tf.serving_dtype(cfg))
    seen = set()
    for path, t in leaves_with_paths(params):
        f32 = path[-1] == "scale"
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), path
        seen.add(path[-2] if path[-1] == "scale" else path[-1])
    assert {"w_x", "bias", "r_h", "norm1", "out_norm", "final_norm"} <= seen
    slstm = params["segments"][0]["block3"]["mixer"]
    assert slstm["w_x"].dtype == slstm["bias"].dtype == torch.bfloat16
    rg = get_config("recurrentgemma-9b", tiny=True)
    rg_dtype = port_tf.serving_dtype(rg)
    assert rg_dtype(("segments", 0, "block0", "mixer", "w_x")) == \
        torch.float32


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #

def _slstm_state(rng, B, D):
    return (rng.standard_normal((B, D)).astype(np.float32),
            np.abs(rng.standard_normal((B, D))).astype(np.float32) + 0.5,
            rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


def test_slstm_cell_and_gates_match_jax():
    _, cfg = _configs()
    rng = np.random.default_rng(0)
    B, D = 3, cfg.d_model
    gates = (2 * rng.standard_normal((B, 4, D))).astype(np.float32)
    state = _slstm_state(rng, B, D)
    want = ref_xlstm._slstm_cell(jnp.asarray(gates),
                                 tuple(map(jnp.asarray, state)))
    got = port_xlstm._slstm_cell(torch.from_numpy(gates),
                                 tuple(map(torch.from_numpy, state)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, CELL_TOL)
    tree = numpy_params(port_xlstm.slstm_specs(cfg), 1)
    tree["bias"] = rng.standard_normal((4, D)).astype(np.float32)
    p = _port_params(tree, cfg, torch.float32)
    xt = rng.standard_normal((B, D)).astype(np.float32)
    _close(port_xlstm._slstm_gates(p, torch.from_numpy(xt),
                                   torch.from_numpy(state[3]), cfg),
           ref_xlstm._slstm_gates(tree, jnp.asarray(xt),
                                  jnp.asarray(state[3]), cfg), CELL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_slstm_prefill_state_and_decode_match_jax(dtype):
    """``apply_slstm`` and ``slstm_prefill`` (one walk: output and final
    state) against the reference's scan and ``_slstm_final_state``; then
    two decode steps from that state."""
    ref_cfg, cfg = _configs(dtype)
    rng = np.random.default_rng(1)
    tree = numpy_params(port_xlstm.slstm_specs(cfg), 2)
    tree["bias"] = rng.standard_normal((4, cfg.d_model)).astype(np.float32)
    p = _port_params(tree, cfg, torch.float32)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    dt = getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jnp.dtype(dtype)), \
        torch.from_numpy(x).to(dt)
    tol = CELL_TOL if dtype == "float32" else dict(atol=5e-2, rtol=5e-2)
    want = ref_xlstm.apply_slstm(tree, jx, ref_cfg)
    out = port_xlstm.apply_slstm(p, tx, cfg)
    assert out.dtype == dt
    _close(out, want, tol)
    out2, st = port_xlstm.slstm_prefill(p, tx, cfg)
    assert torch.equal(out2, out)
    want_st = ref_tf._slstm_final_state(tree, jx, ref_cfg)
    for key in ("c", "n", "m", "h"):
        assert st[key].dtype == torch.float32
        _close(st[key], want_st[key], tol)
    x1 = rng.standard_normal((2, 2, cfg.d_model)).astype(np.float32)
    jst = want_st
    for i in range(2):
        jo, jst = ref_xlstm.apply_slstm_decode(
            tree, jnp.asarray(x1[:, i:i + 1]).astype(jnp.dtype(dtype)),
            ref_cfg, jst)
        to, st = port_xlstm.apply_slstm_decode(
            p, torch.from_numpy(x1[:, i:i + 1]).to(dt), cfg, st)
        assert to.shape == (2, 1, cfg.d_model) and to.dtype == dt
        _close(to, jo, tol)
        for key in ("c", "n", "m", "h"):
            _close(st[key], jst[key], tol)


def test_slstm_decode_init_matches_jax():
    ref_cfg, cfg = _configs()
    want = ref_xlstm.slstm_decode_init(ref_cfg, 3)
    got = port_xlstm.slstm_decode_init(cfg, 3, "cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32
        assert np.array_equal(got[key].numpy(), np.asarray(want[key]))


# The sLSTM's memory plan: under grad the walk is checkpointed in
# SLSTM_TIME_CHUNK-step chunks, as the reference's (T 512: two chunks;
# T 300, not a multiple of 256: one chunk of the whole T).

def _whole_walk(gx, r_h, bias, cfg):
    """The walk without the remat: one loop over all T, every step's
    autograd state kept."""
    state = port_xlstm.slstm_decode_init(cfg, gx.shape[0], gx.device)
    return port_xlstm._walk_steps(gx, r_h, bias,
                                  *(state[k] for k in ("c", "n", "m", "h")))


def _ops_walk(gx, r_h, bias, cfg):
    """The walk as the cell's ops composed, with no autograd node of its
    own and no remat: the loop the prefill ran before the memory plan."""
    st = port_xlstm.slstm_decode_init(cfg, gx.shape[0], gx.device)
    c, n, m, h = (st[k] for k in ("c", "n", "m", "h"))
    hs = []
    for t in range(gx.shape[1]):
        gates = gx[:, t] + port_xlstm._slstm_gh(r_h, h, gx.dtype) + bias
        c, n, m, h = port_xlstm._slstm_cell_parts(gates, c, n, m)[0]
        hs.append(h)
    return torch.stack(hs, 1), c, n, m, h


def _slstm_loss_and_grads(p_np, x, cot, cfg, walk=None):
    """``apply_slstm``'s loss ``sum(out * cot)`` and the gradients of
    every parameter and of x, float32 on the CPU; ``walk`` replaces the
    package's ``_walk`` for the call.  Also the calls the walk made to
    ``checkpoint`` and to ``_walk_steps``."""
    p = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    tx = torch.tensor(x, requires_grad=True)
    calls = {"checkpoint": 0, "steps": 0}
    orig = (port_xlstm._walk, port_xlstm.checkpoint, port_xlstm._walk_steps)

    def counted_checkpoint(*a, **kw):
        calls["checkpoint"] += 1
        return orig[1](*a, **kw)

    def counted_steps(*a, **kw):
        calls["steps"] += 1
        return orig[2](*a, **kw)

    port_xlstm._walk = walk or orig[0]
    port_xlstm.checkpoint = counted_checkpoint
    port_xlstm._walk_steps = counted_steps
    try:
        loss = (port_xlstm.apply_slstm(p, tx, cfg)
                * torch.from_numpy(cot)).sum()
        loss.backward()
    finally:
        port_xlstm._walk, port_xlstm.checkpoint, port_xlstm._walk_steps = orig
    grads = {k: v.grad for k, v in p.items()}
    grads["x"] = tx.grad
    return loss, grads, calls


def _slstm_case(T, seed=5):
    ref_cfg, cfg = _configs()
    rng = np.random.default_rng(seed)
    tree = numpy_params(port_xlstm.slstm_specs(cfg), seed)
    tree["bias"] = rng.standard_normal((4, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, tree, x, cot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_cell_step_function_matches_autograd(dtype):
    """The cell (one autograd node, the chain rule by hand, reached as
    ``_slstm_cell``): the same outputs as its ops composed
    (``_slstm_cell_parts``, ``==``) and the gradients of autograd
    through those ops, at ties of ``maximum`` and on both sides of
    ``clamp_min``'s edge."""
    rng = np.random.default_rng(7)
    B, D = 3, 64
    gates = (2 * rng.standard_normal((B, 4, D))).astype(np.float32)
    c, n, m = (rng.standard_normal((B, D)).astype(np.float32),
               np.abs(rng.standard_normal((B, D))).astype(np.float32),
               rng.standard_normal((B, D)).astype(np.float32))
    n[0] *= 0.05                       # n_new below 1 in part of row 0
    dt = getattr(torch, dtype)
    g = torch.from_numpy(gates).to(dt)
    a = (torch.nn.functional.logsigmoid(g.float()[:, 1])
         + torch.from_numpy(m))
    g[1, 0, :8] = a[1, :8].to(dt)       # i_raw where it may tie a
    if dtype == "float32":
        assert (g[:, 0] == a).any()
    cots = [torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
            for _ in range(4)]

    def run(fn):
        ins = [g.clone().requires_grad_()] + [
            torch.from_numpy(v).clone().requires_grad_() for v in (c, n, m)]
        outs = fn(*ins)
        sum((o * w).sum() for o, w in zip(outs, cots)).backward()
        return outs, [t.grad for t in ins]

    got_out, got = run(lambda gg, cc, nn, mm: port_xlstm._slstm_cell(
        gg, (cc, nn, mm, None)))
    want_out, want = run(lambda gg, cc, nn, mm:
                         port_xlstm._slstm_cell_parts(gg, cc, nn, mm)[0])
    for go, wo in zip(got_out, want_out):
        assert torch.equal(go, wo)
    assert got[0].dtype == dt
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("T,chunks", [(512, 2), (300, 1)])
def test_slstm_remat_chunks_and_grads_equal_the_whole_walk(T, chunks):
    """Loss and every gradient leaf with the chunked remat ``==`` the
    walk over all T without it; the plan checkpoints ``chunks`` chunks
    and recomputes each once in the backward."""
    _, cfg, tree, x, cot = _slstm_case(T)
    loss, grads, calls = _slstm_loss_and_grads(tree, x, cot, cfg)
    assert calls == {"checkpoint": chunks, "steps": 2 * chunks}
    want_loss, want, plain_calls = _slstm_loss_and_grads(
        tree, x, cot, cfg, walk=_whole_walk)
    assert plain_calls == {"checkpoint": 0, "steps": 1}
    assert loss.item() == want_loss.item()
    assert sorted(grads) == sorted(want) == ["bias", "r_h", "w_out",
                                             "w_x", "x"]
    for k in grads:
        assert torch.equal(grads[k], want[k]), k


def test_slstm_remat_grads_match_jax_grad():
    """At T 512 both walks' gradients within ``CELL_TOL`` of
    ``jax.grad`` through the reference's ``apply_slstm``, whose chunked
    branch (two ``jax.checkpoint`` chunks of 256) T 512 takes."""
    ref_cfg, cfg, tree, x, cot = _slstm_case(512)
    assert ref_xlstm.SLSTM_TIME_CHUNK == port_xlstm.SLSTM_TIME_CHUNK == 256

    def ref_loss(p, xx):
        return jnp.sum(ref_xlstm.apply_slstm(p, xx, ref_cfg)
                       * jnp.asarray(cot))

    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    want_loss, (gp, gx) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jtree, jnp.asarray(x))
    want = dict(gp, x=gx)
    for walk in (None, _whole_walk):
        loss, grads, _ = _slstm_loss_and_grads(tree, x, cot, cfg, walk=walk)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
        for k in want:
            _close(grads[k], want[k], CELL_TOL)


def test_slstm_prefill_under_no_grad_is_the_plain_walk():
    """Serving's prefill runs under ``no_grad``: no checkpoint, and the
    output and state ``==`` the cell's ops composed over the whole T (the
    prefill before the memory plan)."""
    _, cfg, tree, x, _ = _slstm_case(512)
    p = _port_params(tree, cfg, torch.float32)
    tx = torch.from_numpy(x)
    seen = []
    orig = port_xlstm.checkpoint
    port_xlstm.checkpoint = lambda *a, **kw: seen.append(1) or orig(*a, **kw)
    try:
        with torch.no_grad():
            out, st = port_xlstm.slstm_prefill(p, tx, cfg)
            gx = port_xlstm._slstm_gx(p, tx)
            h, *want_st = _ops_walk(gx, p["r_h"], p["bias"], cfg)
            want = port_xlstm._slstm_out(p, h, tx.dtype)
    finally:
        port_xlstm.checkpoint = orig
    assert not seen
    assert torch.equal(out, want)
    for key, w in zip(("c", "n", "m", "h"), want_st):
        assert torch.equal(st[key], w)


# --------------------------------------------------------------------------- #
# mLSTM decode
# --------------------------------------------------------------------------- #

def test_mlstm_decode_step_matches_jax():
    rng = np.random.default_rng(3)
    B, H, dh = 2, 3, 16
    q, k, v = (rng.standard_normal((B, H, 1, dh)).astype(np.float32)
               for _ in range(3))
    i, f = (rng.standard_normal((B, H, 1)).astype(np.float32)
            for _ in range(2))
    state = (rng.standard_normal((B, H, dh, dh)).astype(np.float32),
             np.abs(rng.standard_normal((B, H, dh))).astype(np.float32),
             np.asarray([[-1e30, 0.5, -2.0], [1.0, -1e30, 3.0]],
                        np.float32))
    jh, jst = ref_xlstm.mlstm_decode_step(
        *map(jnp.asarray, (q, k, v, i, f)), tuple(map(jnp.asarray, state)))
    th, tst = port_xlstm.mlstm_decode_step(
        *map(torch.from_numpy, (q, k, v, i, f)),
        tuple(map(torch.from_numpy, state)))
    assert th.shape == (B, H, 1, dh) and th.dtype == torch.float32
    _close(th, jh, CELL_TOL)
    for g, w in zip(tst, jst):
        _close(g, w, CELL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_qkv_with_conv_state_matches_jax(dtype):
    """One token against a float32 conv state: with a bfloat16 x the conv
    output, q, k and the gates are float32 (JAX's promotion) and v is
    bfloat16; the new conv state is float32."""
    ref_cfg, cfg = _configs(dtype)
    rng = np.random.default_rng(4)
    tree = numpy_params(port_xlstm.mlstm_specs(cfg), 5)
    for key in ("b_i", "b_f"):
        tree[key] = rng.standard_normal(tree[key].shape).astype(np.float32)
    p = _port_params(tree, cfg, torch.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    d_up = int(cfg.d_model * cfg.proj_factor)
    conv = rng.standard_normal((2, cfg.conv_width - 1, d_up)).astype(
        np.float32)
    want = ref_xlstm._mlstm_qkv(tree, jnp.asarray(x).astype(
        jnp.dtype(dtype)), ref_cfg, conv_state=jnp.asarray(conv))
    got = port_xlstm._mlstm_qkv(p, torch.from_numpy(x).to(
        getattr(torch, dtype)), cfg, conv_state=torch.from_numpy(conv))
    tol = CELL_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    for name, g, w in zip(("q", "k", "v", "i", "f", "gate", "up", "conv"),
                          got, want):
        assert str(g.dtype).split(".")[1] == str(w.dtype), name
        _close(g, w, tol)


def test_mlstm_decode_init_matches_jax():
    ref_cfg, cfg = _configs()
    want = ref_xlstm.mlstm_decode_init(ref_cfg, 2)
    got = port_xlstm.mlstm_decode_init(cfg, 2, "cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32
        assert np.array_equal(got[key].numpy(), np.asarray(want[key]))


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_block_prefill_and_decode_states_match_jax(mixer):
    """One block (no MLP): the prefill's output and decode state, then
    three decode steps' outputs and states, against the reference's
    ``apply_block_prefill`` / ``apply_block_decode``; the training
    forward equals the prefill's output."""
    ref_cfg, cfg = _configs()
    blk, ref_blk = BlockSpec(mixer, "none"), RefBlockSpec(mixer, "none")
    tree = numpy_params(port_tf._block_specs(blk, cfg), 6)
    p = _port_params(tree, cfg)
    assert sorted(p) == ["mixer", "norm1"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    T = 16
    pos = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    jo, jst = ref_tf.apply_block_prefill(ref_blk, tree, jnp.asarray(x[:, :T]),
                                         ref_cfg, positions=jnp.asarray(pos),
                                         cache_len=32)
    to, tst = port_tf.apply_block_prefill(blk, p, torch.from_numpy(x[:, :T]),
                                          cfg, positions=torch.from_numpy(pos),
                                          cache_len=32)
    _close(to, jo, CELL_TOL)
    assert sorted(tst) == sorted(jst)
    for key in jst:
        assert tuple(tst[key].shape) == jst[key].shape, key
        _close(tst[key], jst[key], CELL_TOL)
    train, aux = port_tf.apply_block(blk, p, torch.from_numpy(x[:, :T]),
                                     cfg, positions=torch.from_numpy(pos))
    assert torch.equal(train, to) and aux is None
    for i in range(T, T + 3):
        jo, jst = ref_tf.apply_block_decode(ref_blk, tree,
                                            jnp.asarray(x[:, i:i + 1]),
                                            ref_cfg, jst)
        to, tst = port_tf.apply_block_decode(blk, p,
                                             torch.from_numpy(x[:, i:i + 1]),
                                             cfg, tst)
        _close(to, jo, CELL_TOL)
        for key in jst:
            _close(tst[key], jst[key], CELL_TOL)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_init_block_state_is_float32_whatever_the_cache_dtype(mixer):
    ref_cfg, cfg = _configs("bfloat16")
    st = port_tf.init_block_state(BlockSpec(mixer, "none"), cfg, 3, 64,
                                  dtype=torch.bfloat16, device="cpu")
    want = ref_tf.init_block_state(RefBlockSpec(mixer, "none"), ref_cfg, 3,
                                   64)
    assert sorted(st) == sorted(want)
    for key, t in st.items():
        assert t.dtype == torch.float32 and tuple(t.shape) == \
            want[key].shape
        assert np.array_equal(t.numpy(), np.asarray(want[key]))


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #

def _serve_logits(prefill, decode_step, params, cfg, tokens, wrap, P=16,
                  steps=8):
    """Prefill P tokens, then ``steps`` decode steps: the logit rows."""
    lg, st = prefill(params, {"tokens": wrap(tokens[:, :P])}, cfg, 64)
    out = [lg]
    for i in range(P, P + steps):
        lg, st = decode_step(params, wrap(tokens[:, i:i + 1]), st, cfg)
        out.append(lg)
    return out, st


@pytest.mark.parametrize("layers", [4, 8])
def test_prefill_8_decode_steps_and_states_match_jax(layers):
    """``TINY`` (one superblock) and an 8-layer twin (its segment stacked,
    repeats 2): prefill logits, 8 decode steps' logits and the final
    decode states, float32."""
    ref_cfg, cfg = _configs(num_layers=layers)
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24))
    want, jst = _serve_logits(ref_tf.prefill, ref_tf.decode_step, tree,
                              ref_cfg, tokens, jnp.asarray)
    got, tst = _serve_logits(port_tf.prefill, port_tf.decode_step, params,
                             cfg, tokens, torch.from_numpy)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, F32_TOL)
    for (path, g), (_, w) in zip(leaves_with_paths(tst),
                                 leaves_with_paths(jst)):
        assert tuple(g.shape) == w.shape, path
        _close(g, w, F32_TOL)
    if layers == 8:
        assert tst[0]["block0"]["C"].shape == (2, 2, 4, 32, 32)


def test_bfloat16_logits_as_close_to_float32_as_jax():
    ref_cfg, cfg = _configs("bfloat16", num_layers=8)
    tree, params = _shared(cfg)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 20))
    run = dict(P=16, steps=4)
    f32, _ = _serve_logits(ref_tf.prefill, ref_tf.decode_step, tree,
                           dataclasses.replace(ref_cfg, dtype="float32"),
                           tokens, jnp.asarray, **run)
    jb, _ = _serve_logits(ref_tf.prefill, ref_tf.decode_step, tree, ref_cfg,
                          tokens, jnp.asarray, **run)
    tb, _ = _serve_logits(port_tf.prefill, port_tf.decode_step, params, cfg,
                          tokens, torch.from_numpy, **run)
    for t, j, ref in zip(tb, jb, f32):
        assert t.dtype == torch.bfloat16
        ref, t, j = _np(ref), _np(t), _np(j)
        scale = float(np.abs(ref).max())
        assert np.abs(t - ref).max() <= (1.5 * np.abs(j - ref).max()
                                         + 2e-3 * scale)


def test_decode_matches_teacher_forcing():
    """Prefill 64 tokens (one chunk), decode 5: each logit row equals
    ``forward_train``'s over 128 tokens (two chunks) at that position."""
    _, cfg = _configs(num_layers=8)
    g = torch.Generator().manual_seed(0)
    params = port_params.init_params(port_tf.model_specs(cfg), g, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
    full, _ = port_tf.forward_train(params, {"tokens": tokens}, cfg)
    lg, st = port_tf.prefill(params, {"tokens": tokens[:, :64]}, cfg, 128)
    torch.testing.assert_close(lg, full[:, 63], **F32_TOL)
    for i in range(64, 69):
        lg, st = port_tf.decode_step(params, tokens[:, i:i + 1], st, cfg)
        torch.testing.assert_close(lg, full[:, i], **F32_TOL)


def test_prompt_not_a_multiple_of_the_chunk_raises():
    _, cfg = _configs()
    _, params = _shared(cfg)
    tokens = torch.zeros((1, 100), dtype=torch.int64)
    with pytest.raises(ValueError, match="chunk length 64"):
        port_tf.prefill(params, {"tokens": tokens}, cfg, 128)
    lg, _ = port_tf.prefill(params, {"tokens": tokens[:, :63]}, cfg, 128)
    assert lg.shape == (1, 512)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #

def _requests(module, prompts, reqs):
    return [module.Request(uid=i, prompt=prompts[i], max_new_tokens=new,
                           submitted_at=at)
            for i, (_, new, at) in enumerate(reqs)]


def _prompts(reqs, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n, _, _ in reqs]


def _ref_engine_run(cfg, tree, prompts, reqs, slots, cache_len):
    clock, sleep = golden.virtual_clock()
    eng = ref_engine.ServeEngine(cfg, tree, ref_engine.EngineConfig(
        num_slots=slots, cache_len=cache_len), clock=clock)
    rs = _requests(ref_engine, prompts, reqs)
    metrics = ref_engine.run_server(eng, rs, log=lambda s: None, clock=clock,
                                    sleep=sleep)
    return rs, metrics


def _port_engine_run(cfg, params, prompts, reqs, slots, cache_len,
                     device="cpu"):
    clock, sleep = golden.virtual_clock()
    eng = port_engine.ServeEngine(cfg, params, port_engine.EngineConfig(
        num_slots=slots, cache_len=cache_len), clock=clock, device=device)
    rs = _requests(port_engine, prompts, reqs)
    metrics = port_engine.run_server(eng, rs, log=lambda s: None,
                                     clock=clock, sleep=sleep)
    return rs, metrics


@pytest.mark.parametrize("layers", [4, 8])
def test_engine_greedy_tokens_equal_jax(layers):
    """Staggered admission on 3 slots (the 8-layer twin's state leaves
    carry a leading layer axis): greedy tokens, stamps and metrics
    ``==`` JAX's engine."""
    ref_cfg, cfg = _configs(num_layers=layers)
    tree, params = _shared(cfg, seed=3)
    reqs = ((9, 6, 0.0), (4, 8, 0.0), (13, 5, 0.5), (6, 4, 2.0))
    prompts = _prompts(reqs, cfg.vocab_size, 10)
    want, wm = _ref_engine_run(ref_cfg, tree, prompts, reqs, 3, 32)
    got, gm = _port_engine_run(cfg, params, prompts, reqs, 3, 32)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, g.uid
        assert (g.first_token_at, g.done_at) == (w.first_token_at,
                                                 w.done_at)
    assert [gm[k] for k in METRIC_KEYS] == [wm[k] for k in METRIC_KEYS]


def test_engine_snapshot_restore_with_stacked_state():
    """The 8-layer twin: a request admitted beside another generates what
    it generates alone, and a snapshot restored into a new engine
    continues identically."""
    _, cfg = _configs(num_layers=8)
    g = torch.Generator().manual_seed(1)
    params = port_params.init_params(port_tf.model_specs(cfg), g, "cpu")
    ecfg = port_engine.EngineConfig(num_slots=2, cache_len=32)
    prompt = (np.arange(10) * 7) % 50
    solo = port_engine.ServeEngine(cfg, params, ecfg, device="cpu")
    r_solo = port_engine.Request(uid=0, prompt=prompt, max_new_tokens=6)
    solo.admit(r_solo)
    while any(solo.active):
        solo.step()
    mixed = port_engine.ServeEngine(cfg, params, ecfg, device="cpu")
    assert mixed.states[0]["block0"]["C"].shape == (2, 2, 4, 32, 32)
    other = port_engine.Request(uid=1, prompt=np.arange(9) % 50,
                                max_new_tokens=12)
    mixed.admit(other)
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
    while r_moved.done_at is None:
        moved.step()
    assert r_moved.tokens == r_solo.tokens


# --------------------------------------------------------------------------- #
# the serve CLI
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-9b"])
def test_serve_cli_on_cpu(arch, capsys):
    metrics = serve_cli.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--slots", "2",
                              "--max-new-tokens", "4",
                              "--mean-interarrival-s", "0"])
    assert metrics["requests"] == 3 and metrics["tokens"] == 12
    assert "[serve]" in capsys.readouterr().out


def test_serve_cli_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--arch", NAME, "--requests", "1"])


# --------------------------------------------------------------------------- #
# the golden fixture
# --------------------------------------------------------------------------- #

def build_fixture() -> dict:
    """The fixture's arrays, computed by the JAX package on the CPU from
    the parameters and inputs of ``repro_torch.serve.golden``."""
    fixture = golden.XLSTM
    ref_cfg = golden.config(fixture, ref_get_config(NAME))
    tree = golden.parameters(fixture)
    tokens, prompts = golden.inputs(fixture)
    lg, *decode = golden.logits(fixture, ref_tf.prefill, ref_tf.decode_step,
                                tree, ref_cfg, tokens, jnp.asarray)
    clock, sleep = golden.virtual_clock()
    eng = ref_engine.ServeEngine(ref_cfg, tree, ref_engine.EngineConfig(
        num_slots=fixture.slots, cache_len=fixture.cache_len), clock=clock)
    reqs = golden.requests(fixture, ref_engine, prompts)
    metrics = ref_engine.run_server(eng, reqs, log=lambda s: None,
                                    clock=clock, sleep=sleep)
    width = max(len(r.tokens) for r in reqs)
    return {
        "seed": np.asarray(fixture.seed),
        "params_digest": np.asarray(port_params.tree_digest(tree)),
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
        if key.endswith("_logits"):
            np.testing.assert_allclose(fresh[key], want, rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        else:
            assert np.array_equal(fresh[key], want), key
    assert (GOLDEN / "expected.npz").stat().st_size < 1_500_000


def test_port_reproduces_fixture_on_cpu(committed):
    report = golden.replay(golden.XLSTM, committed, "cpu")
    assert report["digest_ok"]
    assert report["worst_share_of_tol"] <= 1.0, report
    assert report["engine_tokens_equal"] and report["engine_stamps_equal"]
    assert report["engine_metrics_equal"] and report["ok"]


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_xlstm.py --regen")
    GOLDEN.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN / "expected.npz", **build_fixture())
    size = (GOLDEN / "expected.npz").stat().st_size
    print(f"wrote {GOLDEN / 'expected.npz'} ({size} bytes)")
