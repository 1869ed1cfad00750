"""PyTorch port, distributed layer: ``repro_torch.distributed``
(logical-axis sharding on DTensor, int8-compressed gradient sync,
elastic restore), the sharded train step and the axes trees, against the
JAX package on the CPU.

Multi-rank checks run as gloo worlds of 8 processes
(``tests/torch_dist_worker.py``), each rank rendezvousing on a file
store in ``tmp_path`` (no TCP port, so xdist workers never race for
one), with one intra-op thread and a deadline per world that kills every
rank when it passes.  The JAX side of the layouts and of ``psum_int8``
runs in one subprocess with 8 forced host devices; the single-device
JAX steps run here.

Tolerances, each beside the gap measured on this CPU:
* the sharded TINY DeepSeek-7B step (bfloat16 activations, the
  reference's check) against the port's and JAX's single-device steps:
  loss ``rtol 2e-4`` (1.05e-4 and 1.45e-5 seen: bfloat16 partial sums in
  another order), every updated leaf within ``5e-3`` (6.0e-4 seen:
  AdamW's first step moves an element by lr times the sign of its
  gradient, and a gradient near zero flips sign between summation
  orders, 2 lr = 6e-4): the reference's own bounds.  Since a first
  step's leaves show little more than the gradient's signs, the
  gradient's global norm is held too, ``rtol 5e-3`` (5.5e-4 and 1.4e-4
  seen), and the update (new - old) relative to its own norm
  (``golden.update_rel``) within ``0.2`` (0.086 and 0.094 seen: those
  sign flips; a state left unchanged gives 1);
* every family's float32 TINY twin, sharded, against the port's and
  JAX's single-device steps: loss ``rtol 4e-6`` (3.6e-7 at worst,
  InternVL2 against JAX), leaves ``2e-4`` (1.8e-5 at worst, xLSTM),
  gradient norm ``rtol 4e-6`` (4.2e-7 at worst, Qwen1.5 against JAX),
  update ``1.5e-3`` of its norm (1.6e-4 at worst, xLSTM against JAX);
* ``quantize_int8``, ``psum_int8``, the slices each rank holds, the
  restored checkpoint: ``==``;
* the compression check: the loss ``rtol 1e-6`` of JAX's, float32-synced
  gradients within 1e-6 of JAX's relative to the largest, int8-synced
  ones within one int8 step per pod of JAX's, compressed against float32
  ``rel < 0.02`` (the reference's bound).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.distributed import compression as ref_comp
from repro.distributed import elastic as ref_elastic
from repro.distributed import sharding as ref_sharding
from repro.launch import shapes as ref_shapes
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import compression, elastic, sharding
from repro_torch.launch import shapes
from repro_torch.models import transformer as tf
from repro_torch.models.params import (leaves_with_paths, param_axes,
                                       params_from_numpy)
from repro_torch.train import train_step as ts
from repro_torch.train.golden import update_rel
from repro_torch.train.optimizer import init_opt_state

import torch_dist_worker as worker  # noqa: E402

WORLD = 8
SPAWN_TIMEOUT = 240
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model"), (4, 2): ("data", "model"),
          (8,): ("data",)}


def _flat(tree, prefix=()):
    """{path: leaf} of a tree of dicts, lists and NamedTuples whose
    leaves are axes tuples (or anything that is not such a node)."""
    if hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(_flat(getattr(tree, name), prefix + (name,)))
        return out
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _port_trees(cfg):
    """{name: (axes tree, meta-shape tree)} of a config's four trees."""
    spec_shapes = elastic._param_like(cfg)
    state = elastic.state_like(cfg)
    batch = shapes.train_batch_specs(cfg, shapes.SHAPES["train_4k"])
    _, states = shapes.decode_input_specs(cfg, shapes.SHAPES["decode_32k"])
    accum = max(cfg.train_accum, 1)
    return {"params": (param_axes(tf.model_specs(cfg)), spec_shapes),
            "train_state": (ts.train_state_axes(cfg), state),
            "batch": (ts.batch_axes(cfg, accum), batch),
            "decode_state": (tf.decode_state_axes(cfg), states)}


def _ref_trees(cfg):
    specs = ref_tf.model_specs(cfg)
    return {"params": ref_params.param_axes(specs),
            "train_state": ref_ts.train_state_axes(cfg),
            "batch": ref_ts.batch_axes(cfg, max(cfg.train_accum, 1)),
            "decode_state": ref_tf.decode_state_axes(cfg)}


def _is_axes(x):
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def _flat_axes(tree):
    """{path: axes} with axes tuples as leaves (JAX's trees hold them as
    tuples, which _flat would otherwise walk)."""
    if _is_axes(tree):
        return {(): tree}
    if hasattr(tree, "_fields"):
        items = [(n, getattr(tree, n)) for n in tree._fields]
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        items = list(enumerate(tree))
    out = {}
    for k, v in items:
        out.update({(k,) + p: a for p, a in _flat_axes(v).items()})
    return out


class _StubMesh:
    """What JAX's ``ShardingCtx.resolve`` reads of a mesh: ``.shape``."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))


# --------------------------------------------------------------------------- #
# configs, axes trees, resolve
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tiny", [False, True])
def test_config_sharding_fields_equal_reference(tiny):
    for arch in list_archs():
        cfg, ref = get_config(arch, tiny=tiny), ref_get_config(arch,
                                                                tiny=tiny)
        assert cfg.rule_overrides == ref.rule_overrides, arch
        assert cfg.gather_dtype == ref.gather_dtype, arch
    assert set(list_archs()) == set(ref_list_archs())


def test_default_rules_equal_reference():
    assert sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES


@pytest.mark.parametrize("arch", sorted(ref_list_archs()))
def test_axes_trees_equal_reference(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    port, want = _port_trees(cfg), _ref_trees(ref)
    for name in port:
        got = _flat_axes(port[name][0])
        assert got == _flat_axes(want[name]), (arch, name)


@pytest.mark.parametrize("arch", sorted(ref_list_archs()))
def test_resolve_equals_reference(arch):
    """Every leaf of the four trees on the production and test meshes,
    with DEFAULT_RULES and the config's overrides."""
    cfg, ref = get_config(arch), ref_get_config(arch)
    rules = sharding.rules_for(cfg)
    ref_rules = dict(ref_sharding.DEFAULT_RULES)
    ref_rules.update(dict(ref.rule_overrides))
    assert rules == ref_rules
    n = 0
    for mshape, names in MESHES.items():
        ctx = sharding.ShardingCtx(sharding.MeshShape(mshape, names), rules)
        rctx = ref_sharding.ShardingCtx(_StubMesh(mshape, names), ref_rules)
        for name, (axes, like) in _port_trees(cfg).items():
            leaves = _flat(like)
            for path, ax in _flat_axes(axes).items():
                shape = tuple(leaves[path].shape)
                got = ctx.resolve(shape, ax)
                assert got == tuple(rctx.resolve(shape, ax)), (
                    arch, mshape, name, path)
                n += 1
    assert n > 0


def test_placements_for_flattened_and_fallback():
    """("pod", "data") becomes Shard on both mesh dims in mesh order; an
    indivisible dim falls back to the next candidate, then replicates."""
    from torch.distributed.tensor import Replicate, Shard
    ctx = sharding.ShardingCtx(
        sharding.MeshShape((2, 16, 16), ("pod", "data", "model")),
        dict(sharding.DEFAULT_RULES))
    assert ctx.placements_for((64, 40), ("act_batch", "act_heads")) == (
        Shard(0), Shard(0), Replicate())
    assert ctx.placements_for((48, 64), ("act_batch", "act_heads")) == (
        Replicate(), Shard(0), Shard(1))
    assert ctx.placements_for((3, 5), ("act_batch", "act_heads")) == (
        Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.ShardingCtx(
            sharding.MeshShape((2, 2), ("data", "pod")),
            {"x": (("pod", "data"),)}).placements_for((4,), ("x",))


def test_shard_without_context_is_identity_and_refuses_plain_tensors():
    x = torch.zeros(4, 6)
    assert sharding.shard(x, ("act_batch", None)) is x
    assert sharding.current_ctx() is None
    with sharding.sharding_ctx(sharding.MeshShape((2, 4),
                                                  ("data", "model"))):
        assert sharding.current_ctx() is not None
        with pytest.raises(TypeError, match=r"\(4, 6\)"):
            sharding.shard(x, ("act_batch", None))
    assert sharding.current_ctx() is None


@pytest.mark.parametrize("prefer_model", [16, 8])
def test_plan_resize_equals_reference(prefer_model):
    for arch in list_archs():
        cfg, ref = get_config(arch), ref_get_config(arch)
        for n in range(1, 513):
            assert elastic.plan_resize(n, cfg, prefer_model) == \
                ref_elastic.plan_resize(n, ref, prefer_model), (arch, n)


# --------------------------------------------------------------------------- #
# shapes
# --------------------------------------------------------------------------- #

def test_applicable_and_cells_equal_reference():
    archs = sorted(list_archs())
    assert shapes.cells(archs) == ref_shapes.cells(archs)
    assert set(shapes.SHAPES) == set(ref_shapes.SHAPES)
    for name, spec in shapes.SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            ref_shapes.SHAPES[name])
        for arch in archs:
            assert shapes.applicable(get_config(arch), spec) == \
                ref_shapes.applicable(ref_get_config(arch),
                                      ref_shapes.SHAPES[name])


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


@pytest.mark.parametrize("arch", sorted(ref_list_archs()))
def test_input_specs_equal_reference(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    for name, spec in shapes.SHAPES.items():
        if not shapes.applicable(cfg, spec)[0]:
            with pytest.raises(ValueError, match="skipped"):
                shapes.input_specs(cfg, name)
            continue
        got = _flat(shapes.input_specs(cfg, name))
        want = _flat(ref_shapes.input_specs(ref, name))
        assert set(got) == set(want), (arch, name)
        for path, leaf in got.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(want[path].shape), (
                arch, name, path)
            assert _dtype_name(leaf.dtype) == _dtype_name(
                want[path].dtype), (arch, name, path)


# --------------------------------------------------------------------------- #
# gather_dtype
# --------------------------------------------------------------------------- #

def _forward_pair(gather_dtype):
    cfg = dataclasses.replace(get_config("deepseek-7b", tiny=True),
                              gather_dtype=gather_dtype)
    ref = dataclasses.replace(ref_get_config("deepseek-7b", tiny=True),
                              gather_dtype=gather_dtype)
    tree = worker.tiny_tree(cfg)
    batch = worker.step_batch(cfg)
    got, _ = tf.forward_train(params_from_numpy(tree, "cpu"),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg, remat=False)
    want, _ = jax.jit(lambda p, b: ref_tf.forward_train(
        p, b, ref, remat=False))(jax.tree.map(jnp.asarray, tree),
                                 jax.tree.map(jnp.asarray, batch))
    return got.float().numpy(), np.asarray(want, np.float32)


def test_gather_dtype_forward_matches_reference():
    """bfloat16 gathers: the logits within the bfloat16 tolerance of the
    port's tests (test_torch_dense: 2 % of the logits' scale) of JAX's
    with the same field, and with "" the output is that of the default
    config."""
    got, want = _forward_pair("bfloat16")
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
    plain, _ = _forward_pair("")
    cfg = get_config("deepseek-7b", tiny=True)
    default, _ = tf.forward_train(
        params_from_numpy(worker.tiny_tree(cfg), "cpu"),
        {k: torch.from_numpy(v) for k, v in worker.step_batch(cfg).items()},
        cfg, remat=False)
    assert np.array_equal(plain, default.float().numpy())


def test_gather_dtype_keeps_float32_gradients():
    cfg = dataclasses.replace(get_config("deepseek-7b", tiny=True),
                              gather_dtype="bfloat16")
    params = params_from_numpy(worker.tiny_tree(cfg), "cpu")
    state = ts.TrainState(params, init_opt_state(params))
    batch = {k: torch.from_numpy(v)
             for k, v in worker.step_batch(cfg).items()}
    _, m = ts.make_train_step(cfg, worker.step_opt())(state, batch)
    assert np.isfinite(float(m["loss"]))
    for _, leaf in leaves_with_paths(state.params):
        assert leaf.dtype == torch.float32


# --------------------------------------------------------------------------- #
# the JAX side of the layouts and of psum_int8 (8 forced host devices)
# --------------------------------------------------------------------------- #

_JAX8 = textwrap.dedent("""
    import pickle, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.distributed.sharding import DEFAULT_RULES, ShardingCtx
    from repro.distributed.compression import (make_compressed_ddp_step,
                                               psum_int8)
    from repro.models import transformer as tf
    from repro.models.params import param_axes, param_shapes
    sys.path.insert(0, sys.argv[2])
    import torch_dist_worker as w
    out = {"slices": {}}
    for arch in w.SLICE_ARCHS:
        cfg = get_config(arch, tiny=True)
        rules = dict(DEFAULT_RULES); rules.update(dict(cfg.rule_overrides))
        specs = tf.model_specs(cfg)
        flat_ax = jax.tree_util.tree_flatten_with_path(
            param_axes(specs), is_leaf=lambda t: isinstance(t, tuple))[0]
        shapes_ = dict((jax.tree_util.keystr(p), s.shape) for p, s in
                       jax.tree_util.tree_flatten_with_path(
                           param_shapes(specs))[0])
        for shape, names in w.SLICE_MESHES:
            mesh = jax.make_mesh(shape, names)
            ctx = ShardingCtx(mesh, rules)
            per = {}
            for path, ax in flat_ax:
                key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in path)
                shp = shapes_[jax.tree_util.keystr(path)]
                m = NamedSharding(mesh, ctx.resolve(shp, ax)
                                  ).devices_indices_map(shp)
                per[key] = {pos: [(s.start or 0, s.stop if s.stop is not None
                                   else n) for s, n in zip(m[mesh.devices[pos]],
                                                           shp)]
                            for pos in np.ndindex(mesh.devices.shape)}
            out["slices"][f"{arch}|{shape}"] = per
    W, X, rows = w.compress_inputs()
    shape, names = w.COMPRESS_MESH
    mesh = jax.make_mesh(shape, names)
    from jax.experimental.shard_map import shard_map
    f = shard_map(lambda x: psum_int8(x[0], "pod")[None], mesh=mesh,
                  in_specs=P(names), out_specs=P(names), check_rep=False)
    order = [mesh.devices[pos] for pos in np.ndindex(mesh.devices.shape)]
    out["psum_int8"] = np.asarray(jax.jit(f)(jnp.asarray(rows)))
    def loss_fn(wt, x):
        return jnp.mean(jnp.square(jnp.tanh(x @ wt)))
    set_mesh = getattr(jax, "set_mesh", None)
    with (set_mesh(mesh) if set_mesh is not None else mesh):
        for compress in (True, False):
            g = make_compressed_ddp_step(loss_fn, mesh, compress=compress)
            loss, grad = jax.jit(g)(jnp.asarray(W), jnp.asarray(X))
            out[f"loss_{compress}"] = float(loss)
            out[f"grad_{compress}"] = np.asarray(grad)
    out["local_grads"] = [np.asarray(jax.grad(loss_fn)(
        jnp.asarray(W), jnp.asarray(X[2 * i:2 * i + 2]))) for i in range(8)]
    with open(sys.argv[1], "wb") as fh:
        pickle.dump(out, fh)
""")


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    """Start the 8-device JAX subprocess; the value waits for it."""
    d = tmp_path_factory.mktemp("jax8")
    path = str(d / "out.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=worker.SRC,
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _JAX8, path, worker.HERE],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    cache = {}

    def get():
        if not cache:
            log = proc.communicate(timeout=SPAWN_TIMEOUT)[0]
            assert proc.returncode == 0, log[-3000:]
            with open(path, "rb") as fh:
                cache.update(pickle.load(fh))
        return cache
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# --------------------------------------------------------------------------- #
# multi-rank checks
# --------------------------------------------------------------------------- #

def test_rank_slices_equal_jax_devices_indices_map(tmp_path, jax8):
    """The slice of every parameter each of 8 gloo ranks holds equals the
    slice JAX's NamedSharding gives the device at the same mesh
    position."""
    wait = worker.spawn("slices", WORLD, str(tmp_path), SPAWN_TIMEOUT)
    trees = {a: worker.tiny_tree(get_config(a, tiny=True))
             for a in worker.SLICE_ARCHS}
    want = jax8()["slices"]
    ranks = wait()
    n = 0
    for case, per_leaf in want.items():
        tree = {"/".join(map(str, p)): a
                for p, a in leaves_with_paths(trees[case.split("|")[0]])}
        for out in ranks:
            got = out[case]
            for key, (local, _) in got["leaves"].items():
                idx = tuple(slice(a, b)
                            for a, b in per_leaf[key][got["coord"]])
                assert np.array_equal(local, tree[key][idx]), (case, key)
                n += 1
    assert n == sum(len(v) for v in want.values()) * WORLD


def _ref_step(name, tree):
    arch = name.split("|")[0]
    ref = ref_get_config(arch, tiny=True)
    if name.endswith("|float32"):
        ref = dataclasses.replace(ref, dtype="float32")
    params = jax.tree.map(jnp.asarray, tree)
    state = ref_ts.TrainState(params, ref_opt.init_opt_state(params))
    step = jax.jit(ref_ts.make_train_step(
        ref, ref_opt.OptimizerConfig(warmup_steps=1)))
    cfg = get_config(arch, tiny=True)
    new, m = step(state, jax.tree.map(jnp.asarray, worker.step_batch(cfg)))
    return ({"/".join(map(str, p)): np.asarray(a, np.float32)
             for p, a in leaves_with_paths(jax.tree.map(np.asarray,
                                                        new.params))},
            {k: float(v) for k, v in m.items()})


def _port_step(name, tree):
    arch = name.split("|")[0]
    cfg = get_config(arch, tiny=True)
    if name.endswith("|float32"):
        cfg = dataclasses.replace(cfg, dtype="float32")
    params = params_from_numpy(tree, "cpu")
    state, m = ts.make_train_step(cfg, worker.step_opt())(
        ts.TrainState(params, init_opt_state(params)),
        {k: torch.from_numpy(v) for k, v in worker.step_batch(cfg).items()})
    return ({"/".join(map(str, p)): t.float().numpy()
             for p, t in leaves_with_paths(state.params)},
            {k: float(v) for k, v in m.items()})


def _leaf_gap(got, want):
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


# (loss rtol, leaf atol, grad_norm rtol, update_rel) against the port's
# single-device step and against JAX's.
STEP_TOL = {"bfloat16": (2e-4, 5e-3, 5e-3, 0.2),
            "float32": (4e-6, 2e-4, 4e-6, 1.5e-3)}
STEP_RUNS = ["deepseek-7b"] + [f"{a}|float32" for a in sorted(
    ref_list_archs())]


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """The sharded TINY steps on 8 ranks, with the port's and JAX's
    single-device steps on the same numbers (computed while the ranks
    run)."""
    d = str(tmp_path_factory.mktemp("step"))
    wait = worker.spawn("step", WORLD, d, SPAWN_TIMEOUT)
    refs = {}
    for name in STEP_RUNS:
        arch = name.split("|")[0]
        tree = worker.tiny_tree(get_config(arch, tiny=True))
        p0 = {"/".join(map(str, p)): np.asarray(a, np.float32)
              for p, a in leaves_with_paths(tree)}
        refs[name] = (_port_step(name, tree), _ref_step(name, tree), p0)
    return wait(), refs


def _check_step(name, ranks, refs):
    out = ranks[0][name]
    rtol, atol, gtol, utol = STEP_TOL["float32" if name.endswith("|float32")
                                      else "bfloat16"]
    (p_leaves, p_m), (j_leaves, j_m), p0 = refs[name]
    for other in ranks[1:]:       # every rank gathers the same state
        assert all(np.array_equal(other[name]["params"][k], v)
                   for k, v in out["params"].items())
    for want_leaves, want_m in ((p_leaves, p_m), (j_leaves, j_m)):
        np.testing.assert_allclose(out["metrics"]["loss"], want_m["loss"],
                                   rtol=rtol, atol=rtol)
        np.testing.assert_allclose(out["metrics"]["grad_norm"],
                                   want_m["grad_norm"], rtol=gtol)
        assert set(out["params"]) == set(want_leaves)
        assert _leaf_gap(out["params"], want_leaves) <= atol, name
        assert update_rel(p0, want_leaves, out["params"]) <= utol, name


def test_sharded_step_deepseek_7b_matches_single_device(sharded_steps):
    """The reference's sharded check, as the port: 8 gloo ranks on (data
    2, model 4), TINY DeepSeek-7B, batch 8 x 32; the loss and every
    updated leaf against the port's and JAX's single-device steps."""
    ranks, refs = sharded_steps
    _check_step("deepseek-7b", ranks, refs)
    pl = ranks[0]["deepseek-7b"]["placements"]
    assert pl["embed"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["segments/0/block0/mixer/w_q"] == \
        "(Shard(dim=1), Shard(dim=2))"


@pytest.mark.parametrize("arch", sorted(ref_list_archs()))
def test_sharded_step_every_family(sharded_steps, arch):
    """Every family's float32 TINY twin passes the same check, at
    float32 bounds: the dense ones, RecurrentGemma (the RG-LRU kernel on
    local channels), xLSTM (the mLSTM kernel on local heads, the sLSTM's
    loop on local rows), the MoE twins (expert-parallel), Whisper and
    InternVL2."""
    ranks, refs = sharded_steps
    _check_step(f"{arch}|float32", ranks, refs)


def test_mlstm_cell_runs_on_local_shards(sharded_steps):
    """The mLSTM cell on DTensors (batch over data, heads over model)
    runs the plain cell on each rank's (1, 1, 128, 16) shard: within
    float32 rounding of the whole cell (its sums blocked by another
    shape)."""
    ranks, _ = sharded_steps
    gaps = [r["mlstm_local"] for r in ranks]
    assert max(gaps) <= 1e-5, gaps


def test_quantize_int8_equals_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    x[:4] = [0.5, 1.5, -2.5, 127.5]          # halves: round to even
    for scale in (np.float32(1.0), np.float32(0.037), np.float32(1e-30)):
        got = compression.quantize_int8(torch.from_numpy(x),
                                        torch.tensor(scale)).numpy()
        want = np.asarray(ref_comp.quantize_int8(jnp.asarray(x),
                                                 jnp.asarray(scale)))
        assert got.dtype == np.int8 and np.array_equal(got, want)


def test_compression_equals_reference(tmp_path, jax8):
    """psum_int8 over the pod axis of a (2, 2, 2) gloo mesh == JAX's
    under shard_map on the same per-device rows; the compressed DDP step
    (the reference's compression check) against JAX's."""
    wait = worker.spawn("compress", WORLD, str(tmp_path), SPAWN_TIMEOUT)
    want = jax8()
    ranks = wait()
    shape = worker.COMPRESS_MESH[0]
    for out in ranks:
        row = np.ravel_multi_index(out["coord"], shape)
        assert np.array_equal(out["psum_int8"], want["psum_int8"][row])
        assert out["input_unchanged"]
    # one int8 step per pod: the scale of each pod's intra-pod sum
    local = want["local_grads"]
    pods = [sum(local[4 * p:4 * p + 4]) for p in range(2)]
    step = max(np.abs(g).max() for g in pods) / 127.0 * 2 / WORLD
    for out in ranks:
        for compress in (True, False):
            np.testing.assert_allclose(out[f"loss_{compress}"],
                                       want[f"loss_{compress}"], rtol=1e-6)
        gf, gc = out["grad_False"], out["grad_True"]
        jf = want["grad_False"]
        assert np.abs(gf - jf).max() <= 1e-6 * np.abs(jf).max()
        assert np.abs(gc - want["grad_True"]).max() <= step * 1.0001
        rel = np.abs(gc - gf).max() / np.abs(gf).max()
        assert rel < 0.02, rel


def test_elastic_restore_of_jax_checkpoint(tmp_path):
    """A checkpoint JAX's CheckpointManager writes at step 7 (TINY
    DeepSeek-7B), restored by restore_elastic on an 8-rank (4, 2) mesh:
    every full_tensor() == JAX's leaf, and the placements are
    placements_for's."""
    ref = ref_get_config("deepseek-7b", tiny=True)
    state = ref_ts.init_train_state(jax.random.key(0), ref)
    RefCheckpointManager(str(tmp_path / "ckpt")).save(7, state)
    wait = worker.spawn("elastic", WORLD, str(tmp_path), SPAWN_TIMEOUT,
                        arg=str(tmp_path / "ckpt"))
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(a)
            for p, a in flat}
    cfg = get_config("deepseek-7b", tiny=True)
    ctx = sharding.ShardingCtx(sharding.MeshShape(*worker.ELASTIC_MESH),
                               sharding.rules_for(cfg))
    like = elastic.state_like(cfg)
    from repro_torch.train.checkpoint import flatten_with_keys
    placements = {k: repr(ctx.placements_for(t.shape, ax)) for (k, t), ax in
                  zip(flatten_with_keys(like),
                      _flat_axes(ts.train_state_axes(cfg)).values())}
    ranks = wait()
    for out in ranks:
        assert out["step"] == 7
        assert len(out["leaves"]) == len(want)
        for (key, (full, pl)), w in zip(out["leaves"].items(),
                                        want.values()):
            assert np.array_equal(full, w), key
            assert pl == placements[key], key


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_shardings_for_mesh_follow_rule_overrides(arch):
    """restore_elastic places the state as the sharded step pins its
    gradients: by the config's rules, rule_overrides included (Qwen1.5
    and xLSTM move leaves off the model axis that the default rules put
    on it)."""
    cfg = get_config(arch)
    mesh = sharding.MeshShape((2, 4), ("data", "model"))
    got = _flat(elastic.shardings_for_mesh(mesh, cfg))
    like = _flat(elastic.state_like(cfg))
    axes = _flat_axes(ts.train_state_axes(cfg))
    ctxs = {k: sharding.ShardingCtx(mesh, r) for k, r in (
        ("cfg", sharding.rules_for(cfg)),
        ("default", dict(sharding.DEFAULT_RULES)))}
    want = {k: {p: c.placements_for(like[p].shape, axes[p]) for p in like}
            for k, c in ctxs.items()}
    assert got == want["cfg"]
    assert (got != want["default"]) == bool(cfg.rule_overrides)


# --------------------------------------------------------------------------- #
# meshes
# --------------------------------------------------------------------------- #

_MESHES = textwrap.dedent("""
    import sys, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as m
    out = []
    for world, multi in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        pm = m.make_production_mesh(multi_pod=multi, device_type="cpu")
        out.append((tuple(pm.mesh.shape), pm.mesh_dim_names))
        dist.destroy_process_group()
    dev = m.init_distributed("cpu")
    lm = m.local_mesh("cpu")
    out.append((tuple(lm.mesh.shape), lm.mesh_dim_names, str(dev),
                dist.get_backend()))
    try:
        m.make_production_mesh(device_type="cpu")
    except ValueError as e:
        out.append(str(e))
    dist.destroy_process_group()
    print(repr(out))
""")


def test_meshes():
    """make_production_mesh on fake worlds of 256 and 512 ranks, and
    local_mesh on a gloo world of 1 (init_distributed's file store),
    where the production mesh is refused, naming its size."""
    env = dict(os.environ, PYTHONPATH=worker.SRC, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    res = subprocess.run([sys.executable, "-c", _MESHES], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = eval(res.stdout.strip().splitlines()[-1])
    assert out[0] == ((16, 16), ("data", "model"))
    assert out[1] == ((2, 16, 16), ("pod", "data", "model"))
    assert out[2] == ((1,), ("data",), "cpu", "gloo")
    assert "256" in out[3] and "has 1" in out[3]


def test_init_distributed_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.launch.mesh import init_distributed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()
