"""Rank programs for ``tests/test_torch_distributed.py``: each case runs
on every rank of a gloo world on the CPU and writes what it holds to a
file the test reads back.

    python tests/torch_dist_worker.py CASE RANK WORLD INIT_FILE OUT_DIR [ARG]

Every rank rendezvouses on the file store ``INIT_FILE`` (no TCP port),
runs ``case_<CASE>`` with one intra-op thread, and writes
``OUT_DIR/<CASE>.<RANK>.pt`` (``torch.save`` of a dict of numpy arrays,
strings and numbers).  :func:`spawn` starts a world of them and waits
with a deadline, killing every rank when it passes.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

SLICE_ARCHS = ("deepseek-7b", "qwen1.5-32b")
SLICE_MESHES = (((2, 4), ("data", "model")),
                ((2, 2, 2), ("pod", "data", "model")))
STEP_MESH = ((2, 4), ("data", "model"))
ELASTIC_MESH = ((4, 2), ("data", "model"))
COMPRESS_MESH = ((2, 2, 2), ("pod", "data", "model"))
STEP_BATCH, STEP_SEQ = 8, 32


# --------------------------------------------------------------------------- #
# shared inputs (the test builds the same ones for JAX)
# --------------------------------------------------------------------------- #

def tiny_tree(cfg):
    """A TINY twin's float32 parameters as numpy: ``numpy_params`` seed 0,
    or, for a spec tree with an initialiser numpy does not draw (the
    RG-LRU's Lambda), ``init_params`` from a CPU generator seeded 0."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import init_params, map_tree, numpy_params
    specs = tf.model_specs(cfg)
    try:
        return numpy_params(specs, 0)
    except ValueError:
        gen = torch.Generator().manual_seed(0)
        return map_tree(lambda _, t: t.numpy(),
                        init_params(specs, gen, "cpu"))


def step_batch(cfg):
    from repro_torch.train.data import DataConfig, SyntheticLM
    return SyntheticLM(cfg, DataConfig(batch_size=STEP_BATCH,
                                       seq_len=STEP_SEQ)).batch(0)


def step_opt():
    from repro_torch.train.optimizer import OptimizerConfig
    return OptimizerConfig(warmup_steps=1)


def compress_inputs():
    """W (64, 64), X (16, 64) and every rank's (8,) row for psum_int8."""
    rng = np.random.default_rng(0)
    W = rng.standard_normal((64, 64)).astype(np.float32)
    X = rng.standard_normal((16, 64)).astype(np.float32)
    rows = rng.standard_normal((8, 96)).astype(np.float32) * \
        np.array([1.0, 3.0, 0.01, 7.0, 0.5, 2.0, 0.1, 1.5],
                 np.float32)[:, None]
    return W, X, rows


def compress_loss(w, x):
    return torch.mean(torch.square(torch.tanh(x @ w)))


# --------------------------------------------------------------------------- #
# cases
# --------------------------------------------------------------------------- #

def _placements(t) -> str:
    return repr(tuple(t.placements))


def case_slices(out, arg):
    """The local shard every rank holds of TINY deepseek-7b's and
    qwen1.5-32b's parameters on (2, 4) and (2, 2, 2) meshes."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (ShardingCtx,
                                                  distribute_tree, rules_for)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import (leaves_with_paths, param_axes,
                                           params_from_numpy)
    for arch in SLICE_ARCHS:
        cfg = get_config(arch, tiny=True)
        tree = tiny_tree(cfg)
        for shape, names in SLICE_MESHES:
            mesh = make_mesh(shape, names, "cpu")
            ctx = ShardingCtx(mesh, rules_for(cfg))
            dt = distribute_tree(ctx, params_from_numpy(tree, "cpu"),
                                 param_axes(tf.model_specs(cfg)))
            out[f"{arch}|{shape}"] = {
                "coord": tuple(mesh.get_coordinate()),
                "leaves": {"/".join(map(str, p)): (t.to_local().numpy(),
                                                    _placements(t))
                           for p, t in leaves_with_paths(dt)}}


def _sharded_step(cfg, tree, mesh):
    from repro_torch.distributed.sharding import (ShardingCtx,
                                                  distribute_tree, rules_for,
                                                  sharding_ctx)
    from repro_torch.models.params import leaves_with_paths, params_from_numpy
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import init_opt_state
    ctx = ShardingCtx(mesh, rules_for(cfg))
    params = params_from_numpy(tree, "cpu")
    state = distribute_tree(ctx, ts.TrainState(params,
                                               init_opt_state(params)),
                            ts.train_state_axes(cfg))
    batch = distribute_tree(
        ctx, {k: torch.from_numpy(v) for k, v in step_batch(cfg).items()},
        ts.batch_axes(cfg))
    step = ts.make_train_step(cfg, step_opt())
    with sharding_ctx(mesh, ctx.rules):
        state, metrics = step(state, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {"/".join(map(str, p)): t.full_tensor().float().numpy()
                       for p, t in leaves_with_paths(state.params)},
            "placements": {"/".join(map(str, p)): _placements(t)
                           for p, t in leaves_with_paths(state.params)}}


def case_step(out, arg):
    """The sharded train step of TINY DeepSeek-7B and of every
    registered family's float32 TINY twin on (data 2, model 4), and the
    mLSTM cell's local call on DTensors against the plain cell."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*STEP_MESH, "cpu")
    runs = [("deepseek-7b", get_config("deepseek-7b", tiny=True))]
    runs += [(f"{a}|float32", dataclasses.replace(get_config(a, tiny=True),
                                                  dtype="float32"))
             for a in list_archs()]
    if arg:
        runs = [r for r in runs if r[0] in arg.split(",")]
    for name, cfg in runs:
        out[name] = _sharded_step(cfg, tiny_tree(cfg), mesh)
    out["mlstm_local"] = _mlstm_local(mesh)


def _mlstm_local(mesh) -> float:
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import ShardingCtx, sharding_ctx
    from repro_torch.models import xlstm
    rng = np.random.default_rng(3)
    B, H, T, dh = 2, 4, 128, 16
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in [(B, H, T, dh)] * 3 + [(B, H, T)] * 2]
    plain, (C, n, m) = xlstm._mlstm_chunkwise(
        *(torch.from_numpy(a) for a in arrays))
    ctx = ShardingCtx(mesh, {"act_batch": ("data",),
                             "act_heads": ("model",)})
    axes = [("act_batch", "act_heads", None, None)] * 3 + \
        [("act_batch", "act_heads", None)] * 2
    dts = [distribute_tensor(torch.from_numpy(a), mesh,
                             ctx.placements_for(a.shape, ax))
           for a, ax in zip(arrays, axes)]
    with sharding_ctx(mesh, ctx.rules):
        h, (C2, n2, m2) = xlstm._mlstm_chunkwise(*dts)
    return max(float((x.full_tensor() - y).abs().max())
               for x, y in ((h, plain), (C2, C), (n2, n), (m2, m)))


DRYRUN_ARCHS = ("deepseek-7b", "deepseek-moe-16b")
SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS = 16, 32, 2


def dryrun_shapes():
    """The train step, prefill and decode step at STEP_BATCH x
    STEP_SEQ."""
    from repro_torch.launch.shapes import ShapeSpec
    return {kind: ShapeSpec(kind, STEP_SEQ, STEP_BATCH, kind)
            for kind in ("train", "prefill", "decode")}


def dryrun_counts(result) -> dict:
    """What the fake world's accounting must share with a real world's:
    collectives by kind, argument bytes, FLOPs of the aten products."""
    return {"collectives": result["collectives_per_device"],
            "argument_bytes": result["memory"]["argument_bytes"],
            "aten_flops": {k: v for k, v in result["flops_by_op"].items()
                           if k.startswith("aten.")}}


def case_dryrun(out, arg):
    """The dry run's accounting of TINY deepseek-7b's and
    deepseek-moe-16b's train step, prefill and decode step on (2, 4),
    run on real DTensors; then :func:`case_serve`."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*STEP_MESH, "cpu")
    for arch in DRYRUN_ARCHS:
        cfg = get_config(arch, tiny=True)
        for kind, shape in dryrun_shapes().items():
            step, args = dryrun.build_step(cfg, shape, mesh)
            out[f"{arch}|{kind}"] = dryrun_counts(
                dryrun.analyze(step, args, fake=False))
    case_serve(out, arg)


def serve_batch(cfg):
    """A prompt batch of SERVE_PROMPT tokens (and the family's frames or
    patches) from ``step_batch``, and its cache length."""
    batch = {k: v for k, v in step_batch(cfg).items()
             if k not in ("labels", "loss_mask")}
    batch["tokens"] = batch["tokens"][:, :SERVE_PROMPT]
    extra = cfg.vision_prefix_len if cfg.family == "vlm" else 0
    return batch, SERVE_CACHE + extra


def greedy(params, batch, cfg, cache_len, full=lambda t: t, put=None):
    """Prefill and SERVE_STEPS greedy decode steps: every step's logits
    (B, Vp) as numpy float32; ``full`` gathers a sharded tensor, ``put``
    distributes the next tokens."""
    from repro_torch.models import transformer as tf
    with torch.no_grad():
        logits, states = tf.prefill(params, batch, cfg, cache_len)
        out = []
        for _ in range(SERVE_STEPS):
            full_logits = full(logits)
            out.append(full_logits.float().numpy())
            tok = torch.argmax(full_logits[:, :cfg.vocab_size], -1)
            tok = tok[:, None].to(torch.int32)
            logits, states = tf.decode_step(
                params, put(tok) if put else tok, states, cfg)
        out.append(full(logits).float().numpy())
    return np.stack(out)


def case_serve(out, arg):
    """Sharded prefill and greedy decode of every registered family's
    float32 TINY twin on (data 2, model 4)."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.distributed.sharding import (ShardingCtx,
                                                  distribute_tree, rules_for,
                                                  sharding_ctx)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import param_axes, params_from_numpy
    mesh = make_mesh(*STEP_MESH, "cpu")
    archs = arg.split(",") if arg else list_archs()
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch, tiny=True),
                                  dtype="float32")
        ctx = ShardingCtx(mesh, rules_for(cfg))
        params = distribute_tree(ctx, params_from_numpy(tiny_tree(cfg),
                                                        "cpu"),
                                 param_axes(tf.model_specs(cfg)))
        batch, cache_len = serve_batch(cfg)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        batch = distribute_tree(ctx, batch, dryrun._batch_axes_tree(batch))
        with sharding_ctx(mesh, ctx.rules):
            out[f"serve|{arch}"] = greedy(
                params, batch, cfg, cache_len,
                full=lambda t: t.full_tensor(),
                put=lambda t: distribute_tree(ctx, t, ("act_batch", None)))


def case_compress(out, arg):
    """psum_int8 over the pod axis of every rank's row, and the
    compressed DDP step with compression on and off, on (2, 2, 2)."""
    import torch.distributed as dist
    from repro_torch.distributed import compression
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*COMPRESS_MESH, "cpu")
    W, X, rows = compress_inputs()
    rank = dist.get_rank()
    x = torch.from_numpy(rows[rank].copy())
    out["psum_int8"] = compression.psum_int8(
        x, mesh.get_group("pod")).numpy()
    out["input_unchanged"] = bool(np.array_equal(x.numpy(), rows[rank]))
    for compress in (True, False):
        step = compression.make_compressed_ddp_step(
            compress_loss, mesh, compress=compress)
        loss, g = step(torch.from_numpy(W), torch.from_numpy(X))
        out[f"loss_{compress}"] = float(loss)
        out[f"grad_{compress}"] = g.numpy()
    out["coord"] = tuple(mesh.get_coordinate())


def case_elastic(out, arg):
    """``restore_elastic`` of the JAX-written checkpoint in ``arg`` on a
    (4, 2) mesh."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.elastic import restore_elastic
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import (CheckpointManager,
                                              flatten_with_keys)
    mesh = make_mesh(*ELASTIC_MESH, "cpu")
    cfg = get_config("deepseek-7b", tiny=True)
    state, step, _ = restore_elastic(CheckpointManager(arg), cfg, mesh)
    out["step"] = step
    out["leaves"] = {k: (t.full_tensor().numpy(), _placements(t))
                     for k, t in flatten_with_keys(state)}


# --------------------------------------------------------------------------- #
# rank entry point and launcher
# --------------------------------------------------------------------------- #

def main(argv) -> int:
    case, rank, world, init_file, out_dir = argv[:5]
    arg = argv[5] if len(argv) > 5 else ""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    init_distributed("cpu", init_method=f"file://{init_file}", rank=rank,
                     world_size=world)
    out = {}
    try:
        globals()[f"case_{case}"](out, arg)
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        torch.save(out, os.path.join(out_dir, f"{case}.{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def spawn(case: str, world: int, tmp_dir: str, timeout: float,
          arg: str = ""):
    """Start ``world`` ranks of ``case``; returns ``wait()``, which blocks
    until they end (killing all of them past ``timeout`` seconds from
    the start) and returns every rank's output, in rank order."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC,
               PYTHONWARNINGS="ignore", TORCH_CPP_LOG_LEVEL="ERROR")
    init_file = os.path.join(tmp_dir, f"{case}.store")
    start = time.monotonic()
    logs = [os.path.join(tmp_dir, f"{case}.{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, str(r),
                 str(world), init_file, tmp_dir, arg], env=env, stdout=log,
                stderr=subprocess.STDOUT))

    def wait():
        try:
            for p in procs:
                p.wait(timeout=max(timeout - (time.monotonic() - start), 0.1))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise AssertionError(f"{case}: a rank ran past {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode != 0]
        assert not bad, f"{case}: ranks {bad} failed:\n" + "\n".join(
            open(logs[r]).read()[-3000:] for r, _ in bad)
        return [torch.load(os.path.join(tmp_dir, f"{case}.{r}.pt"),
                           weights_only=False) for r in range(world)]
    return wait


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
