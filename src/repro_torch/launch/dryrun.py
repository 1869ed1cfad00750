"""The production dry run, as ``repro/launch/dryrun.py``: per-card
memory, FLOPs, bytes and collective bytes of the port's own train step,
prefill and decode step for every (architecture x input shape) cell on
the production meshes, without a card.

For each cell, on a fake process group of the mesh's size (256 for the
(16, 16) pod, 512 for the (2, 16, 16) pair; ``make_production_mesh(
device_type="cpu")``), the state and batch are built as DTensors whose
local shards are fake tensors (``FakeTensorMode``: shapes, no storage)
at ``repro_torch.launch.shapes.input_specs`` and the logical axes of
``train_state_axes``, ``param_axes`` and ``decode_state_axes``: float32
masters for training, as the reference's ``init_train_state``, and
every parameter in the activation dtype for serving, as its
``__import_params``.  One step then runs eagerly under
``sharding_ctx`` and ``repro_torch.launch.op_analysis.OpCounter``,
which counts what one rank runs.  The model kernels' fake
implementations take the card's route, so the counts are the port's on
H100s, widths and depth as published, with two differences of the
"cpu" mesh a fake world needs: DTensor moves a shard-to-shard change as
an all-gather where NCCL would use an all-to-all, and the fake tensors
take the CPU's branch of ``layers._dot_f32`` (int8 caches only).  The
counts also follow the torch version's DTensor strategies.

The result carries the reference's keys:

* ``memory``: ``argument_bytes`` (this rank's shards of the inputs
  the step reads: the reference's jit prunes the others from its
  executable, such as Whisper's encoder and cross k, v projections at
  decode), ``output_bytes``, ``temp_bytes`` and
  ``peak_estimate_bytes`` (``argument_bytes + temp_bytes``).  ``temp_bytes`` is the eager live
  bytes above the arguments at their peak (every storage an op returns,
  from its first op to its release by Python, and the kernels'
  scratch), not XLA's buffer assignment;
* ``cost``: ``flops_per_device`` at 2 operations per multiply-
  accumulate, where XLA:CPU's ``cost_analysis`` counts 1
  (``benchmarks/roofline.py:24-28``), and ``bytes_per_device``
  (``OpCounter.bytes``);
* ``collectives_per_device``: result bytes by kind and ``total``;
* ``arch``, ``shape``, ``mesh``, ``devices``, ``ok``, ``tag``; and
  ``trace_s`` in place of ``lower_s`` / ``compile_s``, ``ops`` (local
  ops dispatched) in place of ``hlo_bytes``.  ``kernel_calls`` and
  ``flops_by_op`` split the counts by op.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh single

writes ``artifacts/torch/dryrun/<mesh>/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (ShardingCtx, map_axes,
                                              rules_for, sharding_ctx)
from repro_torch.launch import shapes as shp
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import transformer as tf
from repro_torch.models.params import map_tree, param_axes
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamWState, OptimizerConfig

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "torch", "dryrun")
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
MeshSpec = Tuple[Tuple[int, ...], Tuple[str, ...]]


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0;
    collectives return at once), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# DTensor's own bookkeeping that computes with small tensors (sharding
# strategies and their redistribution costs, shard sizes and offsets):
# run outside fake mode, so that its tensors hold values.
_BOOKKEEPING = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "propagate_op_sharding_non_cached"),
    ("torch.distributed.tensor.placement_types", "Shard",
     "local_shard_size_and_offset"),
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset"),
)


@contextlib.contextmanager
def real_bookkeeping():
    """Inside, DTensor's bookkeeping (``_BOOKKEEPING``, where this torch
    has it) runs with fake mode unset."""
    import importlib
    import inspect
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    saved = []
    for module, cls_name, name in _BOOKKEEPING:
        cls = getattr(importlib.import_module(module), cls_name, None)
        if cls is None or name not in vars(cls):
            continue
        raw = inspect.getattr_static(cls, name)
        fn = getattr(cls, name)

        def outside(*args, _fn=fn, **kwargs):
            with unset_fake_temporarily():
                return _fn(*args, **kwargs)
        if not isinstance(raw, staticmethod):
            def outside(self, *args, _fn=raw, **kwargs):  # noqa: F811
                with unset_fake_temporarily():
                    return _fn(self, *args, **kwargs)
        setattr(cls, name, staticmethod(outside)
                if isinstance(raw, staticmethod) else outside)
        saved.append((cls, name, raw))
    try:
        yield
    finally:
        for cls, name, raw in saved:
            setattr(cls, name, raw)


def _dtensor(ctx: ShardingCtx, shape, dtype, axes):
    """A DTensor of global ``shape`` at ``axes``' placements whose local
    shard is zeros made under the current mode (fake under
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor, Shard
    placements = ctx.placements_for(shape, axes)
    local = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= ctx.mesh.size(m)
    stride = [math.prod(shape[d + 1:]) for d in range(len(shape))]
    return DTensor.from_local(torch.zeros(local, dtype=dtype), ctx.mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _dtensor_tree(ctx: ShardingCtx, specs, axes):
    """DTensors (:func:`_dtensor`) for a tree of meta tensors at its axes
    tree."""
    return map_axes(lambda ax, t: _dtensor(ctx, t.shape, t.dtype, ax),
                    axes, specs)


def _params(ctx: ShardingCtx, cfg: ArchConfig, dtype: str):
    specs = tf.model_specs(cfg)
    meta = map_tree(lambda _, s: torch.empty(
        s.shape, dtype=getattr(torch, s.dtype or dtype), device="meta"),
        specs)
    return _dtensor_tree(ctx, meta, param_axes(specs))


def _batch_axes_tree(batch: Dict, accum: int = 1) -> Dict:
    lead = (None,) if accum > 1 else ()
    return {k: lead + ("act_batch",) + (None,) * (v.dim() - 1 - len(lead))
            for k, v in batch.items()}


def build_step(cfg: ArchConfig, shape: shp.ShapeSpec, mesh,
               rules: Optional[Dict] = None, remat: bool = True):
    """``(step, args)`` for one cell on ``mesh``: ``step(*args)`` runs
    the train step, the prefill or the decode step on DTensor inputs (of
    zeros; fake under ``FakeTensorMode``) under ``sharding_ctx``."""
    ctx = ShardingCtx(mesh, rules_for(cfg, rules))
    if shape.kind == "train":
        params = _params(ctx, cfg, cfg.param_dtype)
        state = ts.TrainState(params, AdamWState(
            step=_dtensor(ctx, (), torch.int32, ()),
            m=map_tree(lambda _, p: torch.zeros_like(p), params),
            v=map_tree(lambda _, p: torch.zeros_like(p), params)))
        batch = shp.train_batch_specs(cfg, shape)
        accum = max(cfg.train_accum, 1)
        batch = _dtensor_tree(ctx, batch, _batch_axes_tree(batch, accum))
        run = ts.make_train_step(cfg, OptimizerConfig(), accum=accum,
                                 remat=remat)
        args = (state, batch)
    elif shape.kind == "prefill":
        batch = shp.prefill_batch_specs(cfg, shape)
        args = (_params(ctx, cfg, cfg.dtype),
                _dtensor_tree(ctx, batch, _batch_axes_tree(batch)))

        def run(params, batch):
            with torch.no_grad():
                return tf.prefill(params, batch, cfg, shape.seq_len)
    else:
        tokens, states = shp.decode_input_specs(cfg, shape)
        args = (_params(ctx, cfg, cfg.dtype),
                _dtensor(ctx, tokens.shape, tokens.dtype,
                              ("act_batch", None)),
                _dtensor_tree(ctx, states, tf.decode_state_axes(cfg)))

        def run(params, tokens, states):
            with torch.no_grad():
                return tf.decode_step(params, tokens, states, cfg)

    def step(*xs):
        with sharding_ctx(mesh, ctx.rules):
            return run(*xs)
    return step, args


def _locals(tree) -> list:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def argument_bytes(tree) -> int:
    """This rank's bytes of the tensors of ``tree`` (local shards of
    DTensors), each storage once."""
    seen = {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _locals(tree)}
    return sum(seen.values())


def analyze(step, args, fake: bool = True) -> Dict:
    """Run ``step(*args)`` once under an :class:`OpCounter` (``fake``:
    on fake tensors, else on real ones); the reference's
    ``analyze_compiled`` dictionary, with ``ops``, ``kernel_calls`` and
    ``flops_by_op``."""
    counter = OpCounter(fake)
    held = counter.track(_locals(args))
    with counter:
        out = step(*args)
    c = counter.summary()
    arg_bytes = counter.args_read
    return {
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": argument_bytes(out),
                   "temp_bytes": c["peak"] - held,
                   "peak_estimate_bytes": arg_bytes + c["peak"] - held},
        "cost": {"flops_per_device": float(c["flops"]),
                 "bytes_per_device": float(c["bytes"])},
        "collectives_per_device": c["collectives"],
        "ops": c["ops"], "kernel_calls": c["kernel_calls"],
        "flops_by_op": c["flops_by_op"],
    }


def cell_config(arch: str, cfg_overrides: Optional[Dict] = None,
                tiny: bool = False) -> ArchConfig:
    cfg = get_config(arch, tiny=tiny)
    return dataclasses.replace(cfg, **cfg_overrides) if cfg_overrides \
        else cfg


def run_cell(arch: str, shape: Union[str, shp.ShapeSpec], multi_pod: bool,
             out_dir: Optional[str] = None, rules: Optional[Dict] = None,
             tag: str = "", cfg_overrides: Optional[Dict] = None,
             mesh: Optional[MeshSpec] = None, tiny: bool = False,
             remat: bool = True) -> Dict:
    """One cell on the production mesh (``multi_pod`` picks which) or on
    ``mesh`` = (shape, axis names), in a fake world of the mesh's size
    (started here unless one of that size is running).  ``shape`` is a
    name of ``shapes.SHAPES`` or a ``ShapeSpec``; ``tiny`` takes the
    config's TINY twin."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_mesh
    cfg = cell_config(arch, cfg_overrides, tiny)
    spec = shp.SHAPES[shape] if isinstance(shape, str) else shape
    mesh_shape, axes = mesh or PRODUCTION[multi_pod]
    mesh_name = ("multi" if multi_pod else "single") if mesh is None \
        else "x".join(map(str, mesh_shape))
    world = math.prod(mesh_shape)
    scope = contextlib.nullcontext() if dist.is_initialized() and \
        dist.get_world_size() == world else fake_world(world)
    with scope:
        dmesh = make_mesh(mesh_shape, axes, "cpu")
        with FakeTensorMode(), real_bookkeeping():
            step, args = build_step(cfg, spec, dmesh, rules, remat)
            t0 = time.perf_counter()
            result = analyze(step, args)
            trace_s = time.perf_counter() - t0
    result.update({"arch": arch, "shape": spec.name, "mesh": mesh_name,
                   "devices": world, "trace_s": round(trace_s, 2),
                   "ok": True, "tag": tag})
    mem, coll = result["memory"], result["collectives_per_device"]
    print(f"[dryrun] {arch} x {spec.name} x {mesh_name}: OK "
          f"(trace {trace_s:.1f}s, peak "
          f"{mem['peak_estimate_bytes'] / 2**30:.2f} GiB/dev, coll "
          f"{coll['total'] / 2**30:.2f} GiB/dev, flops/dev "
          f"{result['cost']['flops_per_device']:.3e})")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(out_dir,
                            f"{arch}__{spec.name}__{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Production dry run on a "
                                             "fake world")
    ap.add_argument("--arch", default="all", help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="train_4k|prefill_32k|decode_32k|long_500k|all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    n_ok = n_skip = 0
    for arch in archs:
        cfg = get_config(arch)
        names = list(shp.SHAPES) if args.shape == "all" else [args.shape]
        for shape_name in names:
            ok, why = shp.applicable(cfg, shp.SHAPES[shape_name])
            if not ok:
                print(f"[dryrun] {arch} x {shape_name}: SKIP ({why})")
                n_skip += 1
                continue
            for multi_pod in meshes:
                out = os.path.join(args.out,
                                   "multi" if multi_pod else "single")
                try:
                    run_cell(arch, shape_name, multi_pod, out_dir=out)
                    n_ok += 1
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((arch, shape_name, multi_pod, str(e)))
    print(f"\n[dryrun] {n_ok} cells OK, {n_skip} documented skips, "
          f"{len(failures)} failures")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
