"""PyTorch port, the production dry run and the cost probe
(``repro_torch.launch.dryrun``, ``costprobe``, ``op_analysis``), the
model kernels as registered ops, and sharded prefill and decode, against
the JAX package and a real gloo world on the CPU.

JAX runs only in a subprocess with 8 forced host devices: importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 devices, which would
hold every later JAX test of this worker to them.  Its meshes are built
with ``AxisType.Auto`` axes (JAX 0.9's ``jax.make_mesh`` gives
``Explicit`` ones, which the reference's constraints refuse).  The gloo
world of 8 ranks runs ``tests/torch_dist_worker.py``'s ``dryrun`` case.
Both start with the module's first test and run beside the fake-world
counts, which come first.

Tolerances: argument bytes, collectives and the aten products' FLOPs
``==``; the probe's extrapolation within 1e-9 of the direct count (both
are integers, the extrapolation divides); sharded logits within 4e-6 of
their scale (the sharded step's float32 bound in
``tests/test_torch_distributed.py``; 2.0e-6 seen,
xLSTM), greedy tokens ``==``.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm_chunkwise as mc
from repro_torch.kernels import rglru_scan as rg
from repro_torch.launch import costprobe, dryrun, shapes
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models.params import params_from_numpy

import torch_dist_worker as worker  # noqa: E402

JAX_ARCHS = ("deepseek-7b", "deepseek-moe-16b", "recurrentgemma-9b",
             "xlstm-125m", "whisper-medium", "internvl2-26b")
MESH = worker.STEP_MESH
TIMEOUT = 400
SERVE_TOL = 4e-6

_JAX = textwrap.dedent("""
    import os, pickle, sys
    # 8 devices; argument sizes do not depend on the code XLA emits, so
    # its backend optimisations are off (compiles take half the time)
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    import jax
    jax.devices()            # 8 devices, before the import below asks 512
    from repro.configs import get_config, list_archs
    from repro.launch import costprobe, dryrun, shapes
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {"probe": {}, "args": {}}
    for arch in list_archs():
        a, b, la, lb = costprobe.probe_configs(get_config(arch))
        out["probe"][arch] = (la, lb, a.num_layers, b.num_layers,
                              a.encoder_layers, b.encoder_layers)
    for arch in sys.argv[2].split(","):
        cfg = get_config(arch, tiny=True)
        for name, shape in shapes.SHAPES.items():
            if shapes.applicable(cfg, shape)[0]:
                ma = dryrun.build_lowered(cfg, name, mesh).compile() \\
                    .memory_analysis()
                out["args"][(arch, name)] = ma.argument_size_in_bytes
    with open(sys.argv[1], "wb") as fh:
        pickle.dump(out, fh)
""")


@pytest.fixture(scope="module", autouse=True)
def jobs(tmp_path_factory):
    """Start the JAX subprocess and the gloo world with the module's
    first test; each getter waits for its job."""
    d = tmp_path_factory.mktemp("dryrun")
    path = str(d / "jax.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=worker.SRC,
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX, path,
                             ",".join(JAX_ARCHS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    wait = worker.spawn("dryrun", 8, str(d), TIMEOUT)
    cache = {}

    def jax_out():
        if "jax" not in cache:
            log = proc.communicate(timeout=TIMEOUT)[0]
            assert proc.returncode == 0, log[-3000:]
            with open(path, "rb") as fh:
                cache["jax"] = pickle.load(fh)
        return cache["jax"]

    def gloo_out():
        if "gloo" not in cache:
            cache["gloo"] = wait()
        return cache["gloo"]
    yield {"jax": jax_out, "gloo": gloo_out}
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# --------------------------------------------------------------------------- #
# the kernels as registered ops
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("count,want", [
    (lambda: fa.flash_flops(*_meta((1, 64, 3072, 128), (1, 8, 3072, 128)),
                            True, 0, 1.0), 154_669_154_304),      # Command-R
    (lambda: fa.flash_flops(*_meta((1, 16, 3072, 128), (1, 16, 3072, 128)),
                            True, 0, 1.0), 38_667_288_576),       # DeepSeekMoE
    (lambda: fa.flash_flops(*_meta((1, 16, 1500, 64), (1, 16, 1500, 64)),
                            False, 0, 1.0), 9_216_000_000),       # Whisper enc.
    (lambda: rg.rglru_bytes(_f32((1, 3072, 4096)), _f32((1, 3072, 4096)),
                            torch.bfloat16), 125_829_120),
    (lambda: mc.mlstm_flops(*_mlstm_meta((1, 4, 3072, 384)), None, None,
                            None, 64, True), 7_785_676_800),
], ids=["flash-command-r", "flash-deepseek-moe", "flash-whisper-encoder",
        "rglru-bytes", "mlstm-parallel"])
def test_kernel_counts_equal_perf_md(count, want):
    """Each kernel op's operation or byte count at a cell's shape is the
    count PERF.md §6 gives that cell's bound."""
    assert count() == want


def _meta(q_shape, k_shape):
    q = torch.empty(q_shape, dtype=torch.bfloat16, device="meta")
    k = torch.empty(k_shape, dtype=torch.bfloat16, device="meta")
    return q, k, k


def _f32(shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _mlstm_meta(shape):
    B, H, T, d = shape
    qkv = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    g = torch.empty((B, H, T), dtype=torch.bfloat16, device="meta")
    return qkv, qkv, qkv, g, g


def test_visible_pairs_equal_the_mask():
    for T, S, causal, window in ((7, 7, True, 0), (9, 9, True, 3),
                                 (5, 11, False, 0), (12, 12, False, 4),
                                 (1, 6, True, 0)):
        assert fa.visible_pairs(T, S, causal, window) == int(
            fa._mask(T, S, causal, window, "cpu").sum())


def test_ops_route_cpu_to_plain_and_fake_to_the_card_route():
    """A CPU tensor takes the plain version through the registered op; a
    fake one takes the fake implementation, whose outputs have the CUDA
    route's shapes, and the parallel mLSTM call allocates its scratch
    (seen by the counter's peak); FlopCounterMode reads the ops'
    formulas."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 16, 8, generator=g) for _ in range(3))
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention_plain(q, k, v))
    a, b = torch.rand(2, 8, 4, generator=g), torch.randn(2, 8, 4,
                                                         generator=g)
    assert torch.equal(rg.rglru_scan(a, b), rg.rglru_scan_plain(a, b))
    with FlopCounterMode(display=False) as fc:
        fa.flash_attention(q, k, v)
    assert fc.get_total_flops() == fa.flash_flops(q, k, v, True, 0, 1.0)
    B, H, T, d = 1, 4, 256, 384
    with FakeTensorMode():
        x = torch.empty((B, H, T, d), dtype=torch.bfloat16)
        gate = torch.empty((B, H, T), dtype=torch.bfloat16)
        counter = OpCounter()
        with counter:
            h, (C, n, m) = mc.mlstm_chunkwise(x, x, x, gate, gate)
        assert (h.shape, C.shape, n.shape, m.shape) == (
            (B, H, T, d), (B, H, d, d), (B, H, d), (B, H))
        assert h.dtype == torch.bfloat16 and C.dtype == torch.float32
    NC = T // 64
    scratch = B * H * (NC * d * 2 * d * 2 + NC * d * 4 + NC * 4
                       + (T + 2 * NC) * 4)
    outs = B * H * (T * d * 2 + (d * d + d + 1) * 4)
    assert counter.peak == scratch + outs
    assert counter.kernel_calls == {"mlstm_chunkwise": 1}
    assert counter.flops == mc.mlstm_flops(x, x, x, gate, gate, None, None,
                                           None, 64, True)


# --------------------------------------------------------------------------- #
# the probe and the CLIs
# --------------------------------------------------------------------------- #

# family -> (TINY twin, depth, step): the dense twin's train step, the
# others' prefill (a train step's probe takes 10-30 s each).
PROBES = {"dense": ("deepseek-7b", 5, "train"),
          "moe": ("deepseek-moe-16b", 5, "prefill"),
          "ssm": ("xlstm-125m", 12, "prefill"),
          "hybrid": ("recurrentgemma-9b", 9, "prefill"),
          "audio": ("whisper-medium", 4, "prefill"),
          "vlm": ("internvl2-26b", 4, "prefill")}


@pytest.mark.parametrize("family", PROBES)
def test_probe_extrapolation_equals_direct_count(family):
    """The probe's (La, Lb) extrapolation of a TINY twin's step to a
    deeper stack equals that stack's direct count of FLOPs and
    collective bytes: the accounting is linear in depth (bytes moved are
    not: ``costprobe``'s docstring)."""
    arch, depth, kind = PROBES[family]
    cfg = get_config(arch, tiny=True)
    assert cfg.family == family
    over = {"num_layers": depth}
    if cfg.is_encoder_decoder:
        over["encoder_layers"] = depth
    r = costprobe.run_probe(arch, shapes.ShapeSpec(kind, 16, 8, kind),
                            direct=True, mesh=MESH, tiny=True,
                            cfg_overrides=over)
    assert r["probe_layers"][1] < depth
    assert costprobe.agrees(r)
    assert r["flops_per_device_b"] > r["flops_per_device_a"] > 0


def test_dryrun_cli_reports_the_documented_skips(capsys):
    assert dryrun.main(["--arch", "deepseek-7b", "--shape", "long_500k",
                        "--mesh", "single"]) == 0
    out = capsys.readouterr().out
    assert "SKIP" in out and "0 cells OK, 1 documented skips, 0 failures" \
        in out


# --------------------------------------------------------------------------- #
# the dry run against a real world and against JAX
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", worker.DRYRUN_ARCHS)
@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_fake_world_equals_gloo_world(arch, kind, jobs):
    """The fake world of 8's accounting `==` 8 gloo ranks' on real
    tensors, each rank alike: collectives by kind and bytes, argument
    bytes, and the FLOPs of the aten products outside the kernels."""
    got = worker.dryrun_counts(dryrun.run_cell(
        arch, worker.dryrun_shapes()[kind], False, mesh=MESH, tiny=True))
    ranks = jobs["gloo"]()
    for r in ranks:
        assert r[f"{arch}|{kind}"] == got
    assert got["collectives"]["total"] > 0 and got["aten_flops"]


@pytest.mark.parametrize("arch", list_archs())
def test_sharded_prefill_and_decode_match_single_device(arch, jobs):
    """Sharded prefill and greedy decode of the float32 TINY twin on
    (2, 4) against the port's single-device ones."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32")
    batch, cache_len = worker.serve_batch(cfg)
    want = worker.greedy(params_from_numpy(worker.tiny_tree(cfg), "cpu"),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         cfg, cache_len)
    ranks = jobs["gloo"]()
    got = ranks[0][f"serve|{arch}"]
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= SERVE_TOL * scale
    assert np.array_equal(got[..., :cfg.vocab_size].argmax(-1),
                          want[..., :cfg.vocab_size].argmax(-1))
    for r in ranks[1:]:
        assert np.array_equal(r[f"serve|{arch}"], got)


def _input_bytes(arch, shape):
    """Per-card bytes of a cell's inputs, built on a fake world of 8
    without running the step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_mesh
    with dryrun.fake_world(8):
        mesh = make_mesh(*MESH, "cpu")
        with FakeTensorMode():
            _, args = dryrun.build_step(get_config(arch, tiny=True), shape,
                                        mesh)
            return dryrun.argument_bytes(args)


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_argument_bytes_equal_jax_memory_analysis(arch, jobs):
    """Per-card argument bytes of every applicable shape on (2, 4) `==`
    JAX's ``argument_size_in_bytes``.  A decode cell is traced whole (its
    arguments are those the step reads: jit prunes Whisper's encoder and
    cross k, v projections); a prefill cell reads every input, which a
    small-shape trace of the same config shows, and so does a train step
    (AdamW reads every leaf); their inputs are built at the cell's
    shape."""
    cfg = get_config(arch, tiny=True)
    shape = worker.dryrun_shapes()["prefill"]
    r = dryrun.run_cell(arch, shape, False, mesh=MESH, tiny=True)
    assert r["memory"]["argument_bytes"] == _input_bytes(arch, shape)
    want = jobs["jax"]()["args"]
    names = [n for n, s in shapes.SHAPES.items()
             if shapes.applicable(cfg, s)[0]]
    assert {n for a, n in want if a == arch} == set(names)
    for name in names:
        if shapes.SHAPES[name].kind == "decode":
            got = dryrun.run_cell(arch, name, False, mesh=MESH,
                                  tiny=True)["memory"]["argument_bytes"]
        else:
            got = _input_bytes(arch, shapes.SHAPES[name])
        assert got == want[(arch, name)], name


@pytest.mark.parametrize("arch", list_archs())
def test_probe_configs_equal_reference(arch, jobs):
    a, b, la, lb = costprobe.probe_configs(get_config(arch))
    assert (la, lb, a.num_layers, b.num_layers, a.encoder_layers,
            b.encoder_layers) == jobs["jax"]()["probe"][arch]
