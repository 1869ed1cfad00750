"""Whole runs of tiny cells on the CPU (the harness's look for a card
skipped): a sound run is correct, and a run whose served path is broken
underneath is not; the CLI without a card; no forbidden import; the
fp8 control against the limit."""
import itertools
import json
import subprocess
import sys
import time

import pytest
import torch

import portbench_testlib as tl
from portbench import control, harness, spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tl.tiny_checkout(tmp_path_factory.mktemp("checkout"))


def run(root, cell, seed=SEED, trace=False, loaded=()):
    """One tiny run in this process.  Other test files load JAX and the
    JAX package here (the port's reference), so the guard reads only
    ``loaded``; the subprocess test below holds what a run imports."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "forbidden_modules", lambda: list(loaded))
        return harness.run(spec.load_cell(root, cell), seed, 1.5, trace,
                           CPU, time.perf_counter())


# The end-to-end metrics each tiny cell reports, as its real twin does:
# the MoE cell's time to first token is a per-layer metric.
END_TO_END = {"tiny-dense": {"ttft_p90_ms", "tpot_p90_ms", "setup_s"},
              "tiny-moe": {"tpot_p90_ms", "setup_s"}}


@pytest.mark.parametrize("cell", ["tiny-dense", "tiny-moe"])
def test_sound_run_is_correct(root, cell):
    res = run(root, cell)
    assert res["correct"] is True
    assert res["attempted"] == 60 and res["failed"] == 0
    assert set(res["metrics"]) == END_TO_END[cell]
    assert list(res)[-1] == "checks"
    assert res["checks"]["max_logit_gap"]["value"] <= tl.TINY_LIMIT
    json.dumps(res)


def test_traced_run_reports_the_host_clock_layers(root):
    res = run(root, "tiny-dense", trace=True)
    assert res["correct"] is True
    # the CPU run holds no device trace: only the host-clock readers
    # find something
    assert set(res["metrics"]) == {"prefill_ms", "decode_step_ms",
                                   "prefill_mfu", "decode_hbm_share"}


def test_traced_moe_run_reports_its_time_to_first_token_per_layer(root):
    res = run(root, "tiny-moe", trace=True)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"ttft_p90_ms.moe", "prefill_ms.moe",
                                   "decode_step_ms", "prefill_mfu.moe"}


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import leaves_with_paths, map_tree
    real = tf.decode_step

    def step(params, tokens, states, cfg):
        saved = map_tree(lambda _, t: t.clone(), states)
        logits, new = real(params, tokens, states, cfg)
        for (_, now), (_, before) in zip(leaves_with_paths(new),
                                         leaves_with_paths(saved)):
            now.copy_(before)
        return logits, new
    monkeypatch.setattr(tf, "decode_step", step)


def _half_batch(monkeypatch):
    from repro_torch.models import transformer as tf
    real = tf.decode_step

    def step(params, tokens, states, cfg):
        logits, new = real(params, tokens, states, cfg)
        logits = logits.clone()
        half = logits.shape[0] // 2
        logits[half:] = logits[:logits.shape[0] - half]
        return logits, new
    monkeypatch.setattr(tf, "decode_step", step)


def _token_altered(monkeypatch):
    from repro_torch.serve import engine
    real, calls = engine.sample, itertools.count()

    def sample(gen, logits, cfg):
        out = real(gen, logits, cfg)
        if next(calls) % 5 == 4:
            out = (out + 1) % cfg.vocab_size
        return out
    monkeypatch.setattr(engine, "sample", sample)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=["state-unchanged", "half-batch",
                              "token-altered"])
@pytest.mark.parametrize("cell", ["tiny-dense", "tiny-moe"])
def test_broken_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(root, cell)
    assert res["correct"] is False
    assert res["checks"]["max_logit_gap"]["value"] > 10 * tl.TINY_LIMIT


def test_wrong_length_is_not_correct(root, monkeypatch):
    from repro_torch.serve import engine
    real = engine.ServeEngine.admit

    def admit(self, req):
        ok = real(self, req)
        if ok:
            self.remaining[self.active.index(req)] += 1   # one token more
        return ok
    monkeypatch.setattr(engine.ServeEngine, "admit", admit)
    res = run(root, "tiny-dense")
    assert res["correct"] is False
    assert res["checks"]["wrong_length"]["value"] == 60


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_fails_the_limit(root, seed):
    cell = spec.load_cell(root, "tiny-dense")
    readings, ctrl, _, _ = control.served(cell, seed, 1.5, CPU, warm=True)
    assert readings["max_logit_gap"] <= tl.TINY_LIMIT < ctrl["max_logit_gap"]
    assert readings["decode_kl_mean"] <= tl.TINY_KL_LIMIT < \
        ctrl["decode_kl_mean"]


@pytest.mark.parametrize("cell", ["tiny-dense", "tiny-moe"])
def test_int8_kv_cache_is_not_correct(root, cell):
    """The program's own lower-precision path, its int8 KV cache, comes
    out not correct through the cell's limits: the KL divergence of its
    decode logits, not the gap of its served tokens, is what it fails."""
    c = spec.load_cell(root, cell)
    limits = c.params["check"]["limits"]
    kv, _, _, _ = control.served(c, 4, 1.5, CPU, warm=True, kv_quant=True)
    correct, checks = harness.judge(kv, limits)
    assert correct is False
    assert checks["decode_kl_mean"]["value"] > 10 * tl.TINY_KL_LIMIT


def test_router_witness_departs_from_the_reference(root):
    """The reference with only its router logits in bfloat16 changes
    some top-k sets of the tiny MoE, and its logits with them."""
    c = spec.load_cell(root, "tiny-moe")
    readings, _, witness, _ = control.served(c, 6, 1.5, CPU, warm=True,
                                             flips=True)
    assert readings["decode_kl_mean"] <= tl.TINY_KL_LIMIT
    assert 0.0 < witness["flip_share"] < 1.0
    assert witness["decode_kl_mean"] > 10 * tl.TINY_KL_LIMIT


@pytest.mark.gpu
def test_fp8_control_fails_the_cell_limit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its full size")
    cell = spec.load_cell(tl.ROOT, "dsk7b-docqa")
    limits = cell.params["check"]["limits"]
    readings, ctrl, _, _ = control.served(cell, 12345, 12.0,
                                          torch.device("cuda", 0), True)
    assert all(readings[k] <= v for k, v in limits.items())
    assert any(ctrl[k] > v for k, v in limits.items() if k in ctrl)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["dsk7b-docqa", "moe16b-docqa"])
def test_int8_kv_cache_fails_the_cell_limits_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its full size")
    c = spec.load_cell(tl.ROOT, cell)
    kv, _, _, _ = control.served(c, 54321, 12.0, torch.device("cuda", 0),
                                 True, kv_quant=True)
    assert harness.judge(kv, c.params["check"]["limits"])[0] is False


def test_cli_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(tl.ROOT / "portbench" / "run.py"), "--workload",
         "dsk7b-docqa", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout.strip() == ""


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    code = (
        "import sys, glob, importlib, pathlib\n"
        f"sys.path[:0] = [{str(tl.ROOT / 'src')!r}, {str(tl.ROOT)!r}]\n"
        "from portbench import harness, spec, control, sweep, counters, trace\n"
        "from portbench.reference import deepseek\n"
        "import repro_torch.serve.engine, repro_torch.models.transformer\n"
        "import repro_torch.kernels.flash_attention\n"
        f"for p in glob.glob({str(tl.ROOT / 'portbench/metrics/*.py')!r}):\n"
        f"    spec.metric_reader(pathlib.Path({str(tl.ROOT)!r}), "
        "pathlib.Path(p).stem)\n"
        "print(','.join(harness.forbidden_modules()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "reprox", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "repro.core", "flax",
                                      "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]


def test_a_run_that_loaded_jax_prints_no_result(root):
    with pytest.raises(SystemExit, match="jax"):
        run(root, "tiny-dense", loaded=["jax"])
