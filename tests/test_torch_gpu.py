"""PyTorch port on the card: the CUDA kernels, the lane engine, the
forecaster, the RecurrentGemma, xLSTM, MoE, dense, Whisper and
InternVL2 serving paths and the training path on CUDA.

Every test here is marked ``gpu`` and skips itself without a CUDA card
(the kernels have no CPU mode).  On the card::

    python -m pytest -q -m gpu tests/test_torch_gpu.py

The file imports only torch, numpy and the port, so it runs where JAX is
not installed.
"""
import dataclasses
import hashlib
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.forecast import features, model
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import mlstm_chunkwise as mlstm
from repro_torch.kernels import rglru_scan as rglru
from repro_torch.manyworld import lane_kernel, lanes, select
from repro_torch.search.runner import CellSpec, _get_trace, run_cells

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_forecaster_golden"
LANE_GOLDEN = Path(__file__).resolve().parent / "data" / "torch_lane_golden.npz"
FAMILIES = ("diurnal", "flash-crowd", "heavy-tail", "mix-ramp",
            "scale-stress", "multi-tenant")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _cases():
    rng = np.random.default_rng(5)
    out = [(rng.standard_normal((L, N)), rng.random((L, N)) < 0.5)
           for L, N in ((2048, 64), (7, 1), (33, 1000), (16, 33))]
    ties = rng.integers(0, 2, (64, 40)).astype(np.float64)
    ties[::2] = np.where(ties[::2] > 0, 0.0, -0.0)
    out.append((ties, rng.random((64, 40)) < 0.7))
    inf = np.full((9, 12), np.inf)
    out.append((inf, rng.random((9, 12)) < 0.5))
    return out


@pytest.mark.gpu
def test_kernel_matches_plain_on_cuda(cuda):
    before = select.launches
    cases = _cases()
    for scores, mask in cases:
        s = torch.from_numpy(scores).to(cuda)
        m = torch.from_numpy(mask).to(cuda)
        got = select.masked_argmin(s, m)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        assert torch.equal(got, select.masked_argmin_plain(s, m))
    assert select.launches == before + len(cases)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    s = torch.zeros((4, 8), dtype=torch.float64, device=cuda)
    m = torch.ones((4, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        select.masked_argmin(s.float(), m)
    with pytest.raises(ValueError, match="contiguous"):
        select.masked_argmin(s.t().contiguous().t(), m)
    with pytest.raises(ValueError, match="shape"):
        select.masked_argmin(s, m[:, :4])


@pytest.mark.gpu
@pytest.mark.parametrize("sched", lanes.SCHEDULERS)
def test_lane_outputs_on_cuda_equal_cpu(cuda, sched):
    lane_dicts = []
    for seed, nw in ((0, 4), (1, 2), (2, 12)):
        d = _get_trace("mix-ramp", seed, 40).to_lane_arrays()
        d.update(n_nodes=nw, alloc_cpu=940.0, alloc_mem=3584.0,
                 weights=(0.2, 0.5, 0.3) if sched == "weighted" else None)
        lane_dicts.append(d)
    before = lane_kernel.launches
    on_gpu = lanes.run_lane_batch(
        lanes.stack_lanes(lane_dicts, sched, device=cuda), device=cuda)
    assert lane_kernel.launches == before + 1
    on_cpu = lanes.run_lane_batch(
        lanes.stack_lanes(lane_dicts, sched, device="cpu"), device="cpu")
    _assert_equal(on_gpu, on_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("sched", lanes.SCHEDULERS)
def test_lockstep_select_kernel_on_cuda_equal_cpu(cuda, sched):
    """The lockstep program on the card, whose every select launches the
    standalone masked-argmin kernel."""
    lane_dicts = [_lane("mix-ramp", seed, 40, nw, sched)
                  for seed, nw in ((0, 4), (1, 2))]
    before = select.launches
    on_gpu = lanes.run_lane_batch_lockstep(
        lanes.stack_lanes(lane_dicts, sched, device=cuda), device=cuda)
    assert select.launches > before
    on_cpu = lanes.run_lane_batch(
        lanes.stack_lanes(lane_dicts, sched, device="cpu"), device="cpu")
    _assert_equal(on_gpu, on_cpu)


@pytest.mark.gpu
def test_rows_on_cuda_equal_cpu(cuda):
    cells = [CellSpec(scenario=s, scheduler="k8s-default", autoscaler="void",
                      rescheduler="void", seed=seed, n_jobs=40,
                      initial_workers=3)
             for s in ("heavy-tail", "diurnal") for seed in range(2)]
    before = lane_kernel.launches
    on_gpu = run_cells(cells, workers="lanes")   # device=None is the card
    assert lane_kernel.launches > before
    on_cpu = run_cells(cells, workers="lanes", device="cpu")
    for g, c in zip(on_gpu, on_cpu):
        g.pop("wall_s"), c.pop("wall_s")
        assert g == c


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


def _lane(scen, seed, n_jobs, n_nodes, sched="best-fit"):
    d = _get_trace(scen, seed, n_jobs).to_lane_arrays()
    d.update(n_nodes=n_nodes, alloc_cpu=940.0, alloc_mem=3584.0,
             weights=(0.6, 0.1, 0.3) if sched == "weighted" else None)
    return d


def _pods(arrival, cpu, dur, n_nodes=2):
    n = len(arrival)
    return {"arrival_t": np.asarray(arrival, float),
            "cpu_m": np.asarray(cpu, float), "mem_mb": np.full(n, 100.0),
            "duration_s": np.asarray(dur, float),
            "is_batch": np.ones(n, bool), "n_nodes": n_nodes,
            "alloc_cpu": 940.0, "alloc_mem": 3584.0}


def _edge_batches(sched):
    """(name, lane dicts, lockstep on the card too): the edges of
    tests/test_torch_lane_kernel.py, built without JAX."""
    ht = [_lane("heavy-tail", s, 24, 2, sched) for s in range(5)]
    rng = np.random.default_rng(0)
    mixed = _lane("mix-ramp", 0, 40, 3, sched)
    perm = rng.permutation(mixed["arrival_t"].size)
    shuffled = dict(mixed, **{k: mixed[k][perm] for k in
                              ("arrival_t", "cpu_m", "mem_mb", "duration_s",
                               "is_batch")})
    return [
        ("infeasible_and_zero_pod",
         [_pods([0.0, 5.0], [2000.0, 2000.0], [60.0, 60.0], 3), ht[0],
          _lane("heavy-tail", 0, 0, 2, sched)], True),
        ("three_lanes", ht[:3], True),
        ("five_lanes", ht, True),
        ("unsorted_rows", [shuffled, ht[1]], True),
        # A stuck lane and a lane past the 48 h horizon (MAX_CYCLES + 1
        # cycles; too long for the lockstep program's syncs on the card).
        ("stuck_and_horizon",
         [_pods([0.0, 5.0], [200.0, 2000.0], [30.0, 60.0]),
          _pods([0.0, 0.0], [100.0, 100.0], [300.0, 200000.0]), ht[0]],
         False),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("sched", lanes.SCHEDULERS)
def test_lane_kernel_equals_lockstep_on_edges(cuda, sched):
    for name, lane_dicts, lockstep_on_card in _edge_batches(sched):
        on_card = lanes.stack_lanes(lane_dicts, sched, device=cuda)
        on_cpu = lanes.stack_lanes(lane_dicts, sched, device="cpu")
        before = lane_kernel.launches
        res = lane_kernel.lane_program(on_card)
        torch.cuda.synchronize()
        assert lane_kernel.launches == before + 1, name
        got = lane_kernel.lane_outputs(res)
        _assert_equal(got, lanes.run_lane_batch(on_cpu, device="cpu"))
        if lockstep_on_card:
            _assert_equal(got, lanes.run_lane_batch_lockstep(on_card,
                                                             device=cuda))
        plain = lane_kernel.lane_program_plain(on_cpu)
        assert torch.equal(res["lane_stats"].cpu(), plain["lane_stats"]), name
        _assert_equal(got, lane_kernel.lane_outputs(plain))


@pytest.mark.gpu
def test_lane_kernel_reproduces_golden_fixture(cuda):
    with np.load(LANE_GOLDEN, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    for sched in lanes.SCHEDULERS:
        rows = type("Rows", (), {"scheduler": sched})
        for name in lanes.BATCH_FIELDS:
            setattr(rows, name, fx[f"{sched}/in/{name}"])
        before = lane_kernel.launches
        got = lanes.run_lane_batch(lanes.lane_batch_from_numpy(rows, cuda),
                                   device=cuda)
        assert lane_kernel.launches == before + 1
        want = {key.split("/", 2)[2]: val for key, val in fx.items()
                if key.startswith(f"{sched}/out/")}
        _assert_equal(got, want)


@pytest.mark.gpu
def test_lane_kernel_zero_lanes_and_limits(cuda):
    empty = lanes.stack_lanes([], "best-fit", device=cuda)
    before = lane_kernel.launches
    out = lanes.run_lane_batch(empty, device=cuda)
    assert lane_kernel.launches == before
    assert out["bound"].shape == (0, empty.p_pad) and int(out["n_cycles"]) == 0
    one = lanes.stack_lanes([_lane("heavy-tail", 0, 8, 2)], "best-fit",
                            device=cuda)
    with pytest.raises(ValueError, match="8192"):
        lane_kernel.lane_program(dataclasses.replace(one, n_pad=16384))
    with pytest.raises(TypeError, match="valid"):
        lane_kernel.lane_program(dataclasses.replace(
            one, valid=one.valid.to(torch.uint8)))


# (B, H, T, dk, dv, chunk, dtype, initial state): the forecaster's cell at
# the golden dataset's batch, tests/test_kernels.py's shapes in both
# dtypes, T = L, dv not a multiple of the block kernel's 32-column slice,
# a given initial state, and the block kernel's limits (L = 64, dk =
# 128); then the row kernel's envelope from both sides: L = 32 with
# dk = dv = 64 and a state in and out, several chunks with a state, an
# odd number of (b, h) at L <= 16 (two a warp), bfloat16 with a state,
# and just outside it (dk not a whole 16-byte row, dk = 96, L = 64);
# last, xLSTM-125M's 384-wide heads (the serving prefill's shape, cut in
# T, in bfloat16; float32 with a state in and out; T = L = 64 in both
# dtypes) and a dk of two ragged 128-column panels.
MLSTM_CASES = (
    (8668, 2, 16, 32, 32, 64, "float32", False),
    (1, 1, 128, 64, 64, 64, "float32", False),
    (1, 1, 128, 64, 64, 64, "bfloat16", False),
    (2, 2, 128, 32, 32, 32, "float32", False),
    (2, 2, 128, 32, 32, 32, "bfloat16", False),
    (4, 2, 64, 32, 32, 64, "float32", False),
    (2, 2, 64, 32, 48, 16, "float32", False),
    (3, 1, 32, 24, 20, 16, "float32", True),
    (1, 2, 128, 128, 64, 64, "float32", True),
    (5, 3, 96, 64, 64, 32, "float32", True),
    (64, 2, 64, 32, 32, 16, "float32", True),
    (7, 1, 16, 32, 32, 64, "float32", False),
    (7, 1, 16, 32, 32, 64, "bfloat16", False),
    (3, 3, 48, 16, 24, 16, "bfloat16", True),
    (1, 2, 32, 18, 36, 16, "float32", True),
    (2, 1, 32, 96, 32, 32, "float32", False),
    (3, 2, 64, 32, 32, 64, "bfloat16", True),
    (1, 4, 1024, 384, 384, 64, "bfloat16", False),
    (2, 4, 192, 384, 384, 64, "float32", True),
    (1, 4, 64, 384, 384, 64, "float32", False),
    (1, 4, 64, 384, 384, 64, "bfloat16", True),
    (2, 1, 48, 200, 72, 16, "float32", True),
)
# tests/test_kernels.py:160's tolerances: float32 sums in another order,
# bfloat16 outputs rounded.
TOL = {"float32": dict(atol=2e-4, rtol=2e-3),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _mlstm_inputs(case, device):
    B, H, T, dk, dv, chunk, dtype, with_state = case
    rng = np.random.default_rng(B * 1000 + T + dk + dv)
    arrays = [rng.standard_normal((B, H, T, dk)),
              rng.standard_normal((B, H, T, dk)) / np.sqrt(dk),
              rng.standard_normal((B, H, T, dv)),
              rng.standard_normal((B, H, T)),
              rng.standard_normal((B, H, T)) + 2.0]
    inputs = [torch.tensor(a, dtype=getattr(torch, dtype), device=device)
              for a in arrays]
    state = None
    if with_state:
        state = tuple(torch.tensor(a, dtype=torch.float32, device=device)
                      for a in (rng.standard_normal((B, H, dk, dv)),
                                np.abs(rng.standard_normal((B, H, dk))),
                                rng.standard_normal((B, H))))
    return inputs, state


@pytest.mark.gpu
@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_kernel_matches_plain_on_cuda(cuda, case):
    inputs, state = _mlstm_inputs(case, cuda)
    chunk, dtype = case[5], case[6]
    kernel = mlstm.pick_kernel(min(chunk, case[2]), case[3], case[4],
                               getattr(torch, dtype), inputs, state or ())
    before = (mlstm.launches, mlstm.row_launches, mlstm.parallel_launches)
    h, s = mlstm.mlstm_chunkwise(*inputs, state=state, chunk=chunk)
    h_only, none = mlstm.mlstm_chunkwise(*inputs, state=state, chunk=chunk,
                                         return_state=False)
    torch.cuda.synchronize()
    assert mlstm.launches == before[0] + 2 and none is None
    assert mlstm.row_launches == before[1] + 2 * (kernel == "rows")
    assert mlstm.parallel_launches == before[2] + 2 * (kernel == "parallel")
    want_h, want_s = mlstm.mlstm_chunkwise_plain(*inputs, state=state,
                                                 chunk=chunk)
    assert h.dtype == want_h.dtype == getattr(torch, dtype)
    assert torch.equal(h, h_only)
    torch.testing.assert_close(h.float(), want_h.float(), **TOL[dtype])
    for got, want in zip(s, want_s):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    c for c in MLSTM_CASES if mlstm.takes_row_kernel(
        min(c[2], c[5]), c[3], c[4], getattr(torch, c[6]))])
def test_mlstm_both_kernels_agree_in_the_row_envelope(cuda, case):
    """Each shape the row kernel takes, through it and through the block
    kernel: both match the plain version, h and the final state."""
    inputs, state = _mlstm_inputs(case, cuda)
    chunk, dtype = case[5], case[6]
    want_h, want_s = mlstm.mlstm_chunkwise_plain(*inputs, state=state,
                                                 chunk=chunk)
    for kernel in ("rows", "block"):
        h, s = mlstm._mlstm_chunkwise_cuda(*inputs, state, chunk, True,
                                           kernel=kernel)
        torch.cuda.synchronize()
        torch.testing.assert_close(h.float(), want_h.float(), **TOL[dtype])
        for got, want in zip(s, want_s):
            torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.gpu
def test_mlstm_kernel_rejects_what_it_does_not_take(cuda):
    inputs, _ = _mlstm_inputs((1, 1, 16, 8, 8, 16, "float32", False), cuda)
    q, k, v, i, f = inputs
    with pytest.raises(TypeError):
        mlstm.mlstm_chunkwise(q.half(), k, v, i, f)
    with pytest.raises(ValueError, match="device"):
        mlstm.mlstm_chunkwise(q, k.cpu(), v, i, f)
    with pytest.raises(ValueError, match="dk <= 384"):
        big, _ = _mlstm_inputs((1, 1, 16, 385, 8, 16, "float32", False), cuda)
        mlstm.mlstm_chunkwise(*big)
    with pytest.raises(ValueError, match="row kernel"):
        odd, _ = _mlstm_inputs((1, 1, 16, 18, 8, 16, "float32", False), cuda)
        mlstm._mlstm_chunkwise_cuda(*odd, None, 16, True, kernel="rows")


# The parallel kernel's envelope (bfloat16, L = 64, dk and dv whole
# 64-wide tiles up to 384): T = L, several chunks, a state in and out,
# B*H > 4, dv != dk, T 3008 (the serve cell's longest prompt), and
# xLSTM-125M's prefill shape.
MLSTM_PARALLEL_CASES = (
    (1, 1, 64, 64, 64, 64, "bfloat16", False),
    (1, 4, 64, 384, 384, 64, "bfloat16", True),
    (1, 4, 256, 384, 384, 64, "bfloat16", False),
    (2, 4, 256, 384, 384, 64, "bfloat16", True),
    (5, 2, 192, 64, 128, 64, "bfloat16", True),
    (3, 2, 256, 320, 64, 64, "bfloat16", False),
    (1, 4, 3008, 384, 384, 64, "bfloat16", True),
    (3, 2, 3008, 128, 320, 64, "bfloat16", False),
    (1, 4, 3072, 384, 384, 64, "bfloat16", False),
)


@pytest.mark.gpu
@pytest.mark.parametrize("case", MLSTM_PARALLEL_CASES)
def test_mlstm_parallel_kernel_matches_plain_on_cuda(cuda, case):
    """The parallel kernel against the sequential plain version and
    against its own algorithm in plain PyTorch with the same bfloat16
    hi/lo operands: h and the final state, with the state out and
    without."""
    inputs, state = _mlstm_inputs(case, cuda)
    before = (mlstm.launches, mlstm.parallel_launches)
    h, s = mlstm.mlstm_chunkwise(*inputs, state=state, chunk=64)
    h_only, none = mlstm.mlstm_chunkwise(*inputs, state=state, chunk=64,
                                         return_state=False)
    torch.cuda.synchronize()
    assert none is None and torch.equal(h, h_only)
    assert mlstm.launches == before[0] + 2
    assert mlstm.parallel_launches == before[1] + 2
    for plain in (mlstm.mlstm_chunkwise_plain,
                  lambda *x, **kw: mlstm.mlstm_chunkwise_parallel_plain(
                      *x, rounding="bf16x2", **kw)):
        want_h, want_s = plain(*inputs, state=state, chunk=64)
        assert h.dtype == want_h.dtype == torch.bfloat16
        torch.testing.assert_close(h.float(), want_h.float(),
                                   **TOL["bfloat16"])
        for got, want in zip(s, want_s):
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, want, **TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("case,kernel", [
    ((1, 4, 256, 384, 384, 64, "float32", True), "block"),
    ((1, 4, 256, 384, 384, 32, "bfloat16", False), "block"),
    ((2, 2, 128, 200, 64, 64, "bfloat16", True), "block"),
    ((2, 2, 128, 64, 72, 64, "bfloat16", False), "block"),
    ((2, 2, 64, 32, 32, 16, "bfloat16", False), "rows"),
])
def test_mlstm_parallel_rejections_take_the_old_kernels(cuda, case, kernel):
    """Outside the parallel kernel's envelope (float32, L != 64, dk or dv
    not whole 64-wide tiles) the wrapper takes the row or block kernel,
    and naming the parallel kernel raises."""
    inputs, state = _mlstm_inputs(case, cuda)
    chunk = case[5]
    before = (mlstm.launches, mlstm.row_launches, mlstm.parallel_launches)
    h, s = mlstm.mlstm_chunkwise(*inputs, state=state, chunk=chunk)
    torch.cuda.synchronize()
    assert mlstm.launches == before[0] + 1
    assert mlstm.row_launches == before[1] + (kernel == "rows")
    assert mlstm.parallel_launches == before[2]
    want_h, want_s = mlstm.mlstm_chunkwise_plain(*inputs, state=state,
                                                 chunk=chunk)
    torch.testing.assert_close(h.float(), want_h.float(), **TOL[case[6]])
    for got, want in zip(s, want_s):
        torch.testing.assert_close(got, want, **TOL[case[6]])
    with pytest.raises(ValueError, match="parallel kernel does not take"):
        mlstm._mlstm_chunkwise_cuda(*inputs, state, chunk, True,
                                    kernel="parallel")


def _digest(data) -> str:
    h = hashlib.sha256()
    for key in ("X_train", "y_train", "X_val", "y_val"):
        h.update(np.ascontiguousarray(data[key], np.float64).tobytes())
    return h.hexdigest()


@pytest.mark.gpu
def test_forecaster_reproduces_golden_fixture_on_cuda(cuda):
    with np.load(GOLDEN / "expected.npz", allow_pickle=False) as z:
        want = {key: z[key] for key in z.files}
    data = features.make_dataset(FAMILIES, range(48), features.WindowConfig())
    assert _digest(data) == str(want["digest"])
    fc = model.load_forecaster(str(GOLDEN / "checkpoint"))
    assert fc.device.type == "cuda"
    X = np.concatenate([data["X_train"], data["X_val"]])
    before = mlstm.launches
    with torch.inference_mode():
        out = model.apply_forecast(
            fc.params, torch.from_numpy(np.log1p(X.astype(np.float32))).to(
                cuda), fc.arch).cpu().numpy()
    assert mlstm.launches == before + 1
    np.testing.assert_allclose(out, want["outputs"], atol=2e-5, rtol=2e-5)
    n_train = int(want["n_train"])
    mse = float(np.mean((out[n_train:] - np.log1p(
        data["y_val"].astype(np.float32))) ** 2))
    assert abs(mse - float(want["val_log_mse"])) < 1e-4
    seq = []
    for r in want["flash_rates"]:
        fc.observe_bin(r)
        seq.append(fc.predict())
    np.testing.assert_allclose(np.asarray(seq), want["per_bin"], rtol=1e-4,
                               atol=1e-6)


# (B, T, R, input dtype, output dtype): T = 1, the serving shape (float32
# coefficients, bfloat16 out), T and R not multiples of any block, B > 1,
# bfloat16 inputs; inputs under 24 MB take the chunked kernel, the rest
# the ring kernel: T spanning many tiles (8191 steps, B 4), R not a
# multiple of its 32 channels, rows not whole 16-byte pieces (R 2051 in
# bfloat16), T shorter than one 64-step tile and bfloat16 in and out.
RGLRU_CASES = (
    (1, 1, 4096, "float32", "float32"),
    (1, 3072, 4096, "float32", "bfloat16"),
    (3, 517, 100, "float32", "float32"),
    (2, 33, 4096, "bfloat16", "bfloat16"),
    (2, 200, 257, "bfloat16", "float32"),
    (1, 15, 31, "float32", "bfloat16"),
    (4, 8191, 256, "float32", "float32"),
    (1, 3072, 4096, "float32", "float32"),
    (2, 100, 72, "bfloat16", "bfloat16"),
    (3, 130, 33, "bfloat16", "float32"),
    (1, 63, 4096, "float32", "bfloat16"),
    (2, 700, 96, "bfloat16", "float32"),
    (2, 1600, 2051, "bfloat16", "float32"),
    (1, 2000, 4096, "bfloat16", "bfloat16"),
    (1, 40, 160000, "float32", "bfloat16"),
)
# The tolerances of the earlier chunked kernel, which chained its time
# chunks' carries in another order than the sequential walk (float32
# rounding; a bfloat16 output may then round one ulp apart).  The
# kernel now walks the oracle's own sequence of operations.
RGLRU_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=1e-2, rtol=1e-2)}


def _rglru_inputs(case, device):
    B, T, R, dtype, _ = case
    rng = np.random.default_rng(B * 7919 + T * 31 + R)
    a = rng.uniform(0.5, 0.999, (B, T, R))
    b = 0.1 * rng.standard_normal((B, T, R))
    return [torch.tensor(x, dtype=getattr(torch, dtype), device=device)
            for x in (a, b)]


@pytest.mark.gpu
def test_rglru_kernel_takes_unaligned_inputs(cuda):
    """Inputs that start 4 bytes past a 16-byte boundary, large enough
    for the ring kernel, take its ring filled by element loads."""
    a, b = _rglru_inputs((1, 900, 4096, "float32", "float32"), cuda)
    shifted = [torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
               for x in (a, b)]
    for dst, src in zip(shifted, (a, b)):
        dst.copy_(src)
    assert shifted[0].data_ptr() % 16 == 4
    h = rglru.rglru_scan(*shifted)
    torch.cuda.synchronize()
    torch.testing.assert_close(h, rglru.rglru_scan_plain(a, b),
                               **RGLRU_TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_kernel_matches_plain_on_cuda(cuda, case):
    a, b = _rglru_inputs(case, cuda)
    out_dtype = getattr(torch, case[4])
    before = (rglru.launches, rglru.chunked_launches)
    h = rglru.rglru_scan(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert rglru.launches == before[0] + 1
    assert rglru.chunked_launches == (before[1]
                                      + rglru.takes_chunked_kernel(a))
    want = rglru.rglru_scan_plain(a, b, out_dtype=out_dtype)
    assert h.dtype == want.dtype == out_dtype
    torch.testing.assert_close(h.float(), want.float(), **RGLRU_TOL[case[4]])


@pytest.mark.gpu
@pytest.mark.parametrize("T", [768, 769])
def test_rglru_both_kernels_agree_at_the_size_boundary(cuda, T):
    """Inputs of exactly 24 MB (T 768 at R 4096 in float32) take the
    chunked kernel, one step more the ring kernel; each size through
    both kernels matches the plain version."""
    a, b = _rglru_inputs((1, T, 4096, "float32", "bfloat16"), cuda)
    assert rglru.takes_chunked_kernel(a) == (T == 768)
    want = rglru.rglru_scan_plain(a, b, out_dtype=torch.bfloat16)
    for chunked in (True, False):
        before = (rglru.launches, rglru.chunked_launches)
        h = rglru._rglru_scan_cuda(a, b, torch.bfloat16, chunked=chunked)
        torch.cuda.synchronize()
        assert rglru.launches == before[0] + 1
        assert rglru.chunked_launches == before[1] + chunked
        torch.testing.assert_close(h.float(), want.float(),
                                   **RGLRU_TOL["bfloat16"])


# (B, Hq, Hkv, T, S, hd, causal, window, dtype): tests/test_kernels.py's
# sweep (MHA, GQA, MQA with hd 256), a window, a window wider than T with
# T not a multiple of the block, T = 1, hd not a power of two, a
# non-causal call, and the serving shape cut to T = 1100; then the
# bfloat16 tensor-core kernel's edges: T and S not multiples of its
# 128-query or 64-key tiles (77, 130, 1000, 2990 at the serving heads),
# a window edge inside a tile, GQA 8/2 at hd 128, hd 48, 80, 32 and 33
# zero-padded (33: the copy for hd not a multiple of 8), S > T with a
# window and no causal mask, T = S = 1 and non-causal calls.
FLASH_CASES = (
    (1, 1, 1, 128, 128, 64, True, 0, "float32"),
    (2, 4, 4, 256, 256, 64, True, 0, "bfloat16"),
    (2, 8, 2, 256, 256, 128, True, 0, "float32"),
    (1, 6, 1, 384, 384, 256, True, 0, "bfloat16"),
    (2, 2, 2, 256, 256, 64, True, 64, "float32"),
    (1, 2, 1, 100, 100, 128, True, 300, "float32"),
    (1, 4, 1, 1, 1, 256, True, 16, "bfloat16"),
    (2, 3, 1, 77, 77, 48, True, 0, "float32"),
    (1, 2, 2, 130, 130, 64, False, 0, "float32"),
    (1, 16, 1, 1100, 1100, 256, True, 512, "bfloat16"),
    (2, 3, 1, 77, 77, 48, True, 0, "bfloat16"),
    (1, 2, 2, 130, 130, 64, False, 0, "bfloat16"),
    (1, 4, 2, 1000, 1000, 80, True, 0, "bfloat16"),
    (1, 16, 1, 2990, 2990, 256, True, 2048, "bfloat16"),
    (1, 4, 1, 384, 384, 256, True, 100, "bfloat16"),
    (2, 8, 2, 256, 256, 128, True, 0, "bfloat16"),
    (1, 2, 1, 50, 90, 32, False, 20, "bfloat16"),
    (1, 2, 1, 70, 70, 33, True, 0, "bfloat16"),
    (1, 3, 1, 1, 1, 64, False, 0, "bfloat16"),
    (1, 16, 16, 1536, 1536, 128, True, 0, "bfloat16"),
    (1, 16, 8, 1024, 1024, 64, True, 0, "bfloat16"),
    (1, 64, 8, 512, 512, 128, True, 0, "bfloat16"),
    (1, 64, 8, 512, 512, 128, True, 0, "float32"),
    (1, 48, 48, 512, 512, 128, True, 0, "bfloat16"),
    # Whisper-medium: the encoder (non-causal, T = S = 1500, partial
    # tiles), cross attention at prefill (non-causal, T != S), the
    # decoder's causal self-attention; InternVL2-26B's prefill (GQA 48/8,
    # 1024 patches + 64 tokens); each also in float32, the fixtures' dtype
    (1, 16, 16, 1500, 1500, 64, False, 0, "bfloat16"),
    (1, 16, 16, 4, 1500, 64, False, 0, "bfloat16"),
    (1, 16, 16, 384, 1500, 64, False, 0, "bfloat16"),
    (1, 16, 16, 384, 384, 64, True, 0, "bfloat16"),
    (1, 48, 8, 1088, 1088, 128, True, 0, "bfloat16"),
    (1, 16, 16, 1500, 1500, 64, False, 0, "float32"),
    (1, 16, 16, 384, 1500, 64, False, 0, "float32"),
    (1, 48, 8, 1088, 1088, 128, True, 0, "float32"),
)
# tests/test_kernels.py's tolerances for the Pallas kernel against its
# oracle: float32 sums in another order, bfloat16 outputs rounded.
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _flash_inputs(case, device):
    B, Hq, Hkv, T, S, hd, _, _, dtype = case
    rng = np.random.default_rng(B + Hq * 10 + T + hd)
    return [torch.tensor(rng.standard_normal(shape),
                         dtype=getattr(torch, dtype), device=device)
            for shape in ((B, Hq, T, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain_on_cuda(cuda, case):
    q, k, v = _flash_inputs(case, cuda)
    causal, window, dtype = case[6:]
    before = flash.launches
    out = flash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    want = flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == want.dtype == q.dtype
    torch.testing.assert_close(out.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.gpu
def test_new_kernels_reject_what_they_do_not_take(cuda):
    a, b = _rglru_inputs((1, 4, 8, "float32", "float32"), cuda)
    with pytest.raises(TypeError):
        rglru.rglru_scan(a.half(), b.half())
    with pytest.raises(ValueError, match="device"):
        rglru.rglru_scan(a, b.cpu())
    q, k, v = _flash_inputs((1, 2, 1, 8, 8, 64, True, 0, "float32"), cuda)
    with pytest.raises(ValueError, match="hd <= 256"):
        big = torch.zeros((1, 2, 8, 320), device=cuda)
        flash.flash_attention(big, big[:, :1], big[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                              k, v)
    with pytest.raises(TypeError):
        flash.flash_attention(q.bfloat16(), k, v)


def _check_grads(module, kernel_fn, plain_fn, inputs, tol, seed=0):
    """The wrapper's result from grad-requiring inputs has a grad_fn and
    counts one launch; its gradients, for a seeded cotangent on every
    output, match autograd through the plain version; with grad off the
    wrapper still launches the kernel once and records nothing."""
    inputs = [None if t is None else t.detach().requires_grad_()
              for t in inputs]
    given = [t for t in inputs if t is not None]
    before = module.launches
    got = kernel_fn(*inputs)
    torch.cuda.synchronize()
    assert module.launches == before + 1
    assert all(o.grad_fn is not None for o in got)
    rng = np.random.default_rng(seed)
    cots = [torch.tensor(rng.standard_normal(o.shape), dtype=o.dtype,
                         device=o.device) for o in got]
    want = plain_fn(*inputs)
    for o, w in zip(got, want):
        torch.testing.assert_close(o.float(), w.float(), **tol)
    grads = torch.autograd.grad(got, given, cots)
    want_grads = torch.autograd.grad(want, given, cots)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g.float(), w.float(), **tol)
    with torch.no_grad():
        again = kernel_fn(*inputs)
    assert module.launches == before + 2
    assert all(o.grad_fn is None for o in again)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 300, 96, "float32", "float32"),
                                  (1, 3072, 1536, "float32", "bfloat16"),
                                  (2, 130, 33, "bfloat16", "bfloat16")])
def test_rglru_gradients_on_cuda_match_plain(cuda, case):
    od = getattr(torch, case[4])
    _check_grads(rglru, lambda a, b: (rglru.rglru_scan(a, b, od),),
                 lambda a, b: (rglru.rglru_scan_plain(a, b, od),),
                 _rglru_inputs(case, cuda), RGLRU_TOL[case[4]])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (1, 4, 2, 256, 256, 64, True, 64, "float32"),
    (1, 4, 1, 200, 200, 256, True, 0, "bfloat16"),
    (2, 2, 2, 130, 130, 64, False, 0, "bfloat16")])
def test_flash_gradients_on_cuda_match_plain(cuda, case):
    causal, window = case[6], case[7]
    _check_grads(flash,
                 lambda q, k, v: (flash.flash_attention(
                     q, k, v, causal=causal, window=window),),
                 lambda q, k, v: (flash.flash_attention_plain(
                     q, k, v, causal=causal, window=window),),
                 _flash_inputs(case, cuda), FLASH_TOL[case[8]])


# (B, Hq, Hkv, T, S, hd, causal, window, dtype): the capped kernels at
# each head dim, with their masks' edges: a window edge inside a tile, T
# and S not multiples of the 128-query block or the 64-key tile (keys
# zero-filled past S must stay hidden under the cap), GQA and MQA, no
# mask with T != S; one float32 case per head dim.
SOFTCAP_CASES = (
    (1, 4, 1, 384, 384, 256, True, 100, "bfloat16"),
    (1, 8, 2, 300, 300, 128, True, 0, "bfloat16"),
    (1, 4, 4, 200, 200, 128, False, 0, "bfloat16"),
    (1, 4, 4, 77, 1500, 64, False, 0, "bfloat16"),
    (2, 3, 1, 130, 130, 64, True, 50, "bfloat16"),
    (1, 2, 1, 50, 90, 32, False, 20, "bfloat16"),
    (1, 2, 1, 100, 100, 256, True, 0, "float32"),
    (1, 4, 2, 70, 70, 128, True, 16, "float32"),
    (1, 2, 2, 40, 90, 64, False, 0, "float32"),
)
SOFTCAP = 2.0


def _capped_inputs(case, device):
    """q at 3x unit scale (logits ~N(0, 9), bent hard by a cap of 2)."""
    q, k, v = _flash_inputs(case, device)
    return (3 * q).contiguous(), k, v


@pytest.mark.gpu
@pytest.mark.parametrize("case", SOFTCAP_CASES)
def test_capped_flash_kernel_matches_plain_on_cuda(cuda, case):
    """A CUDA call with a cap launches the capped kernel (one launch) and
    agrees with the plain version with the cap at the flash tolerance
    (bf16 also at that tolerance scaled to each row), where the uncapped
    plain version is 10x that tolerance away."""
    q, k, v = _capped_inputs(case, cuda)
    causal, window, dtype = case[6:]
    before = flash.launches
    out = flash.flash_attention(q, k, v, causal=causal, window=window,
                                softcap=SOFTCAP)
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    want = flash.flash_attention_plain(q, k, v, causal=causal, window=window,
                                       softcap=SOFTCAP)
    unc = flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == want.dtype == q.dtype
    assert float((want.float() - unc.float()).abs().max()) >= \
        10 * FLASH_TOL[dtype]["atol"]
    torch.testing.assert_close(out.float(), want.float(), **FLASH_TOL[dtype])
    if dtype == "bfloat16":
        # A capped softmax spreads over many keys, so its rows lie far
        # below unit scale: hold each query row also at the tolerance
        # scaled to its rms, which a capped logit off by 3 % fails.
        rms = want.float().pow(2).mean(-1, keepdim=True).sqrt()
        torch.testing.assert_close(out.float() / rms, want.float() / rms,
                                   **FLASH_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [SOFTCAP_CASES[1], SOFTCAP_CASES[7]])
def test_capped_flash_gradients_on_cuda_match_plain(cuda, case):
    causal, window = case[6], case[7]
    _check_grads(flash,
                 lambda q, k, v: (flash.flash_attention(
                     q, k, v, causal=causal, window=window,
                     softcap=SOFTCAP),),
                 lambda q, k, v: (flash.flash_attention_plain(
                     q, k, v, causal=causal, window=window,
                     softcap=SOFTCAP),),
                 _capped_inputs(case, cuda), FLASH_TOL[case[8]])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (64, 2, 16, 32, 32, 64, "float32", False),
    (3, 1, 32, 24, 20, 16, "float32", True),
    (64, 2, 64, 32, 32, 16, "float32", True),
    (2, 2, 64, 32, 32, 64, "float32", True),
    (4, 2, 32, 32, 32, 16, "bfloat16", False),
    (1, 4, 3072, 384, 384, 64, "bfloat16", False)])
def test_mlstm_gradients_on_cuda_match_plain(cuda, case):
    inputs, state = _mlstm_inputs(case, cuda)
    chunk = case[5]

    def run(fn):
        def call(q, k, v, i, f, *s):
            h, out = fn(q, k, v, i, f, state=tuple(s) or None, chunk=chunk)
            return (h,) + tuple(out)
        return call

    _check_grads(mlstm, run(mlstm.mlstm_chunkwise),
                 run(mlstm.mlstm_chunkwise_plain),
                 list(inputs) + list(state or ()), TOL[case[6]])


SERVE_GOLDEN = Path(__file__).resolve().parent / "data" / "torch_serve_golden"


@pytest.mark.gpu
def test_serve_golden_fixture_on_cuda(cuda):
    """The 8-layer float32 RecurrentGemma twin of
    ``tests/data/torch_serve_golden`` on the card, through both kernels:
    JAX's prefill and decode logits within ``atol 1e-4, rtol 1e-3`` and
    its greedy engine tokens exactly (tests/test_torch_serve.py makes the
    fixture; this file imports no JAX)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import map_tree, params_from_numpy
    from repro_torch.serve import engine as serve
    with np.load(SERVE_GOLDEN / "expected.npz", allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", tiny=True),
                              num_layers=8, dtype="float32")
    tree = map_tree(lambda path, _: fx["param/" + "/".join(map(str, path))],
                    tf.model_specs(cfg))
    params = params_from_numpy(tree, dtype=tf.serving_dtype(cfg))
    before = (flash.launches, rglru.launches)
    tokens = torch.from_numpy(fx["tokens"]).long().to(cuda)
    lg, states = tf.prefill(params, {"tokens": tokens[:, :13]}, cfg, 32)
    np.testing.assert_allclose(lg.cpu().numpy(), fx["prefill_logits"],
                               atol=1e-4, rtol=1e-3)
    for s in range(5):
        lg, states = tf.decode_step(params, tokens[:, 13 + s:14 + s], states,
                                    cfg)
        np.testing.assert_allclose(lg.cpu().numpy(), fx["decode_logits"][s],
                                   atol=1e-4, rtol=1e-3)
    eng = serve.ServeEngine(cfg, params, serve.EngineConfig(
        num_slots=2, cache_len=40))
    prompts = np.split(fx["engine_prompts"], np.cumsum([13, 4, 21, 9])[:4])
    reqs = [serve.Request(uid=i, prompt=p, max_new_tokens=new,
                          submitted_at=at)
            for i, (p, new, at) in enumerate(zip(
                prompts, (6, 8, 5, 7, 4), (0.0, 0.0, 1.0, 2.5, 2.5)))]
    now = [0.0]

    def clock():
        now[0] += 0.25
        return now[0]

    def sleep(dt):
        now[0] += dt

    serve.run_server(eng, reqs, log=lambda s: None, clock=clock, sleep=sleep)
    for r, want in zip(reqs, fx["engine_tokens"]):
        assert r.tokens == [int(t) for t in want if t >= 0]
    assert flash.launches > before[0] and rglru.launches > before[1]


XLSTM_GOLDEN = Path(__file__).resolve().parent / "data" / \
    "torch_xlstm_serve_golden" / "expected.npz"


@pytest.mark.gpu
def test_xlstm_golden_fixture_on_cuda(cuda):
    """The float32 xLSTM-125M twin of ``tests/data/torch_xlstm_serve_golden``
    (full width, 8 layers) on the card, through the mLSTM block kernel at
    dk 384: JAX's logits within ``golden.TOL`` and its greedy engine
    tokens, stamps and metrics exactly (tests/test_torch_xlstm.py makes
    the fixture)."""
    from repro_torch.serve import golden
    with np.load(XLSTM_GOLDEN, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    block = lambda: (mlstm.launches - mlstm.row_launches  # noqa: E731
                     - mlstm.parallel_launches)
    before = block()
    report = golden.replay(golden.XLSTM, fx, cuda)
    assert report["ok"], report
    assert block() > before


TRAIN_GOLDEN = Path(__file__).resolve().parent / "data" / \
    "torch_train_golden.npz"
# The train step on the card against the plain path on the CPU, float32,
# the same parameters and batches: cuBLAS and the kernels sum in other
# orders than the CPU, so the bounds of tests/test_torch_train.py's
# float32 twin against JAX.
TRAIN_TOL = dict(loss=1e-5, grad_norm=1e-4, update_rel=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("layers,accum,ce_chunk", [(3, 1, 0), (6, 2, 8)])
def test_train_step_on_cuda_matches_cpu(cuda, layers, accum, ce_chunk):
    """Three AdamW steps of the float32 RecurrentGemma twin through
    ``make_train_step`` on the card and on the CPU from the same
    parameters; under grad the forward launches each kernel (twice per
    block with remat)."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import leaves_with_paths, map_tree
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.golden import update_rel
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", tiny=True),
                              dtype="float32", num_layers=layers,
                              ce_chunk=ce_chunk)
    cpu = ts.init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    p0 = {"/".join(map(str, k)): t.numpy().copy()
          for k, t in leaves_with_paths(cpu.params)}
    gpu_p = map_tree(lambda _, t: t.to(cuda), cpu.params)
    gpu = ts.TrainState(gpu_p, init_opt_state(gpu_p))
    step = ts.make_train_step(cfg, OptimizerConfig(
        learning_rate=1e-2, warmup_steps=2, total_steps=10), accum=accum)
    data = SyntheticLM(cfg, DataConfig(batch_size=2, seq_len=32,
                                       accum=accum))
    attn_blocks, rnn_blocks = layers // 3, 2 * (layers // 3)
    for s in range(3):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
        cpu, mc = step(cpu, batch)
        before = (flash.launches, rglru.launches)
        gpu, mg = step(gpu, {k: v.to(cuda) for k, v in batch.items()})
        assert flash.launches - before[0] == 2 * attn_blocks * accum
        assert rglru.launches - before[1] == 2 * rnn_blocks * accum
        for k in ("loss", "grad_norm"):
            assert float(mg[k]) == pytest.approx(float(mc[k]),
                                                 rel=TRAIN_TOL[k])
        assert float(mg["lr"]) == float(mc["lr"])
    want = {"/".join(map(str, k)): t.numpy()
            for k, t in leaves_with_paths(cpu.params)}
    got = {"/".join(map(str, k)): t.cpu().numpy()
           for k, t in leaves_with_paths(gpu.params)}
    assert update_rel(p0, want, got) <= TRAIN_TOL["update_rel"]
    assert int(gpu.opt.step) == 3


@pytest.mark.gpu
def test_train_golden_fixture_on_cuda(cuda):
    """What chip_smoke.py's train_golden runs: JAX's 3 steps of the
    3-layer float32 twin (tests/test_torch_train.py makes the fixture),
    replayed on the card through both kernels."""
    from repro_torch.train import golden
    with np.load(TRAIN_GOLDEN, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    before = (flash.launches, rglru.launches)
    r = golden.replay(fx, cuda)
    assert flash.launches > before[0] and rglru.launches > before[1]
    assert max(r["worst_share_of_tol"].values()) <= 1.0


@pytest.mark.gpu
def test_trainer_and_forecaster_train_on_cuda(cuda, tmp_path):
    """``Trainer`` with a checkpoint and resume, and ``train_forecaster``
    with its mLSTM cell on the row kernel, on the card by default."""
    from repro_torch.configs import get_config
    from repro_torch.train.data import DataConfig
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", tiny=True),
                              num_layers=6, ce_chunk=8)

    def make():
        return Trainer(cfg, OptimizerConfig(learning_rate=1e-3,
                                            warmup_steps=2, total_steps=4),
                       DataConfig(batch_size=2, seq_len=32, accum=2),
                       TrainerConfig(total_steps=4, checkpoint_every=2,
                                     checkpoint_dir=str(tmp_path),
                                     log_every=1), log_fn=lambda s: None)

    tr = make()
    assert tr.state.params["embed"].device.type == "cuda"
    assert tr.run()["completed"] == 1.0
    back = make()
    assert back.step == 4 and torch.equal(back.state.params["embed"],
                                          tr.state.params["embed"])
    data = features.make_dataset(FAMILIES[:3], range(6),
                                 features.WindowConfig())
    before = mlstm.row_launches
    res = model.train_forecaster(data["X_train"], data["y_train"],
                                 window=features.WindowConfig(), steps=10,
                                 X_val=data["X_val"], y_val=data["y_val"])
    assert res.params["w_in"].device.type == "cuda"
    assert mlstm.row_launches - before == 11
    assert np.isfinite(res.losses).all() and np.isfinite(res.val_mse)


# The MoE layer on the card against the CPU plain path (float32: the same
# arithmetic, cuBLAS and the CPU sum in other orders): (arch, B, T,
# capacity_factor) at decode (T = 1), one group, two groups with
# overflow forced.
MOE_CASES = (("deepseek-moe-16b", 8, 1, 1.25),
             ("deepseek-moe-16b", 2, 100, 1.25),
             ("deepseek-moe-16b", 2, 1024, 0.5),
             ("granite-moe-1b-a400m", 1, 1024, 1.25))


@pytest.mark.gpu
@pytest.mark.parametrize("case", MOE_CASES)
def test_apply_moe_on_cuda_matches_cpu(cuda, case):
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import numpy_params, params_from_numpy
    name, B, T, cf = case
    cfg = dataclasses.replace(get_config(name, tiny=True), dtype="float32",
                              capacity_factor=cf)
    tree = numpy_params(moe.moe_specs(cfg), 0)
    x = np.random.default_rng(1).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    got = [moe.apply_moe(params_from_numpy(tree, dev),
                         torch.from_numpy(x).to(dev), cfg)
           for dev in (cuda, "cpu")]
    (gc, rc), (wc, rw) = got
    assert torch.equal(rc.gate_idx.cpu(), rw.gate_idx)
    assert torch.equal(rc.keep.cpu(), rw.keep)
    torch.testing.assert_close(gc.cpu(), wc, atol=1e-5, rtol=0)
    torch.testing.assert_close(moe.aux_loss(rc, cfg).cpu(),
                               moe.aux_loss(rw, cfg), atol=1e-5, rtol=0)


MOE_GOLDEN = Path(__file__).resolve().parent / "data" / \
    "torch_moe_serve_golden" / "expected.npz"


@pytest.mark.gpu
def test_moe_golden_fixture_on_cuda(cuda, monkeypatch):
    """The float32 DeepSeekMoE-16B twin of
    ``tests/data/torch_moe_serve_golden`` (full width, 3 layers) on the
    card, through the flash kernel: JAX's chosen experts exactly, its
    logits within ``golden.TOL``, its greedy engine tokens, stamps and
    metrics exactly (tests/test_torch_moe.py makes the fixture)."""
    from repro_torch.models import moe
    from repro_torch.serve import golden
    with np.load(MOE_GOLDEN, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    seen, route = [], moe.route

    def recording(p, xg, cfg):
        seen.append(route(p, xg, cfg))
        return seen[-1]
    monkeypatch.setattr(moe, "route", recording)
    before = flash.launches
    report = golden.replay(golden.MOE, fx, cuda)
    report.update(golden.routing_report(golden.MOE, fx, seen))
    assert report["ok"] and report["routing_equal"], report
    assert report["dropped_choices"] > 0
    assert flash.launches > before


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "granite-moe-1b-a400m"])
def test_moe_tiny_bf16_serves_on_cuda(cuda, name):
    """The bfloat16 twins on the card: prefill + 8 decode steps equal
    teacher forcing at a capacity nothing overflows (within 0.1 of the
    largest logit: bfloat16 in another order), and the engine serves
    through the flash kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import init_params
    from repro_torch.serve import engine as serve
    cfg = dataclasses.replace(get_config(name, tiny=True),
                              capacity_factor=8.0)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(tf.model_specs(cfg), g, cuda,
                         dtype=tf.serving_dtype(cfg))
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), device=cuda,
                           generator=g)
    full, _ = tf.forward_train(params, {"tokens": tokens}, cfg)
    lg, st = tf.prefill(params, {"tokens": tokens[:, :512]}, cfg, 600)
    rows = [lg]
    for i in range(512, 519):
        lg, st = tf.decode_step(params, tokens[:, i:i + 1], st, cfg)
        rows.append(lg)
    want = full[:, 511:519].float()
    err = (torch.stack(rows, 1).float() - want).abs().max()
    assert float(err) <= 0.1 * float(want.abs().max())
    before = flash.launches
    eng = serve.ServeEngine(cfg, params, serve.EngineConfig(
        num_slots=2, cache_len=64))
    reqs = [serve.Request(uid=i, prompt=np.arange(n) % cfg.vocab_size,
                          max_new_tokens=4) for i, n in enumerate((5, 33))]
    metrics = serve.run_server(eng, reqs, log=lambda s: None)
    assert metrics["tokens"] == 8
    assert flash.launches - before == 2 * cfg.num_layers


# The dense configs' TINY twins with the int8 cache (and Qwen's padded to
# 6 heads), on the card against the CPU: prefill + 8 decode steps.
DENSE_CASES = (("command-r-35b", {"kv_quant": True}),
               ("qwen1.5-32b", {"kv_quant": True, "pad_heads_to": 6}))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DENSE_CASES, ids=lambda c: c[0])
def test_quantised_decode_on_cuda_matches_cpu(cuda, case, dtype):
    """The int8 KV cache's decode on the card (the payload read in the
    activation dtype, float32 sums of bfloat16 products from ``bmm`` with
    ``out_dtype``) against the CPU on the same parameters: float32 logits
    within ``atol 1e-4, rtol 1e-3`` (cuBLAS and the CPU sum in other
    orders), bfloat16 within 2 % of their scale.  The payloads: in
    float32 within one quantisation step and the float16 scales within one
    ulp; in bfloat16, where k and v themselves carry the two devices'
    roundings, within 2 % of a row's largest value plus a rounding step on
    each side (0.02 x 127 + 1, so 3 steps) and the scales within 2 %.
    Prefill through the flash kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import numpy_params, params_from_numpy
    name, overrides = case
    cfg = dataclasses.replace(get_config(name, tiny=True), dtype=dtype,
                              **overrides)
    tree = numpy_params(tf.model_specs(cfg), 1)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 40)))
    runs = []
    for dev in (cuda, "cpu"):
        params = params_from_numpy(tree, dev, dtype=tf.serving_dtype(cfg))
        before = flash.launches
        lg, st = tf.prefill(params, {"tokens": tokens[:, :32].to(dev)}, cfg,
                            48)
        assert flash.launches - before == (cfg.num_layers if dev == cuda
                                           else 0)
        rows = [lg]
        for i in range(32, 40):
            lg, st = tf.decode_step(params, tokens[:, i:i + 1].to(dev), st,
                                    cfg)
            rows.append(lg)
        runs.append((torch.stack(rows).float().cpu(), st[0]["block0"]))
    (got, gst), (want, wst) = runs
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
    else:
        assert float((got - want).abs().max()) <= 2e-2 * float(
            want.abs().max())
    steps, scale_rtol = (1, 2.0 ** -10) if dtype == "float32" else \
        (int(0.02 * 127 + 1), 2e-2)
    for key in ("k", "v"):
        assert gst[key].dtype == torch.int8
        diff = (gst[key].cpu().int() - wst[key].int()).abs()
        assert int(diff.max()) <= steps, key
    for key in ("k_scale", "v_scale"):
        torch.testing.assert_close(gst[key].cpu().float(), wst[key].float(),
                                   rtol=scale_rtol, atol=0)


@pytest.mark.gpu
def test_float32_dot_of_bfloat16_on_cuda(cuda):
    """``layers._dot_f32`` on the card: bfloat16 operands, float32 sums
    and output, as the CPU's widened product (the same exact products)."""
    from repro_torch.models import layers
    rng = np.random.default_rng(3)
    a, b = (torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16)
            for s in ((8, 8, 4, 128), (8, 8, 128, 4096)))
    got = layers._dot_f32(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.float32 and got.shape == (8, 8, 4, 4096)
    torch.testing.assert_close(got.cpu(), a.float() @ b.float(), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.gpu
def test_piecewise_draw_peak_memory_on_cuda(cuda, monkeypatch):
    """A leaf above ``_INIT_PIECE`` values is drawn a run of leading rows
    at a time into the preallocated leaf: the draw's peak is the bfloat16
    leaf plus one float32 piece, where a whole draw would add the whole
    leaf in float32."""
    from repro_torch.models import params
    monkeypatch.setattr(params, "_INIT_PIECE", 1 << 24)
    spec = params.ParamSpec((64, 1 << 22), (None, None))
    gen = torch.Generator(device=cuda).manual_seed(0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaf = params.init_params({"w": spec}, gen, cuda,
                              dtype=torch.bfloat16)["w"]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    leaf_bytes, piece_bytes = 2 * (64 << 22), 4 * (1 << 24)
    assert leaf.dtype == torch.bfloat16 and leaf.shape == spec.shape
    assert peak <= leaf_bytes + 2 * piece_bytes, (peak, leaf_bytes)
    std = float(leaf.float().std())
    assert abs(std * math.sqrt(64) - 1.0) < 0.01



@pytest.mark.gpu
@pytest.mark.parametrize("name", ["WHISPER", "VLM", "SOFTCAP"])
def test_modality_golden_fixture_on_cuda(cuda, name):
    """The float32 Whisper-medium twin (2 + 2 layers, 1500 frames),
    InternVL2-26B twin (2 layers, 256 patches) and the Whisper twin with
    soft-capped logits of ``tests/data/torch_{whisper,vlm,softcap}_serve_
    golden`` on the card: JAX's logits within ``golden.TOL`` and its
    greedy engine tokens, stamps and metrics exactly, flash launched for
    every full-sequence attention of every prefill (Whisper: the
    encoder's, the decoder's and the cross attention's;
    tests/test_torch_whisper.py, test_torch_vlm.py and
    test_torch_softcap.py make the fixtures)."""
    from repro_torch.serve import golden
    fixture = getattr(golden, name)
    path = Path(__file__).resolve().parent / "data" / \
        f"torch_{name.lower()}_serve_golden" / "expected.npz"
    with np.load(path, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    before = flash.launches
    report = golden.replay(fixture, fx, cuda)
    assert report["ok"], report
    per_prefill = fixture.layers * (1 if name == "VLM" else 3)
    prefills = 1 + len(fixture.requests)
    assert flash.launches - before == per_prefill * prefills


# --------------------------------------------------------------------------- #
# the distributed layer on the card (NCCL, a world of 1)
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def nccl():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL has no CPU mode")
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    dev = init_distributed()
    assert dist.get_backend() == "nccl"
    yield dev
    dist.destroy_process_group()


def _tiny_f32(name="deepseek-7b"):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name, tiny=True), dtype="float32")


def _kernel_launches():
    return flash.launches + rglru.launches + mlstm.launches


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["deepseek-7b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "xlstm-125m"])
def test_sharded_train_step_on_cuda_matches_cpu(nccl, name):
    """A float32 TINY twin's step with its state distributed on a (1, 1)
    CUDA mesh under ``sharding_ctx`` (the kernels under ``local_map``,
    the MoE layer expert-parallel, the sLSTM's loop on local rows)
    against the plain step on the CPU, within the CUDA-vs-CPU train
    bounds; DeepSeek-7B launches flash twice a layer (remat)."""
    from repro_torch.distributed.sharding import (ShardingCtx,
                                                  distribute_tree, map_axes,
                                                  rules_for, sharding_ctx)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import leaves_with_paths
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.golden import update_rel
    from repro_torch.train.optimizer import OptimizerConfig
    cfg = _tiny_f32(name)
    cpu = ts.init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    p0 = {"/".join(map(str, k)): t.numpy().copy()
          for k, t in leaves_with_paths(cpu.params)}
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = ShardingCtx(mesh, rules_for(cfg))
    axes = ts.train_state_axes(cfg)
    gpu = distribute_tree(
        ctx, map_axes(lambda _, t: t.to(nccl), axes, cpu), axes)
    step = ts.make_train_step(cfg, OptimizerConfig(warmup_steps=1))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, DataConfig(batch_size=2, seq_len=32)).batch(0).items()}
    cpu, mc = step(cpu, batch)
    before = (flash.launches, _kernel_launches())
    with sharding_ctx(mesh, ctx.rules):
        gpu, mg = step(gpu, distribute_tree(
            ctx, {k: v.to(nccl) for k, v in batch.items()},
            ts.batch_axes(cfg)))
    assert _kernel_launches() > before[1]
    if name == "deepseek-7b":                     # remat: twice a layer
        assert flash.launches - before[0] == 2 * cfg.num_layers
    for k in ("loss", "grad_norm"):
        assert float(mg[k]) == pytest.approx(float(mc[k]), rel=TRAIN_TOL[k])
    want = {"/".join(map(str, k)): t.numpy()
            for k, t in leaves_with_paths(cpu.params)}
    got = {"/".join(map(str, k)): t.full_tensor().cpu().numpy()
           for k, t in leaves_with_paths(gpu.params)}
    assert update_rel(p0, want, got) <= TRAIN_TOL["update_rel"]


@pytest.mark.gpu
def test_psum_int8_on_nccl_equals_cpu(nccl):
    """On a world of one the compressed sum is the int8 round trip, the
    same numbers as the CPU computes."""
    from repro_torch.distributed.compression import psum_int8, quantize_int8
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (33, 65)).astype(np.float32) * 3)
    scale = torch.clamp_min(x.abs().amax(), 1e-30) / 127.0
    want = quantize_int8(x, scale).to(torch.int32).float() * scale
    assert torch.equal(psum_int8(x.to(nccl)).cpu(), want)


@pytest.mark.gpu
def test_restore_elastic_onto_cuda_mesh(nccl, tmp_path):
    from repro_torch.distributed.elastic import restore_elastic
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import (CheckpointManager,
                                              flatten_with_keys)
    cfg = _tiny_f32()
    state = ts.init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(7, state)
    restored, step, _ = restore_elastic(ckpt, cfg,
                                        make_mesh((1, 1), ("data", "model")))
    assert step == 7
    for (k, a), (_, b) in zip(flatten_with_keys(restored),
                              flatten_with_keys(state)):
        assert a.device.type == "cuda"
        assert torch.equal(a.full_tensor().cpu(), b), k


# --------------------------------------------------------------------------- #
# the kernels as registered ops; sharded decode on the card
# --------------------------------------------------------------------------- #

def _op_cases(dev):
    """(name, registered call, the direct CUDA call it replaced, inputs)
    per kernel op at a model path's shape."""
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)
    qkv = [rnd(1, 16, 512, 128) for _ in range(3)]
    ab = [torch.rand((1, 512, 4096), generator=g, device=dev),
          torch.randn((1, 512, 4096), generator=g, device=dev)]
    x = [rnd(1, 4, 256, 384) for _ in range(3)] + [rnd(1, 4, 256)
                                                   for _ in range(2)]
    return [
        ("flash", lambda q, k, v: flash.flash_attention(q, k, v),
         lambda q, k, v: flash._flash_attention_cuda(q, k, v, True, 0, None),
         qkv),
        ("rglru", lambda a, b: rglru.rglru_scan(a, b, bf),
         lambda a, b: rglru._rglru_scan_cuda(a, b, bf), ab),
        ("mlstm", lambda *x: mlstm.mlstm_chunkwise(*x),
         lambda *x: mlstm._mlstm_chunkwise_cuda(*x, None, 64, True), x),
    ]


def _flat_out(out):
    if isinstance(out, torch.Tensor):
        return [out]
    h, s = out
    return [h, *(s or ())]


@pytest.mark.gpu
def test_registered_ops_launch_their_kernels_as_before(cuda):
    """Each kernel op on CUDA tensors launches its kernel once (the
    counters move) and gives what the direct CUDA call gave before the
    ops were registered, bit for bit."""
    counters = {"flash": lambda: flash.launches,
                "rglru": lambda: rglru.launches,
                "mlstm": lambda: mlstm.parallel_launches}
    for name, op, direct, inputs in _op_cases(cuda):
        before = counters[name]()
        got = _flat_out(op(*inputs))
        assert counters[name]() == before + 1, name
        want = _flat_out(direct(*inputs))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name


KERNEL_OPS = {"flash": "flash_attention", "rglru": "rglru_scan",
              "mlstm": "mlstm_chunkwise"}


@pytest.mark.gpu
def test_fake_implementations_match_the_real_calls(cuda):
    """Each op's fake implementation gives the real call's output shapes
    and dtypes, and the scratch it allocates (counted by ``OpCounter``)
    is what the real call holds beside its outputs: the parallel mLSTM
    kernel's four buffers, nothing for flash and the RG-LRU scan.  The
    card's side is read from the allocator's requested bytes, which its
    block rounding and cached blocks do not change."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.op_analysis import OpCounter

    def requested(key):
        return torch.cuda.memory_stats()[f"requested_bytes.all.{key}"]

    for name, op, _, inputs in _op_cases(cuda):
        torch.cuda.synchronize()
        base = requested("current")
        torch.cuda.reset_peak_memory_stats()
        real = _flat_out(op(*inputs))
        torch.cuda.synchronize()
        held = requested("peak") - requested("current")
        outs = requested("current") - base
        with FakeTensorMode() as fm:
            fake_in = [fm.from_tensor(t) for t in inputs]
            counter = OpCounter()
            with counter:
                fake = _flat_out(op(*fake_in))
            scratch = []
            if name == "mlstm":
                scratch = [t.numel() * t.element_size() for t in
                           mlstm._parallel_scratch(1, 4, 256, 64, 384, 384,
                                                   cuda)]
        assert [(t.shape, t.dtype) for t in fake] == \
            [(t.shape, t.dtype) for t in real], name
        out_bytes = sum(t.numel() * t.element_size() for t in real)
        assert counter.peak - out_bytes == sum(scratch), name
        assert counter.kernel_calls == {KERNEL_OPS[name]: 1}, name
        assert held == sum(scratch), name
        assert outs == out_bytes, name
        del real, fake                  # before the next case's baseline


@pytest.mark.gpu
def test_sharded_decode_on_cuda_mesh_equals_plain(nccl):
    """A float32 TINY DeepSeek-7B's prefill and 4 greedy decode steps on
    a (1, 1) CUDA mesh under ``sharding_ctx`` (the cache written on each
    rank's shard) `==` the plain ones on the card."""
    from repro_torch.distributed.sharding import (ShardingCtx,
                                                  distribute_tree, rules_for,
                                                  sharding_ctx)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import init_params, param_axes
    cfg = _tiny_f32()
    params = init_params(tf.model_specs(cfg), torch.Generator(
        device=nccl).manual_seed(0), nccl)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=nccl,
                           generator=torch.Generator(
                               device=nccl).manual_seed(1),
                           dtype=torch.int32)
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = ShardingCtx(mesh, rules_for(cfg))

    def run(p, toks, wrap=lambda t: t, full=lambda t: t):
        logits, states = tf.prefill(p, {"tokens": wrap(toks)}, cfg, 32)
        out = []
        for _ in range(4):
            out.append(full(logits))
            nxt = torch.argmax(out[-1][:, :cfg.vocab_size], -1)
            logits, states = tf.decode_step(
                p, wrap(nxt[:, None].to(torch.int32)), states, cfg)
        return torch.stack(out + [full(logits)])

    with torch.no_grad():
        want = run(params, tokens)
        sh = distribute_tree(ctx, params, param_axes(tf.model_specs(cfg)))
        with sharding_ctx(mesh, ctx.rules):
            got = run(sh, tokens,
                      wrap=lambda t: distribute_tree(ctx, t,
                                                     ("act_batch", None)),
                      full=lambda t: t.full_tensor())
    assert torch.equal(got, want)
