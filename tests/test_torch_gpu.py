"""PyTorch port on the card: the CUDA kernel and the lane engine on CUDA.

Every test here is marked ``gpu`` and skips itself without a CUDA card
(the kernel has no CPU mode).  On the card::

    python -m pytest -q -m gpu tests/test_torch_gpu.py

The file imports only torch, numpy and the port, so it runs where JAX is
not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.manyworld import lanes, select
from repro_torch.search.runner import CellSpec, _get_trace, run_cells


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
    before = select.launches
    on_gpu = lanes.run_lane_batch(
        lanes.stack_lanes(lane_dicts, sched, device=cuda), device=cuda)
    assert select.launches > before
    on_cpu = lanes.run_lane_batch(
        lanes.stack_lanes(lane_dicts, sched, device="cpu"), device="cpu")
    for key in on_cpu:
        assert on_gpu[key].dtype == on_cpu[key].dtype, key
        assert np.array_equal(on_gpu[key], on_cpu[key]), key


@pytest.mark.gpu
def test_rows_on_cuda_equal_cpu(cuda):
    cells = [CellSpec(scenario=s, scheduler="k8s-default", autoscaler="void",
                      rescheduler="void", seed=seed, n_jobs=40,
                      initial_workers=3)
             for s in ("heavy-tail", "diurnal") for seed in range(2)]
    on_gpu = run_cells(cells)                 # device=None is the card
    on_cpu = run_cells(cells, device="cpu")
    for g, c in zip(on_gpu, on_cpu):
        g.pop("wall_s"), c.pop("wall_s")
        assert g == c
