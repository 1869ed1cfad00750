"""PyTorch port, lane engine edges: mixed, padded and degenerate batches.

Lanes of different sizes and fleets in one batch, an all-infeasible lane
beside a feasible one, a zero-pod lane, and lane counts that are not
powers of two: each batch's outputs from ``run_lane_batch(device="cpu")``
equal the JAX lane program's bit for bit (``tests/test_torch_lanes.py``
holds the shared helpers and the per-scheduler cases).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.manyworld import lanes as ref_lanes
from repro.search.runner import _get_trace

from repro_torch.manyworld import lanes as port_lanes
from test_torch_lanes import (ALLOC_CPU, ALLOC_MEM, _assert_same, _jax_run,
                              _lane_of, _port_run)


def test_mixed_batch_equals_jax_and_solo_lanes():
    specs = [(0, 40, 4), (1, 40, 2), (2, 24, 3), (3, 40, 1), (4, 32, 5)]
    lanes = [_lane_of(_get_trace("heavy-tail", s, nj), nw)
             for s, nj, nw in specs]
    out = _port_run(ref_lanes.stack_lanes(lanes, "best-fit"))
    _assert_same(out, _jax_run(ref_lanes.stack_lanes(lanes, "best-fit")))
    for li, lane in enumerate(lanes):
        solo = _port_run(ref_lanes.stack_lanes([lane], "best-fit", p_pad=64))
        p = lane["arrival_t"].size
        for key in ("bound", "bind_node", "bind_seq", "bind_cycle", "done_t"):
            assert np.array_equal(out[key][li, :p], solo[key][0, :p]), key
        assert out["done_time"][li] == solo["done_time"][0]


def test_all_infeasible_lane_beside_feasible_one():
    big = {"arrival_t": np.array([0.0, 5.0]),
           "cpu_m": np.array([2000.0, 2000.0]),       # > 940 alloc
           "mem_mb": np.array([100.0, 100.0]),
           "duration_s": np.array([60.0, 60.0]),
           "is_batch": np.array([True, True]),
           "n_nodes": 3, "alloc_cpu": ALLOC_CPU, "alloc_mem": ALLOC_MEM}
    ok = _lane_of(_get_trace("heavy-tail", 0, 24), 3)
    batch = ref_lanes.stack_lanes([big, ok], "best-fit")
    out = _port_run(batch)
    _assert_same(out, _jax_run(batch))
    assert not out["bound"][0].any() and not out["completed"][0]
    assert int(out["scale_outs"][0]) >= 2


def test_zero_pod_lane_beside_real_lane():
    empty = _lane_of(_get_trace("heavy-tail", 0, 0), 2)
    real = _lane_of(_get_trace("heavy-tail", 0, 24), 2)
    batch = ref_lanes.stack_lanes([empty, real], "best-fit")
    out = _port_run(batch)
    _assert_same(out, _jax_run(batch))
    assert not out["completed"][0] and out["done_time"][0] == port_lanes.HORIZON_S


@pytest.mark.parametrize("count", (3, 5))
def test_non_pow2_lane_counts(count):
    lanes = [_lane_of(_get_trace("heavy-tail", s, 24), 2) for s in range(count)]
    batch = ref_lanes.stack_lanes(lanes, "best-fit")
    _assert_same(_port_run(batch), _jax_run(batch))


def test_host_syncs_are_counted():
    batch = ref_lanes.stack_lanes(
        [_lane_of(_get_trace("heavy-tail", 1, 24), 2)], "best-fit")
    port_lanes.host_syncs = 0
    out = _port_run(batch)
    # at least one sync per cycle condition, completion loop and wave loop
    assert port_lanes.host_syncs >= 3 * int(out["n_cycles"])
