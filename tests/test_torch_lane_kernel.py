"""PyTorch port, the lane-program kernel's algorithm on the CPU.

``lane_kernel.lane_program_plain`` is the algorithm of the CUDA kernel
``repro_torch/manyworld/csrc/lane_program.cu`` in NumPy, one lane at a time
(per-lane counters, the wave's row pointer and early stop, the running-pod
list, ``n_cycles`` as the most cycles any lane ran).  Its outputs must equal
the lockstep program's (``run_lane_batch_lockstep(device="cpu")``) and the
JAX program's (``lanes._jit_cache`` under ``jax.enable_x64(True)``) with
``np.array_equal``, dtypes included, ``n_cycles`` too.  The kernel itself
needs a card: ``tests/test_torch_gpu.py`` holds it to the lockstep program
there; here only its wrapper's checks run, which raise before any build.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.manyworld import lanes as ref_lanes
from repro.search.runner import _get_trace

from repro_torch.manyworld import evaluator, lane_kernel
from repro_torch.manyworld import lanes as port_lanes
from repro_torch.search.runner import CellSpec
from test_torch_golden import CPU_LANES, FIXTURE
from test_torch_lanes import (ALLOC_CPU, ALLOC_MEM, INPUTS, _assert_same,
                              _jax_run, _lane_of)


def _on_cpu(batch):
    return port_lanes.lane_batch_from_numpy(batch, device="cpu")


def _plain(batch):
    return lane_kernel.lane_outputs(
        lane_kernel.lane_program_plain(_on_cpu(batch)))


def _lockstep(batch):
    return port_lanes.run_lane_batch_lockstep(_on_cpu(batch), device="cpu")


def _all_three_equal(batch):
    """plain == lockstep == JAX on ``batch`` (a reference LaneBatch)."""
    out = _plain(batch)
    _assert_same(out, _lockstep(batch))
    _assert_same(out, _jax_run(batch))
    return out


def _pods(arrival, cpu, mem, dur, is_batch, n_nodes=2):
    return {"arrival_t": np.asarray(arrival, float),
            "cpu_m": np.asarray(cpu, float), "mem_mb": np.asarray(mem, float),
            "duration_s": np.asarray(dur, float),
            "is_batch": np.asarray(is_batch, bool), "n_nodes": n_nodes,
            "alloc_cpu": ALLOC_CPU, "alloc_mem": ALLOC_MEM}


@pytest.mark.parametrize("sched", port_lanes.SCHEDULERS)
def test_plain_equals_lockstep_and_jax(sched):
    weights = (0.6, 0.1, 0.3) if sched == "weighted" else None
    lanes = [_lane_of(_get_trace("heavy-tail", 0, 40), 4, weights),
             _lane_of(_get_trace("mix-ramp", 1, 40), 2, weights),
             _lane_of(_get_trace("diurnal", 2, 24), 3, weights)]
    _all_three_equal(ref_lanes.stack_lanes(lanes, sched))


@pytest.mark.parametrize("sched", port_lanes.SCHEDULERS)
def test_plain_reproduces_golden_fixture(sched):
    """All 16 lanes of the fixture's batch (JAX's outputs, which
    ``tests/test_torch_golden.py`` recomputes), and the lockstep program on
    its cheaper lanes."""
    with np.load(FIXTURE, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files if key.startswith(f"{sched}/")}

    def rows(sub):
        batch = type("Rows", (), {"scheduler": sched})
        for name in INPUTS:
            setattr(batch, name, fx[f"{sched}/in/{name}"][sub])
        return batch

    out = _plain(rows(slice(None)))
    want = {key.split("/", 2)[2]: val for key, val in fx.items()
            if key.startswith(f"{sched}/out/")}
    _assert_same(out, want)
    sub = list(CPU_LANES)
    _assert_same(_plain(rows(sub)), _lockstep(rows(sub)))


def test_infeasible_and_zero_pod_lanes():
    big = _pods([0.0, 5.0], [2000.0, 2000.0], [100.0, 100.0], [60.0, 60.0],
                [True, True], n_nodes=3)             # > 940 m CPU a node
    ok = _lane_of(_get_trace("heavy-tail", 0, 24), 3)
    empty = _lane_of(_get_trace("heavy-tail", 0, 0), 2)
    out = _all_three_equal(ref_lanes.stack_lanes([big, ok, empty],
                                                 "best-fit"))
    assert not out["bound"][0].any() and not out["completed"][0]
    assert out["completed"][1]
    assert not out["completed"][2]
    assert out["done_time"][2] == port_lanes.HORIZON_S


@pytest.mark.parametrize("count", (3, 5))
def test_non_pow2_lane_counts(count):
    lanes = [_lane_of(_get_trace("heavy-tail", s, 24), 2)
             for s in range(count)]
    _all_three_equal(ref_lanes.stack_lanes(lanes, "k8s-default"))


def test_stuck_and_horizon_lanes_beside_short_ones():
    """A lane stuck at cycle 3 (its second pod fits nowhere; the first
    completes at t = 30), a lane whose batch pod outlasts the 48 h horizon
    (it runs MAX_CYCLES + 1 cycles, the cycle at t == 48 h included), and
    two ordinary lanes that finish early.  The quiescent check cannot
    fire for a lane that starts active (all arrived with nothing pending
    and nothing running means every row is bound and every batch row
    committed, so the done check fires first); the zero-pod lane of
    ``test_infeasible_and_zero_pod_lanes`` is the lane the lockstep
    program's comment calls quiescent, inactive from the start."""
    stuck = _pods([0.0, 5.0], [200.0, 2000.0], [100.0, 100.0],
                  [30.0, 60.0], [True, True])
    long = _pods([0.0, 0.0], [100.0, 100.0], [100.0, 100.0],
                 [300.0, 200000.0], [True, True])
    short = [_lane_of(_get_trace("heavy-tail", s, 24), 2) for s in (0, 1)]
    out = _all_three_equal(ref_lanes.stack_lanes([stuck, long] + short,
                                                 "best-fit"))
    res = lane_kernel.lane_program_plain(
        _on_cpu(ref_lanes.stack_lanes([stuck, long] + short, "best-fit")))
    cycles = res["lane_stats"][:, 0].tolist()
    assert cycles[0] == 4 and not out["completed"][0]
    assert cycles[1] == port_lanes.MAX_CYCLES + 1 and not out["completed"][1]
    assert max(cycles[2:]) < 1000 and out["completed"][2:].all()
    assert int(out["n_cycles"]) == port_lanes.MAX_CYCLES + 1


def test_unsorted_and_gapped_rows():
    """Rows out of arrival order, and valid rows that are not a prefix:
    the wave walks every row (no early stop)."""
    rng = np.random.default_rng(0)
    d = _lane_of(_get_trace("mix-ramp", 0, 40), 3)
    perm = rng.permutation(d["arrival_t"].size)
    shuffled = dict(d, **{key: d[key][perm] for key in
                          ("arrival_t", "cpu_m", "mem_mb", "duration_s",
                           "is_batch")})
    lanes = [shuffled, _lane_of(_get_trace("heavy-tail", 1, 24), 2)]
    batch = ref_lanes.stack_lanes(lanes, "worst-fit")
    batch.valid[1, 3] = False                        # a hole in lane 1
    batch.arrival_t[1, 3] = np.inf
    _all_three_equal(batch)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    batch = port_lanes.stack_lanes(
        [_lane_of(_get_trace("heavy-tail", 0, 8), 2)], "best-fit",
        device="cpu")
    before = lane_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        lane_kernel.lane_program(batch)
    with pytest.raises(TypeError, match="arrival_t"):
        lane_kernel.lane_program(dataclasses.replace(
            batch, arrival_t=batch.arrival_t.float()))
    with pytest.raises(ValueError, match="8192"):
        lane_kernel.lane_program(dataclasses.replace(batch, n_pad=16384))
    assert lane_kernel.launches == before


def test_run_cells_lanes_records_its_stages():
    cells = [CellSpec(scenario="heavy-tail", scheduler="best-fit",
                      autoscaler="void", rescheduler="void", seed=s,
                      n_jobs=16, initial_workers=2) for s in range(2)]
    rows = evaluator.run_cells_lanes(cells, device="cpu")
    assert len(rows) == 2
    assert set(evaluator.stage_s) == {"prepare_s", "serial_s",
                                      "stack_upload_s", "lane_program_s",
                                      "download_s", "host_replay_s"}
    assert all(v >= 0.0 for v in evaluator.stage_s.values())
    assert evaluator.stage_s["lane_program_s"] > 0.0
    assert evaluator.stage_s["serial_s"] == 0.0   # every cell a lane
