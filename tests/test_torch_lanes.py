"""PyTorch port, lane engine: ``repro_torch.manyworld.lanes`` against the
JAX lane program and the serial engine, on the CPU.

Every output of ``run_lane_batch(device="cpu")`` must equal the JAX
program's (called as ``lanes._jit_cache(...)`` under
``jax.enable_x64(True)``) with ``np.array_equal``, dtypes included, and
its bind columns must equal the serial array engine's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.cloud.adapter import M2_SMALL
from repro.core import build_simulation, reset_id_counters
from repro.manyworld import lanes as ref_lanes
from repro.search.runner import CellSpec, _get_trace

from repro_torch.manyworld import lanes as port_lanes

ALLOC_CPU = float(M2_SMALL.allocatable.cpu_m)
ALLOC_MEM = float(M2_SMALL.allocatable.mem_mb)
INPUTS = ("arrival_t", "cpu_m", "mem_mb", "duration_s", "is_batch", "valid",
          "n_nodes", "alloc_cpu", "alloc_mem", "weights")

# The reference suite's lane cases (tests/test_manyworld.py CASES) without
# capacity-crunch, a chaos family the port does not have yet.
CASES = [
    ("heavy-tail", "best-fit", 4),
    ("heavy-tail", "worst-fit", 1),
    ("heavy-tail", "first-fit", 3),
    ("heavy-tail", "k8s-default", 4),
    ("heavy-tail", "weighted", 12),
    ("diurnal", "k8s-default", 3),
    ("mix-ramp", "worst-fit", 12),
]


def _lane_of(trace, n_nodes, weights=None):
    d = trace.to_lane_arrays()
    d.update(n_nodes=n_nodes, alloc_cpu=ALLOC_CPU, alloc_mem=ALLOC_MEM,
             weights=weights)
    return d


def _jax_run(batch, backend="jnp"):
    with jax.enable_x64(True):
        import jax.numpy as jnp
        run = ref_lanes._jit_cache(batch.scheduler, backend, batch.n_pad)
        out = run(*[jnp.asarray(getattr(batch, name)) for name in INPUTS])
        return {key: np.asarray(v) for key, v in out.items()}


def _port_run(batch):
    return port_lanes.run_lane_batch(
        port_lanes.lane_batch_from_numpy(batch, device="cpu"), device="cpu")


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key


def _serial_bind_columns(cell, trace):
    """(result, bound, rank, bind_t) from a serial array-engine run, node
    slots mapped through ``id_rank`` into the lane engine's rank space."""
    reset_id_counters()
    sim = build_simulation(cell.to_experiment_spec(trace))
    res = sim.run()
    store, arr = sim.orch.store, sim.orch.cluster.arrays
    n = trace.n
    bound = np.array([store.node_slot[i] >= 0 for i in range(n)])
    rank = np.array([arr.id_rank[store.node_slot[i]]
                     if store.node_slot[i] >= 0 else -1 for i in range(n)])
    bind_t = np.array([store.bound_time[i] if store.bound_time[i] is not None
                       else np.nan for i in range(n)])
    return res, bound, rank, bind_t


@pytest.mark.parametrize("scen,sched,nw", CASES)
def test_outputs_equal_jax_and_binds_equal_serial(scen, sched, nw):
    trace = _get_trace(scen, 0, 40)
    weights = (0.2, 0.5, 0.3) if sched == "weighted" else None
    batch = ref_lanes.stack_lanes([_lane_of(trace, nw, weights)], sched)
    out = _port_run(batch)
    _assert_same(out, _jax_run(batch))

    cell = CellSpec(scenario=scen, scheduler=sched, autoscaler="void",
                    rescheduler="void", seed=0, n_jobs=40, engine="array",
                    initial_workers=nw, scheduler_weights=weights)
    res, bound_s, rank_s, bt_s = _serial_bind_columns(cell, trace)
    n = trace.n
    bl = out["bound"][0, :n]
    assert np.array_equal(bound_s, bl)
    assert np.array_equal(rank_s[bl], out["bind_node"][0, :n][bl])
    assert np.array_equal(bt_s[bl], out["bind_cycle"][0, :n][bl] * 10.0)
    assert res.completed == bool(out["completed"][0])
    assert res.scale_outs == int(out["scale_outs"][0])
    seq = out["bind_seq"][0, :n]
    lane_order = sorted(np.nonzero(bl)[0], key=lambda i: seq[i])
    serial_order = sorted(np.nonzero(bound_s)[0], key=lambda i: (bt_s[i], i))
    assert lane_order == serial_order


def test_pallas_select_reference_agrees():
    """One case against the JAX program with the Pallas kernel itself
    (interpret mode) as its select."""
    batch = ref_lanes.stack_lanes(
        [_lane_of(_get_trace("heavy-tail", 0, 40), 4)], "best-fit")
    _assert_same(_port_run(batch), _jax_run(batch, "pallas"))


@pytest.mark.parametrize("sched,weights", [
    ("best-fit", None), ("worst-fit", None), ("first-fit", None),
    ("k8s-default", None), ("weighted", (0.2, 0.5, 0.3))])
def test_wave_scores_match_numpy_bits(sched, weights):
    rng = np.random.default_rng(3)
    free_cpu = rng.integers(0, 941, (8, 6)).astype(np.float64)
    free_mem = rng.random((8, 6)) * 3584.0
    pc, pm = 250.0, 433.3
    w = np.tile(np.array(weights or (1.0, 0.0, 0.0)), (8, 1))
    got = port_lanes._wave_scores(
        sched, torch.from_numpy(free_cpu), torch.from_numpy(free_mem),
        torch.full((8, 1), 940.0, dtype=torch.float64),
        torch.full((8, 1), 3584.0, dtype=torch.float64),
        torch.full((8, 1), pc, dtype=torch.float64),
        torch.full((8, 1), pm, dtype=torch.float64),
        torch.from_numpy(w)).numpy()
    if sched == "best-fit":
        ref = -free_mem
    elif sched == "worst-fit":
        ref = free_mem
    elif sched == "first-fit":
        ref = np.zeros_like(free_mem)
    else:
        cpu_frac = (free_cpu - pc) / np.maximum(940.0, 1)
        mem_frac = (free_mem - pm) / np.maximum(3584.0, 1e-9)
        lr = 10.0 * (cpu_frac + mem_frac) / 2.0
        bal = 10.0 * (1.0 - np.abs(cpu_frac - mem_frac))
        if sched == "k8s-default":
            ref = (lr + bal) / 2.0
        else:
            pack = 10.0 * (1.0 - mem_frac)
            ref = (w[:, 0:1] * pack + w[:, 1:2] * lr) + w[:, 2:3] * bal
    assert np.array_equal(got, -ref)       # lane scores are negated


def test_stack_lanes_matches_reference_and_validates():
    lanes = [_lane_of(_get_trace("mix-ramp", s, 24), 3 + s, (0.2, 0.5, 0.3))
             for s in range(3)]
    ref = ref_lanes.stack_lanes(lanes, "weighted")
    got = port_lanes.stack_lanes(lanes, "weighted", device="cpu")
    assert got.n_pad == ref.n_pad and got.p_pad == ref.p_pad
    for name in INPUTS:
        assert np.array_equal(getattr(got, name).numpy(), getattr(ref, name))
    with pytest.raises(ValueError, match="p_pad"):
        port_lanes.stack_lanes(lanes, "best-fit", p_pad=16, device="cpu")
    with pytest.raises(ValueError, match="scheduler"):
        port_lanes.stack_lanes(lanes, "round-robin", device="cpu")
    assert [port_lanes.next_pow2(n) for n in (0, 1, 2, 3, 40, 64, 65)] \
        == [1, 1, 2, 4, 64, 64, 128]
