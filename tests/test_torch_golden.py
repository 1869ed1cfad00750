"""Golden lane fixture for the PyTorch port: ``tests/data/torch_lane_golden.npz``.

For each of the five lane schedulers the fixture holds one 16-lane batch
— its ten input columns and every output of the JAX lane program (run
with the reference's ``jnp`` select) — plus each lane's recipe
``(scenario, seed, n_jobs)``.  ``chip_smoke.py`` holds the port's output
on the card to it, and rebuilds its input columns from the recipes with
the port's own generators, without importing JAX.  The test here
recomputes the fixture with the JAX reference and requires it to equal
the committed file, and runs the port on the CPU over the fixture's
cheaper lanes.

Regenerate after an intentional change::

    PYTHONPATH=src python tests/test_torch_golden.py --regen
"""
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.cloud.adapter import NODE_TEMPLATES
from repro.manyworld import lanes as ref_lanes
from repro.search.runner import _get_trace

from repro_torch.manyworld import lanes as port_lanes

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_lane_golden.npz")

# (scenario, seed, n_jobs, n_nodes, node template or (alloc_cpu, alloc_mem)).
# Heavy-tail lanes queue behind small fleets; service-bearing lanes run on
# larger templates so their blocked services stay few; lane 14 has no pods
# and lane 15 fits nowhere (every pod asks for more CPU than a node has).
LANES = (
    ("heavy-tail", 0, 200, 24, "m2.small"),
    ("heavy-tail", 1, 200, 3, "m2.medium"),
    ("heavy-tail", 1, 200, 12, "m2.tiny"),
    ("heavy-tail", 1, 200, 8, "m2.small"),
    ("diurnal", 0, 200, 12, "tpu-v5e-host"),
    ("diurnal", 1, 200, 12, "tpu-v5e-host"),
    ("mix-ramp", 0, 200, 24, "m2.small"),
    ("mix-ramp", 0, 200, 16, "m2.medium"),
    ("mix-ramp", 1, 200, 6, "tpu-v5e-host"),
    ("flash-crowd", 1, 200, 24, "m2.medium"),
    ("heavy-tail", 0, 200, 16, "m2.small"),
    ("mix-ramp", 0, 200, 6, "tpu-v5e-host"),
    ("heavy-tail", 1, 200, 24, "m2.small"),
    ("flash-crowd", 1, 200, 24, "tpu-v5e-host"),
    ("heavy-tail", 0, 0, 3, "m2.small"),
    ("heavy-tail", 2, 200, 4, (50.0, 3584.0)),
)
# Non-default weights for the weighted batch, one per lane in turn.
WEIGHTS = ((0.2, 0.5, 0.3), (0.6, 0.1, 0.3), (0.0, 1.0, 0.0),
           (1 / 3, 1 / 3, 1 / 3), (0.5, 0.0, 0.5), (0.05, 0.05, 0.9))
INPUTS = ("arrival_t", "cpu_m", "mem_mb", "duration_s", "is_batch", "valid",
          "n_nodes", "alloc_cpu", "alloc_mem", "weights")
# Lanes cheap enough for the port's CPU run here (the card runs them all).
CPU_LANES = (0, 4, 5, 13, 14, 15)


def _lane(i: int, sched: str) -> dict:
    scen, seed, n_jobs, n_nodes, tmpl = LANES[i]
    if isinstance(tmpl, str):
        alloc = NODE_TEMPLATES[tmpl].allocatable
        alloc_cpu, alloc_mem = float(alloc.cpu_m), float(alloc.mem_mb)
    else:
        alloc_cpu, alloc_mem = tmpl
    d = _get_trace(scen, seed, n_jobs).to_lane_arrays()
    d.update(n_nodes=n_nodes, alloc_cpu=alloc_cpu, alloc_mem=alloc_mem,
             weights=WEIGHTS[i % len(WEIGHTS)] if sched == "weighted"
             else None)
    return d


def reference_batch(sched: str, lanes=None):
    lanes = range(len(LANES)) if lanes is None else lanes
    return ref_lanes.stack_lanes([_lane(i, sched) for i in lanes], sched,
                                 p_pad=256)


def reference_outputs(batch) -> dict:
    """The JAX lane program's outputs (``jnp`` select), called through
    ``_jit_cache`` under ``jax.enable_x64``."""
    with jax.enable_x64(True):
        import jax.numpy as jnp
        run = ref_lanes._jit_cache(batch.scheduler, "jnp", batch.n_pad)
        out = run(*[jnp.asarray(getattr(batch, name)) for name in INPUTS])
        return {key: np.asarray(v) for key, v in out.items()}


def build_fixture() -> dict:
    arrays = {
        "lane_scenario": np.array([lane[0] for lane in LANES]),
        "lane_seed": np.array([lane[1] for lane in LANES], np.int64),
        "lane_n_jobs": np.array([lane[2] for lane in LANES], np.int64),
    }
    for sched in ref_lanes.SCHEDULERS:
        batch = reference_batch(sched)
        for name in INPUTS:
            arrays[f"{sched}/in/{name}"] = getattr(batch, name)
        for key, val in reference_outputs(batch).items():
            arrays[f"{sched}/out/{key}"] = val
    return arrays


@pytest.fixture(scope="module")
def committed():
    with np.load(FIXTURE, allow_pickle=False) as z:
        return {key: z[key] for key in z.files}


@pytest.mark.parametrize("sched", ref_lanes.SCHEDULERS)
def test_fixture_matches_jax_reference(committed, sched):
    """The committed fixture is what the JAX lane program computes now."""
    batch = reference_batch(sched)
    for name in INPUTS:
        got = getattr(batch, name)
        want = committed[f"{sched}/in/{name}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    out = reference_outputs(batch)
    keys = {k.split("/", 2)[2] for k in committed
            if k.startswith(f"{sched}/out/")}
    assert keys == set(out)
    for key, val in out.items():
        want = committed[f"{sched}/out/{key}"]
        assert val.dtype == want.dtype and np.array_equal(val, want), key


@pytest.mark.parametrize("sched", ref_lanes.SCHEDULERS)
def test_port_reproduces_fixture_lanes_on_cpu(committed, sched):
    """The port, fed the fixture's own input rows of its cheaper lanes,
    reproduces those lanes' outputs bit for bit (lanes are independent,
    so a sub-batch gives each lane the outputs it had in the full one)."""
    sub = list(CPU_LANES)

    class Rows:
        scheduler = sched
    for name in INPUTS:
        setattr(Rows, name, committed[f"{sched}/in/{name}"][sub])
    got = port_lanes.run_lane_batch(
        port_lanes.lane_batch_from_numpy(Rows, device="cpu"), device="cpu")
    for key, val in got.items():
        if key == "n_cycles":
            continue
        want = committed[f"{sched}/out/{key}"][sub]
        if key in ("used_cpu", "used_mem", "pcount"):
            want = want[:, :val.shape[1]]       # sub-batch node pad
            assert not committed[f"{sched}/out/{key}"][sub][
                :, val.shape[1]:].any()
        assert val.dtype == want.dtype and np.array_equal(val, want), key


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_golden.py --regen")
    np.savez_compressed(FIXTURE, **build_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
