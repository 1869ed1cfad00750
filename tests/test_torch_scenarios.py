"""PyTorch port, data layer: the port's own copies of the job types, node
templates, scenario generators and cell spec equal the reference's.

The lane engine's bit-parity starts here: the port draws its traces with
the same numpy calls in the same order as ``repro.scenarios``, so every
lane column must be identical, not close.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.cloud import adapter as ref_adapter
from repro.core import workload as ref_workload
from repro.scenarios import build_scenario as ref_build
from repro.search import runner as ref_runner

from repro_torch.cloud import adapter as port_adapter
from repro_torch.core import workload as port_workload
from repro_torch.scenarios import build_scenario as port_build
from repro_torch.search import runner as port_runner

FAMILIES = ("heavy-tail", "diurnal", "flash-crowd", "mix-ramp",
            "scale-stress", "multi-tenant")
COLUMNS = ("arrival_time", "template_id", "cpu_m", "mem_mb", "duration_s",
           "kind", "moveable", "checkpointable")


@pytest.mark.parametrize("n_jobs", (0, 24, 40, 2000))
@pytest.mark.parametrize("scenario", FAMILIES)
def test_lane_arrays_bit_identical(scenario, n_jobs):
    for seed in range(4):
        try:
            want = ref_build(scenario, seed=seed, n_jobs=n_jobs)
        except IndexError:
            # diurnal / flash-crowd / scale-stress (and multi-tenant, whose
            # trio holds a diurnal tenant) cannot build an empty trace; the
            # port fails the same way.
            with pytest.raises(IndexError):
                port_build(scenario, seed=seed, n_jobs=n_jobs)
            continue
        got = port_build(scenario, seed=seed, n_jobs=n_jobs)
        assert got.n == want.n == n_jobs
        a, b = got.to_lane_arrays(), want.to_lane_arrays()
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            assert np.array_equal(a[key], b[key]), (scenario, seed, key)
        for col in COLUMNS:
            assert np.array_equal(getattr(got, col), getattr(want, col)), col


@pytest.mark.parametrize("workload", ("bursty", "slow", "mixed"))
def test_paper_workloads_bit_identical(workload):
    """``paper-*``: ``generate_workload`` columnarized by
    ``TraceStore.from_arrivals``; ``n_jobs`` is ignored (Table 2 fixes 50
    jobs), and the arrivals round-trip."""
    for seed in range(3):
        want = ref_build(f"paper-{workload}", seed=seed, n_jobs=7)
        got = port_build(f"paper-{workload}", seed=seed, n_jobs=7)
        assert got.n == want.n == 50 and got.name == want.name
        a, b = got.to_lane_arrays(), want.to_lane_arrays()
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            assert np.array_equal(a[key], b[key]), (workload, seed, key)
        for col in COLUMNS:
            assert np.array_equal(getattr(got, col), getattr(want, col)), col
        assert got.count_kinds() == want.count_kinds()
        arrivals = port_workload.generate_workload(workload, seed=seed)
        assert [(a.time, a.spec) for a in got.to_arrivals()] == \
            [(a.time, a.spec) for a in arrivals]
        assert [a.time for a in arrivals] == [
            a.time for a in ref_workload.generate_workload(workload, seed)]


def test_default_sizes_and_slice():
    got, want = port_build("heavy-tail", seed=5), ref_build("heavy-tail", seed=5)
    assert got.n == want.n == 2000
    part = got.slice(10, 30)
    assert np.array_equal(part.to_lane_arrays()["arrival_t"],
                          want.slice(10, 30).to_lane_arrays()["arrival_t"])
    assert got.slice(0, 0).n == 0


def test_unported_scenarios_raise_keyerror():
    """The chaos families, once refused, build the reference's traces;
    an unknown name still raises ``KeyError``."""
    for name in ("spot-spike", "zone-outage", "capacity-crunch"):
        want, got = ref_build(name, seed=1), port_build(name, seed=1)
        assert got.name == want.name and got.n == want.n
        for col in COLUMNS:
            assert np.array_equal(getattr(got, col), getattr(want, col)), col
    with pytest.raises(KeyError, match="unknown scenario"):
        port_build("no-such-family")


def test_job_types_and_mixes_equal():
    assert port_workload.WORKLOAD_MIXES == ref_workload.WORKLOAD_MIXES
    assert port_workload.JOB_TYPES.keys() == ref_workload.JOB_TYPES.keys()
    for name, ref in ref_workload.JOB_TYPES.items():
        got = port_workload.JOB_TYPES[name]
        assert got.type_name == ref.type_name
        assert got.kind.value == ref.kind.value
        assert got.moveable == ref.moveable
        assert got.checkpointable == ref.checkpointable
        assert got.requests.cpu_m == ref.requests.cpu_m
        assert got.requests.mem_mb == ref.requests.mem_mb
        assert got.duration_s == ref.duration_s
    for mix in ref_workload.WORKLOAD_MIXES:
        assert (port_workload.mix_templates(mix)[1]
                == ref_workload.mix_templates(mix)[1])


def test_node_templates_equal():
    assert port_adapter.NODE_TEMPLATES.keys() == ref_adapter.NODE_TEMPLATES.keys()
    for name, ref in ref_adapter.NODE_TEMPLATES.items():
        got = port_adapter.NODE_TEMPLATES[name]
        assert got.allocatable.cpu_m == ref.allocatable.cpu_m
        assert got.allocatable.mem_mb == ref.allocatable.mem_mb
        assert got.price_per_s == ref.price_per_s
        assert got.provisioning_delay_s == ref.provisioning_delay_s
    assert port_adapter.M2_SMALL.name == ref_adapter.M2_SMALL.name


def test_cellspec_fields_defaults_and_labels():
    ref_fields = [(f.name, f.default) for f in
                  dataclasses.fields(ref_runner.CellSpec)]
    got_fields = [(f.name, f.default) for f in
                  dataclasses.fields(port_runner.CellSpec)]
    assert got_fields == ref_fields
    assert port_runner._RESULT_FIELDS == ref_runner._RESULT_FIELDS
    for kw in (dict(scenario="heavy-tail"),
               dict(scenario="diurnal", scheduler="weighted",
                    autoscaler="void", rescheduler="void", seed=7,
                    scheduler_weights=(0.2, 0.5, 0.3)),
               dict(scenario="zone-outage", chaos=True, seed=3)):
        got, ref = port_runner.CellSpec(**kw), ref_runner.CellSpec(**kw)
        assert got.label == ref.label
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_merge_interleaves_and_dedups_templates():
    from repro.scenarios.trace import TraceStore as RefTraceStore
    from repro_torch.scenarios.trace import TraceStore
    ref_parts = [ref_build(s, seed=1, n_jobs=30)
                 for s in ("diurnal", "heavy-tail", "diurnal")]
    parts = [port_build(s, seed=1, n_jobs=30)
             for s in ("diurnal", "heavy-tail", "diurnal")]
    got, want = TraceStore.merge(parts, "m"), RefTraceStore.merge(ref_parts)
    assert got.n == want.n == 90
    assert len(got.templates) == len(want.templates)
    for col in COLUMNS:
        assert np.array_equal(getattr(got, col), getattr(want, col)), col
    assert TraceStore.merge([]).n == 0
