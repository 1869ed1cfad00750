"""PyTorch port, the fleet extensions on the CPU, port against reference:

* ``repro_torch.core.heterogeneous``: the cases of
  ``tests/test_heterogeneous.py`` and the replacement cases of
  ``tests/test_disruption.py`` (instance choice, launched types, rows);
* ``repro_torch.core.estimator``: ``tests/test_fleet_features.py``'s
  ``EmaEstimator`` / ``OversubscribingScheduler`` cases, and a whole run
  on the oversubscribing scheduler;
* ``TraceStore.save`` / ``load``: the port's files read by the reference
  and the reverse, in JSON and NPZ;
* ``load_csv_trace`` on the CSV cases of ``tests/test_scenarios.py``;
* ``repro_torch.k8s``: ``from_manifest`` / ``to_pod_spec`` on the paper's
  manifests and their refusals.

Every float is compared ``==``.
"""
import dataclasses
import enum
import json

import numpy as np
import pytest

import repro.core as R
from repro.cloud import adapter as ref_adapter
from repro.core import estimator as ref_est
from repro.core import heterogeneous as ref_het
from repro.core.workload import JOB_TYPES as REF_JOB_TYPES
from repro.core.workload import generate_workload as ref_workload
from repro.k8s import objects as ref_k8s
from repro.scenarios import CsvTraceSpec as RefCsvSpec
from repro.scenarios import TraceStore as RefTraceStore
from repro.scenarios import build_scenario as ref_scenario
from repro.scenarios import load_csv_trace as ref_load_csv

import repro_torch.core as P
import repro_torch.k8s as port_k8s_pkg
from repro_torch.cloud import adapter as port_adapter
from repro_torch.core import estimator as port_est
from repro_torch.core import golden
from repro_torch.core import heterogeneous as port_het
from repro_torch.core.workload import JOB_TYPES as PORT_JOB_TYPES
from repro_torch.core.workload import generate_workload as port_workload
from repro_torch.k8s import objects as port_k8s
from repro_torch.scenarios import CsvTraceSpec, TraceStore, load_csv_trace
from repro_torch.scenarios import build_scenario as port_scenario

REF = (R, ref_het, ref_est, REF_JOB_TYPES, ref_workload)
PORT = (P, port_het, port_est, PORT_JOB_TYPES, port_workload)


def _plain(obj):
    """A dataclass as JSON-native values: each package has its own
    ``PodKind``, so enums compare by value."""
    return json.loads(json.dumps(
        dataclasses.asdict(obj),
        default=lambda v: v.value if isinstance(v, enum.Enum) else v))


def _specs(specs):
    return [_plain(s) for s in specs]


# -- heterogeneous fleet --------------------------------------------------------

def test_cheapest_fitting_equals_reference():
    cases = [(100, 1.0), (100, 2.4), (1500, 5.0), (100, 50.0), (460, 1.5),
             (941, 1.0), (1900, 5.5)]
    for cpu, mem in cases:
        got = port_het.NECTAR_CATALOG.cheapest_fitting(
            P.Resources(cpu, P.gi(mem)))
        want = ref_het.NECTAR_CATALOG.cheapest_fitting(
            R.Resources(cpu, R.gi(mem)))
        assert (got and got.name) == (want and want.name), (cpu, mem)
    assert port_het.NECTAR_CATALOG.cheapest_fitting(
        P.Resources(100, P.gi(1.0))).name == "m2.tiny"
    assert (port_het.NECTAR_CATALOG.price_table()
            == ref_het.NECTAR_CATALOG.price_table())
    assert ([dataclasses.astuple(t) for t in port_het.NECTAR_CATALOG.types]
            == [dataclasses.astuple(t) for t in ref_het.NECTAR_CATALOG.types])


def _run_hetero(pkgs, workload, seed, injector=None):
    core, het, _est, _types, gen = pkgs
    core.reset_id_counters()
    cost = core.CostModel()
    provider = het.HeterogeneousProvider(het.NECTAR_CATALOG, cost)
    cluster = core.Cluster(use_arrays=False)
    cluster.add_node(provider.make_static_node(het.NECTAR_CATALOG.types[1],
                                               0.0))
    orch = core.Orchestrator(cluster, core.BestFitBinPackingScheduler(),
                             core.NonBindingRescheduler(max_pod_age_s=60.0),
                             het.HeterogeneousBindingAutoscaler(provider))
    sim = core.Simulation(orch, cost, gen(workload, seed=seed),
                          config=core.SimConfig(), failure_injector=injector)
    provider.attach(sim)
    result = sim.run()
    result.workload = workload
    return golden.result_row(result), list(provider.launched_types)


@pytest.mark.parametrize("workload,seed", [("slow", 0), ("slow", 1),
                                           ("mixed", 2), ("bursty", 0)])
def test_hetero_runs_equal_reference(workload, seed):
    want = _run_hetero(REF, workload, seed)
    got = _run_hetero(PORT, workload, seed)
    assert got == want
    row, launched = got
    assert row["completed"]
    if workload == "slow" and seed == 0:
        assert len(set(launched)) >= 2, launched


def test_hetero_under_spot_reclaims_equals_reference():
    """Reclaimed nodes are replaced by their own instance type."""
    def inj(core):
        return core.SpotReclaimInjector(default_mtbr_s=500.0, notice_s=60.0,
                                        seed=9)
    want = _run_hetero(REF, "mixed", 1, inj(R))
    got = _run_hetero(PORT, "mixed", 1, inj(P))
    assert got == want
    assert got[0]["completed"] and got[0]["preemption_notices"] > 0


@pytest.mark.parametrize("occupied", [True, False])
def test_replacement_matches_reclaimed_type(occupied):
    class FakeSim:
        def schedule_node_ready(self, node, at):
            pass

    out = []
    for core, het, _est, types, _gen in (REF, PORT):
        core.reset_id_counters()
        provider = het.HeterogeneousProvider(het.NECTAR_CATALOG,
                                             core.CostModel())
        provider.attach(FakeSim())
        bas = het.HeterogeneousBindingAutoscaler(provider)
        cluster = core.Cluster()
        node = provider.make_static_node(
            het.NECTAR_CATALOG.type_by_name("m2.tiny"), 0.0)
        cluster.add_node(node)
        if occupied:
            pod = core.Pod(spec=types["batch_small"], submit_time=0.0)
            assert core.BestFitBinPackingScheduler().schedule(cluster, pod,
                                                              0.0)
        bas.notify_preemption_notice(cluster, node, 10.0)
        bas.notify_preemption_notice(cluster, node, 11.0)
        out.append(list(provider.launched_types))
    assert out[0] == out[1] == (["m2.tiny"] if occupied else [])


# -- usage estimator --------------------------------------------------------------

def _pod(core, types, name):
    return core.Pod(spec=types[name], submit_time=0.0)


def test_ema_learns_usage_ratio_like_reference():
    ratios = []
    for core, _het, est_mod, types, _gen in (REF, PORT):
        est = est_mod.EmaEstimator(alpha=0.5, prior=1.0)
        usage = est_mod.UsageModel({"service_med": 0.5})
        pod = _pod(core, types, "service_med")
        seq = []
        for _ in range(8):
            est.observe(pod, usage.usage(pod))
            seq.append(est.ratio("service_med"))
        seq.append(est.ratio("unseen"))
        seq.append(dataclasses.astuple(usage.usage(
            _pod(core, types, "batch_small"))))
        ratios.append(seq)
    assert ratios[0] == ratios[1]
    assert ratios[1][7] == pytest.approx(0.5, abs=0.05)


def _fill(core, est_mod, types, oversub):
    est = est_mod.EmaEstimator(alpha=1.0)
    usage = est_mod.UsageModel({"service_med": 0.5})
    probe = _pod(core, types, "service_med")
    est.observe(probe, usage.usage(probe))
    sched = core.BestFitBinPackingScheduler()
    if oversub:
        sched = est_mod.OversubscribingScheduler(sched, est)
    cluster = core.Cluster()
    node = core.Node(allocatable=core.Resources(940, core.gi(3.5)))
    node.mark_ready(0.0)
    cluster.add_node(node)
    n = 0
    while sched.schedule(cluster, _pod(core, types, "service_med"), 0.0):
        n += 1
    return n, bool(getattr(node, "oversub", False))


def test_oversubscription_packs_more_like_reference():
    plain = [_fill(c, e, t, False) for c, _h, e, t, _g in (REF, PORT)]
    over = [_fill(c, e, t, True) for c, _h, e, t, _g in (REF, PORT)]
    assert plain[0] == plain[1] and over[0] == over[1]
    assert over[1][0] > plain[1][0]


@pytest.mark.parametrize("case", ["tiny", "half-up", "zero"])
def test_effective_request_equals_reference(case):
    out = []
    for core, _het, est_mod, _types, _gen in (REF, PORT):
        est = est_mod.EmaEstimator(alpha=1.0)
        if case == "tiny":
            req, used, kw = (1, 4.0), (0, 1.0), {}
        elif case == "half-up":
            req, used = (10, 100.0), (3, 37.5)
            kw = dict(cpu_floor=0.0, mem_floor=0.0)
        else:
            req, used, kw = (0, 0.0), (0, 0.0), {}
        pod = core.Pod(spec=core.PodSpec(
            type_name=case, kind=core.PodKind.SERVICE,
            requests=core.Resources(cpu_m=req[0], mem_mb=req[1]),
            duration_s=10.0), submit_time=0.0)
        est.observe(pod, core.Resources(cpu_m=used[0], mem_mb=used[1]))
        eff = est.effective_request(pod, **kw)
        out.append((est.ratio(case), eff.cpu_m, eff.mem_mb))
    assert out[0] == out[1]
    if case == "tiny":
        assert out[1][1] == 1
    if case == "half-up":
        assert out[1][1] == 5


def test_oversubscribing_run_equals_reference():
    """A whole mixed workload on the oversubscribing best-fit scheduler
    (object engine: the decorator schedules pod by pod)."""
    rows = []
    for core, _het, est_mod, _types, gen in (REF, PORT):
        core.reset_id_counters()
        est = est_mod.EmaEstimator(alpha=0.5)
        usage = est_mod.UsageModel({"service_med": 0.4, "batch_small": 0.7})
        spec = core.ExperimentSpec(workload="mixed", seed=1,
                                   rescheduler="non-binding",
                                   autoscaler="binding", engine="object")
        sim = core.build_simulation(spec)
        sim.orch.scheduler = est_mod.OversubscribingScheduler(
            sim.orch.scheduler, est, max_oversub=1.1)
        for pod in (core.Pod(spec=a.spec, submit_time=0.0)
                    for a in gen("mixed", seed=1)[:20]):
            est.observe(pod, usage.usage(pod))
        rows.append(golden.result_row(sim.run()))
    assert rows[0] == rows[1]
    assert rows[1]["completed"]


# -- trace persistence --------------------------------------------------------------

def _same_trace(a, b):
    assert a.name == b.name
    for col in ("arrival_time", "template_id", "duration_s", "cpu_m",
                "mem_mb", "kind"):
        x, y = getattr(a, col), getattr(b, col)
        assert x.dtype == y.dtype and np.array_equal(x, y), col
    assert _specs(a.templates) == _specs(b.templates)


@pytest.mark.parametrize("suffix", [".json", ".npz"])
@pytest.mark.parametrize("scenario", ["heavy-tail", "paper-mixed",
                                      "zone-outage"])
def test_trace_files_cross_load(tmp_path, suffix, scenario):
    port_tr = port_scenario(scenario, seed=4, n_jobs=150)
    ref_tr = ref_scenario(scenario, seed=4, n_jobs=150)
    port_path = str(tmp_path / f"port{suffix}")
    ref_path = str(tmp_path / f"ref{suffix}")
    port_tr.save(port_path)
    ref_tr.save(ref_path)
    _same_trace(TraceStore.load(port_path), port_tr)
    _same_trace(RefTraceStore.load(port_path), ref_tr)
    _same_trace(TraceStore.load(ref_path), port_tr)
    if suffix == ".json":
        with open(port_path) as f, open(ref_path) as g:
            assert f.read() == g.read()


def test_saved_trace_replays_like_reference(tmp_path):
    path = str(tmp_path / "t.npz")
    ref_scenario("heavy-tail", seed=2, n_jobs=80).save(path)
    R.reset_id_counters()
    want = golden.result_row(R.run_experiment(R.ExperimentSpec(
        trace=RefTraceStore.load(path), autoscaler="binding")))
    P.reset_id_counters()
    got = golden.result_row(P.run_experiment(P.ExperimentSpec(
        trace=TraceStore.load(path), autoscaler="binding")))
    assert got == want and got["completed"]


# -- CSV traces ----------------------------------------------------------------------

def _write_csv(tmp_path, rows, header=False):
    path = tmp_path / "tasks.csv"
    lines = (["arrival,cpu,mem,duration"] if header else [])
    lines += [",".join(str(v) for v in r) for r in rows]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.filterwarnings("ignore:loadtxt")
def test_csv_fractional_rescale_and_quantization(tmp_path):
    rows = [(0.0, 0.5, 0.25, 300.0), (10.0, 0.5, 0.25, 60.0),
            (20.0, 0.125, 0.03, 600.0)]
    path = _write_csv(tmp_path, rows, header=True)
    got = load_csv_trace(path, spec=CsvTraceSpec(skip_header=1))
    want = ref_load_csv(path, spec=RefCsvSpec(skip_header=1))
    _same_trace(got, want)
    assert len(got) == 3 and len(got.templates) == 2
    alloc = port_adapter.M2_SMALL.allocatable
    assert got.cpu_m[0] == round(0.5 * alloc.cpu_m / 50) * 50
    assert got.duration_s.tolist() == [300.0, 60.0, 600.0]
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    assert len(load_csv_trace(str(empty))) == 0 == len(ref_load_csv(
        str(empty)))


@pytest.mark.parametrize("variant", ["absolute-service", "medium-cap",
                                     "columns"])
def test_csv_spec_variants_equal_reference(tmp_path, variant):
    rng = np.random.default_rng(3)
    rows = [(float(t), float(c), float(m), float(d), 7.0)
            for t, c, m, d in zip(np.cumsum(rng.exponential(4.0, 30)),
                                  rng.uniform(0.01, 1.5, 30),
                                  rng.uniform(0.01, 1.5, 30),
                                  rng.uniform(-5.0, 300.0, 30))]
    path = _write_csv(tmp_path, rows)
    if variant == "absolute-service":
        kw = dict(cpu_is_fraction=False, mem_is_fraction=False,
                  cpu_scale=400.0, mem_scale=2048.0, batch_kind=False)
        tmpl = ("M2_SMALL",)
    elif variant == "medium-cap":
        kw, tmpl = dict(fraction_cap=0.5, cpu_quant_m=100), ("M2_MEDIUM",)
    else:
        kw, tmpl = dict(columns=(0, 2, 1, 3)), ("M2_TINY",)
    got = load_csv_trace(path, template=getattr(port_adapter, tmpl[0]),
                         spec=CsvTraceSpec(**kw), name=variant)
    want = ref_load_csv(path, template=getattr(ref_adapter, tmpl[0]),
                        spec=RefCsvSpec(**kw), name=variant)
    _same_trace(got, want)


def test_csv_trace_runs_end_to_end_like_reference(tmp_path):
    rng = np.random.default_rng(0)
    rows = [(float(t), float(c), float(m), float(d))
            for t, c, m, d in zip(np.cumsum(rng.exponential(5.0, 60)),
                                  rng.uniform(0.05, 0.4, 60),
                                  rng.uniform(0.05, 0.4, 60),
                                  rng.uniform(30.0, 300.0, 60))]
    path = _write_csv(tmp_path, rows)
    R.reset_id_counters()
    want = golden.result_row(R.run_experiment(R.ExperimentSpec(
        trace=ref_load_csv(path, name="borg-slice"), autoscaler="binding")))
    P.reset_id_counters()
    got = golden.result_row(P.run_experiment(P.ExperimentSpec(
        trace=load_csv_trace(path, name="borg-slice"), autoscaler="binding")))
    assert got == want
    assert got["completed"] and got["workload"] == "borg-slice"


# -- Kubernetes objects -----------------------------------------------------------------

MANIFESTS = [
    {"kind": "Deployment", "metadata": {"generateName": "web-"},
     "spec": {"template": {
         "metadata": {"labels": {"rescheduling": "moveable"}},
         "spec": {"schedulerName": "customScheduler", "containers": [{
             "name": "web", "resources": {
                 "requests": {"cpu": "100m", "memory": "1.4Gi"},
                 "limits": {"cpu": "100m", "memory": "1.4Gi"}}}]}}}},
    {"kind": "Job", "metadata": {"generateName": "batch-"},
     "x-duration-s": 450.0,
     "spec": {"template": {
         "metadata": {"labels": {"type": "batch"}},
         "spec": {"containers": [{
             "name": "job", "resources": {
                 "requests": {"cpu": "1", "memory": "512Mi"}}}]}}}},
    {"kind": "Deployment",
     "spec": {"template": {"containers": [{
         "name": "bare", "resources": {
             "requests": {"cpu": "0.25", "memory": "2G"}}}]}}},
]
BAD_MANIFESTS = [
    dict(MANIFESTS[0], kind="StatefulSet"),
    {"kind": "Job", "spec": {"template": {"spec": {"containers": [{
        "resources": {"requests": {"cpu": "1", "memory": "1Gi"}}}]}}}},
    {"kind": "Deployment", "spec": {"template": {"containers": [{
        "resources": {"requests": {"cpu": "1", "memory": "1Gi"},
                      "limits": {"cpu": "2", "memory": "1Gi"}}}]}}},
    {"kind": "Deployment", "spec": {"template": {"containers": [{
        "resources": {"requests": {"cpu": "1", "memory": "lots"}}}]}}},
]


def test_manifests_equal_reference():
    for m in MANIFESTS:
        assert (_plain(port_k8s_pkg.from_manifest(m))
                == _plain(ref_k8s.from_manifest(m)))
    got = port_k8s_pkg.from_manifest(MANIFESTS[0])
    assert got.moveable and got.kind == P.PodKind.SERVICE
    for m in BAD_MANIFESTS:
        errors = []
        for mod in (port_k8s, ref_k8s):
            with pytest.raises(ValueError) as exc:
                mod.from_manifest(m)
            errors.append(str(exc.value))
        assert errors[0] == errors[1]


def test_objects_and_quantities_equal_reference():
    for s in ("100m", "1", "0.5", "2.25"):
        assert port_k8s.parse_cpu(s) == ref_k8s.parse_cpu(s)
    for s in ("1.4Gi", "512Mi", "2G", "300M", "64"):
        assert port_k8s.parse_mem(s) == ref_k8s.parse_mem(s)
    objs = [(port_k8s.Deployment("svc", "200m", "1Gi", moveable=True),
             ref_k8s.Deployment("svc", "200m", "1Gi", moveable=True)),
            (port_k8s.Job("train", "1", "2Gi", 900.0, checkpointable=True),
             ref_k8s.Job("train", "1", "2Gi", 900.0, checkpointable=True))]
    for got, want in objs:
        assert (_plain(port_k8s_pkg.to_pod_spec(got))
                == _plain(ref_k8s.to_pod_spec(want)))
