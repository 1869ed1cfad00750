"""PyTorch port, the chaos layer (``repro_torch.core.disruption``,
``repro_torch.scenarios.chaos``) against the reference's, on the CPU.

* the injectors' decisions: the cases of ``tests/test_disruption.py``
  (spot reclaims, a zone outage, crash-loops, a composite stack, nodes
  killed while provisioning, the spied eviction path), each run through
  both packages: the ``ExperimentResult``, the disruption log and the
  injectors' state ``==``;
* ``capture_chaos_trace`` on the three families and both engines against
  ``tests/data/golden_chaos_trace.json``;
* each family's ``to_lane_arrays()`` against the reference's;
* ``run_chaos_cell`` at the golden 120 jobs against the reference's
  (array engine), and
  at the families' 400 jobs on the array engine against
  ``tests/data/torch_chaos_rows.json`` (written by the reference);
* a ``CellSpec(chaos=True)`` row through ``run_cells(workers=1)`` and
  ``workers="lanes"`` against the reference's.

Every float is compared ``==``.  Regenerate the rows fixture after an
intentional change to the reference with::

    PYTHONPATH=src python tests/test_torch_chaos.py --regen
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

if __name__ == "__main__":          # --regen entry point (see docstring)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))

import repro.core as R
from repro.cloud import adapter as ref_adapter
from repro.core import simulation as ref_simulation
from repro.core.experiment import build_simulation as ref_build
from repro.scenarios import chaos as ref_chaos
from repro.search import runner as ref_runner

import repro_torch.core as P
from repro_torch.cloud import adapter as port_adapter
from repro_torch.core import golden
from repro_torch.core import simulation as port_simulation
from repro_torch.core.experiment import build_simulation as port_build
from repro_torch.scenarios import chaos as port_chaos
from repro_torch.search import runner as port_runner

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "data", "torch_chaos_rows.json")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "data", "golden_chaos_trace.json")
FAMILIES = tuple(ref_chaos.CHAOS_SCENARIOS)


def _killer(pkg_simulation, node_state):
    """``tests/test_disruption.py``'s provisioning killer for one
    package: every ``period_s`` it fails each node still booting, until
    ``max_kills`` have died."""

    @dataclasses.dataclass
    class ProvisioningKiller:
        period_s: float = 20.0
        max_kills: int = 3
        killed: int = 0

        def prime(self, sim):
            sim.push(self.period_s, pkg_simulation.ZONE_OUTAGE, self)

        def arm_node(self, sim, node):
            pass

        def on_outage(self, sim):
            for node in list(sim.cluster.nodes.values()):
                if (self.killed < self.max_kills
                        and node.state == node_state.PROVISIONING):
                    self.killed += 1
                    sim.fail_node(node)
            if self.killed < self.max_kills:
                sim.push(sim.now + self.period_s,
                         pkg_simulation.ZONE_OUTAGE, self)

    return ProvisioningKiller


def _case(pkg, name):
    """``(spec kwargs, injector)`` of one injector case for ``pkg``."""
    base = dict(rescheduler="non-binding", autoscaler="binding", seed=0)
    if name == "spot-slow":
        return dict(base, workload="slow"), pkg.SpotReclaimInjector(
            default_mtbr_s=400.0, notice_s=60.0, seed=11)
    if name == "spot-mixed":
        return dict(base, workload="mixed", seed=3), pkg.SpotReclaimInjector(
            default_mtbr_s=500.0, notice_s=60.0, seed=5)
    if name == "spot-unlisted":
        return dict(base, workload="bursty"), pkg.SpotReclaimInjector(
            reclaim_mtbr_s={"other-type": 100.0}, default_mtbr_s=None,
            seed=1)
    if name == "spot-static":
        return dict(base, workload="mixed", initial_workers=3), \
            pkg.SpotReclaimInjector(
                reclaim_mtbr_s={"m2.small": 700.0}, notice_s=30.0, seed=8,
                arm_static_nodes=True)
    if name == "zone-fixed":
        return dict(base, workload="mixed", initial_workers=3), \
            pkg.ZoneOutageInjector(outage_times=(150.0, 600.0), seed=4)
    if name == "zone-renewal":
        return dict(base, workload="slow", initial_workers=2), \
            pkg.ZoneOutageInjector(mean_interval_s=500.0, seed=2,
                                   zones=("a", "b"))
    if name == "crash-loop":
        types = pkg.make_fleet_job_types()
        adapter = ref_adapter if pkg is R else port_adapter
        return dict(workload="fleet",
                    arrivals=[pkg.Arrival(0.0, types["train_large"])],
                    template=adapter.TPU_V5E_HOST, initial_workers=1,
                    rescheduler="void", autoscaler="binding"), \
            pkg.CrashLoopInjector(mtbc_s=60.0, seed=2, restart_budget=2,
                                  backoff_base_s=30.0)
    if name == "composite":
        return dict(base, workload="mixed", seed=1), pkg.DisruptionInjector(
            injectors=(pkg.SpotReclaimInjector(default_mtbr_s=600.0,
                                               notice_s=45.0, seed=3),
                       pkg.CrashLoopInjector(mtbc_s=120.0, seed=4),
                       pkg.ZoneOutageInjector(outage_times=(400.0,),
                                              seed=5)))
    if name == "provisioning-kill":
        sim_mod = ref_simulation if pkg is R else port_simulation
        return dict(base, workload="slow"), _killer(sim_mod,
                                                    pkg.NodeState)()
    raise KeyError(name)


INJECTOR_CASES = ("spot-slow", "spot-mixed", "spot-unlisted", "spot-static",
                  "zone-fixed", "zone-renewal", "crash-loop", "composite",
                  "provisioning-kill")


def _injector_state(inj):
    """What an injector decided, beyond the log: RNG position, crash
    counts, zone labels handed out, kills."""
    if hasattr(inj, "injectors"):
        return [_injector_state(i) for i in inj.injectors]
    out = {}
    if hasattr(inj, "_rng"):
        out["rng"] = inj._rng.bit_generator.state
    if hasattr(inj, "crash_counts"):
        out["crashes"] = inj.crash_counts()
    if hasattr(inj, "_next_zone"):
        out["next_zone"] = inj._next_zone
    if hasattr(inj, "killed"):
        out["killed"] = inj.killed
    return json.loads(json.dumps(out))


def _run_case(pkg, build, name, engine):
    kw, inj = _case(pkg, name)
    pkg.reset_id_counters()
    sim = build(pkg.ExperimentSpec(engine=engine, failure_injector=inj,
                                   **kw))
    result = sim.run()
    log = [list(e[:3]) + [list(e[3])] for e in sim.disruption_log]
    return (golden.result_row(result), json.loads(json.dumps(log)),
            _injector_state(inj))


@pytest.mark.parametrize("engine", ["array", "object"])
@pytest.mark.parametrize("name", INJECTOR_CASES)
def test_injector_decisions_equal_reference(name, engine):
    want = _run_case(R, ref_build, name, engine)
    got = _run_case(P, port_build, name, engine)
    assert got == want
    row, log, _state = got
    assert row["completed"]
    if name != "spot-unlisted":
        assert row["failures_injected"] > 0 or log, name


def test_fast_path_equals_spied_path_and_reference():
    """The unspied array run evicts on the column fast path; spying
    ``on_unbind`` forces per-pod eviction.  Both equal the reference."""
    def run(pkg, build, spied):
        kw, inj = _case(pkg, "spot-mixed")
        pkg.reset_id_counters()
        sim = build(pkg.ExperimentSpec(engine="array", failure_injector=inj,
                                       **kw))
        if spied:
            inner = sim.cluster.on_unbind
            sim.cluster.on_unbind = lambda pod: inner(pod)
        return golden.result_row(sim.run())

    want = run(R, ref_build, False)
    assert run(P, port_build, False) == want
    assert run(P, port_build, True) == want


def test_zone_outage_rejects_both_schedules():
    for pkg in (R, P):
        with pytest.raises(ValueError, match="not both"):
            pkg.ZoneOutageInjector(outage_times=(1.0,), mean_interval_s=5.0)


@pytest.mark.parametrize("engine", ["array", "object"])
@pytest.mark.parametrize("scenario", FAMILIES)
def test_chaos_trace_equals_golden_fixture(scenario, engine):
    with open(GOLDEN) as f:
        want = json.load(f)[scenario]
    got = port_chaos.capture_chaos_trace(scenario, engine, seed=0,
                                         n_jobs=port_chaos.GOLDEN_JOBS)
    for key in want:
        assert got[key] == want[key], (scenario, engine, key)
    assert got == want
    assert got["audits"] > 0 and got["disruption_log"]


@pytest.mark.parametrize("scenario", FAMILIES)
def test_family_traces_and_lane_arrays_equal_reference(scenario):
    for seed in (0, 3):
        want = ref_chaos.CHAOS_SCENARIOS[scenario].build(seed)
        got = port_chaos.CHAOS_SCENARIOS[scenario].build(seed)
        assert got.name == want.name and got.n == want.n
        a, b = got.to_lane_arrays(), want.to_lane_arrays()
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            assert np.array_equal(a[key], b[key]), (scenario, seed, key)
    assert (dataclasses.asdict(port_chaos.CHAOS_SCENARIOS[scenario])
            == dataclasses.asdict(ref_chaos.CHAOS_SCENARIOS[scenario]))


def _strip_wall(row):
    row = dict(row)
    assert isinstance(row.pop("wall_s"), float)
    return row


@pytest.mark.parametrize("scenario", FAMILIES)
def test_chaos_cells_equal_reference_at_golden_jobs(scenario):
    """The array engine only: the object engine's trace is already held
    to the golden fixture above, and its cells take seconds each."""
    want = ref_chaos.run_chaos_cell(scenario, seed=0, engine="array",
                                    n_jobs=ref_chaos.GOLDEN_JOBS)
    got = port_chaos.run_chaos_cell(scenario, seed=0, engine="array",
                                    n_jobs=port_chaos.GOLDEN_JOBS)
    assert _strip_wall(got) == _strip_wall(want)


def test_recovery_times_equal_reference():
    with open(GOLDEN) as f:
        golden_traces = json.load(f)
    for scenario, tr in golden_traces.items():
        want = ref_chaos._recovery_times(tr["binds"], tr["disruption_log"])
        got = port_chaos._recovery_times(tr["binds"], tr["disruption_log"])
        assert got == want, scenario
    assert any(port_chaos._recovery_times(tr["binds"], tr["disruption_log"])
               for tr in golden_traces.values())


def test_chaos_cells_at_family_jobs_equal_fixture():
    with open(FIXTURE) as f:
        want = json.load(f)
    assert sorted(want) == sorted(FAMILIES)
    for scenario in FAMILIES:
        got = _strip_wall(port_chaos.run_chaos_cell(scenario, seed=0,
                                                    engine="array"))
        assert got == want[scenario], scenario
        assert got["completed"] and got["disruption_events"] > 0


def test_chaos_cell_through_run_cells_equals_reference():
    kw = dict(scenario="spot-spike", scheduler="best-fit",
              autoscaler="binding", rescheduler="non-binding", seed=1,
              n_jobs=80, chaos=True)
    want = ref_runner.run_cells([ref_runner.CellSpec(**kw)], workers=1)
    got = port_runner.run_cells([port_runner.CellSpec(**kw)], workers=1)
    lanes = port_runner.run_cells([port_runner.CellSpec(**kw)],
                                  workers="lanes")
    assert _strip_wall(got[0]) == _strip_wall(want[0])
    assert _strip_wall(lanes[0]) == _strip_wall(want[0])
    assert got[0]["label"].endswith(".chaos")
    assert got[0]["failures_injected"] > 0


def test_registry_builds_the_chaos_families():
    from repro.scenarios import build_scenario as ref_scenario
    from repro_torch.scenarios import build_scenario as port_scenario
    from repro_torch.scenarios import names
    assert set(FAMILIES) <= set(names())
    for scenario in FAMILIES:
        want = ref_scenario(scenario, seed=2, n_jobs=50)
        got = port_scenario(scenario, seed=2, n_jobs=50)
        assert np.array_equal(got.arrival_time, want.arrival_time)
        assert np.array_equal(got.template_id, want.template_id)
        assert got.n == 50


def _regen() -> None:
    rows = {}
    for scenario in FAMILIES:
        row = ref_chaos.run_chaos_cell(scenario, seed=0, engine="array")
        row.pop("wall_s")
        rows[scenario] = row
    with open(FIXTURE, "w") as f:
        json.dump(rows, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {FIXTURE}: {', '.join(sorted(rows))}")


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        print(__doc__)
        sys.exit(2)
    _regen()
