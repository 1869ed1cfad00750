"""PyTorch port, live mode (``repro_torch.cloud.local_provider``) and the
orchestration CLI (``repro_torch.launch.orchestrate``), on the CPU.

* The reference's two cases (``tests/test_live_cluster.py``) on the
  port, with torch trainers of the ``deepseek-7b`` TINY twin on the CPU:
  a job runs to completion and bills; a job evicted mid-run is
  ``PENDING`` with incarnation 1, then ``SUCCEEDED``, and its final
  train state ``==`` an uninterrupted trainer's, leaf for leaf.
* Parity under one clock: both packages' ``local_provider`` read one
  fake clock, whose ``sleep`` advances it and joins the stub jobs that
  are due; the same stub runners, a static node, the binding autoscaler
  with a provisioning delay and one eviction give the same (cycle, pod,
  phase, node) sequence, readiness times and cost, bit for bit.
* The CLI prints what the reference's prints, for the default run,
  ``--compare --workload bursty`` and ``--failures``.
"""
import sys
import tempfile
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import repro.core as R
from repro.cloud import local_provider as ref_lp
from repro.launch import orchestrate as ref_orchestrate

import repro_torch.core as P
from repro_torch.cloud import local_provider as port_lp
from repro_torch.configs import get_config
from repro_torch.launch import orchestrate as port_orchestrate
from repro_torch.train.checkpoint import flatten_with_keys
from repro_torch.train.data import DataConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def _trainer(ckpt_dir, steps, log=lambda s: None):
    return Trainer(
        get_config("deepseek-7b", tiny=True),
        OptimizerConfig(total_steps=steps),
        DataConfig(batch_size=2, seq_len=16),
        TrainerConfig(total_steps=steps, checkpoint_every=3,
                      checkpoint_dir=ckpt_dir, log_every=1000),
        log_fn=log, device="cpu")


def _factory(ckpt_dir, steps, built=None, log=lambda s: None):
    def build():
        tr = _trainer(ckpt_dir, steps, log)
        if built is not None:
            built.append(tr)
        return tr
    return build


def _spec():
    return P.PodSpec("t", P.PodKind.BATCH, P.Resources(1000, 4096),
                     checkpointable=True)


def _live(cost=None):
    provider = port_lp.LocalCloudProvider(P.Resources(2000, 8192),
                                          cost or P.CostModel())
    live = port_lp.LiveCluster(provider, cycle_period_s=0.1,
                               log=lambda s: None)
    live.add_static_nodes(1)
    return live


def test_live_job_runs_to_completion_and_bills():
    cost = P.CostModel()
    live = _live(cost)
    with tempfile.TemporaryDirectory() as d:
        pod = live.submit(_spec(), _factory(d, 10))
        assert live.run(until=live.batch_done, timeout_s=120)
        assert pod.phase == P.PodPhase.SUCCEEDED
        assert live.jobs[pod.uid].result["completed"] == 1.0
        assert cost.total_cost(time.time()) > 0


def test_live_preemption_resumes_from_checkpoint_to_the_same_state():
    steps = 12
    live = _live()
    built, logs = [], []
    with tempfile.TemporaryDirectory() as d:
        pod = live.submit(_spec(), _factory(d, steps, built, logs.append))
        assert live.run(until=lambda: bool(built) and built[0].step >= 4,
                        timeout_s=60)
        live.evict(pod)                      # the paper's eviction
        assert pod.phase == P.PodPhase.PENDING and pod.incarnation == 1
        stopped = built[0].step
        assert 4 <= stopped < steps and built[0].stopped
        assert live.run(until=live.batch_done, timeout_s=180)
        assert pod.phase == P.PodPhase.SUCCEEDED
    assert len(built) == 2
    assert f"[trainer] resumed from step {stopped}" in logs
    assert built[1].step == steps
    plain = _trainer(None, steps)
    assert plain.run()["completed"] == 1.0
    got = flatten_with_keys(built[1].state)
    want = flatten_with_keys(plain.state)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert torch.equal(g, w), key


# --------------------------------------------------------------------------- #
# Parity under one clock
# --------------------------------------------------------------------------- #

class _FakeClock:
    """``time.time`` and ``time.sleep`` for both ``local_provider``
    modules.  ``sleep`` advances the clock, then releases every stub
    runner that is due and joins its thread, so what the next cycle sees
    does not depend on thread timing."""

    def __init__(self, start=1_000.0):
        self.now = start
        self.jobs = {}

    def time(self):
        return self.now

    def sleep(self, dt):
        self.now += dt
        for job in self.jobs.values():
            if job.runner is not None and job.runner.due(self.now):
                job.runner.release()
                job.thread.join(timeout=10)
                assert not job.thread.is_alive()


class _StubRunner:
    """A job of ``work_s`` fake seconds that resumes its progress
    (``done`` in the shared ``progress`` dict) across incarnations, at
    the granularity of whole cycles."""

    def __init__(self, clock, name, work_s, progress):
        self.clock, self.name, self.work_s = clock, name, work_s
        self.progress = progress
        self.start = clock.now
        self._go = threading.Event()
        self._stop = False

    def due(self, now):
        return self.progress[self.name] + now - self.start >= self.work_s

    def release(self):
        self._go.set()

    def request_stop(self):
        self._stop = True
        self.progress[self.name] += self.clock.now - self.start
        self._go.set()

    def run(self):
        self._go.wait(timeout=10)
        return {"completed": 0.0 if self._stop else 1.0}


def _parity_run(pkg, lp, clock):
    """One scripted live run through package ``pkg``'s core and
    ``lp``: the (cycle, pod, phase, node) record, readiness times and
    cost."""
    pkg.reset_id_counters()
    cost = pkg.CostModel()
    provider = lp.LocalCloudProvider(pkg.Resources(2000, 8192), cost,
                                     provisioning_delay_s=7.0)
    launched, ready = [], []
    inner_launch, inner_poll = provider.launch_node, provider.poll_ready

    def launch_node(now):
        node = inner_launch(now)
        launched.append([node.node_id, provider.pending_ready[-1][1]])
        return node

    def poll_ready(notify):
        def noted(node):
            ready.append([node.node_id, node.ready_time])
            notify(node)
        inner_poll(noted)

    provider.launch_node, provider.poll_ready = launch_node, poll_ready
    live = lp.LiveCluster(provider,
                          autoscaler=pkg.BindingAutoscaler(provider),
                          log=lambda s: None)
    clock.jobs = live.jobs
    live.add_static_nodes(1)
    progress = {}
    pods = {}
    for name, cpu, ram, work in (("a", 1000, 4096, 6.0),
                                 ("b", 800, 2048, 9.0),
                                 ("c", 1200, 4096, 4.0),
                                 ("d", 500, 1024, 3.0)):
        progress[name] = 0.0
        spec = pkg.PodSpec(name, pkg.PodKind.BATCH,
                           pkg.Resources(cpu, ram), checkpointable=True)
        pods[name] = live.submit(
            spec, lambda n=name, w=work: _StubRunner(clock, n, w, progress))
    record = []

    def observe():
        record.append([len(record)] + [
            [p.name, p.phase.value, p.node_id, p.incarnation]
            for p in pods.values()])
        return False

    def observe_until(cond):
        def until():
            observe()
            return cond()
        return until

    ok1 = live.run(until=observe_until(
        lambda: pods["a"].phase.value == "bound"
        and clock.now - pods["a"].bound_time >= 2.0), timeout_s=60)
    live.evict(pods["a"])
    observe()
    ok2 = live.run(until=observe_until(live.batch_done), timeout_s=600)
    return {"ok": [ok1, ok2], "record": record, "launched": launched,
            "ready": ready, "now": clock.now,
            "cost": cost.total_cost(clock.now),
            "incarnations": {n: p.incarnation for n, p in pods.items()}}


def test_live_cluster_matches_reference_under_one_clock(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(ref_lp, "time", clock)
    monkeypatch.setattr(port_lp, "time", clock)
    want = _parity_run(R, ref_lp, clock)
    clock.now = 1_000.0
    got = _parity_run(P, port_lp, clock)
    assert want["ok"] == [True, True]
    assert want["incarnations"]["a"] == 1
    assert want["launched"] and want["ready"]       # the delay was used
    assert got == want


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("argv", [[], ["--compare", "--workload", "bursty"],
                                  ["--failures"]])
def test_orchestrate_cli_prints_the_reference_text(argv, capsys,
                                                   monkeypatch):
    R.reset_id_counters()
    monkeypatch.setattr(sys, "argv", ["orchestrate"] + argv)
    ref_orchestrate.main()
    want = capsys.readouterr().out
    P.reset_id_counters()
    port_orchestrate.main(argv)
    got = capsys.readouterr().out
    assert want.startswith("[orchestrate] workload=")
    assert got == want
