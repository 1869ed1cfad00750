"""Observability layer: flight recorder, decision attribution, and a
cycle-phase profiler, as ``repro/obs``.

Always compiled out unless enabled: every instrumented object in the core
carries an ``obs`` attribute defaulting to ``None``, and each hot-path
hook is a single ``is not None`` test — with ``ExperimentSpec.obs`` unset
nothing else runs and results are untouched.  With obs enabled,
recording is strictly passive, so ``ExperimentResult`` stays
bit-identical (``tests/test_torch_obs.py``).

Quickstart::

    from repro_torch.core import ExperimentSpec
    from repro_torch.obs import ObsConfig, run_recorded

    spec = ExperimentSpec(scenario="flash-crowd", scenario_jobs=400,
                          autoscaler="predictive", obs=ObsConfig())
    result, rec = run_recorded(spec)
    rec.export("run.npz")           # or .json (exact float round-trip)
    print(render_report(load_bundle("run.npz")))
"""
from repro_torch.obs.profiler import PhaseProfiler, chrome_trace
from repro_torch.obs.recorder import (EventLog, ObsConfig, ObsRecorder,
                                      load_bundle, save_bundle)
from repro_torch.obs.report import (decision_summary, explain_events,
                                    phase_table, render_report)


def run_recorded(spec):
    """``run_experiment`` with observability forced on; returns
    ``(ExperimentResult, ObsRecorder)``.  ``spec.obs`` may be an
    ``ObsConfig`` (used as-is) or ``None`` (defaults apply)."""
    import dataclasses

    from repro_torch.core.experiment import build_simulation

    if spec.obs is None:
        spec = dataclasses.replace(spec, obs=ObsConfig())
    sim = build_simulation(spec)
    result = sim.run()
    result.workload = spec.workload_label()
    return result, sim.obs


__all__ = [
    "EventLog", "ObsConfig", "ObsRecorder", "PhaseProfiler",
    "chrome_trace", "load_bundle", "save_bundle", "run_recorded",
    "decision_summary", "explain_events", "phase_table", "render_report",
]
