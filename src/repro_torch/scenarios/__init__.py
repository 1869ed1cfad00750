"""Columnar traces, the scenario families and their registry."""
from repro_torch.scenarios.registry import build_scenario, names, register
from repro_torch.scenarios.trace import KIND_BATCH, KIND_SERVICE, TraceStore

__all__ = ["TraceStore", "KIND_BATCH", "KIND_SERVICE", "build_scenario",
           "names", "register"]
