"""Columnar traces and the scenario families the lane engine runs."""
from repro_torch.scenarios.registry import build_scenario, names
from repro_torch.scenarios.trace import KIND_BATCH, KIND_SERVICE, TraceStore

__all__ = ["TraceStore", "KIND_BATCH", "KIND_SERVICE", "build_scenario",
           "names"]
