"""Failure injection + straggler model (fleet extension; DESIGN.md §2).

The paper assumes reliable VMs; a 1000+-node fleet cannot.  This module adds:

* `FailureInjector` — per-node exponential time-to-failure.  On failure the
  node vanishes, its pods are recreated as PENDING (checkpointable training
  jobs resume from their last checkpoint boundary — see `Pod.evict`), and the
  orchestrator's normal schedule→reschedule→scale-out loop absorbs the loss.
  This is exactly the paper's machinery reused as a *recovery* mechanism.
* `StragglerInjector` — marks a fraction of nodes slow (speed_factor < 1);
  the orchestrator's straggler policy evicts checkpointable batch pods from
  slow nodes so they finish elsewhere.  Wire it into the launch path via
  ``ExperimentSpec.straggler_injector``.

Spot reclaims (notice-before-kill), correlated zone outages and pod
crash-loops live in `repro_torch.core.disruption`; they speak this module's
``prime``/``arm_node`` injector protocol and compose with `FailureInjector`
through `disruption.DisruptionInjector`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cluster import Node

NODE_FAIL = 5   # must match simulation.NODE_FAIL


@dataclasses.dataclass
class FailureInjector:
    mtbf_s: float = 4 * 3600.0
    seed: int = 0
    arm_static_nodes: bool = True

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def prime(self, sim) -> None:
        for node in sim.cluster.nodes.values():
            if self.arm_static_nodes or node.autoscaled:
                self.arm_node(sim, node)

    def arm_node(self, sim, node: Node) -> None:
        ttf = float(self._rng.exponential(self.mtbf_s))
        sim.push(sim.now + ttf, NODE_FAIL, node)


@dataclasses.dataclass
class StragglerInjector:
    """Makes every k-th launched node slow by `slow_factor`."""

    every_k: int = 4
    slow_factor: float = 0.4
    _count: int = 0

    def maybe_slow(self, node: Node) -> Node:
        self._count += 1
        if self.every_k > 0 and self._count % self.every_k == 0:
            node.speed_factor = self.slow_factor
        return node
