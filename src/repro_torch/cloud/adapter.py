"""Cloud adapters (paper §4.2 "Cloud Adapter" + Fig. 1 red components),
copied from ``repro/cloud/adapter.py``.

* `SimCloudProvider` — the provisioning-delay model used by the discrete-event
  evaluation (boot + join ≈ 50 s, the paper's own justification for
  ``provisioning_interval = 60 s``).

The reference's ``LocalCloudProvider`` (live in-process workers) is not
ported yet.  Node templates cover the paper's Nectar m2.small worker, its
two siblings and the reference's TPU v5e host template.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Optional

from repro_torch.core.autoscaler import NodeProvider
from repro_torch.core.cluster import Node
from repro_torch.core.cost import CostModel
from repro_torch.core.resources import Resources, gi


@dataclasses.dataclass(frozen=True)
class NodeTemplate:
    """What one worker looks like when the autoscaler asks for one."""

    name: str
    allocatable: Resources
    provisioning_delay_s: float
    price_per_s: float = 0.011


# Paper testbed: Nectar m2.small (1 vCPU / 4 GB).  Allocatable is capacity
# minus kubelet/system reservations — calibrated so that, like on the paper's
# testbed, a service_large (2.359 Gi) + service_small (1 Gi) fill a node.
M2_SMALL = NodeTemplate(
    name="m2.small",
    allocatable=Resources(cpu_m=940, mem_mb=gi(3.5)),
    provisioning_delay_s=50.0,
)

# Nectar siblings (same family as the reference's heterogeneous catalog):
# the policy search's node-template axis — half-size and double-size workers
# at their catalog prices, so the cost objective responds to the mix choice.
M2_TINY = NodeTemplate(
    name="m2.tiny",
    allocatable=Resources(cpu_m=460, mem_mb=gi(1.5)),
    provisioning_delay_s=50.0,
    price_per_s=0.0055,
)

M2_MEDIUM = NodeTemplate(
    name="m2.medium",
    allocatable=Resources(cpu_m=1900, mem_mb=gi(5.5)),
    provisioning_delay_s=50.0,
    price_per_s=0.022,
)

# Fleet adaptation: one TPU v5e host = 4 chips x 16 GB HBM; chip milli-shares
# are the compressible axis, HBM the non-compressible one (DESIGN.md §2).
TPU_V5E_HOST = NodeTemplate(
    name="tpu-v5e-host",
    allocatable=Resources(cpu_m=4000, mem_mb=4 * 16 * 1024),
    provisioning_delay_s=120.0,
)

# Name -> template registry: `ExperimentSpec.template_name` (a picklable
# string — sweep/search cells cross process boundaries) resolves here.
NODE_TEMPLATES = {
    t.name: t for t in (M2_TINY, M2_SMALL, M2_MEDIUM, TPU_V5E_HOST)
}


class CloudAdapter(NodeProvider):
    """NodeProvider + billing wiring, shared by all adapters."""

    def __init__(self, template: NodeTemplate, cost: CostModel,
                 straggler_injector: Optional[object] = None):
        self.template = template
        self.cost = cost
        self.launched = 0
        # repro_torch.core.failures.StragglerInjector (or None): applied to every
        # launched node so a deterministic fraction boots slow.
        self.straggler_injector = straggler_injector

    @abc.abstractmethod
    def _schedule_ready(self, node: Node, ready_at: float) -> None:
        """Backend-specific: deliver the node at `ready_at`."""

    def make_static_node(self, now: float = 0.0) -> Node:
        """A pre-existing (non-autoscaled) worker, READY immediately."""
        node = Node(allocatable=self.template.allocatable,
                    node_type=self.template.name, autoscaled=False,
                    provision_time=now)
        node.mark_ready(now)
        self.cost.on_provision(node, now)
        return node

    def launch_node(self, now: float) -> Node:
        node = Node(allocatable=self.template.allocatable,
                    node_type=self.template.name, autoscaled=True,
                    provision_time=now)
        if self.straggler_injector is not None:
            self.straggler_injector.maybe_slow(node)
        self.cost.on_provision(node, now)
        self.launched += 1
        self._schedule_ready(node, now + self.template.provisioning_delay_s)
        return node

    def terminate_node(self, node: Node, now: float) -> None:
        self.cost.on_deprovision(node, now)


class SimCloudProvider(CloudAdapter):
    """Provisioning-delay model for the discrete-event simulation."""

    def __init__(self, template: NodeTemplate, cost: CostModel,
                 straggler_injector: Optional[object] = None):
        super().__init__(template, cost, straggler_injector)
        self._sim = None

    def attach(self, sim) -> None:
        """Late-bound: the Simulation is constructed after the provider."""
        self._sim = sim

    def _schedule_ready(self, node: Node, ready_at: float) -> None:
        assert self._sim is not None, "SimCloudProvider.attach(sim) first"
        self._sim.schedule_node_ready(node, ready_at)
