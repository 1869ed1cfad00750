"""Heterogeneous VM types (paper §8, implemented as a beyond-paper feature).

The paper assumes homogeneous workers and names heterogeneity as its first
future direction: "considering heterogeneous VMs could lead to a more
efficient use of resources and decreased cost."  This module provides:

* `InstanceCatalog` — priced VM/slice templates (cpu, mem, $/s);
* `HeterogeneousBindingAutoscaler` — the paper's binding autoscaler
  (Alg. 7 association semantics) that, on launch, picks the template with
  the lowest $/s among those that fit the triggering pod *and* best matches
  its shape (smallest feasible — bin-packing's "tight bin" intuition at
  provisioning time);
* pricing flows through `CostModel.price_table` so Fig.-3-style cost
  accounting just works.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.autoscaler import BindingAutoscaler, NodeProvider
from repro_torch.core.cluster import Cluster, Node
from repro_torch.core.cost import CostModel
from repro_torch.core.pods import Pod
from repro_torch.core.resources import Resources


@dataclasses.dataclass(frozen=True)
class InstanceType:
    name: str
    allocatable: Resources
    price_per_s: float
    provisioning_delay_s: float = 50.0


@dataclasses.dataclass
class InstanceCatalog:
    types: Tuple[InstanceType, ...]

    def price_table(self) -> Dict[str, float]:
        return {t.name: t.price_per_s for t in self.types}

    def type_by_name(self, name: str) -> Optional[InstanceType]:
        return next((t for t in self.types if t.name == name), None)

    def cheapest_fitting(self, req: Resources) -> Optional[InstanceType]:
        feasible = [t for t in self.types if req.fits_in(t.allocatable)]
        if not feasible:
            return None
        # lowest price first; tie-break on smallest capacity (tightest bin)
        return min(feasible, key=lambda t: (t.price_per_s,
                                            t.allocatable.mem_mb))


# The paper's testbed family, extended with two plausible Nectar siblings.
NECTAR_CATALOG = InstanceCatalog(types=(
    InstanceType("m2.tiny", Resources(460, 1.5 * 1024), 0.0055),
    InstanceType("m2.small", Resources(940, 3.5 * 1024), 0.011),
    InstanceType("m2.medium", Resources(1900, 5.5 * 1024), 0.022),
))


class HeterogeneousProvider(NodeProvider):
    """Sim provider that launches a *specific* instance type."""

    def __init__(self, catalog: InstanceCatalog, cost: CostModel):
        self.catalog = catalog
        self.cost = cost
        cost.price_table.update(catalog.price_table())
        self._sim = None
        self.launched_types: List[str] = []

    def attach(self, sim) -> None:
        self._sim = sim

    def make_static_node(self, itype: InstanceType, now: float = 0.0) -> Node:
        node = Node(allocatable=itype.allocatable, node_type=itype.name,
                    autoscaled=False, provision_time=now)
        node.mark_ready(now)
        self.cost.on_provision(node, now)
        return node

    def launch_node(self, now: float,
                    itype: Optional[InstanceType] = None) -> Node:
        itype = itype or self.catalog.types[-1]
        node = Node(allocatable=itype.allocatable, node_type=itype.name,
                    autoscaled=True, provision_time=now)
        self.cost.on_provision(node, now)
        self.launched_types.append(itype.name)
        assert self._sim is not None, "attach(sim) first"
        self._sim.schedule_node_ready(node, now + itype.provisioning_delay_s)
        return node

    def terminate_node(self, node: Node, now: float) -> None:
        self.cost.on_deprovision(node, now)


class HeterogeneousBindingAutoscaler(BindingAutoscaler):
    """Alg. 7 with a per-launch instance-type decision (paper §4.2: "the
    autoscaler can then decide the number and *type* of VMs to launch")."""

    name = "binding-hetero"

    def __init__(self, provider: HeterogeneousProvider):
        super().__init__(provider)
        self.catalog = provider.catalog

    def scale_out(self, cluster: Cluster, pod: Pod, now: float) -> None:
        if pod.uid in self._pod_to_node:
            return
        for tracker in sorted(self._tracked.values(),
                              key=lambda t: t.node.node_id):
            if pod.requests.fits_in(tracker.planned_free):
                tracker.assigned[pod.uid] = pod.requests
                self._pod_to_node[pod.uid] = tracker.node.node_id
                return
        itype = self.catalog.cheapest_fitting(pod.requests)
        if itype is None:
            return   # no instance type can ever host this pod
        node = self.provider.launch_node(now, itype)
        cluster.add_node(node)
        from repro_torch.core.autoscaler import _ProvisioningTracker
        self._tracked[node.node_id] = _ProvisioningTracker(
            node=node, assigned={pod.uid: pod.requests})
        self._pod_to_node[pod.uid] = node.node_id

    def _launch_replacement(self, node: Node, now: float) -> Node:
        """Replace a reclaimed spot node with its own instance type (the
        workload that fit there fits its twin); unknown types fall back to
        the provider's default (largest) template."""
        return self.provider.launch_node(
            now, self.catalog.type_by_name(node.node_type))
