"""Node templates: what one worker offers and what it costs.

A copy of the templates in ``repro/cloud/adapter.py`` (data only; the
provider classes belong to the serial simulator, which is not ported).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.workload import Resources, gi


@dataclasses.dataclass(frozen=True)
class NodeTemplate:
    """What one worker looks like when the autoscaler asks for one."""

    name: str
    allocatable: Resources
    provisioning_delay_s: float
    price_per_s: float = 0.011


# Paper testbed: Nectar m2.small (1 vCPU / 4 GB) minus kubelet reservations.
M2_SMALL = NodeTemplate(
    name="m2.small",
    allocatable=Resources(cpu_m=940, mem_mb=gi(3.5)),
    provisioning_delay_s=50.0,
)

# Half-size and double-size Nectar siblings (the policy search's axis).
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

# Fleet adaptation: one TPU v5e host = 4 chips x 16 GB HBM.
TPU_V5E_HOST = NodeTemplate(
    name="tpu-v5e-host",
    allocatable=Resources(cpu_m=4000, mem_mb=4 * 16 * 1024),
    provisioning_delay_s=120.0,
)

NODE_TEMPLATES = {
    t.name: t for t in (M2_TINY, M2_SMALL, M2_MEDIUM, TPU_V5E_HOST)
}
