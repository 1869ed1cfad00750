"""Node templates, the simulated cloud provider and the live in-process
provider (``repro.cloud``)."""
from repro_torch.cloud.adapter import (CloudAdapter, NodeTemplate,
                                       SimCloudProvider, M2_SMALL,
                                       TPU_V5E_HOST)
from repro_torch.cloud.local_provider import (LiveCluster, LiveJob,
                                              LocalCloudProvider)

__all__ = ["CloudAdapter", "NodeTemplate", "SimCloudProvider", "M2_SMALL",
           "TPU_V5E_HOST", "LiveCluster", "LiveJob", "LocalCloudProvider"]
