from repro_torch.k8s.objects import Deployment, Job, from_manifest, to_pod_spec

__all__ = ["Deployment", "Job", "from_manifest", "to_pod_spec"]
