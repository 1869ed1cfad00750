"""Minimal in-process Kubernetes object model (paper §5.1).

Long-running services are *Deployments* (single replica in the paper's
initial scope) whose pod template may carry the ``rescheduling: moveable``
label; batch jobs are *Jobs* labelled ``type: batch``.  CPU/memory requests
must equal limits (guaranteed QoS class).  `from_manifest` accepts the
dict-form of the paper's Fig. 3/4 YAML files and yields `PodSpec`s for the
orchestrator.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

from repro_torch.core.pods import PodKind, PodSpec
from repro_torch.core.resources import Resources


def parse_cpu(s: str) -> int:
    """'100m' -> 100; '1' -> 1000 (millicores)."""
    s = str(s).strip()
    if s.endswith("m"):
        return int(s[:-1])
    return int(float(s) * 1000)


def parse_mem(s: str) -> float:
    """'1.4Gi' -> MB; '512Mi' -> MB."""
    s = str(s).strip()
    m = re.fullmatch(r"([\d.]+)(Gi|Mi|G|M)?", s)
    if not m:
        raise ValueError(f"bad memory quantity {s!r}")
    val = float(m.group(1))
    unit = m.group(2) or "Mi"
    return val * (1024.0 if unit in ("Gi", "G") else 1.0)


@dataclasses.dataclass(frozen=True)
class Deployment:
    name: str
    cpu: str
    memory: str
    moveable: bool = False
    scheduler_name: str = "customScheduler"

    def pod_spec(self) -> PodSpec:
        return PodSpec(self.name, PodKind.SERVICE,
                       Resources(parse_cpu(self.cpu), parse_mem(self.memory)),
                       moveable=self.moveable,
                       scheduler_name=self.scheduler_name)


@dataclasses.dataclass(frozen=True)
class Job:
    name: str
    cpu: str
    memory: str
    duration_s: float
    checkpointable: bool = False
    scheduler_name: str = "customScheduler"

    def pod_spec(self) -> PodSpec:
        return PodSpec(self.name, PodKind.BATCH,
                       Resources(parse_cpu(self.cpu), parse_mem(self.memory)),
                       duration_s=self.duration_s,
                       checkpointable=self.checkpointable,
                       scheduler_name=self.scheduler_name)


def to_pod_spec(obj) -> PodSpec:
    return obj.pod_spec()


def from_manifest(manifest: Dict) -> PodSpec:
    """Dict form of the paper's YAML (Fig. 3 deployment / Fig. 4 job)."""
    kind = manifest.get("kind", "")
    tmpl = manifest["spec"]["template"]
    meta = tmpl.get("metadata", {})
    labels = meta.get("labels", {})
    spec = tmpl["spec"] if "spec" in tmpl else tmpl
    container = spec["containers"][0]
    req = container["resources"]["requests"]
    lim = container["resources"].get("limits", req)
    if req != lim:
        raise ValueError("requests must equal limits (guaranteed QoS, §5.1)")
    cpu, mem = parse_cpu(req["cpu"]), parse_mem(req["memory"])
    name = manifest.get("metadata", {}).get("generateName",
                                            container.get("name", "pod"))
    name = name.rstrip("-")
    if kind == "Deployment":
        moveable = labels.get("rescheduling") == "moveable"
        return PodSpec(name, PodKind.SERVICE, Resources(cpu, mem),
                       moveable=moveable,
                       scheduler_name=spec.get("schedulerName",
                                               "customScheduler"))
    if kind == "Job":
        if labels.get("type") != "batch":
            raise ValueError("paper §5.1: jobs must be labelled type=batch")
        return PodSpec(name, PodKind.BATCH, Resources(cpu, mem),
                       duration_s=float(manifest.get("x-duration-s", 300.0)),
                       scheduler_name=spec.get("schedulerName",
                                               "customScheduler"))
    raise ValueError(f"unsupported kind {kind!r}")
