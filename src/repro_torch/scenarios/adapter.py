"""External-trace adapter: Borg/Alibaba-style task CSVs → TraceStore.

Cluster traces in the wild (Google Borg ``task_events``, Alibaba
``batch_task``) reduce to rows of *(arrival time, cpu request, memory
request, duration)* with resources normalized to machine capacity.  The
adapter ingests that shape and **rescales** it onto a target
:class:`repro_torch.cloud.adapter.NodeTemplate`:

* fractional cpu/mem (``[0, 1]`` of one machine) multiply out to the
  template's allocatable ``cpu_m`` / ``mem_mb`` (absolute units pass
  through via ``cpu_scale``/``mem_scale``);
* requests are **quantized** to a grid (``cpu_quant_m``, ``mem_quant_mb``)
  and clipped to ``[1 quantum, fraction_cap × allocatable]`` — the
  distinct quantized (cpu, mem) pairs become the trace's interned template
  table, keeping it bounded no matter how many rows the CSV has;
* durations land in the per-row ``duration_s`` column (0 for service
  rows), so big-data-style heavy tails survive ingestion exactly.

Parsing is vectorized: ``np.loadtxt`` over the selected columns, one
``np.unique`` for the template table — no per-row Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.pods import PodKind, PodSpec
from repro_torch.core.resources import Resources
from repro_torch.scenarios.trace import TraceStore


@dataclasses.dataclass
class CsvTraceSpec:
    """Column layout + rescaling rules for one external CSV.

    ``columns`` gives the 0-based indices of (arrival_time, cpu, mem,
    duration) in each row; ``cpu_is_fraction``/``mem_is_fraction`` say
    whether requests are machine fractions (Borg/Alibaba normalized form)
    or absolute ``cpu_m``/``mem_mb`` values."""

    columns: Sequence[int] = (0, 1, 2, 3)
    delimiter: str = ","
    skip_header: int = 0
    cpu_is_fraction: bool = True
    mem_is_fraction: bool = True
    cpu_scale: float = 1.0           # absolute-unit multiplier when not fractional
    mem_scale: float = 1.0
    cpu_quant_m: int = 50            # request quantization grid
    mem_quant_mb: float = 64.0
    fraction_cap: float = 1.0        # clip requests to this node fraction
    batch_kind: bool = True          # rows are run-to-completion tasks


def load_csv_trace(path, template=None, spec: Optional[CsvTraceSpec] = None,
                   name: str = "external") -> TraceStore:
    """Ingest an external task CSV into a :class:`TraceStore`.

    ``template`` is the target :class:`repro_torch.cloud.adapter.NodeTemplate`
    (default ``M2_SMALL``) the normalized resources are rescaled against —
    the same template the experiment will provision nodes from, so a trace
    recorded on 64-core machines replays sensibly on 1-vCPU workers."""
    from repro_torch.cloud.adapter import M2_SMALL
    template = template or M2_SMALL
    spec = spec or CsvTraceSpec()

    raw = np.loadtxt(path, delimiter=spec.delimiter,
                     skiprows=spec.skip_header,
                     usecols=tuple(spec.columns), ndmin=2, dtype=np.float64)
    if raw.size == 0:
        return TraceStore([], [], [], name=name)
    times, cpu, mem, dur = raw[:, 0], raw[:, 1], raw[:, 2], raw[:, 3]

    alloc = template.allocatable
    cpu_m = cpu * alloc.cpu_m if spec.cpu_is_fraction else cpu * spec.cpu_scale
    mem_mb = (mem * alloc.mem_mb if spec.mem_is_fraction
              else mem * spec.mem_scale)
    # Quantize to the grid, clip into (0, fraction_cap × allocatable].
    qc, qm = spec.cpu_quant_m, spec.mem_quant_mb
    cpu_m = np.clip(np.round(cpu_m / qc) * qc, qc,
                    np.floor(spec.fraction_cap * alloc.cpu_m / qc) * qc)
    mem_mb = np.clip(np.round(mem_mb / qm) * qm, qm,
                     np.floor(spec.fraction_cap * alloc.mem_mb / qm) * qm)

    pairs = np.stack([cpu_m, mem_mb], axis=1)
    uniq, tid = np.unique(pairs, axis=0, return_inverse=True)
    kind = PodKind.BATCH if spec.batch_kind else PodKind.SERVICE
    templates = [
        PodSpec(f"ext-{int(c)}m-{int(m)}mb", kind,
                Resources(int(c), float(m)),
                duration_s=0.0,
                moveable=not spec.batch_kind)
        for c, m in uniq.tolist()]
    dur = np.clip(dur, 0.0, None) if spec.batch_kind else np.zeros_like(dur)
    return TraceStore(templates, tid.astype(np.int32), times,
                      duration_s=dur, name=name)
