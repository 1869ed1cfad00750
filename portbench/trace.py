"""Reading the device trace of a run's traced sub-window.

``events(prof)`` keeps, from kineto's raw events (building
torch.profiler's event tree takes minutes for 10^5 kernels): every
device event (kernels, copies, fills; not the profiler's annotations)
as ``(name, start_ns, end_ns, linked_correlation)``, the start of each
host op by its correlation id, and the harness's own host ranges
(``portbench.*`` annotations).  The rest reduce those lists.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

RANGE_PREFIX = "portbench."


def events(prof) -> Dict:
    from torch.autograd import DeviceType
    device, op_start, ranges = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation() or name.startswith("ProfilerStep"):
                continue
            device.append((name, start, start + ev.duration_ns(),
                           ev.linked_correlation_id()))
        elif ev.is_user_annotation():
            if name.startswith(RANGE_PREFIX):
                ranges.append((name[len(RANGE_PREFIX):], start,
                               start + ev.duration_ns()))
        elif ev.linked_correlation_id() == 0:
            op_start[ev.correlation_id()] = start
    device.sort(key=lambda e: e[1])
    ranges.sort(key=lambda r: r[1])
    return {"device": device, "op_start": op_start, "ranges": ranges}


def busy_intervals(device: List[Tuple]) -> List[Tuple[int, int]]:
    """The union of the device events' intervals, in order (ns)."""
    out: List[List[int]] = []
    for _, start, end, _ in device:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy_s(device: List[Tuple]) -> float:
    return sum(b - a for a, b in busy_intervals(device)) * 1e-9


def top_ops(device: List[Tuple], n: int = 10) -> List[List]:
    """[name, seconds] of the n device operations with most time."""
    total: Dict[str, int] = {}
    for name, start, end, _ in device:
        total[name] = total.get(name, 0) + end - start
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns * 1e-9] for name, ns in top]


def host_range_at(ranges: List[Tuple], t_ns: int) -> str:
    """The harness's host range that holds ``t_ns``, or 'between calls'."""
    starts = [r[1] for r in ranges]
    i = bisect.bisect_right(starts, t_ns) - 1
    if i >= 0 and t_ns <= ranges[i][2]:
        return ranges[i][0]
    return "between calls"


def idle_gaps(trace: Dict, n: int = 10) -> List[List]:
    """[what the host was doing, seconds] of the n longest gaps between
    device work, each named by the host range in which it began."""
    busy = busy_intervals(trace["device"])
    gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[host_range_at(trace["ranges"], a), (b - a) * 1e-9]
            for a, b in gaps[:n]]


def kernels_in_ranges(trace: Dict, kind: str) -> int:
    """Kernels (not copies or fills) launched by host ops that began
    inside the harness's ranges named ``kind``."""
    ranges = [r for r in trace["ranges"] if r[0] == kind]
    starts = [r[1] for r in ranges]
    count = 0
    for name, _, _, corr in trace["device"]:
        if name.startswith(("Memcpy", "Memset")):
            continue
        t = trace["op_start"].get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][2]:
            count += 1
    return count
