"""launches_per_decode_step: the kernels launched by host ops inside
the profiled decode steps, over the number of those steps."""
from portbench import trace as bench_trace


def read(run):
    trace = run["trace"]
    steps = [s for s in run["spans"] if s["kind"] == "decode" and s["traced"]]
    if trace is None or not steps:
        return None
    count = bench_trace.kernels_in_ranges(trace, "decode_step")
    return count / len(steps) if count else None
