"""device_idle_share: the share of the profiled sub-window in which no
operation ran on the card (one less the union of the device events'
intervals over the sub-window's length)."""
from portbench import trace as bench_trace


def read(run):
    trace = run["trace"]
    if trace is None or not trace["device"]:
        return None
    return (1 - bench_trace.busy_s(trace["device"]) / trace["window_s"]) * 100
