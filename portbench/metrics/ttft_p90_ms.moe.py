"""ttft_p90_ms.moe: ``ttft_p90_ms`` in a cell whose time to first token
spreads too widely from run to run to be held to a bound (the MoE
cell).  Every prefill stops every slot's decode, so in an open loop the
time to first token and each request's decode time share one queue: it
moves ``tpot_p90_ms`` there.

Per-layer metrics are read from a traced run, and the profiler holds up
every request that waits while it runs and stops; below the knee the
queue it leaves takes many seconds to drain.  So this reads the
requests due more than ``MARGIN_S`` before the first traced span began
(the sub-window opens late, ``harness.TRACE_AT``): a set fixed by due
times, not by how long each waited.  In a run without a trace it reads
every request, as ``ttft_p90_ms`` does."""
import numpy as np

MARGIN_S = 1.0


def before_the_trace(run):
    reqs = [r for r in run["requests"] if r["first_token"] is not None]
    traced = [s["start"] for s in run["spans"] if s["traced"]]
    if not traced:
        return reqs
    on = min(traced)
    return [r for r in reqs if r["due"] < on - MARGIN_S]


def read(run):
    vals = [r["first_token"] - r["due"] for r in before_the_trace(run)]
    return float(np.percentile(vals, 90)) * 1e3 if vals else None
