"""prefill_mfu: the operations the window's prefills need (the frozen
count of ``counters.prefill_flops``) over their time on the harness's
clock (outside the profiled sub-window), as a share of the card's bf16
peak."""
from portbench import counters


def read(run):
    spans = [s for s in run["spans"]
             if s["kind"] == "prefill" and not s["traced"]]
    secs = sum(s["end"] - s["start"] for s in spans)
    if not spans or secs <= 0:
        return None
    ops = sum(counters.prefill_flops(run["config"], s["info"]["tokens"])
              for s in spans)
    return ops / secs / run["peaks"]["bf16_flop_per_s"] * 100
