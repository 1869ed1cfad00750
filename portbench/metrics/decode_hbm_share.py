"""decode_hbm_share: the bytes the window's dense decode steps need
(``counters.dense_decode_bytes``: the weights once, the occupied KV
positions read, the new ones written) over their time on the harness's
clock (outside the profiled sub-window), as a share of the card's
bandwidth.  Nothing for a MoE model: the bytes it needs depend on its
routing, which nothing counts yet."""
from portbench import counters


def read(run):
    if run["config"].get("n_experts"):
        return None
    spans = [s for s in run["spans"]
             if s["kind"] == "decode" and not s["traced"]]
    secs = sum(s["end"] - s["start"] for s in spans)
    if not spans or secs <= 0:
        return None
    need = sum(counters.dense_decode_bytes(run["config"], s["info"]["active"],
                                           s["info"]["kv_positions"])
               for s in spans)
    return need / secs / run["peaks"]["hbm_byte_per_s"] * 100
