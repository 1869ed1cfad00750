"""prefill_ms: the harness's clock around each ``admit`` that prefilled
(outside the profiled sub-window): all their time over their count."""


def read(run):
    spans = [s for s in run["spans"]
             if s["kind"] == "prefill" and not s["traced"]]
    if not spans:
        return None
    return sum(s["end"] - s["start"] for s in spans) / len(spans) * 1e3
