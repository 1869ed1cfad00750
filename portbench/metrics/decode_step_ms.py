"""decode_step_ms: the harness's clock around each ``step`` that
decoded (outside the profiled sub-window): all their time over their
count."""


def read(run):
    spans = [s for s in run["spans"]
             if s["kind"] == "decode" and not s["traced"]]
    if not spans:
        return None
    return sum(s["end"] - s["start"] for s in spans) / len(spans) * 1e3
