"""tpot_p90_ms: the 90th percentile, over every request due in the
window, of its whole decode's time per token after the first, so a
stall anywhere in a request's decode shows."""
import numpy as np


def read(run):
    vals = [(r["done"] - r["first_token"]) / (r["tokens"] - 1)
            for r in run["requests"]
            if r["done"] is not None and r["tokens"] > 1]
    return float(np.percentile(vals, 90)) * 1e3 if vals else None
