"""ttft_p90_ms: the 90th percentile, over every request due in the
window, of its first token's time less its due time."""
import numpy as np


def read(run):
    vals = [r["first_token"] - r["due"] for r in run["requests"]
            if r["first_token"] is not None]
    return float(np.percentile(vals, 90)) * 1e3 if vals else None
