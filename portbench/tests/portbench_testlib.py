"""Shared pieces of the benchmark's CPU tests: the repository root on
``sys.path`` and a throw-away checkout that holds the benchmark beside
tiny twins of its configurations, a tiny mix and tiny cells."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TINY_DENSE = {"name": "tiny-dense", "source": "tiny twin", "reference": "deepseek",
              "family": "dense", "num_layers": 2, "d_model": 64,
              "num_heads": 4, "num_kv_heads": 4, "d_ff": 128,
              "vocab_size": 512, "rope_theta": 10000.0, "norm_eps": 1e-6,
              "dtype": "float32", "prompt_multiple": 0}
TINY_MOE = {"name": "tiny-moe", "source": "tiny twin", "reference": "deepseek",
            "family": "moe", "num_layers": 3, "d_model": 64, "num_heads": 4,
            "num_kv_heads": 4, "d_ff": 48, "vocab_size": 512,
            "n_experts": 8, "n_shared_experts": 2, "experts_per_token": 2,
            "moe_d_ff": 48, "first_k_dense": 1, "dense_d_ff": 128,
            "capacity_factor": 1.25, "rope_theta": 10000.0,
            "norm_eps": 1e-6, "dtype": "float32", "norm_topk_prob": True,
            "moe_group_tokens": 512, "prompt_multiple": 0}
TINY_MIX = {"arrivals": "poisson",
            "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                       "min": 8, "max": 48},
            "output": {"dist": "uniform", "min": 4, "max": 12}}
# The tiny twins run in float32, where a sound run's served tokens lie
# within 1e-5 of the reference's best logit; the check compares every
# request of a tiny window, offered fast enough to keep the slots busy.
TINY_LIMIT = 1e-3
TINY_KL_LIMIT = 1e-7
TINY_CELL = {"slots": 4, "cache_len": 64, "rate_per_s": 40.0,
             "check": {"requests": 64,
                       "limits": {"max_logit_gap": TINY_LIMIT,
                                  "decode_kl_mean": TINY_KL_LIMIT,
                                  "wrong_length": 0}}}


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


# The real cell each tiny cell reports the metrics of.
TWIN_OF = {"tiny-dense": "dsk7b-docqa", "tiny-moe": "moe16b-docqa"}


def tiny_checkout(tmp: Path) -> Path:
    """A copy of the benchmark under ``tmp`` whose BENCHMARK.json holds
    the real cells and two tiny ones, ``tiny-dense`` and ``tiny-moe``,
    each reporting the metrics of its real twin (``TWIN_OF``)."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in (TINY_DENSE, TINY_MOE):
        name = cfg["name"]
        write_json(tmp / "portbench" / "configs" / f"{name}.json", cfg)
        write_json(tmp / "portbench" / "cells" / f"{name}.json", TINY_CELL)
        spec["configs"].append({"name": name, "source": "tiny twin",
                                "file": f"portbench/configs/{name}.json",
                                "reduced": [], "why": "CPU test"})
        spec["workloads"].append({"name": name, "config": name,
                                  "traffic": "tiny", "chips": 1,
                                  "why": "CPU test"})
        twin = TWIN_OF[name]
        for m in spec["end_to_end"] + spec["per_layer"]:
            if twin in m.get("workloads", ()):
                m["workloads"].append(name)
    write_json(tmp / "portbench" / "traffic" / "tiny.json", TINY_MIX)
    write_json(tmp / "BENCHMARK.json", spec)
    return tmp
