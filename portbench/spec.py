"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; its own parameters (slots, cache length, offered rate, the
correctness check's sample and limits) sit in ``cells/<cell>.json``, the
configuration in the file its ``configs`` entry names, the mix in
``traffic/<traffic>.json``, and each per-layer metric's reader in
``metrics/<metric>.py``.  Nothing here knows any cell, configuration,
mix or metric by name.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    root: Path                 # the checkout's root
    entry: dict                # the cell's entry of ``workloads``
    params: dict               # cells/<cell>.json
    config: dict               # the configuration's file
    traffic: dict              # traffic/<traffic>.json
    end_to_end: List[dict]     # the end-to-end metrics this cell reports
    per_layer: List[dict]      # the per-layer metrics this cell reports


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    spec = _read(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "portbench"
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _reports(m, name) and m["moves"] in moved]
    return Cell(name=name, root=root, entry=entry,
                params=_read(bench / "cells" / f"{name}.json"),
                config=_read(root / configs[entry["config"]]["file"]),
                traffic=_read(bench / "traffic" / f"{entry['traffic']}.json"),
                end_to_end=e2e, per_layer=layer)


def metric_reader(root: Path, name: str) -> Callable[[dict], object]:
    """``read(run)`` of ``portbench/metrics/<name>.py``: the metric's
    value from the run's record, or None where the run holds nothing
    for it to read."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def peaks() -> Dict[str, float]:
    """The card's published peaks (``peaks.json``)."""
    return _read(BENCH_DIR / "peaks.json")
