"""BENCHMARK.json against the contract's form, and a cell, a
configuration, a traffic mix and a metric added as files and entries
only, found without editing any file."""
import json
import re

import pytest

import portbench_testlib as tl
from portbench import harness, spec

BENCH = json.loads((tl.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_entries_and_names():
    names = set()
    for key, fields in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[key]:
            assert set(e) == fields
            assert NAME.match(e["name"]) and len(e["why"]) <= 200
            names.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_its_files_and_metrics(cell):
    c = spec.load_cell(tl.ROOT, cell)
    assert c.entry["chips"] == 1
    assert c.config["name"] == c.entry["config"]
    assert {m["name"] for m in c.end_to_end} > {"setup_s"}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        if m["name"] != "setup_s":
            assert callable(spec.metric_reader(tl.ROOT, m["name"]))
    limits = c.params["check"]["limits"]
    assert "wrong_length" in limits and limits["wrong_length"] == 0
    assert set(limits) <= {"max_logit_gap", "mean_logit_gap",
                           "decode_kl_mean", "wrong_length"}
    assert len(limits) >= 2
    harness.arch_config(c.config)          # the program takes the file


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_reduced_keys_are_keys_of_the_config_file(entry):
    cfg = json.loads((tl.ROOT / entry["file"]).read_text())
    assert all(NAME.match(k) and k in cfg for k in entry["reduced"])


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_new_files_are_found_without_editing(tmp_path):
    root = tl.tiny_checkout(tmp_path)
    bench = root / "portbench"
    tl.write_json(bench / "configs" / "tiny-new.json",
                  dict(tl.TINY_DENSE, name="tiny-new", num_layers=3))
    tl.write_json(bench / "traffic" / "tiny-long.json",
                  dict(tl.TINY_MIX, output={"dist": "uniform", "min": 9,
                                             "max": 9}))
    tl.write_json(bench / "cells" / "tiny-new-long.json", tl.TINY_CELL)
    (bench / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return len(run['requests']) + 0.5\n")
    spec_json = json.loads((root / "BENCHMARK.json").read_text())
    spec_json["configs"].append({"name": "tiny-new", "source": "tiny twin",
                                 "file": "portbench/configs/tiny-new.json",
                                 "reduced": [], "why": "test"})
    spec_json["workloads"].append({"name": "tiny-new-long",
                                   "config": "tiny-new",
                                   "traffic": "tiny-long", "chips": 1,
                                   "why": "test"})
    spec_json["per_layer"].append({"name": "new_metric", "unit": "requests",
                                   "better": "higher",
                                   "source": "program_counter",
                                   "layer": "engine",
                                   "moves": "tpot_p90_ms",
                                   "workloads": ["tiny-new-long"]})
    tl.write_json(root / "BENCHMARK.json", spec_json)
    cell = spec.load_cell(root, "tiny-new-long")
    assert cell.config["num_layers"] == 3
    assert cell.traffic["output"] == {"dist": "uniform", "min": 9, "max": 9}
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    reqs = harness.offered(cell, 5, 2.0)
    assert {r.max_new_tokens for r in reqs} == {9}
    record = {"requests": [{}] * 4}
    assert harness.read_metrics(cell, record, cell.per_layer) == \
        {"new_metric": {"value": 4.5, "unit": "requests"}}
    # the other cells do not report it
    assert "new_metric" not in [m["name"] for m in
                                spec.load_cell(root, "tiny-dense").per_layer]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell(tl.ROOT, "no-such-cell")
