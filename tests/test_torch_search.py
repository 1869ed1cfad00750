"""PyTorch port, the policy search (``repro_torch.search``: ``nsga2``,
``paramspace``, ``report``) against the reference's, on the CPU.

* ``tests/data/golden_search.json`` (the reference's seeded micro-search:
  front, history, evaluations) reproduced by the port's ``run_search`` on
  both engines;
* the seeded cases of ``tests/test_search_properties.py``, port against
  reference: the non-dominated sort, crowding distance, SBX crossover,
  mutation, encode/decode and ``predictive_space`` draw the same numbers
  from the same generator;
* a pool of 2 and ``workers="lanes"`` against the serial search;
* ``build_report`` / ``summarize`` against the reference's.

Every float is compared ``==``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import repro.search as RS
from repro.search import paramspace as ref_paramspace
from repro.search import report as ref_report

import repro_torch.search as PS
from repro_torch.search import paramspace as port_paramspace
from repro_torch.search import report as port_report

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "data", "golden_search.json")

# The pinned micro-search of tests/test_golden_search.py.
SCENARIOS = ("diurnal", "heavy-tail")
SETTINGS = dict(generations=2, pop_size=6, seed=7, n_jobs=40)
_ROW_KEYS = ("completed", "infeasible", "cost", "mean_pending_s",
             "avg_ram_ratio", "evictions", "scale_outs", "scale_ins",
             "max_nodes")


def _doc(res):
    """A ``SearchResult`` in the fixture's layout, JSON round-tripped."""
    return json.loads(json.dumps({
        "scenarios": list(res.scenarios),
        "settings": dict(SETTINGS),
        "evaluations": res.evaluations,
        "history": res.history,
        "front": [{
            "vector": list(ind.vector),
            "config": ind.config,
            "objectives": list(ind.objectives),
            "per_scenario": {sc: {k: row[k] for k in _ROW_KEYS}
                             for sc, row in ind.per_scenario.items()},
        } for ind in res.front],
    }))


def _search(workers=1, engine=None):
    return PS.run_search(PS.default_space(), SCENARIOS, workers=workers,
                         engine=engine, **SETTINGS)


@pytest.fixture(scope="module")
def serial():
    return _search()


@pytest.mark.parametrize("engine", ["array", "object"])
def test_search_equals_golden_fixture(engine, serial):
    with open(GOLDEN) as f:
        want = json.load(f)
    res = serial if engine == "array" else _search(engine=engine)
    got = _doc(res)
    for key in want:
        assert got[key] == want[key], (engine, key)
    assert got == want
    assert got["front"] and got["evaluations"] > SETTINGS["pop_size"]


def _population(res):
    return [(ind.vector, ind.objectives) for ind in res.population]


def test_pool_of_two_equals_serial(serial):
    pooled = _search(workers=2)
    assert _doc(pooled) == _doc(serial)
    assert _population(pooled) == _population(serial)


def test_lanes_equals_serial(serial):
    """No default-space cell is lane-eligible (weighted scorer with an
    autoscaler), so every cell runs serially in place, and no device is
    resolved: this runs on the CPU without ``device``."""
    lanes = _search(workers="lanes")
    assert _doc(lanes) == _doc(serial)
    assert _population(lanes) == _population(serial)


def _objective_sets(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(50):
        n, m = int(rng.integers(1, 25)), int(rng.integers(1, 4))
        objs = [tuple(float(x) for x in rng.integers(0, 6, size=m))
                for _ in range(n)]
        for i in range(1, n):
            if rng.random() < 0.3:
                objs[i] = objs[int(rng.integers(i))]
        out.append(objs)
    return out


def test_sort_and_crowding_equal_reference():
    cases = _objective_sets(0) + [[(3.0, 3.0)] * 5, [(1.0, 2.0)],
                                  [(0.0, 3.0), (1.0, 2.0), (2.0, 1.0),
                                   (3.0, 0.0)]]
    for objs in cases:
        fronts = PS.fast_non_dominated_sort(objs)
        assert fronts == RS.fast_non_dominated_sort(objs)
        for front in fronts:
            assert (PS.crowding_distance(objs, front)
                    == RS.crowding_distance(objs, front))
        for a in objs[:5]:
            for b in objs[:5]:
                assert PS.dominates(a, b) == RS.dominates(a, b)


@pytest.mark.parametrize("space_fn", ["default_space", "predictive_space"])
def test_variation_operators_equal_reference(space_fn):
    """SBX and mutation from one seeded generator: children and the
    generator's position after each step equal the reference's."""
    ps, rs = getattr(PS, space_fn)(), getattr(RS, space_fn)()
    assert ps.bounds() == rs.bounds()
    assert [p.name for p in ps.params] == [p.name for p in rs.params]
    prng, rrng = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(200):
        pv1, rv1 = ps.encode(ps.sample(prng)), rs.encode(rs.sample(rrng))
        pv2, rv2 = ps.encode(ps.sample(prng)), rs.encode(rs.sample(rrng))
        assert (pv1, pv2) == (rv1, rv2)
        pc = PS.sbx_crossover(prng, pv1, pv2, ps)
        rc = RS.sbx_crossover(rrng, rv1, rv2, rs)
        assert pc == rc
        for p_child, r_child in zip(pc, rc):
            pm = PS.mutate(prng, p_child, ps, prob=0.8)
            rm = RS.mutate(rrng, r_child, rs, prob=0.8)
            assert pm == rm
            assert ps.encode(ps.decode(pm)) == rs.encode(rs.decode(rm))
    assert prng.bit_generator.state == rrng.bit_generator.state


def test_encode_decode_and_cells_equal_reference():
    ps, rs = PS.default_space(), RS.default_space()
    prng, rrng = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(200):
        pcfg, rcfg = ps.sample(prng), rs.sample(rrng)
        assert pcfg == rcfg
        vec = ps.encode(pcfg)
        assert vec == rs.encode(rcfg)
        assert ps.decode(vec) == pcfg
    assert PS.PAPER_DEFAULT_CONFIG == RS.PAPER_DEFAULT_CONFIG
    assert (ps.decode(ps.encode(PS.PAPER_DEFAULT_CONFIG))
            == PS.PAPER_DEFAULT_CONFIG)
    cfg = dict(PS.PAPER_DEFAULT_CONFIG, w_pack=0.0)   # the zero-weight corner
    for chaos in (False, True):
        got = PS.to_cell_spec(cfg, "diurnal", seed=3, n_jobs=20, chaos=chaos)
        want = RS.to_cell_spec(cfg, "diurnal", seed=3, n_jobs=20, chaos=chaos)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    pcfg = PS.predictive_space().sample(np.random.default_rng(5))
    rcfg = RS.predictive_space().sample(np.random.default_rng(5))
    assert pcfg == rcfg
    assert (dataclasses.asdict(PS.to_cell_spec(pcfg, "flash-crowd"))
            == dataclasses.asdict(RS.to_cell_spec(rcfg, "flash-crowd")))


def test_validation_rejects_like_reference():
    bad = [dict(PS.PAPER_DEFAULT_CONFIG, w_pack=1.5),
           dict(PS.PAPER_DEFAULT_CONFIG, rescheduler="mystery"),
           {k: v for k, v in PS.PAPER_DEFAULT_CONFIG.items()
            if k != "w_bal"},
           dict(PS.PAPER_DEFAULT_CONFIG, extra_knob=1.0),
           dict(PS.PAPER_DEFAULT_CONFIG, w_pack=1)]
    for cfg in bad:
        errors = []
        for space in (PS.default_space(), RS.default_space()):
            with pytest.raises((ValueError, TypeError)) as exc:
                space.validate(cfg)
            errors.append((type(exc.value), str(exc.value)))
        assert errors[0] == errors[1]
    for pkg in (port_paramspace, ref_paramspace):
        with pytest.raises(ValueError):
            pkg.ParamSpace((pkg.FloatParam("x", 0.0, 1.0),
                            pkg.FloatParam("x", 0.0, 2.0)))
        with pytest.raises(ValueError):
            pkg.FloatParam("y", 1.0, 1.0)
        with pytest.raises(ValueError):
            pkg.ChoiceParam("z", ("a", "a"))
    with pytest.raises(KeyError, match="unknown objective"):
        PS.run_search(PS.default_space(), SCENARIOS, objectives=("speed",))
    with pytest.raises(ValueError, match="pop_size"):
        PS.run_search(PS.default_space(), SCENARIOS, pop_size=1)


def test_report_and_summary_equal_reference(serial):
    want_res = RS.run_search(RS.default_space(), SCENARIOS, workers=1,
                             **SETTINGS)
    kw = dict(seed=SETTINGS["seed"], n_jobs=SETTINGS["n_jobs"])
    want_base = RS.baseline_rows(SCENARIOS, **kw)
    got_base = PS.baseline_rows(SCENARIOS, **kw)
    for sc in SCENARIOS:
        a, b = dict(got_base[sc]), dict(want_base[sc])
        a.pop("wall_s"), b.pop("wall_s")
        assert a == b, sc
    want = RS.build_report(want_res, want_base)
    got = PS.build_report(serial, got_base)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert PS.summarize(got) == RS.summarize(want)
    assert PS.summarize(got)[0].startswith("Pareto front:")
    chaos_cells = port_report.baseline_cells(SCENARIOS, chaos=True)
    assert [dataclasses.asdict(c) for c in chaos_cells] == [
        dataclasses.asdict(c)
        for c in ref_report.baseline_cells(SCENARIOS, chaos=True)]
