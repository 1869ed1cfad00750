"""The metric readers on synthetic runs: a stall moves both tails, and
the trace's readers count what they claim."""
import copy

import pytest

import portbench_testlib as tl
from portbench import counters, spec, trace

PEAKS = {"bf16_flop_per_s": 989e12, "hbm_byte_per_s": 3.35e12}


def read(name, run):
    return spec.metric_reader(tl.ROOT, name)(run)


def steady_run():
    """100 requests due every 0.5 s, each first token 0.1 s after its due
    time and 100 tokens 0.1 s apart."""
    reqs = [{"due": 0.5 * i, "prompt_tokens": 1000, "tokens": 100,
             "first_token": 0.5 * i + 0.1, "done": 0.5 * i + 0.1 + 9.9}
            for i in range(100)]
    return {"requests": reqs, "spans": [], "trace": None,
            "config": dict(tl.TINY_DENSE), "peaks": PEAKS}


def stalled(run, at: float, by: float):
    """Every program event after ``at`` seconds happens ``by`` later; the
    requests stay due when they were."""
    out = copy.deepcopy(run)
    for r in out["requests"]:
        for key in ("first_token", "done"):
            if r[key] > at:
                r[key] += by
    return out


@pytest.mark.parametrize("name", ["ttft_p90_ms", "tpot_p90_ms"])
def test_a_stall_moves_both_tails(name):
    run = steady_run()
    before = read(name, run)
    after = read(name, stalled(run, at=25.0, by=2.0))
    assert after > before * 1.2
    assert read(name, stalled(run, at=1000.0, by=2.0)) == before


@pytest.mark.parametrize("name", ["ttft_p90_ms", "prefill_ms",
                                  "prefill_mfu", "flash_roofline"])
def test_a_moe_cell_split_reads_as_its_original(name):
    run = stalled(steady_run(), at=25.0, by=2.0)
    run["spans"] = [span("prefill", 0.0, 0.2, {"tokens": 40}),
                    span("prefill", 1.0, 1.5, {"tokens": 40})]
    assert spec.metric_reader(tl.ROOT, name + ".moe") is not None
    assert read(name + ".moe", run) == read(name, run)


def test_moe_ttft_reads_the_requests_due_before_the_trace():
    run = steady_run()
    # profiled steps from 20 s to 30 s; every request due from 19.5 s on
    # waits at least until 33.5 s, as a queue the profiler left drains
    for r in run["requests"]:
        if r["due"] >= 19.5:
            r["first_token"] = max(r["first_token"], 33.5 + r["due"] / 100)
    run["spans"] = [span("decode", 20.0 + i, 20.5 + i, {}, traced=True)
                    for i in range(10)]
    run["spans"] += [span("decode", t, t + 0.1, {}) for t in (33.0, 34.0)]
    assert read("ttft_p90_ms", run) > 1000.0
    assert read("ttft_p90_ms.moe", run) == pytest.approx(100.0)
    run["spans"] = []
    assert read("ttft_p90_ms.moe", run) == read("ttft_p90_ms", run)


def test_steady_tails():
    run = steady_run()
    assert read("ttft_p90_ms", run) == pytest.approx(100.0)
    assert read("tpot_p90_ms", run) == pytest.approx(100.0)


def span(kind, start, end, info, traced=False):
    return {"kind": kind, "start": start, "end": end, "info": info,
            "traced": traced}


def test_host_clock_readers_skip_the_traced_spans():
    run = steady_run()
    run["config"] = dict(tl.TINY_DENSE)
    run["spans"] = [span("prefill", 0.0, 0.2, {"tokens": 40}),
                    span("prefill", 1.0, 1.4, {"tokens": 40}),
                    span("prefill", 2.0, 9.0, {"tokens": 40}, traced=True),
                    span("decode", 3.0, 3.01, {"active": 2,
                                               "kv_positions": 100}),
                    span("decode", 4.0, 4.03, {"active": 2,
                                               "kv_positions": 100}),
                    span("decode", 5.0, 6.0, {"active": 2,
                                              "kv_positions": 100}, True)]
    assert read("prefill_ms", run) == pytest.approx(300.0)
    assert read("decode_step_ms", run) == pytest.approx(20.0)
    ops = 2 * counters.prefill_flops(tl.TINY_DENSE, 40)
    assert read("prefill_mfu", run) == pytest.approx(ops / 0.6 / 989e12 * 100)
    need = 2 * counters.dense_decode_bytes(tl.TINY_DENSE, 2, 100)
    assert read("decode_hbm_share", run) == pytest.approx(
        need / 0.04 / 3.35e12 * 100)
    run["config"] = dict(tl.TINY_MOE)
    assert read("decode_hbm_share", run) is None
    run["spans"] = []
    assert read("prefill_ms", run) is None
    assert read("prefill_mfu", run) is None


def traced_run(flash_launches=2):
    s = 10 ** 9
    run = steady_run()
    run["spans"] = [span("prefill", 0.1, 0.2, {"tokens": 100}, True),
                    span("decode", 0.3, 0.4, {"active": 1,
                                              "kv_positions": 101}, True),
                    span("decode", 2.0, 2.1, {"active": 1,
                                              "kv_positions": 102}, True)]
    run["trace"] = {
        "window_s": 4.0, "flash_launches": flash_launches,
        "ranges": [("prefill", 0, s // 10), ("decode_step", s, 2 * s),
                   ("decode_step", 3 * s, 4 * s)],
        "op_start": {1: s // 20, 2: s + 5, 3: 3 * s + 5, 4: 3 * s + 7,
                     5: 5 * s},
        "device": sorted([
            ("flash_attention_bf16", 0, s // 1000, 1),
            ("flash_attention_bf16", s // 1000, 2 * s // 1000, 1),
            ("gemm", s, s + s // 2, 2),
            ("Memcpy DtoH", s + s // 2, s + s // 2 + 10, 2),
            ("softmax", 3 * s, 3 * s + s // 2, 3),
            ("gemm", 3 * s + s // 2, 4 * s, 4),
            ("late", int(3.5 * s), int(3.6 * s), 5)], key=lambda e: e[1])}
    return run


def test_device_readers():
    run = traced_run()
    busy = 2 * 10 ** 6 + (10 ** 9 // 2 + 10) + 10 ** 9
    assert trace.busy_s(run["trace"]["device"]) == pytest.approx(busy * 1e-9)
    assert read("device_idle_share", run) == pytest.approx(
        (1 - busy * 1e-9 / 4.0) * 100)
    # kernels launched inside decode ranges: gemm, softmax, gemm (the
    # copy is no kernel, "late" began outside)
    assert read("launches_per_decode_step", run) == pytest.approx(3 / 2)
    bound = 2 * counters.flash_bound_s(100, 4, 4, 16, PEAKS)
    assert read("flash_roofline", run) == pytest.approx(bound / 2e-3 * 100)


def test_flash_roofline_reads_nothing_from_a_partial_trace():
    assert read("flash_roofline", traced_run(flash_launches=3)) is None
    run = steady_run()
    assert read("flash_roofline", run) is None
    assert read("device_idle_share", run) is None


def test_breakdown_lists():
    tr = traced_run()["trace"]
    ops = trace.top_ops(tr["device"])
    assert ops[0][0] == "gemm" and ops[0][1] == pytest.approx(1.0)
    gaps = trace.idle_gaps(tr)
    # the gap after the first decode step's work began inside that step,
    # the one after the flash kernels inside the prefill's range
    assert gaps[0][0] == "decode_step"
    assert gaps[0][1] == pytest.approx(1.5, abs=1e-6)
    assert gaps[1][0] == "prefill"
    assert gaps[1][1] == pytest.approx(0.998)
    assert trace.host_range_at(tr["ranges"], int(2.5e9)) == "between calls"
    assert len(ops) <= 10 and len(gaps) <= 10
