"""One run of one cell: build the served system from the seed, warm up
the cell's shapes, serve the measured window, read the trace, check the
served tokens against the plain reference, and assemble the result.

The window drives ``repro_torch.serve.engine.run_server`` over a
``ServeEngine``: the harness only hands it the requests (each one's
``submitted_at`` is its due time) and times its ``admit`` and ``step``
calls from outside.  Every time here is the host's ``perf_counter``;
the program's own timestamps come from the same clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import sys
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from portbench import spec as bench_spec
from portbench import trace as bench_trace
from portbench import weights
from portbench.traffic import offered as offered_requests

# Top-level module names that no process of the benchmark may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The traced sub-window of a ``--trace 1`` run: it opens at this share
# of the window and lasts TRACE_SECONDS (a whole window holds millions
# of device events).  Late, so that the requests it holds up come after
# most of the window's (``metrics/ttft_p90_ms.moe.py``).
TRACE_AT = 0.8
TRACE_SECONDS = 5.0
# Warm-up: this many prefills at lengths spread over the window's own,
# each decoding WARMUP_TOKENS tokens beside the others.
WARMUP_PROMPTS = 7
WARMUP_TOKENS = 3


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among the module names ``names``
    (by default those in ``sys.modules``), compared whole:
    ``repro_torch`` is not ``repro``."""
    if names is None:
        names = list(sys.modules)
    loaded = {name.split(".")[0] for name in names}
    return sorted(loaded & set(FORBIDDEN))


def arch_config(config: Dict, **overrides):
    """The program's ``ArchConfig`` of a configuration file: its keys
    that name a field."""
    from repro_torch.configs.base import ArchConfig
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in config.items() if k in fields}
    kw.update(overrides)
    return ArchConfig(**kw)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class System:
    cfg: object          # the program's ArchConfig
    params: Dict         # the benchmark's weights, as served
    engine: object       # repro_torch.serve.engine.ServeEngine


def build(cell: bench_spec.Cell, seed: int, device: torch.device,
          **overrides) -> System:
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    cfg = arch_config(cell.config, **overrides)
    params = weights.draw(tf.model_specs(cfg), tf.serving_dtype(cfg), seed,
                          device)
    p = cell.params
    engine = ServeEngine(cfg, params, EngineConfig(num_slots=p["slots"],
                                                   cache_len=p["cache_len"]),
                         clock=time.perf_counter, device=device)
    return System(cfg, params, engine)


def offered(cell: bench_spec.Cell, seed: int, seconds: float,
            rate: Optional[float] = None):
    return offered_requests(cell.traffic, rate or cell.params["rate_per_s"],
                            seconds, seed, cell.config["vocab_size"],
                            cell.config.get("prompt_multiple", 0))


def warm_up(system: System, reqs, seed: int) -> None:
    """Prefills at WARMUP_PROMPTS lengths spread over the window's own
    (its shortest and longest among them), decoding beside each other,
    through the same engine the window drives."""
    from repro_torch.serve.engine import Request, run_server
    lengths = sorted({len(r.prompt) for r in reqs})
    n = min(WARMUP_PROMPTS, len(lengths), system.engine.ecfg.num_slots)
    picks = sorted({lengths[round(i * (len(lengths) - 1) / max(n - 1, 1))]
                    for i in range(n)})
    rng = np.random.default_rng([seed, 2])
    vocab = system.cfg.vocab_size
    warm = [Request(uid=-1 - i, max_new_tokens=WARMUP_TOKENS,
                    prompt=rng.integers(0, vocab, L).astype(np.int32))
            for i, L in enumerate(picks)]
    run_server(system.engine, warm, log=lambda _: None,
               clock=time.perf_counter)
    sync(system.engine.device)


class _Clock:
    """``perf_counter`` that remembers its first reading: ``run_server``
    reads it first as the window's opening."""

    def __init__(self):
        self.t0: Optional[float] = None

    def __call__(self) -> float:
        t = time.perf_counter()
        if self.t0 is None:
            self.t0 = t
        return t


@dataclasses.dataclass
class Span:
    kind: str            # "prefill" | "decode"
    start: float         # seconds after the window opened
    end: float
    info: Dict
    traced: bool         # inside the profiled sub-window


class _Recorder:
    """Stands in for the engine's ``admit`` and ``step``: times each
    call that does work, and opens and closes the profiled sub-window
    between calls.  It also stands in for the sampler the engine's step
    calls, and keeps a copy of each decode logits row of the requests
    in ``picks`` (their vocabulary's columns, as served)."""

    def __init__(self, engine, clock: _Clock, trace_window=None,
                 picks: Iterable[int] = ()):
        from repro_torch.serve import engine as engine_mod
        self.engine, self.clock = engine, clock
        self.admit_fn, self.step_fn = engine.admit, engine.step
        self.sample_fn = engine_mod.sample
        self.spans: List[Span] = []
        self.trace_window = trace_window
        self.prof = None
        self.trace: Optional[Dict] = None
        self.logits: Dict[int, List[torch.Tensor]] = {u: [] for u in picks}
        self._rows: List = []
        engine.admit, engine.step = self.admit, self.step
        engine_mod.sample = self.sample

    def uninstall(self) -> None:
        from repro_torch.serve import engine as engine_mod
        del self.engine.admit, self.engine.step
        engine_mod.sample = self.sample_fn

    def sample(self, generator, logits, cfg):
        vocab = self.engine.cfg.vocab_size
        for slot, uid in self._rows:
            self.logits[uid].append(logits[slot, :vocab].clone())
        return self.sample_fn(generator, logits, cfg)

    def _now(self) -> float:
        return time.perf_counter() - self.clock.t0

    def _range(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(bench_trace.RANGE_PREFIX + name)

    def admit(self, req) -> bool:
        traced = self.prof is not None
        t0 = self._now()
        with self._range("prefill"):
            ok = self.admit_fn(req)
        if ok:
            self.spans.append(Span("prefill", t0, self._now(),
                                   {"tokens": len(req.prompt)}, traced))
        return ok

    def step(self):
        self._maybe_trace()
        active = [r for r in self.engine.active if r is not None]
        info = {"active": len(active),
                "kv_positions": sum(len(r.prompt) + len(r.tokens)
                                    for r in active)}
        self._rows = [(slot, r.uid) for slot, r in
                      enumerate(self.engine.active)
                      if r is not None and r.uid in self.logits]
        traced = self.prof is not None
        t0 = self._now()
        with self._range("decode_step"):
            out = self.step_fn()
        self._rows = []
        if active:
            self.spans.append(Span("decode", t0, self._now(), info, traced))
        return out

    def _maybe_trace(self) -> None:
        if self.trace_window is None or self.trace is not None:
            return
        now = self._now()
        if self.prof is None and now >= self.trace_window[0]:
            self.start_trace()
        elif self.prof is not None and now >= self.trace_window[1]:
            self.stop_trace()

    def start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.kernels import flash_attention
        sync(self.engine.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._flash0 = flash_attention.launches
        self._t_on = time.perf_counter()

    def stop_trace(self) -> None:
        """Close the profiled sub-window.  Its events are read later, by
        ``read_trace`` once the window has closed: reading them takes
        seconds, which would hold up every request due meanwhile."""
        if self.prof is None or self.trace is not None:
            return
        from repro_torch.kernels import flash_attention
        sync(self.engine.device)
        window_s = time.perf_counter() - self._t_on
        self.prof.stop()
        self.trace = {"window_s": window_s,
                      "flash_launches": flash_attention.launches
                      - self._flash0}
        self._stopped, self.prof = self.prof, None

    def read_trace(self) -> None:
        if self.trace is not None and "device" not in self.trace:
            self.trace.update(bench_trace.events(self._stopped))
            self._stopped = None


@dataclasses.dataclass
class Window:
    requests: List       # the engine's Request objects, due in the window
    due: Dict[int, float]
    t0: float            # the window's opening (perf_counter)
    wall_s: float        # the window's opening to the last request's end
    spans: List[Span]
    trace: Optional[Dict]
    logits: Dict[int, List[torch.Tensor]]   # the picks' decode rows


def serve_window(system: System, reqs, seconds: float,
                 trace: bool = False, picks: Iterable[int] = ()) -> Window:
    """Every request of ``reqs`` through ``run_server``, each due at its
    time after the window opens; returns when the last is served, with
    the decode logits of the requests whose uids are in ``picks``."""
    from repro_torch.serve.engine import Request, run_server
    served = [Request(uid=r.uid, prompt=r.prompt,
                      max_new_tokens=r.max_new_tokens, submitted_at=r.due)
              for r in reqs]
    clock = _Clock()
    window = None
    if trace:
        start = TRACE_AT * seconds
        window = (start, start + min(TRACE_SECONDS, 0.5 * seconds))
    rec = _Recorder(system.engine, clock, window, picks)
    try:
        run_server(system.engine, served, log=lambda _: None, clock=clock)
        wall = time.perf_counter() - clock.t0
        rec.stop_trace()
        rec.read_trace()
    finally:
        rec.uninstall()
    return Window(requests=served, due={r.uid: r.due for r in reqs},
                  t0=clock.t0, wall_s=wall, spans=rec.spans, trace=rec.trace,
                  logits=rec.logits)


def run_record(cell: bench_spec.Cell, window: Window) -> Dict:
    """What a metric's reader reads: the cell, the card's peaks, every
    request (times in seconds after the window opened), the spans and
    the trace."""
    t0 = window.t0
    reqs = [{"due": window.due[r.uid], "prompt_tokens": len(r.prompt),
             "tokens": len(r.tokens),
             "first_token": r.first_token_at - t0
             if r.first_token_at is not None else None,
             "done": r.done_at - t0 if r.done_at is not None else None}
            for r in window.requests]
    return {"config": cell.config, "cell": cell.params,
            "peaks": bench_spec.peaks(), "requests": reqs,
            "spans": [dataclasses.asdict(s) for s in window.spans],
            "trace": window.trace, "wall_s": window.wall_s}


def release(system: System) -> None:
    """Free the program's state (the engine and its KV cache); the
    weights stay for the reference."""
    system.engine = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample(requests, k: int, seed: int) -> List[int]:
    """The uids of the requests the check compares, chosen before the
    window: the longest (prompt and asked-for output) and k - 1 others
    drawn from the seed."""
    longest = max(requests, key=lambda r: (len(r.prompt) + r.max_new_tokens,
                                           r.uid))
    rest = [r.uid for r in requests if r is not longest]
    rng = np.random.default_rng([seed, 1])
    picks = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest.uid] + [rest[i] for i in sorted(picks)]


def reference_logits(config: Dict, params: Dict, reqs, device,
                     precision: str = "float32") -> List[torch.Tensor]:
    """The plain reference's logits at each served token's position:
    each prompt with its served tokens but the last, read from the
    prompt's last position on."""
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    seqs = [torch.as_tensor(np.concatenate([r.prompt, r.tokens[:-1]]),
                            dtype=torch.int64, device=device) for r in reqs]
    return ref.logits(config, params, seqs, [len(r.prompt) for r in reqs],
                      [len(r.prompt) - 1 for r in reqs], precision)


def logit_gaps(ref: torch.Tensor, tokens) -> torch.Tensor:
    """How far each chosen token's reference logit lies below the
    reference's best at its position."""
    tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                          device=ref.device)
    return ref.max(-1).values - ref.gather(1, tok[:, None])[:, 0]


def decode_kl(ref: torch.Tensor, served: List[torch.Tensor]) -> torch.Tensor:
    """KL(reference || program) of the next-token distributions at each
    decoded position: the reference's rows after its first (the
    prefill's) against the program's decode logits."""
    got = torch.stack(served).float().to(ref.device)
    lp = torch.log_softmax(ref[1:], -1)
    return (lp.exp() * (lp - torch.log_softmax(got, -1))).sum(-1)


def check(cell: bench_spec.Cell, system: System,
          window: Window) -> Dict[str, float]:
    """Free the program's state, then compare the requests picked before
    the window (``window.logits``) with the reference: ``compare``."""
    picks = checked(window)
    device = system.engine.device
    release(system)
    return compare(window, picks, reference_logits(cell.config,
                                                   system.params, picks,
                                                   device))


def checked(window: Window) -> List:
    """The picked requests that were served a token or more."""
    by_uid = {r.uid: r for r in window.requests}
    return [by_uid[u] for u in window.logits if by_uid[u].tokens]


def compare(window: Window, picks, refs) -> Dict[str, float]:
    """The numbers a cell may compare: the widest and the mean gap of a
    served token below the reference's best logit; the mean KL
    divergence of the program's decode logits from the reference's
    (infinite where a pick's rows do not match its tokens); and the
    requests served a number of tokens other than they asked for."""
    gaps = torch.cat([logit_gaps(ref, r.tokens) for ref, r in
                      zip(refs, picks)])
    kls, whole = [], True
    for ref, r in zip(refs, picks):
        rows = window.logits[r.uid]
        whole &= len(rows) == len(r.tokens) - 1
        if rows and whole:
            kls.append(decode_kl(ref, rows))
    kl = float(torch.cat(kls).mean()) if whole and kls else float("inf")
    wrong = sum(len(r.tokens) != r.max_new_tokens for r in window.requests)
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean()), "decode_kl_mean": kl,
            "wrong_length": int(wrong), "tokens_compared": int(gaps.numel())}


def kv_bytes(engine, spans: List[Span]) -> Dict[str, int]:
    """The KV pool's bytes and the bytes its occupied positions hold,
    at the fullest decode step and on the mean step."""
    from repro_torch.models.params import leaves_with_paths
    pool = sum(t.nbytes for _, t in leaves_with_paths(engine.states))
    per_pos = pool / (engine.ecfg.num_slots * engine.ecfg.cache_len)
    used = [s.info["kv_positions"] for s in spans if s.kind == "decode"]
    return {"pool": int(pool),
            "occupied_peak": int(per_pos * max(used, default=0)),
            "occupied_mean": int(per_pos * float(np.mean(used or [0])))}


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the limited numbers."""
    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def read_metrics(cell: bench_spec.Cell, record: Dict, metrics) -> Dict:
    """Each metric's reader over the run's record; a metric whose reader
    finds nothing to read is left out."""
    out = {}
    for m in metrics:
        if m["name"] == "setup_s":
            continue
        value = bench_spec.metric_reader(cell.root, m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(device: torch.device, count: int) -> Dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(cell: bench_spec.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> Dict:
    """One run of the cell: the result line's object, or SystemExit when
    a forbidden module was loaded by the time the window closed."""
    parts = {"import": time.perf_counter() - t_start}
    reqs = offered(cell, seed, seconds)
    picks = sample(reqs, cell.params["check"]["requests"], seed)
    system = build(cell, seed, device)
    sync(device)
    parts["build"] = time.perf_counter() - t_start - sum(parts.values())
    warm_up(system, reqs, seed)
    parts["warm_up"] = time.perf_counter() - t_start - sum(parts.values())
    if trace and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)   # CUPTI's start-up
        sync(device)
    setup_s = time.perf_counter() - t_start
    parts["profiler"] = setup_s - sum(parts.values())
    win = serve_window(system, reqs, seconds, trace, picks)
    sync(device)
    dev = device_info(device, cell.entry["chips"])
    kv = kv_bytes(system.engine, win.spans)
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"forbidden modules loaded by the window's close: "
                         f"{loaded}")
    record = run_record(cell, win)
    if trace:
        metrics = read_metrics(cell, record, cell.per_layer)
    else:
        metrics = read_metrics(cell, record, cell.end_to_end)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    readings = check(cell, system, win)
    correct, checks = judge(readings, cell.params["check"]["limits"])
    result = {"correct": correct, "attempted": len(win.requests),
              "failed": readings["wrong_length"], "metrics": metrics,
              "device": dev, "kv_bytes": kv,
              "setup_parts_s": parts}
    if trace and win.trace is not None:
        result["device"].update(busy_s=bench_trace.busy_s(win.trace["device"]),
                                window_s=win.trace["window_s"])
        result["breakdown"] = {
            "device_ops": bench_trace.top_ops(win.trace["device"]),
            "idle_gaps": bench_trace.idle_gaps(win.trace)}
    result["checks"] = checks
    return result
