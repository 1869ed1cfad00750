"""Run-report rendering over obs bundles.

Everything renders from the plain-dict bundle shape
(``ObsRecorder.bundle()`` live, or ``recorder.load_bundle(path)`` from
disk), so a report on a run just executed and on its exported trace are
identical:

* ``phase_table``    — per-phase breakdown of where the cycle time went;
* ``decision_summary`` — event counts with the interesting splits
  (scale-outs by disposition, scale-ins by Alg. 6 step, evictions by
  reason);
* ``explain_events`` — per-decision drill-down: one line per event with
  its attributed inputs (pending depth, utilization, forecast
  rate/confidence, rate-limiter state) decoded per kind.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.recorder import (EV_BIND, EV_EVICT, EV_FORECAST,
                                      EV_NOTICE, EV_RESCHED, EV_SCALE_IN,
                                      EV_SCALE_OUT, FCOLS, KIND_NAMES,
                                      REASON_NAMES, RESCHED_NAMES,
                                      SCALE_OUT_NAMES)


def _fmt_s(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:8.3f} s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:8.3f} ms"
    return f"{seconds * 1e6:8.1f} µs"


def phase_table(bundle: Dict) -> str:
    """Per-phase profiler breakdown, heaviest first."""
    prof = bundle.get("profile")
    if prof is None or not prof["names"]:
        return "(no profile data: run with ObsConfig(profile=True))"
    names = prof["names"]
    count = np.asarray(prof["count"])
    total = np.asarray(prof["total_s"], np.float64)
    mn = np.asarray(prof["min_s"], np.float64)
    mx = np.asarray(prof["max_s"], np.float64)
    grand = float(total.sum()) or 1.0
    order = np.argsort(-total, kind="stable")
    lines = [f"{'phase':<22} {'calls':>9} {'total':>11} {'share':>6} "
             f"{'mean':>11} {'min':>11} {'max':>11}"]
    for i in order:
        c = int(count[i])
        mean = total[i] / c if c else 0.0
        lines.append(
            f"{names[i]:<22} {c:>9d} {_fmt_s(float(total[i])):>11} "
            f"{100.0 * total[i] / grand:5.1f}% {_fmt_s(mean):>11} "
            f"{_fmt_s(float(mn[i])):>11} {_fmt_s(float(mx[i])):>11}")
    dropped = prof["n_spans_seen"] - min(prof["n_spans_seen"],
                                         len(prof["spans"]["t0"]))
    if dropped > 0:
        lines.append(f"(span ring wrapped: oldest {dropped} raw spans "
                     f"dropped; aggregates above cover every span)")
    return "\n".join(lines)


def _event_cols(bundle: Dict) -> Optional[Dict[str, np.ndarray]]:
    ev = bundle.get("events")
    if ev is None:
        return None
    cols = {k: np.asarray(v) for k, v in ev["columns"].items()}
    cols["_node_table"] = ev["node_table"]
    cols["_n_seen"] = ev["n_seen"]
    return cols


def decision_summary(bundle: Dict) -> str:
    cols = _event_cols(bundle)
    if cols is None:
        return "(no event data: run with ObsConfig(events=True))"
    kind = cols["kind"]
    v1 = cols["v1"]
    v2 = cols["v2"]
    lines = []
    n_held = len(kind)
    dropped = cols["_n_seen"] - n_held
    lines.append(f"events: {n_held} retained"
                 + (f" (+{dropped} overwritten by the ring)" if dropped > 0
                    else ""))
    for code, name in enumerate(KIND_NAMES):
        mask = kind == code
        n = int(mask.sum())
        if n == 0:
            continue
        detail = ""
        if code == EV_SCALE_OUT:
            parts = [f"{SCALE_OUT_NAMES[d]}={int((v1[mask] == d).sum())}"
                     for d in range(len(SCALE_OUT_NAMES))
                     if int((v1[mask] == d).sum())]
            detail = "  [" + ", ".join(parts) + "]"
        elif code == EV_SCALE_IN:
            parts = [f"step{s}={int((v1[mask] == s).sum())}"
                     for s in (1, 2, 3) if int((v1[mask] == s).sum())]
            detail = "  [" + ", ".join(parts) + "]"
        elif code == EV_EVICT:
            parts = [f"{REASON_NAMES[r]}={int((v2[mask] == r).sum())}"
                     for r in range(len(REASON_NAMES))
                     if int((v2[mask] == r).sum())]
            detail = "  [" + ", ".join(parts) + "]"
        elif code == EV_RESCHED:
            parts = [f"{RESCHED_NAMES[o]}={int((v1[mask] == o).sum())}"
                     for o in range(len(RESCHED_NAMES))
                     if int((v1[mask] == o).sum())]
            detail = "  [" + ", ".join(parts) + "]"
        lines.append(f"  {name:<15} {n:>7d}{detail}")
    return "\n".join(lines)


def _node_name(cols: Dict, i: int) -> str:
    idx = int(cols["node"][i])
    return cols["_node_table"][idx] if idx >= 0 else "-"


def _explain_one(cols: Dict, i: int) -> str:
    """One drill-down line: the event plus the inputs that drove it."""
    kind = int(cols["kind"][i])
    t = float(cols["t"][i])
    cyc = int(cols["cycle"][i])
    uid = int(cols["uid"][i])
    node = _node_name(cols, i)
    pend = cols["pending"][i]
    util = cols["util"][i]
    v1 = cols["v1"][i]
    v2 = cols["v2"][i]
    head = f"t={t:10.1f}s cycle={cyc:<6d}"
    if kind == EV_BIND:
        return (f"{head} bind       pod={uid} -> {node}  "
                f"waited={v1:.1f}s inc={int(v2)} pending={pend:.0f}")
    if kind == EV_EVICT:
        reason = REASON_NAMES[int(v2)] if 0 <= v2 < len(REASON_NAMES) \
            else "?"
        return (f"{head} evict      pod={uid} ({reason})  "
                f"inc={int(v1)} pending={pend:.0f}")
    if kind == EV_SCALE_OUT:
        disp = SCALE_OUT_NAMES[int(v1)] if 0 <= v1 < len(SCALE_OUT_NAMES) \
            else "?"
        rate = cols["rate"][i]
        conf = cols["conf"][i]
        hr = cols["headroom"][i]
        why = f"pending={pend:.0f} util={util:.3f}"
        if not np.isnan(rate):
            why += f" rate={rate:.4f}/s conf={conf:.2f}"
        if not np.isnan(hr):
            why += f" headroom={hr:.2f}"
        if not np.isnan(v2):
            why += f" since_last_launch={v2:.0f}s" if int(v1) in (0, 1) \
                else f" deficit={v2:.2f}"
        tgt = f" -> {node}" if node != "-" else ""
        return f"{head} scale_out  [{disp}]{tgt}  trigger_pod={uid}  {why}"
    if kind == EV_SCALE_IN:
        action = {1: "terminate empty", 2: "drain+terminate",
                  3: "evict movers + taint"}.get(int(v1), "?")
        return (f"{head} scale_in   {node} [{action}]  moved={int(v2)} "
                f"pending={pend:.0f} util={util:.3f}")
    if kind == EV_NOTICE:
        return (f"{head} notice     {node}  residents={int(v1)} "
                f"kill_in={v2:.0f}s pending={pend:.0f}")
    if kind == EV_RESCHED:
        out = RESCHED_NAMES[int(v1)] if 0 <= v1 < len(RESCHED_NAMES) else "?"
        vic = f" victim={node}" if node != "-" else ""
        return (f"{head} resched    pod={uid} [{out}]{vic}  "
                f"moved={int(v2)} pending={pend:.0f}")
    if kind == EV_FORECAST:
        rate = cols["rate"][i]
        conf = cols["conf"][i]
        state = "overloaded" if v1 == 1.0 else "keeping-up"
        return (f"{head} forecast   rate={rate:.4f}/s conf={conf:.2f} "
                f"slow={v2:.4f}/s [{state}] pending={pend:.0f} "
                f"util={util:.3f}")
    return f"{head} kind={kind} uid={uid} node={node}"


def explain_events(bundle: Dict, kinds: Optional[List[str]] = None,
                   limit: Optional[int] = None) -> str:
    """Drill-down listing, chronological.  ``kinds`` filters by kind name
    (default: scale_out + scale_in — the decisions the paper's claims rest
    on); ``limit`` keeps only the last N matching events."""
    cols = _event_cols(bundle)
    if cols is None:
        return "(no event data: run with ObsConfig(events=True))"
    if kinds is None:
        kinds = ["scale_out", "scale_in"]
    codes = []
    for name in kinds:
        if name not in KIND_NAMES:
            raise KeyError(f"unknown event kind {name!r}; "
                           f"one of {list(KIND_NAMES)}")
        codes.append(KIND_NAMES.index(name))
    idx = np.nonzero(np.isin(cols["kind"], codes))[0]
    total = idx.size
    if limit is not None and total > limit:
        idx = idx[-limit:]
    lines = [_explain_one(cols, int(i)) for i in idx]
    header = (f"{total} event(s) of kind {'/'.join(kinds)}"
              + (f", showing last {len(lines)}" if len(lines) < total
                 else ""))
    return "\n".join([header] + lines)


def node_count_summary(bundle: Dict) -> str:
    t = bundle.get("node_count_t")
    n = bundle.get("node_count_n")
    if t is None or len(t) == 0:
        return "(no node-count series in bundle)"
    n = np.asarray(n)
    return (f"node count: samples={len(n)} min={int(n.min())} "
            f"max={int(n.max())} final={int(n[-1])}; "
            f"pending intervals recorded={len(bundle.get('pending_intervals', []))}")


def render_report(bundle: Dict, kinds: Optional[List[str]] = None,
                  limit: Optional[int] = 50) -> str:
    """The full report: meta + phases + decisions + drill-down."""
    meta = bundle.get("meta") or {}
    parts = []
    if meta:
        parts.append("== run ==")
        parts.append("  ".join(f"{k}={v}" for k, v in sorted(meta.items())))
    parts.append("\n== cycle-phase profile ==")
    parts.append(phase_table(bundle))
    parts.append("\n== decisions ==")
    parts.append(decision_summary(bundle))
    parts.append(node_count_summary(bundle))
    parts.append("\n== drill-down ==")
    parts.append(explain_events(bundle, kinds=kinds, limit=limit))
    return "\n".join(parts)
