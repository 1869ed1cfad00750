"""Billing model (paper §7.1).

Per-second billing at $0.011 per worker (Azure B2S-derived), partial seconds
rounded **up**.  A dynamically-created node is billed from the moment the
provisioning request is placed until the deprovisioning request; static nodes
are billed for the whole scheduling duration of the workload.

The fleet adaptation uses the identical model with a per-node-type price table
(heterogeneous node types are a paper-§8 extension, off by default).

Closed records are mirrored into SoA columns (start / end / node_type) as
they retire, so the end-of-run queries (`total_cost`, `total_node_seconds`)
are one vectorized ceil/multiply reduction over the billing history instead
of a per-record method-call walk — at 2k autoscaled nodes that walk was ~5%
of full-run wall time.  The float contract is unchanged: per-record seconds
are ``ceil(max(0, end-start))`` (bit-identical to ``math.ceil`` below 2^53)
and the cost accumulates left-to-right in record-retirement order, so the
totals match the scalar loop bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.cluster import Node

DEFAULT_PRICE_PER_S = 0.011


@dataclasses.dataclass
class BillingRecord:
    node_id: str
    node_type: str
    start: float
    end: Optional[float] = None   # None -> still running

    def seconds(self, now: float) -> int:
        end = self.end if self.end is not None else now
        return int(math.ceil(max(0.0, end - self.start)))


class CostModel:
    """Tracks provision/deprovision events and prices node-seconds."""

    def __init__(self, price_per_s: float = DEFAULT_PRICE_PER_S,
                 price_table: Optional[Dict[str, float]] = None):
        self.price_per_s = price_per_s
        self.price_table = price_table or {}
        self.records: Dict[str, BillingRecord] = {}
        self.closed: List[BillingRecord] = []
        # SoA mirror of `closed` (same order): the query path reduces over
        # these columns instead of walking record objects.
        self._closed_start: List[float] = []
        self._closed_end: List[float] = []
        self._closed_type: List[str] = []

    def price_of(self, node_type: str) -> float:
        return self.price_table.get(node_type, self.price_per_s)

    # -- events ---------------------------------------------------------------
    def on_provision(self, node: Node, now: float) -> None:
        open_rec = self.records.get(node.node_id)
        if open_rec is not None:
            raise ValueError(
                f"node {node.node_id} is already billing (open record since "
                f"t={open_rec.start}): double provision — deprovision it "
                f"before provisioning again")
        self.records[node.node_id] = BillingRecord(
            node_id=node.node_id, node_type=node.node_type, start=now)

    def on_deprovision(self, node: Node, now: float) -> None:
        rec = self.records.pop(node.node_id, None)
        if rec is None:
            raise ValueError(
                f"node {node.node_id} has no open billing record: double "
                f"deprovision (a failed/reclaimed node is already retired "
                f"by the NODE_FAIL handler — don't also terminate it) or "
                f"a node this CostModel never provisioned")
        rec.end = now
        self.closed.append(rec)
        self._closed_start.append(rec.start)
        self._closed_end.append(now)
        self._closed_type.append(rec.node_type)

    def close_all(self, now: float) -> None:
        """End of experiment: static/running nodes stop billing now.

        One bulk column append over the open set (insertion order, same as
        the retired-record order the scalar walk produced) instead of a
        per-node close loop."""
        if not self.records:
            return
        recs = list(self.records.values())
        self.records.clear()
        for rec in recs:
            rec.end = now
        self.closed.extend(recs)
        self._closed_start.extend(rec.start for rec in recs)
        self._closed_end.extend(now for _ in recs)
        self._closed_type.extend(rec.node_type for rec in recs)

    # -- queries ---------------------------------------------------------------
    def _resolve_now(self, now: Optional[float]) -> float:
        """``now`` may be omitted only once every record is closed.

        Open records bill ``start → now``; pricing them against a default
        of 0.0 silently yields `max(0, -start)` = 0 node-seconds for every
        running node — a cost of $0 that *looks* like an answer.  Closed
        records never read ``now``, so the query is unambiguous without it
        only after ``close_all``/``on_deprovision`` retired everything."""
        if now is not None:
            return now
        if self.records:
            raise ValueError(
                f"now= is required while {len(self.records)} node(s) are "
                "still billing (open records would price as 0 seconds); "
                "pass the current simulation time or call close_all first")
        return 0.0   # unused: only closed records remain

    def _seconds_column(self, now: float) -> "tuple":
        """``(seconds, node_types)`` over closed-then-open records.

        ``seconds`` is one vectorized ``ceil(max(0, end-start))`` reduction
        — bit-identical to ``BillingRecord.seconds`` (float64 ``np.ceil``
        equals ``math.ceil`` for any billing span below 2^53 seconds)."""
        if len(self._closed_start) != len(self.closed):   # external mutation
            self._closed_start = [r.start for r in self.closed]
            self._closed_end = [now if r.end is None else r.end
                                for r in self.closed]
            self._closed_type = [r.node_type for r in self.closed]
        open_recs = list(self.records.values())
        starts = np.fromiter(
            (s for s in self._closed_start), dtype=np.float64,
            count=len(self._closed_start))
        ends = np.fromiter(
            (e for e in self._closed_end), dtype=np.float64,
            count=len(self._closed_end))
        if open_recs:
            starts = np.concatenate(
                [starts, np.fromiter((r.start for r in open_recs),
                                     dtype=np.float64, count=len(open_recs))])
            ends = np.concatenate(
                [ends, np.full(len(open_recs), now, dtype=np.float64)])
        seconds = np.ceil(np.maximum(0.0, ends - starts))
        types = self._closed_type + [r.node_type for r in open_recs]
        return seconds, types

    def total_cost(self, now: Optional[float] = None) -> float:
        now = self._resolve_now(now)
        seconds, types = self._seconds_column(now)
        if not types:
            return 0.0
        prices = np.fromiter((self.price_of(t) for t in types),
                             dtype=np.float64, count=len(types))
        # Left-to-right accumulation in record order: the per-term products
        # are IEEE-identical to the scalar loop's `seconds * price`, and the
        # running float sum must visit them in the same order to keep the
        # golden-fixture cost bits.
        total = 0.0
        for term in (seconds * prices).tolist():
            total += term
        return total

    def total_node_seconds(self, now: Optional[float] = None) -> int:
        now = self._resolve_now(now)
        seconds, _ = self._seconds_column(now)
        # Exact: every element is a small non-negative integer-valued float,
        # so the float64 sum is exact far beyond any plausible fleet size.
        return int(seconds.sum())
