"""Array-backed cluster engine: a structure-of-arrays mirror of cluster state.

The discrete-event simulator's cycle hot path — filter+select over all nodes
for every pending pod — is O(pods x nodes) in Python objects.  This module
maintains a NumPy structure-of-arrays (SoA) mirror of the cluster
(:class:`ClusterArrays`) that is **incrementally updated** on
bind/unbind/add/remove/state changes, so the schedulers can run their
filter+select as a handful of masked vector reductions instead of object
scans.

On top of the mirror sits **wave placement** (:class:`WavePlacer`): instead
of binding pods one at a time through the object layer, the orchestrator
hands the scheduler a whole pending snapshot.  The scheduler places the wave
against the placer's *working copies* of the usage columns — accumulating
bind effects as array deltas — and the accumulated prefix is committed to
the ``Cluster``/``Node``/``Pod`` objects once per wave
(:meth:`repro_torch.core.cluster.Cluster.bind_wave`) instead of once per pod.

Parity contract (enforced by ``tests/test_engine_parity.py``): every value in
the mirror is *assigned* from the corresponding node's incremental
accounting — never recomputed with a different operation order — so the
vectorized engine and the object-scan engine see bit-identical floats and
make bit-identical decisions.  Wave placement preserves the contract by
construction:

* working ``used_*`` columns are advanced with the same ``+=`` the object
  accounting uses, in the same bind order, on the same start values;
* working ``free_*`` entries are refreshed per bound slot as
  ``alloc[slot] - used[slot]`` — the identical elementwise operation
  ``free_views`` applies to the whole vector;
* selection reads the same masks/scores/tie-breaks as the per-pod path.

So pod *k* of a wave observes bit-identical frees to what it would have seen
had pods ``1..k-1`` been committed individually — same pods land on the same
nodes, with the same lowest-node_id tie-breaks.

The mirror also anchors three further array-native subsystems:

* **Table-5 sampling aggregates** — per-node utilization contribution
  columns with dirty tracking, so the 20 s metrics sampler costs O(dirty
  nodes) incremental maintenance plus one C-speed exact ``fsum`` instead of
  a per-node Python scan (see :meth:`ClusterArrays.sample_totals`);
* **segment-tree selection** (:class:`SegExtTree`) — an O(log n)
  first-extremum index over the wave path's cached score buffers, selectable
  against the flat argmin kernel via ``ExperimentSpec(wave_select=...)``
  (identical decisions, different
  constants; "auto" switches on cluster size);
* **pod state** (:class:`PodStore`) — uid-indexed SoA columns that are the
  source of truth for pod lifecycle on the array engine; ``Pod`` objects are
  lazily-materialized shells handed out only at API boundaries (callbacks,
  reschedulers/autoscalers, metrics, direct ``pods`` access, the object
  engine).  Arrival batches ingest in bulk, binds/completions commit as
  column writes, and the best-fit wave loop amortizes its extremum queries
  over runs of same-size pods (``Scheduler.select_wave_store``).

Slot discipline: slots are append-only (never reused), so ascending slot
order == ``Cluster.nodes`` insertion order.  This matters: Alg. 6 scale-in
iterates nodes in insertion order and termination order is behaviour.

Engine selection: the mirror is enabled by default;
``Cluster(use_arrays=False)`` / ``ExperimentSpec(engine="object")``
disables it, restoring the seed per-pod object-scan path (including the
per-pod scheduling loop in ``Orchestrator.cycle``) for parity testing and
benchmarking.  The port reads no environment variable: the engine, the
wave kernel and the run-length fast path are arguments only.
"""
from __future__ import annotations

import bisect
import itertools
import math
from typing import List, Optional

import numpy as np

# Node-state codes (mirror of cluster.NodeState; kept as plain ints so the
# state array is an int8 vector).
STATE_PROVISIONING = 0
STATE_READY = 1
STATE_TAINTED = 2
STATE_TERMINATED = 3

# Pod-phase codes (PodStore.phase column).  Only the three *observable*
# phases exist at rest: ``Pod.evict`` passes through EVICTED/FAILED and lands
# back on PENDING within one call, so the column never needs those codes.
POD_PENDING = 0
POD_BOUND = 1
POD_SUCCEEDED = 2

# Pod-kind flag bits (PodStore.flags column, one byte per pod, derived from
# the immutable spec at ingest).
POD_F_BATCH = 1
POD_F_SERVICE = 2
POD_F_MOVEABLE = 4
POD_F_CHECKPOINTABLE = 8

# Below this many active nodes the flat C-speed argmin over the cached score
# buffer beats the Python-level O(log n) tree descent; "auto" wave selection
# switches to the segment tree only above it.  Measured on the CPU container
# (query + one real point update per placement): argmin 0.5us/2k nodes ->
# ~8us/64k nodes vs segtree ~4-6us roughly flat — crossover ~32k
# (``benchmarks/bench_sched_throughput.py --kernels`` re-measures).
SEGTREE_AUTO_MIN_NODES = 32768

WAVE_SELECT_MODES = ("auto", "argmin", "segtree")


class ClusterArrays:
    """SoA mirror of per-node capacity, usage and lifecycle state.

    All arrays are capacity-doubling; the live prefix is ``[:self.n_slots]``.
    ``active`` masks out removed nodes (slots are never reused).

    **Metrics aggregates** (Table-5 sampling, paper §7.2): alongside the
    capacity columns the mirror maintains per-node *sampling contribution*
    columns — the RAM ratio, CPU ratio and pod count each READY|TAINTED node
    contributes to the 20 s utilization sample — plus running node/pod
    counters.  Any membership / state / usage mutation marks the slot
    *dirty*; :meth:`sample_totals` refreshes only the dirty slots
    (vectorized over the dirty index set) and produces the exact,
    correctly-rounded column sums the seed ``statistics.fmean``/``fsum``
    sampler computes — bit-identical by construction, because the final
    reduction is ``math.fsum`` over the contribution column (zeros for
    non-sampled slots change neither the exact sum nor its rounding).  A
    compensated running scalar cannot reproduce ``fsum``'s correct rounding
    bit-for-bit, so the per-tick cost is O(dirty) incremental maintenance
    plus one C-speed exact reduction, rather than the seed's per-node Python
    object scan.
    """

    def __init__(self, capacity: int = 64, wave_select: Optional[str] = None,
                 wave_runlen: bool = True):
        self.n_slots = 0                       # slots ever allocated (monotone)
        # Monotone mutation counter: bumped on every membership / state /
        # usage change.  WavePlacer uses it to detect that its working
        # arrays went stale (e.g. a rescheduler evicted pods mid-cycle).
        self.version = 0
        # Wave selection kernel (None = "auto": segment tree above
        # SEGTREE_AUTO_MIN_NODES active nodes).
        if wave_select is None:
            wave_select = "auto"
        if wave_select not in WAVE_SELECT_MODES:
            raise ValueError(f"wave_select must be one of {WAVE_SELECT_MODES},"
                             f" got {wave_select!r}")
        self.wave_select = wave_select
        # Run-length best-fit fast path (``Scheduler.select_wave_store``):
        # decision-identical to querying the extremum per pod; False forces
        # the per-pod query path, for parity tests and bisection.
        self.wave_runlen = wave_runlen
        self._cap = capacity
        self.alloc_cpu = np.zeros(capacity, np.int64)
        self.alloc_mem = np.zeros(capacity, np.float64)
        self.used_cpu = np.zeros(capacity, np.int64)
        self.used_mem = np.zeros(capacity, np.float64)
        self.state = np.full(capacity, STATE_TERMINATED, np.int8)
        self.autoscaled = np.zeros(capacity, bool)
        self.oversub = np.zeros(capacity, bool)
        self.active = np.zeros(capacity, bool)
        self.pod_count = np.zeros(capacity, np.int64)
        self.node_ids: List[str] = []          # slot -> node_id
        # Lexicographic-by-node_id order over *active* slots, for tie-breaks.
        self._sorted_ids: List[str] = []
        self._sorted_slot_list: List[int] = []
        self._sorted_slots = np.zeros(0, np.int64)
        self.id_rank = np.zeros(capacity, np.int64)   # slot -> rank in id order
        # Sampling contribution columns (plain Python containers: the exact
        # fsum reduction and the O(dirty) flush both run at scalar
        # granularity, where list/bytearray access beats NumPy indexing).
        self._samp_ram: List[float] = [0.0] * capacity   # slot -> RAM ratio
        self._samp_cpu: List[float] = [0.0] * capacity   # slot -> CPU ratio
        self._samp_ppn: List[int] = [0] * capacity       # slot -> pod count
        self._samp_in = bytearray(capacity)    # slot currently sampled?
        self._samp_n = 0                       # nodes contributing
        self._samp_pods = 0                    # exact running Σ pod_count
        self._dirty = bytearray(capacity)      # slot stale since last flush?
        self._dirty_slots: List[int] = []

    # -- growth ----------------------------------------------------------------
    def _grow(self) -> None:
        new_cap = self._cap * 2
        for name in ("alloc_cpu", "alloc_mem", "used_cpu", "used_mem",
                     "state", "autoscaled", "oversub", "active", "pod_count",
                     "id_rank"):
            old = getattr(self, name)
            new = np.zeros(new_cap, old.dtype)
            if name == "state":
                new[:] = STATE_TERMINATED
            new[:self._cap] = old
            setattr(self, name, new)
        extra = new_cap - self._cap
        self._samp_ram.extend([0.0] * extra)
        self._samp_cpu.extend([0.0] * extra)
        self._samp_ppn.extend([0] * extra)
        self._samp_in.extend(bytearray(extra))
        self._dirty.extend(bytearray(extra))
        self._cap = new_cap

    def _resync_order(self) -> None:
        self._sorted_slots = np.asarray(self._sorted_slot_list, np.int64)
        if self._sorted_slots.size:
            self.id_rank[self._sorted_slots] = np.arange(
                self._sorted_slots.size, dtype=np.int64)

    # -- membership ------------------------------------------------------------
    def add(self, node) -> int:
        """Register `node`, returning its (permanent) slot index."""
        if self.n_slots == self._cap:
            self._grow()
        slot = self.n_slots
        self.n_slots += 1
        self.node_ids.append(node.node_id)
        self.alloc_cpu[slot] = node.allocatable.cpu_m
        self.alloc_mem[slot] = node.allocatable.mem_mb
        self.autoscaled[slot] = node.autoscaled
        self.active[slot] = True
        pos = bisect.bisect_left(self._sorted_ids, node.node_id)
        self._sorted_ids.insert(pos, node.node_id)
        self._sorted_slot_list.insert(pos, slot)
        self._resync_order()
        self.sync_state(slot, node)
        self.sync_usage(slot, node)
        return slot

    def remove(self, slot: int) -> None:
        self.version += 1
        self.active[slot] = False
        self.state[slot] = STATE_TERMINATED
        if not self._dirty[slot]:
            self._dirty[slot] = 1
            self._dirty_slots.append(slot)
        pos = self._sorted_slot_list.index(slot)
        del self._sorted_ids[pos]
        del self._sorted_slot_list[pos]
        self._resync_order()

    # -- incremental sync (assignment-copy => bit-identical to the node) -------
    def sync_state(self, slot: int, node) -> None:
        self.version += 1
        self.state[slot] = node.state.value_code
        if not self._dirty[slot]:
            self._dirty[slot] = 1
            self._dirty_slots.append(slot)

    def sync_usage(self, slot: int, node) -> None:
        self.version += 1
        self.used_cpu[slot] = node._used_cpu_m
        self.used_mem[slot] = node._used_mem_mb
        self.pod_count[slot] = len(node.pods)
        self.oversub[slot] = node.oversub
        if not self._dirty[slot]:
            self._dirty[slot] = 1
            self._dirty_slots.append(slot)

    # -- vector views ----------------------------------------------------------
    def free_views(self):
        """(free_cpu, free_mem) over the live prefix — fresh arrays, same
        float op (alloc - used) the object path uses, so bit-identical."""
        m = self.n_slots
        return (self.alloc_cpu[:m] - self.used_cpu[:m],
                self.alloc_mem[:m] - self.used_mem[:m])

    def live(self, name: str) -> np.ndarray:
        return getattr(self, name)[:self.n_slots]

    # -- Table-5 sampling aggregates -------------------------------------------
    def sample_totals(self):
        """``(n_nodes, ram_ratio_sum, cpu_ratio_sum, pod_count_sum)`` over
        READY|TAINTED nodes — the exact sums the Table-5 sampler divides by
        ``n_nodes`` (paper §7.2).

        Incremental: only slots dirtied since the previous call are
        re-derived (one vectorized pass over the dirty index set); the float
        sums are then rounded exactly with ``math.fsum`` over the
        contribution columns, whose non-sampled entries are zero — so the
        result is bit-identical to the seed path's
        ``fsum(per-node ratios) `` regardless of which slots went dirty, in
        which order, or how the column is laid out."""
        d = self._dirty_slots
        if d:
            idx = np.fromiter(d, np.int64, len(d))
            st = self.state[idx]
            sampled = self.active[idx] & (
                (st == STATE_READY) | (st == STATE_TAINTED))
            # Same elementwise IEEE ops as the seed utilization scan.
            ram = self.used_mem[idx] / self.alloc_mem[idx]
            cpu = self.used_cpu[idx] / np.maximum(self.alloc_cpu[idx], 1)
            ppn = self.pod_count[idx]
            sr, sc = self._samp_ram, self._samp_cpu
            sp, si = self._samp_ppn, self._samp_in
            dirty = self._dirty
            dn = dp = 0
            for slot, f, r, c, p in zip(d, sampled.tolist(), ram.tolist(),
                                        cpu.tolist(), ppn.tolist()):
                if f:
                    sr[slot] = r
                    sc[slot] = c
                    if not si[slot]:
                        dn += 1
                        si[slot] = 1
                    dp += p - sp[slot]
                    sp[slot] = p
                elif si[slot]:
                    dn -= 1
                    dp -= sp[slot]
                    sr[slot] = 0.0
                    sc[slot] = 0.0
                    sp[slot] = 0
                    si[slot] = 0
                dirty[slot] = 0
            self._dirty_slots = []
            self._samp_n += dn
            self._samp_pods += dp
        return (self._samp_n, math.fsum(self._samp_ram),
                math.fsum(self._samp_cpu), self._samp_pods)

    # -- many-world export -----------------------------------------------------
    def lane_snapshot(self) -> dict:
        """Rank-ordered accounting columns for one many-world lane
        (`repro_torch.manyworld`): copies of alloc/used/pod_count plus the READY
        mask over the active slots, permuted into lexicographic node_id
        order — the same permutation `WavePlacer` ranks by, so index ``r``
        here is the lane engine's node ``r``.  Fancy indexing copies float
        bits verbatim; the snapshot stays valid after the mirror moves on."""
        rank = self._sorted_slots
        return {
            "alloc_cpu": self.alloc_cpu[rank],
            "alloc_mem": self.alloc_mem[rank],
            "used_cpu": self.used_cpu[rank],
            "used_mem": self.used_mem[rank],
            "pod_count": self.pod_count[rank].copy(),
            "ready": self.state[rank] == STATE_READY,
        }

    # -- tie-breaks ------------------------------------------------------------
    def first_by_id(self, mask: np.ndarray) -> int:
        """Slot of the lexicographically-smallest node_id with mask True,
        or -1.  `mask` is over the live prefix."""
        s = self._sorted_slots
        if s.size == 0:
            return -1
        sel = mask[s]
        i = int(np.argmax(sel))
        return int(s[i]) if sel[i] else -1

    # -- consistency (deep invariant checks / property tests) ------------------
    def verify_against(self, cluster) -> None:
        """Assert the mirror matches the object model exactly."""
        seen = 0
        for node in cluster.nodes.values():
            slot = node._slot
            assert slot is not None and self.active[slot], node
            assert self.node_ids[slot] == node.node_id
            assert self.alloc_cpu[slot] == node.allocatable.cpu_m
            assert self.alloc_mem[slot] == node.allocatable.mem_mb
            assert self.used_cpu[slot] == node._used_cpu_m, node
            assert self.used_mem[slot] == node._used_mem_mb, node
            assert self.pod_count[slot] == len(node.pods), node
            assert self.state[slot] == node.state.value_code, node
            assert self.autoscaled[slot] == node.autoscaled
            seen += 1
        assert seen == int(self.active[:self.n_slots].sum())
        # id-order structure is a permutation of active slots, sorted
        ids = [self.node_ids[s] for s in self._sorted_slot_list]
        assert ids == sorted(ids)
        assert set(self._sorted_slot_list) == {
            n._slot for n in cluster.nodes.values()}
        # Sampling aggregates: a flush must reproduce a from-scratch scan.
        n, ram_sum, cpu_sum, pods_sum = self.sample_totals()
        m = self.n_slots
        st = self.state[:m]
        mask = self.active[:m] & ((st == STATE_READY) | (st == STATE_TAINTED))
        assert n == int(mask.sum()), (n, int(mask.sum()))
        ram = self.used_mem[:m][mask] / self.alloc_mem[:m][mask]
        cpu = self.used_cpu[:m][mask] / np.maximum(self.alloc_cpu[:m][mask], 1)
        assert ram_sum == math.fsum(ram.tolist()), "ram aggregate drifted"
        assert cpu_sum == math.fsum(cpu.tolist()), "cpu aggregate drifted"
        assert pods_sum == int(self.pod_count[:m][mask].sum())
        assert not self._dirty_slots and not any(self._dirty)


class SegExtTree:
    """First-extremum segment tree over one cached wave score buffer.

    Replaces the flat O(nodes) ``argmin``/``argmax`` of the cached-buffer
    wave path with an O(log nodes) descent: :meth:`argext` returns the
    *lowest rank attaining the extremum* (ties always prefer the left
    child), which in node-id rank order is exactly the lowest-node_id
    tie-break the flat reduction implements — so selections are
    bit-identical to the argmin path (``tests/test_engine_parity.py``
    asserts identical bind sequences under both kernels).

    Point updates (:meth:`update`) recompute the leaf's ancestors in
    O(log n), stopping early once an ancestor's value is unchanged.
    Construction is one vectorized pairwise reduction per level; levels are
    stored as plain Python lists because queries/updates run at scalar
    granularity, where list access beats NumPy indexing.

    Crossover: NumPy's flat argmin has far smaller constants, so the tree
    only wins above roughly ``SEGTREE_AUTO_MIN_NODES`` active nodes —
    ``wave_select="auto"`` picks per that threshold; ``"argmin"`` /
    ``"segtree"`` force a kernel.
    """

    __slots__ = ("levels", "mode_min", "fill", "n")

    def __init__(self, buf: np.ndarray, mode_min: bool):
        self.mode_min = mode_min
        self.fill = np.inf if mode_min else -np.inf
        self.n = int(buf.shape[0])
        red = np.minimum if mode_min else np.maximum
        lv = buf.astype(np.float64)            # bool masks become 0.0 / 1.0
        levels = []
        while True:
            if lv.shape[0] & 1 and lv.shape[0] > 1:
                lv = np.append(lv, self.fill)  # keep sibling pairs complete
            levels.append(lv.tolist())
            if lv.shape[0] <= 1:
                break
            lv = red(lv[0::2], lv[1::2])
        self.levels = levels

    def argext(self) -> int:
        """Lowest rank attaining the extremum, or -1 when the root is the
        fill value (every rank masked infeasible)."""
        levels = self.levels
        top = levels[-1][0]
        if top == self.fill:
            return -1
        i = 0
        # The extremum value propagates unchanged down the chosen path, and
        # preferring the left child on equality yields the first index.
        for k in range(len(levels) - 2, -1, -1):
            i <<= 1
            if levels[k][i] != top:
                i += 1
        return i

    def update(self, i: int, v: float) -> None:
        levels = self.levels
        levels[0][i] = v
        if self.mode_min:
            for k in range(1, len(levels)):
                j = i & ~1
                child = levels[k - 1]
                a, b = child[j], child[j + 1]
                nv = a if a < b else b
                i >>= 1
                parent = levels[k]
                if parent[i] == nv:
                    return
                parent[i] = nv
        else:
            for k in range(1, len(levels)):
                j = i & ~1
                child = levels[k - 1]
                a, b = child[j], child[j + 1]
                nv = a if a >= b else b
                i >>= 1
                parent = levels[k]
                if parent[i] == nv:
                    return
                parent[i] = nv


class WavePlacer:
    """Working state for placing one wave of pods against the SoA mirror.

    A placer snapshots the usage columns (working *copies*) and the lifecycle
    masks (READY / TAINTED) of a :class:`ClusterArrays` mirror.
    ``Scheduler.select_wave`` advances the working copies with :meth:`bind`
    as it places pods, so later pods of the wave see earlier placements
    **without any object-layer commit**; the orchestrator commits the
    accumulated bindings once per wave via ``Cluster.bind_wave``.

    Rank order: the working arrays cover the *active* slots permuted into
    **lexicographic node_id order** (``slot_of_rank[r]`` maps back to the
    mirror slot).  In rank space, ``argmin``/``argmax`` over a masked score
    buffer returns the *first* extremum — i.e. the lowest-node_id tie-break —
    in a single vector pass, replacing the per-pod masked-reduction +
    explicit tie-break chain of the iterated ``select_slot`` path.

    Bit-parity with committing per pod:

    * :meth:`bind` applies the identical ``+=`` the object accounting
      (``Node._account_add``) would apply, in the same order, on the same
      start values, then refreshes the bound rank's free entries as
      ``alloc[r] - used[r]`` — the same elementwise op
      ``ClusterArrays.free_views`` uses;
    * permuting into rank order copies float bits verbatim, and extremum /
      equality comparisons are order-independent, so selection decisions are
      identical to the slot-ordered per-pod path;
    * lifecycle masks cannot change inside a wave (reschedulers/autoscalers
      only run between waves), so snapshotting them is exact.

    ``cache`` memoizes, per request size, the feasibility mask and the
    policy's ready-masked score buffer; ``Scheduler.select_wave`` refreshes
    only the just-bound rank after each placement, making the per-pod filter
    cost O(1) amortized for repeated request sizes.

    Staleness: ``version`` captures ``ClusterArrays.version`` at snapshot
    time.  Any mirror mutation that did not flow through this placer (an
    eviction, a node add/remove/taint) bumps the mirror's counter;
    :meth:`in_sync` turning False tells the orchestrator to rebuild the
    placer before placing the rest of the snapshot.  After committing its own
    wave the orchestrator re-arms ``version`` to the post-commit value.
    """

    def __init__(self, arr: ClusterArrays):
        self.arr = arr
        self.version = arr.version
        rank = arr._sorted_slots            # active slots in node_id order
        self.slot_of_rank = rank
        self.slot_of_rank_list = rank.tolist()   # scalar reads in the pod loop
        self.n = rank.size
        self.used_cpu = arr.used_cpu[rank]  # fancy index => working copies
        self.used_mem = arr.used_mem[rank]
        self.alloc_cpu = arr.alloc_cpu[rank]
        self.alloc_mem = arr.alloc_mem[rank]
        self.free_cpu = self.alloc_cpu - self.used_cpu
        self.free_mem = self.alloc_mem - self.used_mem
        state = arr.state[rank]
        self.ready = state == STATE_READY
        self.tainted = state == STATE_TAINTED
        # Selection kernel for this wave: flat argmin/argmax over the cached
        # buffer, or the O(log n) segment tree (identical decisions).
        mode = arr.wave_select
        self.use_tree = (mode == "segtree"
                         or (mode == "auto" and self.n >= SEGTREE_AUTO_MIN_NODES))
        # (cpu_m, mem_mb) -> (fits, ready_mask, score_buf, requests, tree,
        #                     cpu_m, mem_mb); cache_list mirrors the values
        # for the per-bind refresh loop (no dict-view overhead per pod).
        self.cache: dict = {}
        self.cache_list: list = []
        # Request keys proven infeasible against this placer.  Sound as a
        # *latch* because working frees only decrease over a placer's
        # lifetime (binds consume capacity; anything that frees capacity
        # bumps the mirror version and forces a placer rebuild), so a size
        # that once found no READY or TAINTED node never fits again — a
        # saturated cycle's backlog skips the extremum query entirely.
        self.blocked_keys: set = set()

    def in_sync(self) -> bool:
        """True while no mirror mutation bypassed this placer."""
        return self.version == self.arr.version

    def bind(self, r: int, req) -> None:
        """Record a placement at rank ``r`` in the working arrays (no object
        commit).  Same ``+=`` / ``alloc - used`` float ops as the object
        path, so the rest of the wave sees bit-identical frees.
        (``Scheduler.select_wave`` inlines these four ops in its pod loop;
        this method is the documented reference implementation.)"""
        self.used_cpu[r] += req.cpu_m
        self.used_mem[r] += req.mem_mb
        self.free_cpu[r] = self.alloc_cpu[r] - self.used_cpu[r]
        self.free_mem[r] = self.alloc_mem[r] - self.used_mem[r]


# Phase-code <-> PodPhase mapping for shell materialization (built lazily so
# this module keeps importing before repro_torch.core.pods on cold starts).
_PHASE_OBJ = None


def _phase_objects():
    global _PHASE_OBJ
    if _PHASE_OBJ is None:
        from repro_torch.core.pods import PodPhase
        _PHASE_OBJ = {POD_PENDING: PodPhase.PENDING,
                      POD_BOUND: PodPhase.BOUND,
                      POD_SUCCEEDED: PodPhase.SUCCEEDED}
    return _PHASE_OBJ


class PodStore:
    """Uid-indexed SoA columns for pod state; ``Pod`` objects become shells.

    On the array engine the store — not a ``Pod`` instance — is the source
    of truth for every pod the orchestrator ingests:

    * ``Orchestrator.submit_wave`` bulk-ingests each presorted ARRIVAL batch
      straight into the columns (:meth:`ingest`) — no ``Pod`` construction,
      no per-pod heap push;
    * the wave scheduler reads request sizes and phases from the columns
      (``Scheduler.select_wave_store``);
    * bind/complete effects commit as column writes
      (``Cluster.bind_wave_store`` / ``Cluster.complete_wave_store``) when no
      external observer needs the objects.

    A ``Pod`` *shell* is materialized on demand (:meth:`pod_at`) only at API
    boundaries: registered callbacks, reschedulers/autoscalers handling a
    blocked pod, evictions, metrics/`_result`, direct ``orch.pods`` /
    ``node.pods`` access, and the seed object engine (which bypasses the
    store entirely).  Materialization reads the columns verbatim, so a shell
    is attribute-for-attribute identical to the object the seed path would
    have produced (property-tested).  Once a shell exists it becomes the
    mutable face of the pod and every subsequent transition — object-path or
    column-path — keeps the two in lockstep via the ``sync_*`` hooks, the
    same assignment-copy discipline :class:`ClusterArrays` uses for nodes.

    Storage: plain Python lists / bytearrays, not NumPy arrays — every hot
    access is scalar-granular (one pod at a time), where list indexing beats
    NumPy boxing; bulk ingest uses C-speed ``list.extend``.  Rows are
    append-only and allocated in uid order (uids come from the same global
    counter ``Pod.__init__`` uses), so row order == uid order == submission
    order.
    """

    def __init__(self, arr: ClusterArrays):
        self.arr = arr                     # node_id lookup for shells
        self.n_rows = 0
        self.index = {}                    # uid -> row
        # -- columns (one entry per row) --------------------------------------
        self.uid = []                      # int
        self.spec_id = []                  # int -> _spec_by_id
        self.cpu_m = []                    # int   (spec.requests.cpu_m)
        self.mem_mb = []                   # float (spec.requests.mem_mb)
        self.duration_s = []               # float (spec.duration_s)
        self.submit_time = []              # float
        self.pending_since = []            # float (current pending interval)
        self.phase = bytearray()           # POD_PENDING/BOUND/SUCCEEDED
        self.node_slot = []                # int, -1 == unbound
        self.bound_time = []               # float | None
        self.finish_time = []              # float | None
        self.incarnation = []              # int
        self.flags = bytearray()           # POD_F_* bits, from the spec
        self.lost_work_s = []              # float (Σ executed-but-not-durable)
        # Pending intervals closed by column-native bulk evictions
        # (Cluster.fail_node_store) for rows that never had a shell; a
        # later materialization transfers them onto the Pod and drops the
        # entry.  row -> [interval, ...]
        self.closed_intervals = {}
        # -- completion log ---------------------------------------------------
        # Append-only finish-time index written by the simulation's
        # completion scheduler: each cycle appends its newly bound batch
        # rows sorted by completion timestamp and pushes one POD_DONE event
        # per distinct timestamp carrying a ``(lo, hi)`` range into these
        # columns — replacing the per-pod ``(uid, incarnation)`` dict the
        # event path used to maintain.  ``done_incs`` snapshots each row's
        # incarnation at schedule time (the staleness check at fire time);
        # ``done_consumed`` counts fired entries, and the log resets to
        # empty whenever every scheduled entry has fired (bounding it by
        # the in-flight completion window, not the trace length).
        self.done_rows = []                # int (store row)
        self.done_incs = []                # int (incarnation when scheduled)
        self.done_consumed = 0
        # -- interned spec table ----------------------------------------------
        # Keyed by id(spec), not value: shells must carry the *identical*
        # spec object the seed path would have stored (``pod.spec is
        # arrival.spec``), the table keeps every interned spec alive so ids
        # stay unique, and identity hashing skips the frozen-dataclass
        # value hash on the ingest hot path.
        self._spec_by_id = []
        self._spec_ids = {}                # id(PodSpec) -> spec id
        self._spec_flags = []              # spec id -> POD_F_* byte
        self._spec_cpu = []                # spec id -> requests.cpu_m
        self._spec_mem = []                # spec id -> requests.mem_mb
        self._spec_dur = []                # spec id -> duration_s
        # -- materialized shells ----------------------------------------------
        self.shells = {}                   # row -> Pod

    # -- completion log --------------------------------------------------------
    def log_completions(self, rows, incs) -> tuple:
        """Append one same-timestamp completion bucket; returns its
        ``(lo, hi)`` range (the POD_DONE payload)."""
        lo = len(self.done_rows)
        self.done_rows.extend(rows)
        self.done_incs.extend(incs)
        return lo, len(self.done_rows)

    def consume_completions(self, lo: int, hi: int) -> None:
        """Mark one fired ``(lo, hi)`` bucket consumed; when every logged
        entry has fired the log resets, so its footprint tracks the
        in-flight completion window (POD_DONE events fire in time order,
        not log order — ranges stay valid because the reset only happens
        at quiescence)."""
        self.done_consumed += hi - lo
        if self.done_consumed == len(self.done_rows):
            self.done_rows.clear()
            self.done_incs.clear()
            self.done_consumed = 0

    # -- many-world export -----------------------------------------------------
    def lane_columns(self) -> dict:
        """Pending-row workload columns for one many-world lane
        (`repro_torch.manyworld.lanes.stack_lanes` input): float64 request /
        duration / submit columns plus the batch-kind mask over the rows
        still PENDING, in row (== FIFO submission) order — the order the
        wave walks them.  Integer cpu_m is exact in float64."""
        pend = [row for row in range(self.n_rows)
                if self.phase[row] == POD_PENDING]
        return {
            "arrival_t": np.array([self.pending_since[r] for r in pend]),
            "cpu_m": np.array([float(self.cpu_m[r]) for r in pend]),
            "mem_mb": np.array([self.mem_mb[r] for r in pend]),
            "duration_s": np.array([self.duration_s[r] for r in pend]),
            "is_batch": np.array([not (self.flags[r] & POD_F_SERVICE)
                                  for r in pend], bool),
        }

    # -- spec interning --------------------------------------------------------
    def _intern_spec(self, spec) -> int:
        sid = self._spec_ids.get(id(spec))
        if sid is None:
            from repro_torch.core.pods import PodKind
            sid = len(self._spec_by_id)
            self._spec_ids[id(spec)] = sid
            self._spec_by_id.append(spec)
            f = 0
            if spec.kind == PodKind.BATCH:
                f |= POD_F_BATCH
            elif spec.kind == PodKind.SERVICE:
                f |= POD_F_SERVICE
            if spec.moveable:
                f |= POD_F_MOVEABLE
            if spec.checkpointable:
                f |= POD_F_CHECKPOINTABLE
            self._spec_flags.append(f)
            self._spec_cpu.append(spec.requests.cpu_m)
            self._spec_mem.append(spec.requests.mem_mb)
            self._spec_dur.append(spec.duration_s)
        return sid

    # -- ingestion -------------------------------------------------------------
    def ingest(self, arrivals):
        """Bulk-ingest one presorted ARRIVAL batch; returns ``(rows, uids)``.

        Semantically identical to constructing one PENDING ``Pod`` per
        arrival in order — uids are drawn from the same global counter, and
        ``submit_time == pending_since == arrival.time`` — but pod state
        lands directly in the columns: the only per-pod Python work is spec
        interning (a dict hit) plus C-speed column extends.
        """
        from repro_torch.core import pods as _pods_mod
        n = len(arrivals)
        first = self.n_rows
        ids = self._spec_ids
        intern = self._intern_spec
        for a in arrivals:               # register any first-seen specs
            if id(a.spec) not in ids:
                intern(a.spec)
        sids = [ids[id(a.spec)] for a in arrivals]
        times = [a.time for a in arrivals]
        uids = list(itertools.islice(_pods_mod._uid, n))
        spec_cpu, spec_mem, spec_dur = (self._spec_cpu, self._spec_mem,
                                        self._spec_dur)
        self.uid.extend(uids)
        self.spec_id.extend(sids)
        self.cpu_m.extend([spec_cpu[s] for s in sids])
        self.mem_mb.extend([spec_mem[s] for s in sids])
        self.duration_s.extend([spec_dur[s] for s in sids])
        self.submit_time.extend(times)
        self.pending_since.extend(times)
        self.phase.extend(bytes(n))              # POD_PENDING == 0
        self.node_slot.extend([-1] * n)
        self.bound_time.extend([None] * n)
        self.finish_time.extend([None] * n)
        self.incarnation.extend([0] * n)
        spec_flags = self._spec_flags
        self.flags.extend(bytes(spec_flags[s] for s in sids))
        self.lost_work_s.extend([0.0] * n)
        self.n_rows = first + n
        index = self.index
        for row, u in enumerate(uids, first):
            index[u] = row
        return range(first, first + n), uids

    def ingest_trace(self, trace, lo: int, hi: int):
        """Bulk-ingest rows ``[lo, hi)`` of a columnar trace
        (``repro_torch.scenarios.trace.TraceStore``); returns
        ``(rows, uids, times)``.

        The trace-native twin of :meth:`ingest` — identical column writes
        (uids drawn from the same global counter, request sizes read from
        the interned spec tables, so the values are bit-identical to the
        ``Arrival`` path), but no ``Arrival`` or ``Pod`` object exists at
        any point: the per-row Python work is C-speed list building from
        the trace's NumPy columns.  ``duration_s`` copies the trace's
        per-row column — equal to the template's duration for plain traces,
        row-specific for heavy-tailed scenario families (shells for such
        rows materialize a ``dataclasses.replace``-d spec, see
        :meth:`pod_at`)."""
        from repro_torch.core import pods as _pods_mod
        n = hi - lo
        first = self.n_rows
        sid_of = [self._intern_spec(s) for s in trace.templates]
        sids = [sid_of[t] for t in trace.template_id[lo:hi].tolist()]
        times = trace.arrival_time[lo:hi].tolist()
        uids = list(itertools.islice(_pods_mod._uid, n))
        spec_cpu, spec_mem = self._spec_cpu, self._spec_mem
        self.uid.extend(uids)
        self.spec_id.extend(sids)
        self.cpu_m.extend([spec_cpu[s] for s in sids])
        self.mem_mb.extend([spec_mem[s] for s in sids])
        self.duration_s.extend(trace.duration_s[lo:hi].tolist())
        self.submit_time.extend(times)
        self.pending_since.extend(times)
        self.phase.extend(bytes(n))              # POD_PENDING == 0
        self.node_slot.extend([-1] * n)
        self.bound_time.extend([None] * n)
        self.finish_time.extend([None] * n)
        self.incarnation.extend([0] * n)
        spec_flags = self._spec_flags
        self.flags.extend(bytes(spec_flags[s] for s in sids))
        self.lost_work_s.extend([0.0] * n)
        self.n_rows = first + n
        index = self.index
        for row, u in enumerate(uids, first):
            index[u] = row
        return range(first, first + n), uids, times

    def adopt(self, pod) -> int:
        """Register an externally-constructed (PENDING) ``Pod`` as a row.

        The object-path entry point (``Orchestrator.submit``, live-cluster
        submissions, tests): the pod itself stays the mutable face, the
        columns mirror it from day one."""
        row = self.index.get(pod.uid)
        if row is not None:
            return row
        row = self.n_rows
        self.n_rows = row + 1
        self.index[pod.uid] = row
        sid = self._intern_spec(pod.spec)
        self.uid.append(pod.uid)
        self.spec_id.append(sid)
        self.cpu_m.append(pod.spec.requests.cpu_m)
        self.mem_mb.append(pod.spec.requests.mem_mb)
        self.duration_s.append(pod.spec.duration_s)
        self.submit_time.append(pod.submit_time)
        self.pending_since.append(pod.pending_since)
        from repro_torch.core.pods import PodPhase
        code = {PodPhase.PENDING: POD_PENDING, PodPhase.BOUND: POD_BOUND,
                PodPhase.SUCCEEDED: POD_SUCCEEDED}[pod.phase]
        self.phase.append(code)
        self.node_slot.append(-1)
        self.bound_time.append(pod.bound_time)
        self.finish_time.append(pod.finish_time)
        self.incarnation.append(pod.incarnation)
        self.flags.append(self._spec_flags[sid])
        self.lost_work_s.append(pod.lost_work_s)
        self.shells[row] = pod
        return row

    # -- shells ----------------------------------------------------------------
    def pod_at(self, row: int):
        """The ``Pod`` for ``row``, materializing (and caching) a shell from
        the columns on first access."""
        pod = self.shells.get(row)
        if pod is None:
            import dataclasses

            from repro_torch.core.pods import Pod
            code = self.phase[row]
            slot = self.node_slot[row]
            bt = self.bound_time[row]
            spec = self._spec_by_id[self.spec_id[row]]
            if self.duration_s[row] != spec.duration_s:
                # Trace-native ingest with a per-row duration override
                # (heavy-tailed scenario families): the shell must carry
                # the row's true duration — an API-boundary object, so the
                # replace costs nothing on the hot path.
                spec = dataclasses.replace(
                    spec, duration_s=self.duration_s[row])
            # Intervals closed while the row was shell-less: bulk evictions
            # recorded them in closed_intervals (chronological), and an open
            # binding closes with the same `bound_time - pending_since`
            # float op Pod.bind applies — so the shell's list is exactly
            # what the seed object would carry.
            closed = self.closed_intervals.pop(row, None)
            intervals = list(closed) if closed is not None else []
            if bt is not None:
                intervals.append(bt - self.pending_since[row])
            pod = Pod._restore(
                spec=spec,
                submit_time=self.submit_time[row],
                uid=self.uid[row],
                phase=_phase_objects()[code],
                node_id=self.arr.node_ids[slot] if slot >= 0 else None,
                pending_since=self.pending_since[row],
                bound_time=bt,
                finish_time=self.finish_time[row],
                incarnation=self.incarnation[row],
                pending_intervals=intervals,
                lost_work_s=self.lost_work_s[row],
            )
            self.shells[row] = pod
        return pod

    def pod_by_uid(self, uid: int):
        return self.pod_at(self.index[uid])

    # -- object-path writeback (assignment-copy => bit-identical) --------------
    def sync_bind(self, pod, slot: int) -> None:
        row = self.index.get(pod.uid)
        if row is None:
            return
        self.phase[row] = POD_BOUND
        self.node_slot[row] = slot
        self.bound_time[row] = pod.bound_time

    def sync_unbind(self, pod) -> None:
        row = self.index.get(pod.uid)
        if row is None:
            return
        self.phase[row] = POD_PENDING
        self.node_slot[row] = -1
        self.bound_time[row] = None
        self.pending_since[row] = pod.pending_since
        self.incarnation[row] = pod.incarnation
        self.lost_work_s[row] = pod.lost_work_s

    def sync_complete(self, pod) -> None:
        row = self.index.get(pod.uid)
        if row is None:
            return
        self.phase[row] = POD_SUCCEEDED
        self.finish_time[row] = pod.finish_time

    # Column-path bind/complete commits live in Cluster.bind_wave_store /
    # Cluster.complete_wave_store, which interleave the column writes with
    # node accounting per entry; Pod semantics are preserved there (complete
    # retains node_slot/bound_time exactly like the object keeps node_id).

    # -- end-of-run aggregates -------------------------------------------------
    def pending_intervals_all(self):
        """Every pod's pending intervals (the multiset `_result` feeds to the
        metrics collector): shells contribute their recorded lists, shell-less
        rows derive their single interval from the columns."""
        out = []
        shells = self.shells
        ps = self.pending_since
        bt = self.bound_time
        closed = self.closed_intervals
        for row in range(self.n_rows):
            pod = shells.get(row)
            if pod is not None:
                out.extend(pod.pending_intervals)
            else:
                ci = closed.get(row)
                if ci is not None:
                    out.extend(ci)
                b = bt[row]
                if b is not None:
                    out.append(b - ps[row])
        return out

    def total_incarnations(self) -> int:
        """Σ incarnation — the seed's eviction count (columns are synced on
        every eviction, so no shell walk is needed)."""
        return sum(self.incarnation)

    def total_lost_work_s(self) -> float:
        """Σ lost_work_s over every row — bulk evictions write the column
        directly, object-path evictions sync it, so no shell walk is
        needed and the left-fold order (row == uid == submission order)
        matches the object engine's ``sum`` over ``orch.pods``."""
        return sum(self.lost_work_s, 0.0)

    # -- consistency (deep periodic invariant check) ---------------------------
    def audit_columns(self, cluster) -> None:
        """Vectorized deep audit: re-derive per-node accounting straight
        from the pod columns and compare against the mirror.

        Replaces the per-node object walk of
        ``Cluster.check_invariants(deep=True)`` on the array engine (a
        ROADMAP "next bottlenecks" item): the re-sum that used to
        materialize shells and iterate every resident in Python is now
        three ``bincount`` reductions over the bound rows — O(rows) at C
        speed, and **zero shells are materialized by the audit itself**.
        Shells that already exist are cross-checked attribute-for-attribute
        against their columns (the lockstep contract), which is O(shells),
        not O(rows).

        Checks:

        * every BOUND row sits on an active mirror slot;
        * per-slot Σcpu / Σmem / row-count over BOUND rows equal the
          mirror's ``used_cpu`` / ``used_mem`` / ``pod_count`` (cpu and
          counts exactly; mem to the seed walk's 1e-6 absolute tolerance —
          the re-sum's accumulation order differs from the incremental
          event order);
        * row ↔ residency linkage, bidirectionally: the BOUND uids grouped
          per slot equal each node's resident uid *set* (C-speed set
          equality — catches swapped residency between equal-request pods,
          which every aggregate above would miss);
        * materialized shells agree with their columns (phase,
          pending_since, bound/finish time, incarnation, node linkage).
        """
        arr = self.arr
        m = arr.n_slots
        n_rows = self.n_rows
        if n_rows:
            phase = np.frombuffer(self.phase, np.uint8, n_rows)
            bound = phase == POD_BOUND
            slots = np.asarray(self.node_slot, np.int64)[bound]
            assert slots.size == 0 or (
                slots.min() >= 0 and arr.active[slots].all()), \
                "bound pod on a missing/inactive node slot"
            cpu = np.asarray(self.cpu_m, np.float64)[bound]
            mem = np.asarray(self.mem_mb, np.float64)[bound]
            used_cpu = np.bincount(slots, weights=cpu, minlength=m)[:m]
            used_mem = np.bincount(slots, weights=mem, minlength=m)[:m]
            counts = np.bincount(slots, minlength=m)[:m]
            # Row ↔ residency linkage: group bound uids by slot and compare
            # against the node's resident key set.  (pod_count equality
            # below pins nodes with residents but no rows, so checking the
            # slots that *have* rows covers both directions.)
            if slots.size:
                uids = np.asarray(self.uid, np.int64)[bound]
                order = np.argsort(slots, kind="stable")
                s_sorted, u_sorted = slots[order], uids[order]
                cuts = np.flatnonzero(np.diff(s_sorted)) + 1
                slot_nodes = cluster._slot_nodes
                for slot, group in zip(
                        s_sorted[np.concatenate(([0], cuts))].tolist(),
                        np.split(u_sorted, cuts)):
                    node = slot_nodes[slot]
                    assert node is not None, f"bound rows on dead slot {slot}"
                    assert set(group.tolist()) == set(node.pods), \
                        f"row/residency drift on {node.node_id}"
        else:
            used_cpu = used_mem = np.zeros(m)
            counts = np.zeros(m, np.int64)
        live = arr.active[:m]
        # int64 column == float64 bincount sum: exact below 2**53.
        assert (arr.used_cpu[:m][live] == used_cpu[live]).all(), \
            "node used_cpu drifted from the pod columns"
        assert (np.abs(arr.used_mem[:m][live] - used_mem[live]) < 1e-6).all(), \
            "node used_mem drifted from the pod columns"
        assert (arr.pod_count[:m][live] == counts[live]).all(), \
            "node pod_count drifted from the pod columns"
        # Materialized shells stay in lockstep with their columns.
        from repro_torch.core.pods import PodPhase
        rev = {PodPhase.PENDING: POD_PENDING, PodPhase.BOUND: POD_BOUND,
               PodPhase.SUCCEEDED: POD_SUCCEEDED}
        node_ids = arr.node_ids
        for row, pod in self.shells.items():
            assert rev[pod.phase] == self.phase[row], pod
            assert self.pending_since[row] == pod.pending_since, pod
            assert self.bound_time[row] == pod.bound_time, pod
            assert self.finish_time[row] == pod.finish_time, pod
            assert self.incarnation[row] == pod.incarnation, pod
            assert self.lost_work_s[row] == pod.lost_work_s, pod
            assert row not in self.closed_intervals, \
                f"closed_intervals survived materialization for row {row}"
            if pod.phase is PodPhase.BOUND:
                slot = self.node_slot[row]
                assert slot >= 0 and node_ids[slot] == pod.node_id, pod
                node = cluster.nodes.get(pod.node_id)
                assert node is not None and pod.uid in node.pods, pod

    # -- consistency (property tests) ------------------------------------------
    def verify_against(self, cluster) -> None:
        """Assert columns, shells and node residency agree exactly."""
        from repro_torch.core.pods import PodPhase
        rev = {PodPhase.PENDING: POD_PENDING, PodPhase.BOUND: POD_BOUND,
               PodPhase.SUCCEEDED: POD_SUCCEEDED}
        assert len(self.uid) == self.n_rows == len(self.index)
        for row in range(self.n_rows):
            uid = self.uid[row]
            assert self.index[uid] == row
            pod = self.shells.get(row)
            if pod is not None:
                assert pod.uid == uid
                assert rev[pod.phase] == self.phase[row], pod
                assert self.pending_since[row] == pod.pending_since, pod
                assert self.bound_time[row] == pod.bound_time, pod
                assert self.finish_time[row] == pod.finish_time, pod
                assert self.incarnation[row] == pod.incarnation, pod
                assert self.lost_work_s[row] == pod.lost_work_s, pod
                if pod.phase == PodPhase.BOUND:
                    slot = self.node_slot[row]
                    assert slot >= 0
                    assert self.arr.node_ids[slot] == pod.node_id, pod
            if self.phase[row] == POD_BOUND:
                slot = self.node_slot[row]
                node = cluster.nodes.get(self.arr.node_ids[slot])
                assert node is not None, f"bound row {row} on dead node"
                assert uid in node.pods, f"bound row {row} missing from node"
