"""Schedulers (paper §6.1 + the default-K8s baseline used in Fig. 4).

All schedulers implement the same two-stage shape Kubernetes uses:
*filter* (feasibility) then *select* (scoring).  The paper's contribution is
the selection rule; filtering is request-based feasibility on both axes.

Tainted nodes (Alg. 6 step 3) are used **only as a last resort**: the filter
first considers READY nodes and falls back to TAINTED nodes only when no
untainted node fits.

Two execution engines share each policy:

* the **object path** (seed engine) — list comprehensions over ``Node``
  objects, kept for parity testing and as the fallback when the cluster has
  no SoA mirror;
* the **array path** — filter+select as masked NumPy reductions over the
  cluster's :class:`repro_torch.core.engine.ClusterArrays` mirror.  Identical
  floats, identical IEEE ops, identical tie-breaks => identical bindings.

On the array path the orchestrator schedules in **waves**
(:meth:`Scheduler.select_wave_store`): the whole pending snapshot — rows of
the SoA :class:`repro_torch.core.engine.PodStore` — is placed against a
:class:`repro_torch.core.engine.WavePlacer` in one call, and the chosen bindings
are committed once per wave (``Cluster.bind_wave_store``, or the
object-path ``Cluster.bind_wave`` when an external observer needs ``Pod``
shells) instead of once per pod.  :meth:`Scheduler.select_wave` is the
``Pod``-based twin, kept as the documented reference implementation and for
direct callers.  Each policy contributes its vectorized selection rule
through two hooks:

* :attr:`Scheduler.wave_mode` — ``'min'``/``'max'``: which extremum of the
  policy's score vector wins (``None`` = no score, first feasible node in
  node_id order);
* :meth:`Scheduler.wave_scores` — the score vector itself, computed over the
  placer's working free columns (falls back to ``None`` for score-free
  policies).

``select_slot`` (the iterated single-pod array kernel) remains as the
non-wave array path used by :meth:`Scheduler.schedule`; a policy that
defines ``select_slot`` but keeps the default wave hooks is still wave-
compatible because the base ``select_wave`` loop and ``select_slot`` read
the same masks and tie-breaks.

Wave-placement parity contract (property-tested by
``tests/test_engine_parity.py``): a wave must produce the **bit-identical
bind sequence** the seed per-pod loop produces — same pods on the same
nodes in the same order, lowest-node_id tie-breaks — because the placer
advances its working frees with the same float ops the object accounting
applies (see ``repro_torch.core.engine``).

Tie-breaks are uniform across all four policies: among equally-scored
feasible nodes the **lexicographically lowest node_id wins**.
"""
from __future__ import annotations

import abc
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import engine as _engine
from repro_torch.core.cluster import Cluster, Node
from repro_torch.core.pods import Pod, PodPhase
from repro_torch.core.resources import Resources


def _lowest_id(nodes: List[Node]) -> Node:
    return min(nodes, key=lambda n: n.node_id)


class Scheduler(abc.ABC):
    """Base scheduler: filter feasible nodes, pick one, create the binding."""

    name = "scheduler"

    # Concrete policies override with a vectorized (arrays, mask, free_cpu,
    # free_mem, pod) -> slot implementation; None disables the array path.
    select_slot = None

    # Wave placement: which extremum of `wave_scores` wins ('min' | 'max');
    # None = score-free policy (first feasible node in node_id order).
    wave_mode: Optional[str] = None

    # Run-length fast path (select_wave_store): amortize one extremum query
    # over a run of same-size pods.  Sound only for 'min' policies whose
    # score at the bound rank can only move further into the minimum or go
    # infeasible (best-fit: free_mem decreases per bind) — every other rank's
    # cached score is frozen during the run, so the runner-up comparison is
    # exact.  Decision-identical to querying per pod (parity-tested).
    wave_run_length = False

    def suitable_nodes(self, cluster: Cluster, pod: Pod) -> List[Node]:
        """getAllSuitableNodes(p): feasible READY nodes, else TAINTED ones."""
        ready = [n for n in cluster.ready_nodes() if n.fits(pod.requests)]
        if ready:
            return ready
        # Last resort: tainted nodes (paper: "unless strictly necessary").
        return [n for n in cluster.tainted_nodes() if n.fits(pod.requests)]

    @abc.abstractmethod
    def select(self, nodes: List[Node], pod: Pod) -> Optional[Node]:
        """Pick the target node among feasible candidates."""

    def schedule(self, cluster: Cluster, pod: Pod, now: float) -> bool:
        """Paper Alg. 2 skeleton. Returns True iff a binding was created."""
        if cluster.arrays is not None and self.select_slot is not None:
            return self._schedule_arrays(cluster, pod, now)
        nodes = self.suitable_nodes(cluster, pod)
        node = self.select(nodes, pod) if nodes else None
        if node is None:
            return False
        cluster.bind(pod, node, now)
        return True

    # -- array engine ---------------------------------------------------------
    def _schedule_arrays(self, cluster: Cluster, pod: Pod, now: float) -> bool:
        arr = cluster.arrays
        if arr.n_slots == 0:
            return False
        req = pod.requests
        free_cpu, free_mem = arr.free_views()
        # Same feasibility ops as Resources.fits_in, elementwise.
        fits = (free_cpu >= req.cpu_m) & ((free_mem + 1e-9) >= req.mem_mb)
        state = arr.live("state")
        mask = fits & arr.live("active") & (state == _engine.STATE_READY)
        if not mask.any():
            mask = fits & arr.live("active") & (state == _engine.STATE_TAINTED)
            if not mask.any():
                return False
        slot = self.select_slot(arr, mask, free_cpu, free_mem, pod)
        if slot < 0:
            return False
        cluster.bind(pod, cluster.node_by_slot(slot), now)
        return True

    # -- wave placement (vectorized multi-pod array engine) --------------------
    def wave_scores(self, placer, req, sl=slice(None)) -> Optional[np.ndarray]:
        """Policy score vector over ``placer``'s working frees, or None.

        ``sl`` restricts the computation to a slice of ranks: ``select_wave``
        passes a single-rank slice to refresh a cached score buffer after a
        placement (NumPy ops on a length-1 view are the same IEEE-754 ops as
        the full-vector elementwise computation, so the refreshed entry is
        bit-identical to a recompute).  May return a *view* of a placer
        column (e.g. ``free_mem``).
        """
        return None

    def wave_score_at(self, placer, req, r: int):
        """Scalar policy score at rank ``r`` — the per-bind cache refresh.

        Default falls back to a length-1 ``wave_scores`` slice; policies
        whose score is a direct column read (best-fit / worst-fit) or a
        scalar formula (k8s-default) override it to skip the vector-slice
        machinery.  Must apply the same IEEE-754 double ops as the
        elementwise vector computation so the refreshed entry stays
        bit-identical to a full recompute."""
        return self.wave_scores(placer, req, slice(r, r + 1))[0]

    def select_wave(self, placer, pods: List[Pod],
                    start: int = 0) -> Tuple[list, Optional[int]]:
        """Place ``pods[start:]`` in order against the placer's working state.

        The wave engine of ``Orchestrator.cycle``: pods are considered in
        snapshot (FIFO) order; each placement is recorded in the placer's
        working arrays so later pods of the wave observe it, but **no object
        state is touched** — the caller commits the returned prefix with
        ``Cluster.bind_wave``.

        Returns ``(bindings, blocked)``: ``bindings`` is the placed prefix as
        ``(pod, slot)`` pairs, and ``blocked`` is the index (into ``pods``)
        of the first pod with no feasible node — or ``None`` when the whole
        remainder was placed.  The orchestrator then runs the paper's
        rescheduling/scale-out path for the blocked pod and resumes the wave
        after it.

        Selection per pod is one extremum query over a per-request-size
        score buffer: the buffer holds the policy score where the node is
        READY and feasible and ±inf elsewhere, lives in node-id rank order
        (so the first extremum *is* the lowest-node_id tie-break), is
        memoized in ``placer.cache``, and is refreshed only at the just-bound
        rank after each placement — O(1) amortized filter+score work per pod
        for repeated request sizes.  The extremum itself runs on one of two
        kernels (``ClusterArrays.wave_select`` / ``ExperimentSpec``):

        * **flat** — one C-speed O(nodes) ``argmin``/``argmax`` per pod;
        * **segment tree** — an :class:`repro_torch.core.engine.SegExtTree` per
          cached buffer answers the first-extremum query in O(log nodes)
          and absorbs the per-bind refresh as an O(log nodes) point update.

        Both kernels return the identical rank (same extremum, same
        first-index tie-break), so decisions are bit-identical to each other
        and to iterating ``select_slot`` pod by pod (see the module
        docstring).
        """
        bindings: List[Tuple[Pod, int]] = []
        cache = placer.cache
        cache_list = placer.cache_list
        mode = self.wave_mode
        mode_min = mode == "min"
        fill = np.inf if mode_min else -np.inf
        slot_of_rank = placer.slot_of_rank_list
        use_tree = placer.use_tree
        ready = placer.ready
        free_cpu, free_mem = placer.free_cpu, placer.free_mem
        used_cpu, used_mem = placer.used_cpu, placer.used_mem
        alloc_cpu, alloc_mem = placer.alloc_cpu, placer.alloc_mem
        pending = PodPhase.PENDING
        score_at = self.wave_score_at
        for i in range(start, len(pods)):
            pod = pods[i]
            if pod.phase is not pending:
                continue   # a binding rescheduler may have placed it already
            if placer.n == 0:
                return bindings, i
            req = pod.requests
            key = (req.cpu_m, req.mem_mb)
            ent = cache.get(key)
            if ent is None:
                # Same feasibility ops as Resources.fits_in, elementwise.
                fits = (free_cpu >= req.cpu_m) & (
                    (free_mem + 1e-9) >= req.mem_mb)
                mask = fits & ready
                if mode is None:
                    buf = mask          # argmax(bool) == first feasible rank
                else:
                    buf = np.where(mask, self.wave_scores(placer, req), fill)
                if not use_tree:
                    tree = None
                elif mode is None:
                    # Boolean mask as a 'max' tree with -inf infeasible
                    # entries: first rank attaining 1.0 == first feasible,
                    # all-(-inf) root == no feasible rank.
                    tree = _engine.SegExtTree(
                        np.where(mask, 1.0, -np.inf), False)
                else:
                    tree = _engine.SegExtTree(buf, mode_min)
                ent = (fits, mask, buf, req, tree, key[0], key[1])
                cache[key] = ent
                cache_list.append(ent)
            fits, mask, buf, _, tree, _, _ = ent
            if tree is None:
                r = int(buf.argmin() if mode_min else buf.argmax())
                feasible = mask[r] if mode is None else buf[r] != fill
            else:
                r = tree.argext()
                feasible = r >= 0
            if not feasible:
                # No READY node fits.  Last resort: tainted nodes (paper:
                # "unless strictly necessary") — same fallback as per-pod.
                r = self._select_wave_tainted(placer, fits, req)
                if r < 0:
                    return bindings, i
            bindings.append((pod, slot_of_rank[r]))
            # Inlined placer.bind(r, req): same `+=` / `alloc - used` float
            # ops as the object accounting, so the rest of the wave sees
            # bit-identical frees.
            used_cpu[r] += req.cpu_m
            used_mem[r] += req.mem_mb
            free_cpu[r] = alloc_cpu[r] - used_cpu[r]
            free_mem[r] = alloc_mem[r] - used_mem[r]
            # Only the bound rank's feasibility/score changed: refresh that
            # one entry in every cached buffer.  Scalar extraction is exact
            # (int64/float64 round-trip verbatim), and Python int/float
            # comparisons and the `+ 1e-9` are the identical IEEE doubles
            # the elementwise vector ops compute.
            fc = int(free_cpu[r])
            fm_eps = float(free_mem[r]) + 1e-9
            ready_r = bool(ready[r])
            for f2, m2, b2, r2, t2, cpu_m, mem_mb in cache_list:
                ok = fc >= cpu_m and fm_eps >= mem_mb
                f2[r] = ok
                ok = ok and ready_r
                m2[r] = ok
                if mode is not None:
                    v = score_at(placer, r2, r) if ok else fill
                    b2[r] = v
                    if t2 is not None:
                        t2.update(r, v)
                elif t2 is not None:   # buf is the mask itself (1/-inf tree)
                    t2.update(r, 1.0 if ok else -np.inf)
        return bindings, None

    def _select_wave_tainted(self, placer, fits, req) -> int:
        """Tainted-node fallback of the wave filter: rank of the policy's
        pick among feasible TAINTED nodes, or -1.  Cold path — only reached
        when no READY node fits — so nothing is cached."""
        mask = fits & placer.tainted
        if not mask.any():
            return -1
        if self.wave_mode is None:
            return int(mask.argmax())
        fill = np.inf if self.wave_mode == "min" else -np.inf
        buf = np.where(mask, self.wave_scores(placer, req), fill)
        return int(buf.argmin() if self.wave_mode == "min" else buf.argmax())

    def select_wave_store(self, placer, store, rows,
                          start: int = 0) -> Tuple[list, Optional[int]]:
        """Row-native :meth:`select_wave`: place ``rows[start:]`` of a
        :class:`repro_torch.core.engine.PodStore` against the placer.

        The store-path wave engine of ``Orchestrator.cycle``.  Identical
        decision procedure to :meth:`select_wave` — same cached ±inf-masked
        score buffers, same per-bind float ops, same refresh, same
        tie-breaks — except pod phase and request sizes are read from the
        SoA columns instead of ``Pod`` attributes, and no object is ever
        touched.  Returns ``(bindings, blocked)`` where ``bindings`` is the
        placed prefix as ``(row, slot)`` pairs.

        **Run-length fast path** (``wave_run_length`` policies, best-fit):
        one extremum query is amortized over a run of consecutive same-size
        pods.  After placing a pod at rank ``r``, the runner-up ``(v2, r2)``
        — the first extremum with ``r`` masked out — is computed once; while
        successive pods carry the same request key, the next extremum is
        decidable from two scalars, because only ``buf[r]`` has changed:
        the per-pod query collapses to *stay at r iff
        ``(buf[r], r) < (v2, r2)`` lexicographically and r still fits*.  The
        moment ``r`` goes infeasible or loses to the runner-up the loop
        falls back to a full query.  Accounting floats still advance one pod
        at a time in bind order (``+=`` / ``alloc − used``), so the working
        frees — and therefore every subsequent decision — are bit-identical
        to the per-pod query path; cache refreshes for the run's rank are
        flushed before the next query reads any buffer (refreshes are pure
        functions of the current working frees, so one flush equals the
        per-bind refreshes it replaces).  ``Cluster(wave_runlen=False)`` forces
        the per-pod query path for A/B parity testing.
        """
        bindings: List[Tuple[int, int]] = []
        cache = placer.cache
        cache_list = placer.cache_list
        mode = self.wave_mode
        mode_min = mode == "min"
        fill = np.inf if mode_min else -np.inf
        slot_of_rank = placer.slot_of_rank_list
        use_tree = placer.use_tree
        ready = placer.ready
        free_cpu, free_mem = placer.free_cpu, placer.free_mem
        used_cpu, used_mem = placer.used_cpu, placer.used_mem
        alloc_cpu, alloc_mem = placer.alloc_cpu, placer.alloc_mem
        phase_col = store.phase
        cpu_col = store.cpu_m
        mem_col = store.mem_mb
        pending = _engine.POD_PENDING
        score_at = self.wave_score_at
        run_len = (self.wave_run_length and mode_min
                   and placer.arr.wave_runlen)

        def refresh(r):
            # Only rank r's feasibility/score changed: refresh that one
            # entry in every cached buffer.  Scalar extraction is exact
            # (int64/float64 round-trip verbatim), and Python int/float
            # comparisons and the `+ 1e-9` are the identical IEEE doubles
            # the elementwise vector ops compute.
            fc = int(free_cpu[r])
            fm_eps = float(free_mem[r]) + 1e-9
            ready_r = bool(ready[r])
            for f2, m2, b2, r2, t2, c2, m_mb2 in cache_list:
                ok = fc >= c2 and fm_eps >= m_mb2
                f2[r] = ok
                ok = ok and ready_r
                m2[r] = ok
                if mode is not None:
                    v = score_at(placer, r2, r) if ok else fill
                    b2[r] = v
                    if t2 is not None:
                        t2.update(r, v)
                elif t2 is not None:   # buf is the mask itself (1/-inf tree)
                    t2.update(r, 1.0 if ok else -np.inf)

        blocked_keys = placer.blocked_keys
        i = start
        n = len(rows)
        while i < n:
            row = rows[i]
            if phase_col[row] != pending:
                i += 1
                continue   # a binding rescheduler may have placed it already
            if placer.n == 0:
                return bindings, i
            cpu_m = cpu_col[row]
            mem_mb = mem_col[row]
            key = (cpu_m, mem_mb)
            if key in blocked_keys:
                return bindings, i   # latched infeasible (frees only shrink)
            ent = cache.get(key)
            if ent is None:
                req = Resources(cpu_m, mem_mb)
                # Same feasibility ops as Resources.fits_in, elementwise.
                fits = (free_cpu >= cpu_m) & ((free_mem + 1e-9) >= mem_mb)
                mask = fits & ready
                if mode is None:
                    buf = mask          # argmax(bool) == first feasible rank
                else:
                    buf = np.where(mask, self.wave_scores(placer, req), fill)
                if not use_tree:
                    tree = None
                elif mode is None:
                    tree = _engine.SegExtTree(
                        np.where(mask, 1.0, -np.inf), False)
                else:
                    tree = _engine.SegExtTree(buf, mode_min)
                ent = (fits, mask, buf, req, tree, cpu_m, mem_mb)
                cache[key] = ent
                cache_list.append(ent)
            fits, mask, buf, req, tree, _, _ = ent
            if tree is None:
                r = int(buf.argmin() if mode_min else buf.argmax())
                feasible = mask[r] if mode is None else buf[r] != fill
            else:
                r = tree.argext()
                feasible = r >= 0
            if not feasible:
                # No READY node fits.  Last resort: tainted nodes (paper:
                # "unless strictly necessary") — same fallback as per-pod.
                r = self._select_wave_tainted(placer, fits, req)
                if r < 0:
                    blocked_keys.add(key)
                    return bindings, i
            bindings.append((row, slot_of_rank[r]))
            # Same `+=` / `alloc - used` float ops as the object accounting,
            # so the rest of the wave sees bit-identical frees.
            used_cpu[r] += cpu_m
            used_mem[r] += mem_mb
            free_cpu[r] = alloc_cpu[r] - used_cpu[r]
            free_mem[r] = alloc_mem[r] - used_mem[r]
            # Inlined refresh(r) — the per-bind hot path skips the call.
            fc = int(free_cpu[r])
            fm_eps = float(free_mem[r]) + 1e-9
            rdy = bool(ready[r])
            for f2, m2, b2, r2_, t2, c2, m_mb2 in cache_list:
                ok = fc >= c2 and fm_eps >= m_mb2
                f2[r] = ok
                ok = ok and rdy
                m2[r] = ok
                if mode is not None:
                    v = score_at(placer, r2_, r) if ok else fill
                    b2[r] = v
                    if t2 is not None:
                        t2.update(r, v)
                elif t2 is not None:
                    t2.update(r, 1.0 if ok else -np.inf)
            i += 1
            # Run-length continuation must pay for itself: the runner-up
            # query is one extra extremum pass, and a run of exactly two
            # breaks even (one saved query, one paid) — so peek *two* rows
            # ahead and only arm the fast path for runs of three or more.
            if (not run_len or not feasible or i + 1 >= n
                    or cpu_col[rows[i]] != cpu_m
                    or mem_col[rows[i]] != mem_mb
                    or cpu_col[rows[i + 1]] != cpu_m
                    or mem_col[rows[i + 1]] != mem_mb):
                continue   # (feasible False => tainted fallback bind: no run)
            # -- run-length continuation at rank r -----------------------------
            if tree is None:
                old = buf[r]
                buf[r] = fill
                r2 = int(buf.argmin())
                v2 = buf[r2]
                buf[r] = old
            else:
                old = buf[r]
                tree.update(r, fill)
                r2 = tree.argext()
                tree.update(r, old)
                v2 = buf[r2] if r2 >= 0 else fill
                if r2 < 0:
                    r2 = placer.n   # sentinel: no competitor, v2 == fill
            ready_r = bool(ready[r])
            dirty = False
            while i < n:
                row2 = rows[i]
                if phase_col[row2] != pending:
                    i += 1
                    continue
                if cpu_col[row2] != cpu_m or mem_col[row2] != mem_mb:
                    break   # run over: next pod has a different request key
                # Identical scalar feasibility ops as refresh()/fits_in.
                if not (ready_r and int(free_cpu[r]) >= cpu_m
                        and float(free_mem[r]) + 1e-9 >= mem_mb):
                    break   # r no longer fits: full re-query needed
                v = score_at(placer, req, r)
                if v > v2 or (v == v2 and r2 < r):
                    break   # the frozen runner-up now wins the extremum
                bindings.append((row2, slot_of_rank[r]))
                used_cpu[r] += cpu_m
                used_mem[r] += mem_mb
                free_cpu[r] = alloc_cpu[r] - used_cpu[r]
                free_mem[r] = alloc_mem[r] - used_mem[r]
                dirty = True
                i += 1
            if dirty:
                refresh(r)   # flush the run's deferred per-bind refreshes
        return bindings, None


class BestFitBinPackingScheduler(Scheduler):
    """Paper Alg. 2 — online best-fit bin packing.

    Filter nodes with enough free CPU (compressible), then among those that
    also fit the memory request pick the one with the **least** free memory:
    the fullest bin that still accommodates the item.  Memory is the best-fit
    key because it is the non-compressible axis (§6.1).
    """

    name = "best-fit"
    wave_mode = "min"
    # Binding at rank r strictly decreases free_mem[r] while all other ranks
    # are frozen, so a run of same-size pods piles onto r until it fills or
    # ties against the runner-up — the premise of the run-length fast path.
    wave_run_length = True

    def select(self, nodes: List[Node], pod: Pod) -> Optional[Node]:
        if not nodes:
            return None
        # Deterministic tie-break on node_id.
        return min(nodes, key=lambda n: (n.free.mem_mb, n.node_id))

    def select_slot(self, arr, mask, free_cpu, free_mem, pod) -> int:
        best = free_mem[mask].min()
        return arr.first_by_id(mask & (free_mem == best))

    def wave_scores(self, placer, req, sl=slice(None)):
        # A view into the working frees: the cached score buffer is still a
        # masked *copy* (np.where) that select_wave must refresh per bind —
        # the view only makes that single-element refresh read for free.
        return placer.free_mem[sl]

    def wave_score_at(self, placer, req, r: int):
        return placer.free_mem[r]


def _k8s_scores(free_cpu, free_mem, alloc_cpu, alloc_mem, req):
    """LeastRequestedPriority + BalancedResourceAllocation, equally weighted.

    Shared by both engines: the object path feeds scalars, the array path
    feeds vectors; NumPy elementwise ops are the same IEEE-754 double ops, so
    the scores are bit-identical.
    """
    cpu_frac = (free_cpu - req.cpu_m) / np.maximum(alloc_cpu, 1)
    mem_frac = (free_mem - req.mem_mb) / np.maximum(alloc_mem, 1e-9)
    least_requested = 10.0 * (cpu_frac + mem_frac) / 2.0
    balanced = 10.0 * (1.0 - np.abs(cpu_frac - mem_frac))
    return (least_requested + balanced) / 2.0


class KubernetesDefaultScheduler(Scheduler):
    """The Fig. 4 baseline: default kube-scheduler scoring (v1.10 era).

    LeastRequestedPriority + BalancedResourceAllocation, equally weighted —
    a *spread* strategy that favours the least-loaded node, the opposite of
    bin packing.  Run on a fixed-size static cluster in the baseline.
    """

    name = "k8s-default"
    wave_mode = "max"

    def select(self, nodes: List[Node], pod: Pod) -> Optional[Node]:
        if not nodes:
            return None

        def score(n: Node) -> float:
            free = n.free
            cap = n.allocatable
            return float(_k8s_scores(free.cpu_m, free.mem_mb,
                                     cap.cpu_m, cap.mem_mb, pod.requests))

        scored = [(score(n), n) for n in nodes]
        best = max(s for s, _ in scored)
        return _lowest_id([n for s, n in scored if s == best])

    def select_slot(self, arr, mask, free_cpu, free_mem, pod) -> int:
        scores = _k8s_scores(free_cpu, free_mem, arr.live("alloc_cpu"),
                             arr.live("alloc_mem"), pod.requests)
        best = scores[mask].max()
        return arr.first_by_id(mask & (scores == best))

    def wave_scores(self, placer, req, sl=slice(None)):
        return _k8s_scores(placer.free_cpu[sl], placer.free_mem[sl],
                           placer.alloc_cpu[sl], placer.alloc_mem[sl], req)

    def wave_score_at(self, placer, req, r: int):
        # NumPy scalar ops are the same IEEE-754 doubles as the elementwise
        # vector computation — bit-identical to a length-1 slice.
        return _k8s_scores(placer.free_cpu[r], placer.free_mem[r],
                           placer.alloc_cpu[r], placer.alloc_mem[r], req)


def _weighted_scores(free_cpu, free_mem, alloc_cpu, alloc_mem, req,
                     w_pack, w_lr, w_bal):
    """Parameterized scoring: packing + LeastRequested + Balanced, weighted.

    The policy-search scoring surface (repro_torch.search): ``w_pack`` pulls
    toward bin packing (fullest-after-placement node wins — best-fit's
    regime), ``w_lr`` toward spreading (least-requested — k8s-default's
    regime) and ``w_bal`` toward cpu/mem balance.  Shared by both engines
    exactly like ``_k8s_scores``: scalars on the object path, vectors on
    the array path, same IEEE-754 double ops either way, so scores are
    bit-identical across engines.
    """
    cpu_frac = (free_cpu - req.cpu_m) / np.maximum(alloc_cpu, 1)
    mem_frac = (free_mem - req.mem_mb) / np.maximum(alloc_mem, 1e-9)
    # Packing keys on memory alone — best-fit's non-compressible axis
    # (§6.1) — so it is not an affine shadow of LeastRequested (which
    # averages both axes): the three weights span genuinely different
    # orderings.
    pack = 10.0 * (1.0 - mem_frac)
    least_requested = 10.0 * (cpu_frac + mem_frac) / 2.0
    balanced = 10.0 * (1.0 - np.abs(cpu_frac - mem_frac))
    return w_pack * pack + w_lr * least_requested + w_bal * balanced


class WeightedScoringScheduler(Scheduler):
    """Tunable-weight scheduler — the policy-search scoring knob.

    A continuous family that contains both ends of the paper's Fig.-4
    comparison: ``(1, 0, 0)`` is ordering-equivalent to best-fit bin
    packing on a homogeneous fleet (max packing == min free memory after
    placement) and ``(0, 1, 1)`` is ordering-equivalent to the k8s-default
    LeastRequested+Balanced blend (same sum, scaled by 2).
    ``repro_torch.search`` optimizes the three weights against the
    cost/pending/utilization front.
    """

    name = "weighted"
    wave_mode = "max"

    def __init__(self, w_pack: float = 1.0, w_lr: float = 0.0,
                 w_bal: float = 0.0):
        total = w_pack + w_lr + w_bal
        if not (total > 0.0):     # also rejects NaN
            raise ValueError(
                f"weighted scheduler needs w_pack + w_lr + w_bal > 0, got "
                f"({w_pack}, {w_lr}, {w_bal})")
        if min(w_pack, w_lr, w_bal) < 0.0:
            raise ValueError(f"weights must be non-negative, got "
                             f"({w_pack}, {w_lr}, {w_bal})")
        self.weights = (float(w_pack), float(w_lr), float(w_bal))

    def _scores(self, free_cpu, free_mem, alloc_cpu, alloc_mem, req):
        w_pack, w_lr, w_bal = self.weights
        return _weighted_scores(free_cpu, free_mem, alloc_cpu, alloc_mem,
                                req, w_pack, w_lr, w_bal)

    def select(self, nodes: List[Node], pod: Pod) -> Optional[Node]:
        if not nodes:
            return None

        def score(n: Node) -> float:
            free = n.free
            cap = n.allocatable
            return float(self._scores(free.cpu_m, free.mem_mb,
                                      cap.cpu_m, cap.mem_mb, pod.requests))

        scored = [(score(n), n) for n in nodes]
        best = max(s for s, _ in scored)
        return _lowest_id([n for s, n in scored if s == best])

    def select_slot(self, arr, mask, free_cpu, free_mem, pod) -> int:
        scores = self._scores(free_cpu, free_mem, arr.live("alloc_cpu"),
                              arr.live("alloc_mem"), pod.requests)
        best = scores[mask].max()
        return arr.first_by_id(mask & (scores == best))

    def wave_scores(self, placer, req, sl=slice(None)):
        return self._scores(placer.free_cpu[sl], placer.free_mem[sl],
                            placer.alloc_cpu[sl], placer.alloc_mem[sl], req)

    def wave_score_at(self, placer, req, r: int):
        # NumPy scalar ops are the same IEEE-754 doubles as the elementwise
        # vector computation — bit-identical to a length-1 slice.
        return self._scores(placer.free_cpu[r], placer.free_mem[r],
                            placer.alloc_cpu[r], placer.alloc_mem[r], req)


class FirstFitScheduler(Scheduler):
    """Ablation baseline: first feasible node in id order (classic FF)."""

    name = "first-fit"

    def select(self, nodes: List[Node], pod: Pod) -> Optional[Node]:
        return _lowest_id(nodes) if nodes else None

    def select_slot(self, arr, mask, free_cpu, free_mem, pod) -> int:
        return arr.first_by_id(mask)


class WorstFitScheduler(Scheduler):
    """Ablation baseline: emptiest feasible node (Docker Swarm 'spread')."""

    name = "worst-fit"
    wave_mode = "max"

    def select(self, nodes: List[Node], pod: Pod) -> Optional[Node]:
        if not nodes:
            return None
        best = max(n.free.mem_mb for n in nodes)
        return _lowest_id([n for n in nodes if n.free.mem_mb == best])

    def select_slot(self, arr, mask, free_cpu, free_mem, pod) -> int:
        best = free_mem[mask].max()
        return arr.first_by_id(mask & (free_mem == best))

    def wave_scores(self, placer, req, sl=slice(None)):
        return placer.free_mem[sl]

    def wave_score_at(self, placer, req, r: int):
        return placer.free_mem[r]


SCHEDULERS = {
    cls.name: cls
    for cls in (BestFitBinPackingScheduler, KubernetesDefaultScheduler,
                FirstFitScheduler, WorstFitScheduler,
                WeightedScoringScheduler)
}
