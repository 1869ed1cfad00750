"""Event kinds, eviction reasons, scale-out dispositions and rescheduler
outcomes of the flight recorder, copied from ``repro/obs/recorder.py``.

The autoscaler and the rescheduler pass these codes to their ``obs``
hooks; the recorder that would receive them is not ported yet.
"""
from __future__ import annotations

# -- event kinds -------------------------------------------------------------
(EV_BIND, EV_EVICT, EV_SCALE_OUT, EV_SCALE_IN, EV_NOTICE, EV_RESCHED,
 EV_FORECAST) = range(7)
KIND_NAMES = ("bind", "evict", "scale_out", "scale_in", "preempt_notice",
              "resched", "forecast")

# -- eviction reasons (EVICT detail ``v2``) ----------------------------------
(R_UNSPEC, R_RESCHED, R_CONSOLIDATE, R_NODE_FAIL, R_STRAGGLER,
 R_CRASH) = range(6)
REASON_NAMES = ("unspecified", "reschedule", "scale_in_consolidation",
                "node_fail", "straggler", "crash_loop")

# -- scale-out dispositions (SCALE_OUT detail ``v1``) ------------------------
(SO_LIMITED, SO_LAUNCH, SO_ABSORBED, SO_ASSOCIATED, SO_PRELAUNCH) = range(5)
SCALE_OUT_NAMES = ("rate_limited", "launched", "absorbed_by_booting",
                   "already_associated", "predictive_prelaunch")

# -- rescheduler outcomes (RESCHED detail ``v1``) ----------------------------
(RS_WAIT, RS_RESCHEDULED, RS_FAILED) = range(3)
RESCHED_NAMES = ("wait", "rescheduled", "failed")
