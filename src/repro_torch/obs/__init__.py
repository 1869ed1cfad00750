"""Observability codes shared with the core (``repro/obs``, in part).

Only :mod:`repro_torch.obs.recorder`'s event, reason and disposition
codes are ported: the core's recorder hooks name them.  The flight
recorder, profiler and reports wait (ROADMAP.md Queue 1 item 18,
"obs/"), so every ``obs`` attribute in the core stays ``None``.
"""
