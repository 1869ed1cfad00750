"""Serving path of the port: the slot-based continuous-batching engine
(``engine``), token sampling (``sampling``) and the xLSTM serve fixture's
replay (``golden``)."""
