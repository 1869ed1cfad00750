"""Serving path of the port: the slot-based continuous-batching engine
(``engine``), token sampling (``sampling``) and the replay of the serve
fixtures whose parameters are drawn from a seed (``golden``)."""
