"""Serving path of the port: the slot-based continuous-batching engine
(``engine``) and token sampling (``sampling``)."""
