"""Serving path of the port: the slot-based continuous-batching engine
(``engine``), token sampling (``sampling``) and the replay of the xLSTM
and MoE serve fixtures (``golden``)."""
