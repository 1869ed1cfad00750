"""Frozen counts of the work a cell needs, from its configuration and
shapes alone: the operations of a prefill, the operations and bytes of
one flash-attention launch, and the bytes a dense decode step needs.
They read the configuration file's keys and nothing of the program, so
a change to the program cannot change what its time is held against.

Operations are multiply-adds counted as two; bytes count each input
read once and each output written once, in the served dtypes (two
bytes a value, four for the float32 norm scales).
"""
from __future__ import annotations

from typing import Dict

BF16 = 2
F32 = 4


def _hd(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def causal_pairs(T: int) -> int:
    """Visible (query, key) pairs of one head's causal attention."""
    return T * (T + 1) // 2


def flash_ops(T: int, heads: int, hd: int) -> int:
    """q.k and p.v over the causal pairs: 4 operations a pair and head
    dimension."""
    return 4 * heads * hd * causal_pairs(T)


def flash_bytes(T: int, heads: int, kv_heads: int, hd: int) -> int:
    """q, k, v read once and the output written once, bf16."""
    return BF16 * T * hd * (2 * heads + 2 * kv_heads)


def flash_bound_s(T: int, heads: int, kv_heads: int, hd: int,
                  peaks: Dict) -> float:
    """The least time the card could take for one causal launch."""
    return max(flash_ops(T, heads, hd) / peaks["bf16_flop_per_s"],
               flash_bytes(T, heads, kv_heads, hd) / peaks["hbm_byte_per_s"])


def _layer_kinds(cfg: Dict):
    """'dense' or 'moe' for each layer, in order."""
    n, dense = cfg["num_layers"], cfg.get("first_k_dense", 0)
    if not cfg.get("n_experts"):
        return ["dense"] * n
    return ["dense"] * dense + ["moe"] * (n - dense)


def _attn_params(cfg: Dict) -> int:
    d, hd = cfg["d_model"], _hd(cfg)
    return d * hd * (2 * cfg["num_heads"] + 2 * cfg["num_kv_heads"])


def _dense_ff(cfg: Dict) -> int:
    """A dense layer's width: ``dense_d_ff`` in a MoE model that sets
    it, else ``d_ff``."""
    if cfg.get("n_experts") and cfg.get("dense_d_ff"):
        return cfg["dense_d_ff"]
    return cfg["d_ff"]


def prefill_flops(cfg: Dict, T: int) -> int:
    """Operations one prompt of T tokens needs: every token through
    every layer's projections, its attention over the causal pairs, its
    MLP (a MoE token: the router, its ``experts_per_token`` routed
    experts and the shared ones), and the head at the last position."""
    d, hd, H = cfg["d_model"], _hd(cfg), cfg["num_heads"]
    total = 2 * d * cfg["vocab_size"]
    for kind in _layer_kinds(cfg):
        total += 2 * T * _attn_params(cfg) + flash_ops(T, H, hd)
        if kind == "dense":
            total += 2 * T * 3 * d * _dense_ff(cfg)
        else:
            f = cfg["moe_d_ff"]
            per_token = d * cfg["n_experts"] \
                + 3 * d * f * (cfg["experts_per_token"]
                               + cfg.get("n_shared_experts", 0))
            total += 2 * T * per_token
    return total


def dense_weight_bytes(cfg: Dict) -> int:
    """Bytes of the weights one dense decode step reads once: every
    layer's matrices and norm scales, the final norm and the head over
    the vocabulary."""
    if cfg.get("n_experts"):
        raise ValueError("a MoE step's bytes depend on its routing")
    d = cfg["d_model"]
    layer = BF16 * (_attn_params(cfg) + 3 * d * cfg["d_ff"]) + F32 * 2 * d
    return cfg["num_layers"] * layer + F32 * d + BF16 * d * cfg["vocab_size"]


def kv_bytes_per_token(cfg: Dict) -> int:
    """Bytes of one position's keys and values over all layers, bf16."""
    return BF16 * 2 * cfg["num_kv_heads"] * _hd(cfg) * cfg["num_layers"]


def dense_decode_bytes(cfg: Dict, active: int, kv_positions: int) -> int:
    """Bytes one dense decode step needs: the weights once, each active
    request's embedding row, its cached positions read (``kv_positions``
    summed over the active requests, the new one included) and its new
    position written."""
    return (dense_weight_bytes(cfg) + BF16 * active * cfg["d_model"]
            + kv_bytes_per_token(cfg) * (kv_positions + active))
