"""Mixture-of-Experts layer, as ``repro/models/moe.py``: GShard-style
grouped dispatch with a capacity per expert and group, top-k routing
renormalised over the chosen experts, shared experts (DeepSeekMoE's
always-on experts, added to the routed output) and the Switch
load-balancing loss.

The semantics are the reference's, step by step:

* tokens in groups of ``Sg = min(MOE_GROUP_SIZE, T)``; a sequence that
  is not a whole number of groups is refused;
* router logits in the activation dtype, a float32 softmax, the top
  ``K`` experts (ties to the lower expert index, as ``jax.lax.top_k``
  orders them) and their weights renormalised by ``sum + 1e-9``;
* the Switch loss from each token's first choice (:func:`aux_loss`,
  which only training asks for: the serve path never builds it);
* capacity positions counted over the group's tokens in order, then
  each token's choices in order; a choice at position ``>= C`` is
  dropped and gives no routed output;
* the combine weights rounded to the activation dtype.

The reference writes dispatch and combine as one-hot einsums over
(B, G, Sg, E, C).  Here the kept tokens are copied by index into a
zero-filled (E, B·G·C, D) buffer, which is what its ``dispatch`` einsum
computes; the three expert products are ``torch.bmm`` over the experts;
and each token gathers its kept rows back, weighted and summed in
float32.  The expert products are plain matrix products in the
reference too (``jnp.einsum`` outside any Pallas kernel), so this layer
has no kernel of its own.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamSpec

MOE_GROUP_SIZE = 512   # tokens per dispatch group (GShard "groups")


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts
    specs: Dict[str, ParamSpec] = {
        "w_router": ParamSpec((d, e), ("embed", "expert")),
        "w_gate": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "w_up": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "w_down": ParamSpec((e, f, d), ("expert", "mlp", "embed")),
    }
    if cfg.n_shared_experts > 0:
        fs = f * cfg.n_shared_experts
        specs["shared_gate"] = ParamSpec((d, fs), ("embed", "mlp"))
        specs["shared_up"] = ParamSpec((d, fs), ("embed", "mlp"))
        specs["shared_down"] = ParamSpec((fs, d), ("mlp", "embed"))
    return specs


def group_capacity(cfg: ArchConfig, group_len: int) -> int:
    cap = int(group_len * cfg.experts_per_token * cfg.capacity_factor
              / cfg.n_experts)
    return max(cap, cfg.experts_per_token)


def groups(T: int) -> Tuple[int, int]:
    """(G, Sg): the number of dispatch groups and their length."""
    Sg = min(MOE_GROUP_SIZE, T)
    if T % Sg:
        raise ValueError(f"a sequence of {T} tokens is not a multiple of "
                         f"the MoE group of {Sg} tokens")
    return T // Sg, Sg


class Routing(NamedTuple):
    """Each token's choices, best first: all (B, G, Sg, K) but ``probs``."""
    gate_idx: torch.Tensor   # int64 expert ids
    gate_vals: torch.Tensor  # float32 weights, renormalised over the K
    pos: torch.Tensor        # int64 position in its expert's capacity
    keep: torch.Tensor       # bool, pos < C
    probs: torch.Tensor      # (B, G, Sg, E) float32 router softmax


def route(p, xg: torch.Tensor, cfg: ArchConfig) -> Routing:
    """Top-k routing and capacity positions of grouped tokens
    xg (B, G, Sg, D)."""
    B, G, Sg, _ = xg.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = xg @ p["w_router"].to(xg.dtype)                 # (B,G,Sg,E)
    probs = torch.softmax(logits.float(), dim=-1)
    # A stable descending sort puts the lower index first among equal
    # probabilities, as jax.lax.top_k does (torch.topk promises no order).
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :K], idx[..., :K]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # Position of each choice in its expert's capacity: the choices before
    # it for the same expert, over the group's tokens and then k in order.
    # The count runs along the last axis, where a scan is parallel.
    flat = gate_idx.reshape(B, G, 1, Sg * K)
    onehot = torch.zeros(B, G, E, Sg * K, dtype=torch.int32,
                         device=xg.device).scatter_(2, flat, 1)
    before = onehot.cumsum(-1, dtype=torch.int32) - onehot
    pos = before.gather(2, flat).reshape(B, G, Sg, K).long()
    return Routing(gate_idx, gate_vals, pos, pos < group_capacity(cfg, Sg),
                   probs)


def aux_loss(r: Routing, cfg: ArchConfig) -> torch.Tensor:
    """Switch's load-balancing loss, E * sum_e f_e * p_e, from each
    token's first choice: () float32."""
    E = cfg.n_experts
    me = r.probs.mean(dim=(0, 1, 2))
    ce = F.one_hot(r.gate_idx[..., 0], E).float().mean(dim=(0, 1, 2))
    return cfg.router_aux_coef * E * torch.sum(me * ce)


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, Routing]:
    """x: (B, T, D) -> (out (B, T, D), its routing).  The reference's
    ``apply_moe`` returns the aux loss in place of the routing:
    ``aux_loss(routing, cfg)`` is that loss."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    G, Sg = groups(T)
    C = group_capacity(cfg, Sg)
    dt = x.dtype
    r = route(p, x.reshape(B, G, Sg, D), cfg)

    # Row of each choice in the (E * B·G·C, D) expert buffer: expert, then
    # group, then capacity position; kept rows are unique.  Dropped
    # choices go to one spare row past the buffer, so no step waits on
    # the host for the count of kept ones.
    rows = B * G * C
    group = torch.arange(B * G, device=x.device).reshape(B, G, 1, 1)
    slot = r.gate_idx * rows + group * C + r.pos
    token = torch.arange(B * T, device=x.device).repeat_interleave(K)
    xe = x.new_zeros(E * rows + 1, D).index_copy(
        0, torch.where(r.keep, slot, E * rows).reshape(-1),
        x.reshape(B * T, D)[token])

    xe = xe[:-1].view(E, rows, D)
    g = torch.bmm(xe, p["w_gate"].to(dt))
    u = torch.bmm(xe, p["w_up"].to(dt))
    ye = torch.bmm(F.silu(g) * u, p["w_down"].to(dt)).view(E * rows, D)

    # Combine: each token's kept rows (a dropped choice weighs 0), the
    # weights rounded to the activation dtype, summed in float32.
    w = torch.where(r.keep, r.gate_vals, 0.0).to(dt)         # (B,G,Sg,K)
    rows_of = ye[torch.where(r.keep, slot, 0)].float()      # (B,G,Sg,K,D)
    out = (w.float().unsqueeze(-1) * rows_of).sum(-2)
    out = out.to(dt).reshape(B, T, D)

    if cfg.n_shared_experts > 0:
        hs = F.silu(x @ p["shared_gate"].to(dt)) * (x @ p["shared_up"].to(dt))
        out = out + hs @ p["shared_down"].to(dt)
    return out, r
