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

Under a sharding context (DTensors) the layer is expert-parallel
(:func:`_moe_sharded`): the expert weights split over ``act_expert``,
as the reference's dispatched buffers do, each rank routing its batch
rows whole and running its own experts, the float32 sums reduced over
the expert split before the cast; the shared experts and the output
carry the reference's constraints.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (current_ctx, is_dtensor,
                                              local_run, shard)
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
    first = r.gate_idx[..., 0, None] == torch.arange(E, device=me.device)
    ce = first.float().mean(dim=(0, 1, 2))
    return cfg.router_aux_coef * E * torch.sum(me * ce)


def _expert_sum(x: torch.Tensor, r: Routing, w_gate, w_up, w_down,
                cfg: ArchConfig, e0: int = 0) -> torch.Tensor:
    """The routed experts' outputs for x (B, T, D), each token's kept
    choices weighted and summed in float32: (B, T, D) float32.  The
    weights hold experts ``e0`` .. ``e0 + len(w_gate) - 1`` (all of
    them, or one rank's shard); a choice of another expert weighs 0."""
    B, T, D = x.shape
    El, K = w_gate.shape[0], cfg.experts_per_token
    G, Sg = groups(T)
    C = group_capacity(cfg, Sg)
    dt = x.dtype
    mine = r.keep if El == cfg.n_experts else \
        r.keep & (r.gate_idx >= e0) & (r.gate_idx < e0 + El)

    # Row of each choice in the (El * B·G·C, D) expert buffer: expert,
    # then group, then capacity position; kept rows are unique.  Other
    # choices go to one spare row past the buffer, so no step waits on
    # the host for the count of kept ones.
    rows = B * G * C
    group = torch.arange(B * G, device=x.device).reshape(B, G, 1, 1)
    slot = (r.gate_idx - e0) * rows + group * C + r.pos
    token = torch.arange(B * T, device=x.device).repeat_interleave(K)
    xe = x.new_zeros(El * rows + 1, D).index_copy(
        0, torch.where(mine, slot, El * rows).reshape(-1),
        x.reshape(B * T, D)[token])

    xe = xe[:-1].view(El, rows, D)
    g = torch.bmm(xe, w_gate.to(dt))
    u = torch.bmm(xe, w_up.to(dt))
    ye = torch.bmm(F.silu(g) * u, w_down.to(dt)).view(El * rows, D)

    # Combine: each token's rows (another expert's or a dropped choice
    # weighs 0), the weights rounded to the activation dtype, summed in
    # float32.
    w = torch.where(mine, r.gate_vals, 0.0).to(dt)          # (B,G,Sg,K)
    rows_of = ye[torch.where(mine, slot, 0)].float()        # (B,G,Sg,K,D)
    return (w.float().unsqueeze(-1) * rows_of).sum(-2).reshape(B, T, D)


def _moe_sharded(p, x: torch.Tensor, cfg: ArchConfig, ctx
                 ) -> Tuple[torch.Tensor, Routing]:
    """Expert parallelism on DTensors: every rank routes its batch rows'
    tokens whole (routing is replicated over the other mesh dims), then
    runs the experts its ``act_expert`` shard holds on those tokens;
    the float32 sums are partial over the expert split, reduced before
    the cast to the activation dtype."""
    from torch.distributed.tensor import Partial, Shard
    B, T, D = x.shape
    G, Sg = groups(T)
    x = shard(x, ("act_batch", None, None))
    xg = x.reshape(B, G, Sg, D)
    grouped = ctx.placements_for(xg.shape, ("act_batch", None, None, None))
    tokens = ctx.placements_for(x.shape, ("act_batch", None, None))
    whole = ctx.placements_for(p["w_router"].shape, (None, None))
    r = Routing(*local_run(lambda xx, w: tuple(route({"w_router": w}, xx,
                                                      cfg)),
                           (xg, p["w_router"]), (grouped, whole),
                           (list(grouped),) * 5))
    ex = ctx.placements_for(p["w_gate"].shape, ("act_expert", None, None))
    split = [i for i, pl in enumerate(ex) if isinstance(pl, Shard)]
    coord = ctx.mesh.get_coordinate()
    idx = 0
    for i in split:
        idx = idx * ctx.mesh.size(i) + coord[i]
    e0 = idx * (cfg.n_experts // math.prod(ctx.mesh.size(i) for i in split))
    out_pl = [Partial() if i in split else pl for i, pl in enumerate(tokens)]
    out = local_run(
        lambda xx, gi, gv, pos, keep, wg, wu, wd: _expert_sum(
            xx, Routing(gi, gv, pos, keep, None), wg, wu, wd, cfg, e0),
        (x, r.gate_idx, r.gate_vals, r.pos, r.keep, p["w_gate"], p["w_up"],
         p["w_down"]), (tokens,) + (grouped,) * 4 + (ex,) * 3, out_pl)
    return shard(out, ("act_batch", None, None)).to(x.dtype), r


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, Routing]:
    """x: (B, T, D) -> (out (B, T, D), its routing).  The reference's
    ``apply_moe`` returns the aux loss in place of the routing:
    ``aux_loss(routing, cfg)`` is that loss."""
    B, T, D = x.shape
    G, Sg = groups(T)
    dt = x.dtype
    ctx = current_ctx()
    if ctx is not None and is_dtensor(x):
        out, r = _moe_sharded(p, x, cfg, ctx)
    else:
        r = route(p, x.reshape(B, G, Sg, D), cfg)
        out = _expert_sum(x, r, p["w_gate"], p["w_up"], p["w_down"],
                          cfg).to(dt)
    if cfg.n_shared_experts > 0:
        hs = F.silu(x @ p["shared_gate"].to(dt)) * (x @ p["shared_up"].to(dt))
        hs = shard(hs, ("act_batch", None, "act_mlp"))
        out = out + hs @ p["shared_down"].to(dt)
    return shard(out, ("act_batch", "act_seq", "act_embed")), r
