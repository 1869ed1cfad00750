"""Plain reference of DeepSeek-LLM (dense, arXiv:2401.02954) and
DeepSeekMoE (arXiv:2401.06066) decoders, in float32 with TF32 off.

It reads the benchmark's weights (a tree keyed as the served parameter
tree: ``embed``, ``segments`` of ``block0`` with ``norm1``, ``mixer``,
``norm2``, ``mlp``, a leading layer axis where a segment repeats,
``final_norm``, ``lm_head``) and computes, for whole token sequences,
the logits at the positions asked for.  Layer by layer: each layer's
weights are widened to float32 once and applied to every sequence, so
one layer's float32 copy lives at a time.

The mathematics, as the configurations state it:

* token embedding, pre-norm RMSNorm (``norm_eps``), residual adds;
* attention: RoPE with half rotation (``rope_theta``) at positions
  0..T-1, q scaled by ``head_dim ** -0.5``, causal softmax;
* a SwiGLU MLP, ``(silu(h Wg) * h Wu) Wd``;
* the MoE layer of the served model: router softmax over
  ``n_experts``, the top ``experts_per_token`` (ties to the lower
  index), weights renormalised by their sum + 1e-9 where
  ``norm_topk_prob`` holds; the prompt's tokens
  in dispatch groups of ``moe_group_tokens`` (a shorter prompt is one
  group), each expert taking at most
  ``max(int(group * K * capacity_factor / E), K)`` choices of a group,
  counted over its tokens in order and each token's choices in order,
  the rest dropped; every generated token its own group (nothing
  dropped); plus the shared experts, one SwiGLU of
  ``n_shared_experts * moe_d_ff`` width;
* the final RMSNorm and the head, logits over ``vocab_size``.

``precision="fp8"`` is the control: every product of a block's
projections, MLPs and experts takes its operands rounded to float8
e4m3 (activations scaled per row, weights per output column, each to
its largest magnitude over 448), as an fp8 serving path would;
attention's softmax, the router, the norms and the head stay float32.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
HEADS_AT_ONCE = 8


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Math:
    def __init__(self, cfg: Dict, precision: str):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.fp8 = precision == "fp8"

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N); in the control both rounded to fp8."""
        if self.fp8:
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        ms = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(ms + self.cfg["norm_eps"]) * scale

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (T, H, hd) at positions 0..T-1, half rotation."""
        T, _, hd = x.shape
        half = hd // 2
        freqs = self.cfg["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
            * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, h: torch.Tensor, w: Dict) -> torch.Tensor:
        d = h.shape[-1]
        H, Kv = self.cfg["num_heads"], self.cfg["num_kv_heads"]
        hd = w["w_q"].shape[-1]
        T = h.shape[0]
        q = self.rope(self.linear(h, w["w_q"].reshape(d, -1))
                      .view(T, H, hd)) * hd ** -0.5
        k = self.rope(self.linear(h, w["w_k"].reshape(d, -1)).view(T, Kv, hd))
        v = self.linear(h, w["w_v"].reshape(d, -1)).view(T, Kv, hd)
        rep = H // Kv
        k = k.repeat_interleave(rep, 1)
        v = v.repeat_interleave(rep, 1)
        hidden = torch.ones(T, T, dtype=torch.bool, device=h.device).triu(1)
        out = torch.empty(T, H, hd, dtype=torch.float32, device=h.device)
        for h0 in range(0, H, HEADS_AT_ONCE):
            sl = slice(h0, h0 + HEADS_AT_ONCE)
            s = torch.einsum("thd,shd->hts", q[:, sl], k[:, sl])
            p = torch.softmax(s.masked_fill(hidden, -math.inf), -1)
            out[:, sl] = torch.einsum("hts,shd->thd", p, v[:, sl])
        return self.linear(out.reshape(T, H * hd), w["w_o"].reshape(H * hd, d))

    def swiglu(self, h, gate, up, down) -> torch.Tensor:
        return self.linear(F.silu(self.linear(h, gate)) * self.linear(h, up),
                           down)

    def keep(self, idx: torch.Tensor, prompt_len: int) -> torch.Tensor:
        """(T, K) bool: the choices the experts' capacity takes."""
        cfg = self.cfg
        E, K, cf = cfg["n_experts"], cfg["experts_per_token"], \
            cfg["capacity_factor"]
        keep = torch.ones_like(idx, dtype=torch.bool)
        group = min(cfg["moe_group_tokens"], prompt_len)
        if prompt_len % group:
            raise ValueError(f"a prompt of {prompt_len} tokens is not a "
                             f"whole number of {group}-token groups")
        cap = max(int(group * K * cf / E), K)
        for g0 in range(0, prompt_len, group):
            sel = idx[g0:g0 + group]
            chosen = torch.zeros(group, E, dtype=torch.int64,
                                 device=idx.device).scatter_(1, sel, 1)
            before = chosen.cumsum(0) - chosen
            keep[g0:g0 + group] = before.gather(1, sel) < cap
        return keep

    def router_logits(self, h: torch.Tensor, w: Dict) -> torch.Tensor:
        return h @ w["w_router"]

    def moe(self, h: torch.Tensor, w: Dict, prompt_len: int) -> torch.Tensor:
        cfg = self.cfg
        K = cfg["experts_per_token"]
        probs = torch.softmax(self.router_logits(h, w), -1)
        vals, idx = torch.sort(probs, dim=-1, descending=True,
                                stable=True)
        gates = vals[:, :K]
        if cfg.get("norm_topk_prob", True):
            gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        idx = idx[:, :K]
        keep = self.keep(idx, prompt_len)
        out = torch.zeros_like(h)
        for e in range(cfg["n_experts"]):
            rows, ks = torch.nonzero((idx == e) & keep, as_tuple=True)
            if rows.numel() == 0:
                continue
            ye = self.swiglu(h[rows], w["w_gate"][e], w["w_up"][e],
                             w["w_down"][e])
            out.index_add_(0, rows, ye * gates[rows, ks, None])
        if "shared_gate" in w:
            out = out + self.swiglu(h, w["shared_gate"], w["shared_up"],
                                    w["shared_down"])
        return out


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def layers(params: Dict) -> Iterator[Dict]:
    """Each layer's weights (views), in order."""
    for seg in params["segments"]:
        if list(seg) != ["block0"]:
            raise ValueError(f"a segment of blocks {list(seg)}: the "
                             "reference reads one block a segment")
        blk = seg["block0"]
        if blk["norm1"]["scale"].dim() == 1:
            yield blk
            continue
        for i in range(blk["norm1"]["scale"].shape[0]):
            yield _tree(lambda t, i=i: t[i], blk)


@torch.no_grad()
def logits(cfg: Dict, params: Dict, seqs: Sequence[torch.Tensor],
           prompt_lens: Sequence[int], first: Sequence[int],
           precision: str = "float32", calc: "_Math" = None
           ) -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (T,) of which the first
    ``prompt_lens[i]`` are the prompt: float32 logits (T - first[i],
    vocab_size) at positions ``first[i]`` .. T - 1.  ``calc`` stands in
    for the arithmetic of ``precision`` (a ``_Math`` that also observes)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        m = calc or _Math(cfg, precision)
        xs = [params["embed"][s].float() for s in seqs]
        for layer in layers(params):
            w = _tree(lambda t: t.float(), layer)
            for i, x in enumerate(xs):
                x = x + m.attention(m.norm(x, w["norm1"]["scale"]), w["mixer"])
                h = m.norm(x, w["norm2"]["scale"])
                mlp = w["mlp"]
                if "w_router" in mlp:
                    x = x + m.moe(h, mlp, prompt_lens[i])
                else:
                    x = x + m.swiglu(h, mlp["w_gate"], mlp["w_up"],
                                     mlp["w_down"])
                xs[i] = x
            del w
        head = params["lm_head"][:, :cfg["vocab_size"]].float()
        scale = params["final_norm"]["scale"].float()
        return [m.norm(x[f:], scale) @ head for x, f in zip(xs, first)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
