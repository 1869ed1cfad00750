"""Model assembly, as ``repro/models/transformer.py``, for the configs
the port runs: token embedding, segments of blocks, final norm, tied or
separate LM head.

Three modes share one block implementation:

  * ``forward_train`` / ``forward_hidden`` — full-sequence teacher
    forcing, differentiable; return (logits or the final-normed hidden
    state, aux), aux the sum of the MoE layers' load-balancing losses
    (0 without experts).  With ``remat`` (the
    default) and grad enabled, each superblock runs under
    ``torch.utils.checkpoint`` (``use_reentrant=False``), as the
    reference wraps its scanned superblock in ``jax.checkpoint``: the
    backward reruns its forward, kernels included;
  * ``prefill``       — full sequence + per-layer decode state;
  * ``decode_step``   — one new token against the decode state.

Segments with ``repeats > 1`` keep parameters and decode state stacked
on a leading layer axis (the reference scans them); the port walks the
layer axis in a Python loop, and a layer's parameters are views into the
stacked leaves, so gradients land in them.  ``decode_step`` updates the
decode state in place, layer by layer, as the reference's write-back
chain does (``transformer.py:447-460``), and returns the same object.

Mixers ``attn``, ``local_attn``, ``rglru``, ``mlstm`` and ``slstm`` and
the ``dense``, ``moe`` and ``none`` MLPs are ported (a block with no MLP
has no ``norm2``, as xLSTM's; the dense blocks of an MoE config are
``dense_d_ff`` wide).  With ``parallel_block`` a dense block feeds one
pre-norm to both the mixer and the MLP, ``x + mix + mlp(h)``, and has no
``norm2`` (Command-R).  Prefill and decode run the MoE layer as training
does, without its aux; at decode T = 1, so each slot is its own group
and no choice is dropped.  With ``kv_quant`` the prefill writes the
int8 cache as the reference does, the reference's quirk included: a
windowed layer whose prompt overruns its window gets its ring's
payload but not its scales (``apply_block_prefill``).  Cross attention
and the modality stubs raise ``NotImplementedError`` naming ROADMAP
Queue 1 item 11.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import NOT_PORTED, ArchConfig, BlockSpec, Segment
from repro_torch.models import layers, moe, rglru, xlstm
from repro_torch.models.params import ParamSpec, map_tree, stack_specs

VOCAB_PAD_MULTIPLE = 512

# Leaves the reference reads in float32 whatever the activation dtype
# (norm scales and biases, Lambda) or in both float32 and the activation
# dtype (the RG-LRU gate projections: see repro_torch/models/rglru.py).
# Every other leaf is read only as ``astype(cfg.dtype)``, and so are the
# sLSTM's ``w_x`` and ``bias``, which share these names
# (``_float32_leaf``).
FLOAT32_LEAVES = frozenset({"scale", "bias", "lam", "w_a", "b_a", "w_x",
                            "b_x"})


def padded_vocab(cfg: ArchConfig) -> int:
    v, m = cfg.vocab_size, VOCAB_PAD_MULTIPLE
    return (v + m - 1) // m * m


def serving_dtype(cfg: ArchConfig):
    """The serving form of the parameters: a function of a leaf's key path
    giving the dtype the reference computes that leaf in, for
    ``init_params`` / ``params_from_numpy``.  Holding a leaf in it changes
    no number of the serving path, and halves the bytes of the large
    matrices in bfloat16."""
    act = getattr(torch, cfg.dtype)
    plan = cfg.layer_plan()

    def dtype(path) -> torch.dtype:
        return torch.float32 if _float32_leaf(plan, path) else act
    return dtype


def _float32_leaf(plan: List[Segment], path) -> bool:
    """Whether the reference reads the leaf at ``path`` in float32: a
    name in ``FLOAT32_LEAVES`` outside an sLSTM mixer (whose leaves are
    all read in the activation dtype)."""
    if path[-1] not in FLOAT32_LEAVES:
        return False
    if path[0] == "segments" and len(path) > 3 and path[3] == "mixer":
        blk = plan[path[1]].blocks[int(path[2][len("block"):])]
        return blk.mixer != "slstm"
    return True


class _Recurrent(NamedTuple):
    """A recurrent mixer's functions, each as its module names it."""
    specs: Callable
    forward: Callable        # (p, x, cfg) -> out: training
    prefill: Callable        # (p, x, cfg) -> (out, decode state)
    decode_init: Callable    # (cfg, batch, device=) -> decode state
    decode: Callable         # (p, x, cfg, state) -> (out, new state)


_RECURRENT = {
    "rglru": _Recurrent(rglru.rglru_specs, rglru.apply_rglru,
                        rglru.rglru_prefill, rglru.rglru_decode_init,
                        rglru.apply_rglru_decode),
    "mlstm": _Recurrent(xlstm.mlstm_specs, xlstm.apply_mlstm,
                        xlstm.mlstm_prefill, xlstm.mlstm_decode_init,
                        xlstm.apply_mlstm_decode),
    "slstm": _Recurrent(xlstm.slstm_specs, xlstm.apply_slstm,
                        xlstm.slstm_prefill, xlstm.slstm_decode_init,
                        xlstm.apply_slstm_decode),
}


def _check_block(blk: BlockSpec, cfg: ArchConfig) -> None:
    if blk.mixer not in ("attn", "local_attn", *_RECURRENT):
        raise NotImplementedError(f"mixer {blk.mixer!r} is {NOT_PORTED}")
    if blk.mlp not in ("dense", "moe", "none"):
        raise NotImplementedError(f"mlp {blk.mlp!r} is {NOT_PORTED}")
    if blk.cross_attn:
        raise NotImplementedError(f"{cfg.name}: cross attention is "
                                  f"{NOT_PORTED}")


def _parallel(blk: BlockSpec, cfg: ArchConfig) -> bool:
    """Whether the block runs mixer and MLP on one shared pre-norm (a
    dense block of a ``parallel_block`` config, as the reference's)."""
    return cfg.parallel_block and blk.mlp == "dense"


# --------------------------------------------------------------------------- #
# specs
# --------------------------------------------------------------------------- #

def _block_specs(blk: BlockSpec, cfg: ArchConfig) -> Dict[str, Any]:
    _check_block(blk, cfg)
    rec = _RECURRENT.get(blk.mixer)
    mixer = rec.specs(cfg) if rec else layers.attn_specs(cfg)
    specs = {"norm1": layers.norm_specs(cfg), "mixer": mixer}
    if blk.mlp == "dense":
        ff = cfg.dense_d_ff if cfg.n_experts > 0 and cfg.dense_d_ff else None
        if not _parallel(blk, cfg):
            specs["norm2"] = layers.norm_specs(cfg)
        specs["mlp"] = layers.mlp_specs(cfg, ff)
    elif blk.mlp == "moe":
        specs.update(norm2=layers.norm_specs(cfg), mlp=moe.moe_specs(cfg))
    return specs


def _tower_specs(plan: List[Segment], cfg: ArchConfig) -> List[Dict]:
    out = []
    for seg in plan:
        seg_specs = {f"block{j}": _block_specs(blk, cfg)
                     for j, blk in enumerate(seg.blocks)}
        if seg.repeats > 1:
            seg_specs = stack_specs(seg_specs, seg.repeats)
        out.append(seg_specs)
    return out


def model_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, vp = cfg.d_model, padded_vocab(cfg)
    specs: Dict[str, Any] = {
        "embed": ParamSpec((vp, d), ("vocab", "embed"), scale=1.0),
        "final_norm": layers.norm_specs(cfg),
        "segments": _tower_specs(cfg.layer_plan(), cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, vp), ("embed", "vocab"))
    return specs


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #

def _window(blk: BlockSpec, cfg: ArchConfig) -> int:
    return cfg.sliding_window if blk.mixer == "local_attn" else 0


def _finish_block(blk: BlockSpec, p, x, h, mix, cfg: ArchConfig):
    """The residual add of the mixer, then the MLP's: (x, routing), the
    MoE layer's routing or None.  ``h`` is the block's pre-norm, which a
    parallel block's MLP reads (``x + mix + mlp(h)``, added in that
    order, as the reference does)."""
    x = x + mix
    if blk.mlp == "none":
        return x, None
    if not _parallel(blk, cfg):
        h = layers.apply_norm(p["norm2"], x, cfg)
    if blk.mlp == "moe":
        y, r = moe.apply_moe(p["mlp"], h, cfg)
        return x + y, r
    return x + layers.apply_mlp(p["mlp"], h, cfg), None


def apply_block(blk: BlockSpec, p, x, cfg: ArchConfig, *, positions,
                causal: bool = True):
    """Training forward of one block: (x, aux), aux the MoE layer's
    load-balancing loss or None."""
    _check_block(blk, cfg)
    h = layers.apply_norm(p["norm1"], x, cfg)
    if blk.mixer in _RECURRENT:
        mix = _RECURRENT[blk.mixer].forward(p["mixer"], h, cfg)
    else:
        mix = layers.attention(p["mixer"], h, cfg, positions=positions,
                               causal=causal, window=_window(blk, cfg),
                               use_rope=cfg.use_rope)
    x, r = _finish_block(blk, p, x, h, mix, cfg)
    return x, None if r is None else moe.aux_loss(r, cfg)


def init_block_state(blk: BlockSpec, cfg: ArchConfig, batch: int,
                     cache_len: int, dtype=torch.bfloat16,
                     device=None) -> Dict:
    """A block's zero decode state.  ``dtype`` is the KV caches'; the
    recurrent states (RG-LRU, mLSTM, sLSTM) are float32 whatever it is,
    as the reference's."""
    _check_block(blk, cfg)
    if blk.mixer in _RECURRENT:
        return _RECURRENT[blk.mixer].decode_init(cfg, batch, device=device)
    return layers.init_kv_cache(cfg, batch, cache_len,
                                window=_window(blk, cfg), dtype=dtype,
                                device=device)


_rglru_prefill = rglru.rglru_prefill


def apply_block_prefill(blk: BlockSpec, p, x, cfg: ArchConfig, *, positions,
                        cache_len: int) -> Tuple[torch.Tensor, Dict]:
    """Forward + decode-state extraction (serving prefill).  The k, v that
    fill the cache are the ones the attention reads, the mLSTM's conv
    tail the ``up`` its cell read, and the sLSTM's state comes from the
    walk that gave its output (the reference computes each twice, to the
    same values)."""
    _check_block(blk, cfg)
    B, S, _ = x.shape
    h = layers.apply_norm(p["norm1"], x, cfg)
    if blk.mixer in _RECURRENT:
        mix, state = _RECURRENT[blk.mixer].prefill(p["mixer"], h, cfg)
        return _finish_block(blk, p, x, h, mix, cfg)[0], state
    window = _window(blk, cfg)
    q, k, v = layers._project_qkv(p["mixer"], h, cfg, positions,
                                  cfg.use_rope)
    state = layers.init_kv_cache(cfg, B, cache_len, window=window,
                                 dtype=x.dtype, device=x.device)
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)    # (B, Kv, S, hd)
    scales = {}
    if cfg.kv_quant:
        (kc, scales["k_scale"]), (vc, scales["v_scale"]) = (
            layers.quantize_kv(kc), layers.quantize_kv(vc))
    W = state["k"].shape[2]
    if window > 0 and S > W:
        # ring write of the last W positions, split at the wrap point.
        # The reference writes only the payloads here (transformer.py:
        # 255-262): with kv_quant the scales of such a layer stay 0.
        slot0 = (S - W) % W
        first = W - slot0
        for buf, val in ((state["k"], kc[:, :, S - W:]),
                         (state["v"], vc[:, :, S - W:])):
            buf[:, :, slot0:] = val[:, :, :first]
            buf[:, :, :W - first] = val[:, :, first:]
    elif S > W:
        raise ValueError(f"prompt of {S} tokens exceeds the cache of {W}")
    else:
        state["k"][:, :, :S] = kc
        state["v"][:, :, :S] = vc
        for name, val in scales.items():
            state[name][:, :, :S] = val
    state["pos"].fill_(S)
    out = layers.attention_from_qkv(q, k, v, causal=True, window=window,
                                    pad_heads_to=cfg.pad_heads_to)
    mix = layers._out_proj(out, p["mixer"]["w_o"])
    return _finish_block(blk, p, x, h, mix, cfg)[0], state


def apply_block_decode(blk: BlockSpec, p, x, cfg: ArchConfig, state: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
    _check_block(blk, cfg)
    h = layers.apply_norm(p["norm1"], x, cfg)
    if blk.mixer in _RECURRENT:
        mix, state = _RECURRENT[blk.mixer].decode(p["mixer"], h, cfg, state)
    else:
        mix, state = layers.decode_attention(p["mixer"], h, cfg, state,
                                             window=_window(blk, cfg),
                                             use_rope=cfg.use_rope)
    return _finish_block(blk, p, x, h, mix, cfg)[0], state


# --------------------------------------------------------------------------- #
# towers
# --------------------------------------------------------------------------- #

def _layer(tree, i: int):
    """Layer ``i`` of a stacked segment's tree (views)."""
    return map_tree(lambda _, t: t[i], tree)


def _segment_layers(seg: Segment, seg_p):
    if seg.repeats > 1:
        return [_layer(seg_p, i) for i in range(seg.repeats)]
    return [seg_p]


def _run_tower_train(segments_p, plan: List[Segment], x, cfg, positions,
                     causal: bool = True, remat: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder tower over a whole sequence: (x, aux), aux summed over
    the MoE layers in order, as the reference sums its superblocks'.
    With ``remat`` and grad enabled each superblock is checkpointed."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg, seg_p in zip(plan, segments_p):
        def superblock(xx, layer_p, seg=seg):
            ax = torch.zeros((), dtype=torch.float32, device=xx.device)
            for j, blk in enumerate(seg.blocks):
                xx, a = apply_block(blk, layer_p[f"block{j}"], xx, cfg,
                                    positions=positions, causal=causal)
                if a is not None:
                    ax = ax + a
            return xx, ax

        for layer_p in _segment_layers(seg, seg_p):
            if remat and torch.is_grad_enabled():
                x, a = checkpoint(superblock, x, layer_p,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = superblock(x, layer_p)
            aux = aux + a
    return x, aux


def _stack(trees: List):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _run_tower_prefill(segments_p, plan, x, cfg, positions, cache_len):
    states: List[Any] = []
    for seg, seg_p in zip(plan, segments_p):
        reps = []
        for layer_p in _segment_layers(seg, seg_p):
            sts = {}
            for j, blk in enumerate(seg.blocks):
                x, sts[f"block{j}"] = apply_block_prefill(
                    blk, layer_p[f"block{j}"], x, cfg, positions=positions,
                    cache_len=cache_len)
            reps.append(sts)
        states.append(_stack(reps) if seg.repeats > 1 else reps[0])
    return x, states


def _write_back(old: Dict, new: Dict) -> None:
    """Copy a block's new decode state into its buffers (views into the
    stacked state), where the block did not update them in place."""
    for key, val in new.items():
        if val is not old[key]:
            old[key].copy_(val)


def _run_tower_decode(segments_p, plan, x, cfg, states):
    for seg, seg_p, seg_st in zip(plan, segments_p, states):
        layer_sts = _segment_layers(seg, seg_st)
        for layer_p, layer_st in zip(_segment_layers(seg, seg_p), layer_sts):
            for j, blk in enumerate(seg.blocks):
                st = layer_st[f"block{j}"]
                x, new = apply_block_decode(blk, layer_p[f"block{j}"], x,
                                            cfg, st)
                _write_back(st, new)
    return x, states


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #

def _embed_inputs(params, batch: Dict, cfg: ArchConfig) -> torch.Tensor:
    if not cfg.use_rope or cfg.family in ("vlm", "audio"):
        raise NotImplementedError(f"{cfg.name}: absolute positions and "
                                  f"modality inputs are {NOT_PORTED}")
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][batch["tokens"]].to(dt)
    if cfg.family == "hybrid":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)  # gemma scale
    return x


def _lm_logits(params, x, cfg: ArchConfig) -> torch.Tensor:
    x = layers.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["lm_head"].to(x.dtype)


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, dtype=torch.int32,
                        device=device)[None].expand(B, T)


def forward_hidden(params, batch: Dict, cfg: ArchConfig, *,
                   remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tower up to and including the final norm: (x (B,T,D), aux).
    The fused chunked cross-entropy reads it and never builds the full
    logits."""
    x = _embed_inputs(params, batch, cfg)
    B, T, _ = x.shape
    x, aux = _run_tower_train(params["segments"], cfg.layer_plan(), x, cfg,
                              _positions(B, T, x.device), remat=remat)
    return layers.apply_norm(params["final_norm"], x, cfg), aux


def head_weights(params, cfg: ArchConfig) -> torch.Tensor:
    """The (D, Vp) output projection (a view of the embedding when tied)."""
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def forward_train(params, batch: Dict, cfg: ArchConfig, *,
                  remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher forcing.  Returns (logits (B,T,Vp), aux)."""
    x = _embed_inputs(params, batch, cfg)
    B, T, _ = x.shape
    x, aux = _run_tower_train(params["segments"], cfg.layer_plan(), x, cfg,
                              _positions(B, T, x.device), remat=remat)
    return _lm_logits(params, x, cfg), aux


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16, device=None) -> List:
    """Zero decode state; stacked segments get a leading layer axis."""
    states = []
    for seg in cfg.layer_plan():
        seg_states = {}
        for j, blk in enumerate(seg.blocks):
            st = init_block_state(blk, cfg, batch, cache_len, dtype, device)
            if seg.repeats > 1:
                st = {k: v[None].repeat((seg.repeats,) + (1,) * v.dim())
                      for k, v in st.items()}
            seg_states[f"block{j}"] = st
        states.append(seg_states)
    return states


def prefill(params, batch: Dict, cfg: ArchConfig, cache_len: int
            ) -> Tuple[torch.Tensor, List]:
    """Full-sequence forward + decode-state construction.
    Returns (last-position logits (B, Vp), states)."""
    x = _embed_inputs(params, batch, cfg)
    B, T, _ = x.shape
    x, states = _run_tower_prefill(params["segments"], cfg.layer_plan(), x,
                                   cfg, _positions(B, T, x.device), cache_len)
    return _lm_logits(params, x[:, -1:], cfg)[:, 0], states


def decode_step(params, tokens: torch.Tensor, states: List, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, List]:
    """tokens: (B, 1) -> (logits (B, Vp), states updated in place)."""
    x = _embed_inputs(params, {"tokens": tokens}, cfg)
    x, states = _run_tower_decode(params["segments"], cfg.layer_plan(), x,
                                  cfg, states)
    return _lm_logits(params, x, cfg)[:, 0], states
