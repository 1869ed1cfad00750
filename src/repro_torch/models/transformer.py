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
payload but not its scales (``apply_block_prefill``).

Whisper adds an encoder tower (``params["encoder"]``: its segments and
final norm) over ``batch["audio_embeds"]`` plus sinusoidal positions,
run without a causal mask; each decoder block then attends to its
output (``cross_attn``: ``norm_cross`` and ``cross`` after the mixer's
residual, before the MLP).  Prefill keeps each block's cross k, v in
the decode state (``cross_k``, ``cross_v``: (B, encoder_seq, Kv, hd)),
and decode reads them unchanged.  Without RoPE the token embeddings get
sinusoidal positions: the table in a full sequence, and at decode the
inline sinusoid at each slot's position before the step.  InternVL2
puts ``batch["pixel_embeds"]`` ahead of the tokens; the causal mask and
RoPE positions cover them.

Under ``repro_torch.distributed.sharding.sharding_ctx`` the parameters
and batch are DTensors; ``shard`` pins the residual stream and the
logits to the reference's logical axes, and the training tower
re-asserts each layer's parameter placements (``_shard_layer_params``)
inside the (checkpointed) superblock, as the reference does inside its
scanned one.  With ``cfg.gather_dtype`` the training tower casts each
segment's float32 parameters to that dtype once before its layer loop
(the reference's FSDP gather knob); gradients flow back to the float32
leaves.  ``block_state_axes`` and ``decode_state_axes`` give the decode
state's logical axes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import NOT_PORTED, ArchConfig, BlockSpec, Segment
from repro_torch.models import layers, moe, rglru, xlstm
from repro_torch.distributed.sharding import (bind_ctx, current_ctx,
                                              lookup_rows, map_axes, shard)
from repro_torch.models.params import (ParamSpec, map_tree, param_axes,
                                       stack_specs)

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
    if blk.cross_attn:
        specs.update(norm_cross=layers.norm_specs(cfg),
                     cross=layers.cross_attn_specs(cfg))
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
    if cfg.is_encoder_decoder:
        specs["encoder"] = {
            "segments": _tower_specs(cfg.encoder_plan(), cfg),
            "final_norm": layers.norm_specs(cfg),
        }
    return specs


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #

def _window(blk: BlockSpec, cfg: ArchConfig) -> int:
    return cfg.sliding_window if blk.mixer == "local_attn" else 0


def _finish_block(blk: BlockSpec, p, x, h, mix, cfg: ArchConfig,
                  cross=None):
    """The residual add of the mixer, then cross attention over
    ``cross`` (the encoder's k, v, for a ``cross_attn`` block), then the
    MLP's: (x, routing), the MoE layer's routing or None.  ``h`` is the
    block's pre-norm, which a parallel block's MLP reads (``x + mix +
    mlp(h)``, added in that order, as the reference does)."""
    x = x + mix
    if _parallel(blk, cfg):
        return x + layers.apply_mlp(p["mlp"], h, cfg), None
    if blk.cross_attn:
        hc = layers.apply_norm(p["norm_cross"], x, cfg)
        x = x + layers.cross_attention(p["cross"], hc, cfg, cross)
    if blk.mlp == "none":
        return x, None
    h = layers.apply_norm(p["norm2"], x, cfg)
    if blk.mlp == "moe":
        y, r = moe.apply_moe(p["mlp"], h, cfg)
        return x + y, r
    return x + layers.apply_mlp(p["mlp"], h, cfg), None


def _cross_kv(blk: BlockSpec, p, enc_out, cfg: ArchConfig):
    """A ``cross_attn`` block's k, v over the encoder output, else
    None."""
    if not blk.cross_attn:
        return None
    if enc_out is None:
        raise ValueError("a cross-attention block needs the encoder's "
                         "output (batch['audio_embeds'])")
    return layers.encode_cross_kv(p["cross"], enc_out, cfg)


def apply_block(blk: BlockSpec, p, x, cfg: ArchConfig, *, positions,
                causal: bool = True, enc_out=None):
    """Training (or encoder) forward of one block: (x, aux), aux the MoE
    layer's load-balancing loss or None."""
    _check_block(blk, cfg)
    h = layers.apply_norm(p["norm1"], x, cfg)
    if blk.mixer in _RECURRENT:
        mix = _RECURRENT[blk.mixer].forward(p["mixer"], h, cfg)
    else:
        mix = layers.attention(p["mixer"], h, cfg, positions=positions,
                               causal=causal, window=_window(blk, cfg),
                               use_rope=cfg.use_rope)
    x, r = _finish_block(blk, p, x, h, mix, cfg,
                         _cross_kv(blk, p, enc_out, cfg))
    return x, None if r is None else moe.aux_loss(r, cfg)


# A cross-attention block's decode-state keys: the encoder's k, v.
CROSS_KEYS = ("cross_k", "cross_v")


def init_block_state(blk: BlockSpec, cfg: ArchConfig, batch: int,
                     cache_len: int, dtype=torch.bfloat16,
                     device=None, per_example_pos: bool = True) -> Dict:
    """A block's zero decode state.  ``dtype`` is the KV caches' (and
    the cross k, v's); the recurrent states (RG-LRU, mLSTM, sLSTM) are
    float32 whatever it is, as the reference's.  Without
    ``per_example_pos`` a cache's ``pos`` is one scalar, the uniform
    decode wave of the reference's shape specs."""
    _check_block(blk, cfg)
    if blk.mixer in _RECURRENT:
        st = _RECURRENT[blk.mixer].decode_init(cfg, batch, device=device)
    else:
        st = layers.init_kv_cache(cfg, batch, cache_len,
                                  window=_window(blk, cfg), dtype=dtype,
                                  device=device)
        if not per_example_pos:
            st["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    if blk.cross_attn:
        shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim_)
        for name in CROSS_KEYS:
            st[name] = torch.zeros(shape, dtype=dtype, device=device)
    return st


_RECURRENT_STATE_AXES = {
    "mlstm": {"C": ("act_batch", "act_heads", None, None),
              "n": ("act_batch", "act_heads", None),
              "m": ("act_batch", "act_heads"),
              "conv": ("act_batch", None, "act_rnn")},
    "slstm": {k: ("act_batch", "act_rnn") for k in ("c", "n", "m", "h")},
    "rglru": {"h": ("act_batch", "act_rnn"),
              "conv": ("act_batch", None, "act_rnn")},
}


def block_state_axes(blk: BlockSpec, cfg: ArchConfig) -> Dict:
    """Logical axes of a block's decode state."""
    _check_block(blk, cfg)
    if blk.mixer in _RECURRENT:
        ax = dict(_RECURRENT_STATE_AXES[blk.mixer])
    else:
        ax = layers.cache_axes(cfg.kv_quant)
    if blk.cross_attn:
        for name in CROSS_KEYS:
            ax[name] = ("act_batch", None, "act_kv_heads", None)
    return ax

_rglru_prefill = rglru.rglru_prefill


def apply_block_prefill(blk: BlockSpec, p, x, cfg: ArchConfig, *, positions,
                        cache_len: int, enc_out=None
                        ) -> Tuple[torch.Tensor, Dict]:
    """Forward + decode-state extraction (serving prefill).  The k, v that
    fill the cache are the ones the attention reads, the mLSTM's conv
    tail the ``up`` its cell read, and the sLSTM's state comes from the
    walk that gave its output (the reference computes each twice, to the
    same values).  A cross-attention block keeps the encoder's k, v in
    the activation dtype."""
    _check_block(blk, cfg)
    B, S, _ = x.shape
    h = layers.apply_norm(p["norm1"], x, cfg)
    cross = _cross_kv(blk, p, enc_out, cfg)
    if blk.mixer in _RECURRENT:
        mix, state = _RECURRENT[blk.mixer].prefill(p["mixer"], h, cfg)
    else:
        mix, state = _attention_prefill(blk, p["mixer"], h, cfg, positions,
                                        cache_len)
    if cross is not None:
        state = dict(state)
        for name, val in zip(CROSS_KEYS, cross):
            state[name] = val.to(x.dtype)
    return _finish_block(blk, p, x, h, mix, cfg, cross)[0], state


def _attention_prefill(blk: BlockSpec, p, h, cfg: ArchConfig, positions,
                       cache_len: int) -> Tuple[torch.Tensor, Dict]:
    """The attention mixer over a prompt: (its output, the filled KV
    cache)."""
    B, S, _ = h.shape
    window = _window(blk, cfg)
    q, k, v = layers._project_qkv(p, h, cfg, positions, cfg.use_rope)
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)    # (B, Kv, S, hd)
    scales = {}
    if cfg.kv_quant:
        (kc, scales["k_scale"]), (vc, scales["v_scale"]) = (
            layers.quantize_kv(kc), layers.quantize_kv(vc))
    sharded = current_ctx() is not None
    if sharded:
        state = layers.sharded_kv_cache(cfg, B, cache_len, window=window,
                                        dtype=h.dtype)
    else:
        state = layers.init_kv_cache(cfg, B, cache_len, window=window,
                                     dtype=h.dtype, device=h.device)
    W = state["k"].shape[2]
    if sharded:
        _fill_sharded_cache(state, {"k": kc, "v": vc, **scales}, S, W,
                            window)
    elif window > 0 and S > W:
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
                                    pad_heads_to=cfg.pad_heads_to,
                                    softcap=cfg.attn_logit_softcap)
    return layers._out_proj(out, p["w_o"]), state


def _fill_sharded_cache(state: Dict, vals: Dict, S: int, W: int,
                        window: int) -> None:
    """The prompt's k, v (and int8 scales) into the DTensor cache
    ``state`` on each rank's shard (``layers.fill_prefix``), as the
    single-device branch writes them: a ring keeps the last W positions
    from slot ``(S - W) % W`` on and, as the reference, not their
    scales."""
    if S > W and window <= 0:
        raise ValueError(f"prompt of {S} tokens exceeds the cache of {W}")
    for name, val in vals.items():
        if S > W:
            if name.endswith("_scale"):
                continue
            first = W - (S - W) % W
            tail = val[:, :, S - W:]
            val = torch.cat([tail[:, :, first:], tail[:, :, :first]], 2)
        layers.fill_prefix(state[name], val)


def apply_block_decode(blk: BlockSpec, p, x, cfg: ArchConfig, state: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
    """One token through a block.  A cross-attention block reads its
    ``cross_k``, ``cross_v`` and returns them unchanged."""
    _check_block(blk, cfg)
    h = layers.apply_norm(p["norm1"], x, cfg)
    cross = {k: state[k] for k in CROSS_KEYS if k in state}
    core = {k: v for k, v in state.items() if k not in cross}
    if blk.mixer in _RECURRENT:
        mix, core = _RECURRENT[blk.mixer].decode(p["mixer"], h, cfg, core)
    else:
        mix, core = layers.decode_attention(p["mixer"], h, cfg, core,
                                            window=_window(blk, cfg),
                                            use_rope=cfg.use_rope)
    kv = (cross["cross_k"], cross["cross_v"]) if cross else None
    return _finish_block(blk, p, x, h, mix, cfg, kv)[0], {**core, **cross}


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


def _segment_axes(cfg: ArchConfig, seg: Segment) -> Dict:
    """The logical-axes tree of one layer of a segment (no layer
    axis)."""
    return param_axes({f"block{j}": _block_specs(blk, cfg)
                       for j, blk in enumerate(seg.blocks)})


def _shard_layer_params(layer_p, seg_axes):
    """Re-assert a layer's parameter placements under a sharding
    context (the reference's guard against one gather of every layer at
    once); the layer itself without one."""
    if current_ctx() is None:
        return layer_p
    return map_axes(lambda ax, p: shard(p, ax), seg_axes, layer_p)


def _gather_cast(seg_p, cfg: ArchConfig):
    """``cfg.gather_dtype``: a segment's float32 leaves cast to it once
    before the layer loop; the segment itself without it."""
    if not cfg.gather_dtype:
        return seg_p
    gd = getattr(torch, cfg.gather_dtype)
    return map_tree(lambda _, v: v.to(gd) if v.dtype == torch.float32
                    else v, seg_p)


def _run_tower_train(segments_p, plan: List[Segment], x, cfg, positions,
                     causal: bool = True, remat: bool = True, enc_out=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A tower (the decoder's, or the encoder's with ``causal=False``)
    over a whole sequence: (x, aux), aux summed over the MoE layers in
    order, as the reference sums its superblocks'.  With ``remat`` and
    grad enabled each superblock is checkpointed."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg, seg_p in zip(plan, segments_p):
        seg_axes = _segment_axes(cfg, seg)
        seg_p = _gather_cast(seg_p, cfg)

        def superblock(xx, layer_p, seg=seg, seg_axes=seg_axes):
            layer_p = _shard_layer_params(layer_p, seg_axes)
            ax = torch.zeros((), dtype=torch.float32, device=xx.device)
            for j, blk in enumerate(seg.blocks):
                xx, a = apply_block(blk, layer_p[f"block{j}"], xx, cfg,
                                    positions=positions, causal=causal,
                                    enc_out=enc_out)
                if a is not None:
                    ax = ax + a
            return xx, ax

        for layer_p in _segment_layers(seg, seg_p):
            if remat and torch.is_grad_enabled():
                x, a = checkpoint(bind_ctx(superblock), x, layer_p,
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


def _run_tower_prefill(segments_p, plan, x, cfg, positions, cache_len,
                       enc_out=None):
    states: List[Any] = []
    for seg, seg_p in zip(plan, segments_p):
        reps = []
        for layer_p in _segment_layers(seg, seg_p):
            sts = {}
            for j, blk in enumerate(seg.blocks):
                x, sts[f"block{j}"] = apply_block_prefill(
                    blk, layer_p[f"block{j}"], x, cfg, positions=positions,
                    cache_len=cache_len, enc_out=enc_out)
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

def _embed_tokens(params, tokens, cfg: ArchConfig) -> torch.Tensor:
    dt = getattr(torch, cfg.dtype)
    return lookup_rows(params["embed"], tokens, ("act_batch", None)).to(dt)


def _embed_inputs(params, batch: Dict, cfg: ArchConfig) -> torch.Tensor:
    """A full sequence's inputs, in the reference's order: the token
    embeddings, the patch embeddings ahead of them (vlm), the gemma
    scale (hybrid), the sinusoidal positions (without RoPE)."""
    dt = getattr(torch, cfg.dtype)
    x = _embed_tokens(params, batch["tokens"], cfg)
    if cfg.family == "vlm" and "pixel_embeds" in batch:
        x = torch.cat([batch["pixel_embeds"].to(dt), x], dim=1)
    if cfg.family == "hybrid":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)  # gemma scale
    if not cfg.use_rope:
        x = x + layers.sinusoidal_embeddings(x.shape[1], cfg.d_model, dt,
                                             x.device)[None]
    return shard(x, layers.RESIDUAL_AXES)


def _cache_pos(states: List) -> torch.Tensor:
    """The decode positions, read off the first attention cache before
    the step, as the reference's ``_cache_pos``: the first layer's (B,)
    positions of a stacked cache; of an unstacked one, its first slot's
    position as one (1,) row for every slot (the reference's reading)."""
    for seg_states in states:
        for st in seg_states.values():
            if "pos" in st:
                p = st["pos"]
                if p.dim() == 0:                 # a uniform wave
                    return p.reshape(1)
                return p[0] if p.dim() > 1 else p[:1]
    raise ValueError("no attention cache in the decode state")


def _encode(params, batch: Dict, cfg: ArchConfig,
            remat: bool = True) -> torch.Tensor:
    """The encoder over the frame embeddings ``batch["audio_embeds"]``
    (B, S_enc, D) plus sinusoidal positions, without a causal mask, then
    its final norm."""
    dt = getattr(torch, cfg.dtype)
    frames = batch["audio_embeds"].to(dt)
    B, S, _ = frames.shape
    x = frames + layers.sinusoidal_embeddings(S, cfg.d_model, dt,
                                              frames.device)[None]
    enc = params["encoder"]
    x, _ = _run_tower_train(enc["segments"], cfg.encoder_plan(), x, cfg,
                            _positions(B, S, x.device), causal=False,
                            remat=remat)
    return layers.apply_norm(enc["final_norm"], x, cfg)


def _encoder_output(params, batch: Dict, cfg: ArchConfig, remat: bool):
    return _encode(params, batch, cfg, remat) if cfg.is_encoder_decoder \
        else None


def _lm_logits(params, x, cfg: ArchConfig) -> torch.Tensor:
    x = layers.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    return shard(logits, ("act_batch", None, "act_vocab"))


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
                              _positions(B, T, x.device), remat=remat,
                              enc_out=_encoder_output(params, batch, cfg,
                                                      remat))
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
                              _positions(B, T, x.device), remat=remat,
                              enc_out=_encoder_output(params, batch, cfg,
                                                      remat))
    return _lm_logits(params, x, cfg), aux


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16, device=None,
                      per_example_pos: bool = True) -> List:
    """Zero decode state; stacked segments get a leading layer axis.
    Without ``per_example_pos`` each cache's position is a scalar: the
    form the shape specs describe (``repro_torch.launch.shapes``); the
    port's decode step reads per-example positions."""
    states = []
    for seg in cfg.layer_plan():
        seg_states = {}
        for j, blk in enumerate(seg.blocks):
            st = init_block_state(blk, cfg, batch, cache_len, dtype, device,
                                  per_example_pos)
            if seg.repeats > 1:
                st = {k: v[None].repeat((seg.repeats,) + (1,) * v.dim())
                      for k, v in st.items()}
            seg_states[f"block{j}"] = st
        states.append(seg_states)
    return states


def decode_state_axes(cfg: ArchConfig) -> List:
    """The logical-axes tree of ``init_decode_state``'s output."""
    axes = []
    for seg in cfg.layer_plan():
        seg_axes = {}
        for j, blk in enumerate(seg.blocks):
            ax = block_state_axes(blk, cfg)
            if seg.repeats > 1:
                ax = {k: ("layer",) + a for k, a in ax.items()}
            seg_axes[f"block{j}"] = ax
        axes.append(seg_axes)
    return axes


def prefill(params, batch: Dict, cfg: ArchConfig, cache_len: int
            ) -> Tuple[torch.Tensor, List]:
    """Full-sequence forward + decode-state construction.
    Returns (last-position logits (B, Vp), states)."""
    x = _embed_inputs(params, batch, cfg)
    B, T, _ = x.shape
    x, states = _run_tower_prefill(
        params["segments"], cfg.layer_plan(), x, cfg,
        _positions(B, T, x.device), cache_len,
        enc_out=_encoder_output(params, batch, cfg, remat=False))
    return _lm_logits(params, x[:, -1:], cfg)[:, 0], states


def decode_step(params, tokens: torch.Tensor, states: List, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, List]:
    """tokens: (B, 1) -> (logits (B, Vp), states updated in place).
    Without RoPE each slot's token gets the sinusoid at its cache
    position before the step."""
    dt = getattr(torch, cfg.dtype)
    x = _embed_tokens(params, tokens, cfg)
    if cfg.family == "hybrid":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)  # gemma scale
    if not cfg.use_rope:
        x = x + layers.sinusoid_at(_cache_pos(states), cfg.d_model,
                                   dt)[:, None, :]
    x = shard(x, layers.RESIDUAL_AXES)
    x, states = _run_tower_decode(params["segments"], cfg.layer_plan(), x,
                                  cfg, states)
    return _lm_logits(params, x, cfg)[:, 0], states
