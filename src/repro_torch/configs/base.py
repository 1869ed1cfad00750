"""Architecture configs, as ``repro/configs/base.py``: the fields the
port's models read, each block's (mixer, mlp) pair, and the layer plan.

A model is a list of *segments*, each ``repeats`` × a superblock of
blocks; a segment with ``repeats > 1`` keeps its parameters and decode
state stacked on a leading layer axis, as the reference's scanned
segments do, so a parameter tree crosses between the two packages by
key.  The port builds the dense plan (``attn`` + ``dense``, sequential
or, with ``parallel_block``, attention and MLP on one shared pre-norm),
the Griffin hybrid plan (``rglru`` ×2 + ``local_attn``), the xLSTM plan
(``mlstm`` ×(k−1) + ``slstm``, no MLP) and the MoE plan
(``first_k_dense`` × (``attn``, ``dense``), then (``attn``, ``moe``))
and the encoder-decoder plan (Whisper: decoder blocks with
``cross_attn``, and an ``encoder_plan`` of ``encoder_layers`` dense
attention blocks).

``param_count`` and ``active_param_count`` are the reference's
approximations (embeddings and the blocks' large matrices, the encoder
tower and cross attention included, no norms or biases), formula for
formula; ``models.params.count_params`` counts a spec tree exactly.

The forecaster's mLSTM trunk reads ``d_model``, ``num_heads``,
``proj_factor`` and ``conv_width`` only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# The message for a block kind that no reference config uses: the port
# runs every mixer and MLP that a reference config names.
NOT_PORTED = "in no reference config, so the port does not run it"


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block inside a superblock."""

    mixer: str = "attn"          # attn|local_attn|mlstm|slstm|rglru
    mlp: str = "dense"           # dense|moe|none
    cross_attn: bool = False     # enc-dec decoder blocks


@dataclasses.dataclass(frozen=True)
class Segment:
    """``repeats`` × superblock of ``blocks`` (stacked if repeats > 1)."""

    blocks: Tuple[BlockSpec, ...]
    repeats: int = 1

    @property
    def n_layers(self) -> int:
        return len(self.blocks) * self.repeats


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads

    # attention
    use_rope: bool = True
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0
    qkv_bias: bool = False
    sliding_window: int = 0       # 0 = global attention
    parallel_block: bool = False
    attn_logit_softcap: float = 0.0

    # norm / mlp
    norm_type: str = "rmsnorm"    # rmsnorm|layernorm
    act: str = "silu"
    gated_mlp: bool = True
    mlp_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # MoE (repro_torch/models/moe.py)
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ssm / hybrid
    slstm_every: int = 0          # xLSTM: every k-th block is sLSTM
    proj_factor: float = 2.0      # mLSTM up-projection
    conv_width: int = 4
    d_rnn: int = 0                # RG-LRU width (0 -> d_model)
    rglru_pattern: int = 3        # 2 recurrent + 1 local attn per 3 layers

    # encoder-decoder (whisper): the encoder reads ``encoder_seq``
    # precomputed frame embeddings (the conv frontend is a stub)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # vlm: ``vision_prefix_len`` precomputed patch embeddings ahead of
    # the tokens (the vision tower is a stub)
    vision_prefix_len: int = 0

    # kv_quant: an int8 KV cache with a float16 max-abs scale per (slot,
    # kv head, position) (repro_torch/models/layers.py quantize_kv).
    # pad_heads_to: prefill and training attention run on this many
    # heads, the extra ones zero and sliced off before w_o (qwen1.5-32b:
    # 40 -> 48); decode does not pad.  gather_dtype ("bfloat16"): the
    # training tower casts each segment's float32 stacked parameters to it
    # once before the layer loop, so a sharded step gathers that many
    # bytes per layer; the float32 masters and their gradients stay.
    kv_quant: bool = False
    pad_heads_to: int = 0
    gather_dtype: str = ""

    # memory shape knobs (0 = off), read by training.  ce_chunk: the
    # fused LM-head + cross-entropy over sequence chunks
    # (repro_torch/train/losses.py chunked_ce), so the full (B, T, V)
    # logits never exist.  train_accum: gradient-accumulation
    # microbatches at train_4k.  (The reference's attn_chunk is not
    # carried: the port's attention is the flash kernel at every length.)
    ce_chunk: int = 0
    train_accum: int = 1

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # per-arch sharding-rule overrides merged over
    # repro_torch.distributed.sharding.DEFAULT_RULES: (logical axis,
    # candidate mesh axes) pairs, e.g. xlstm-125m's pure data parallelism.
    rule_overrides: Tuple[Tuple[str, Tuple], ...] = ()

    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks, the encoder
        tower's among them), the reference's formula."""
        d, hd = self.d_model, self.head_dim_
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for seg in (self.layer_plan() +
                    (self.encoder_plan() if self.is_encoder_decoder else [])):
            for blk in seg.blocks * seg.repeats:
                if blk.mixer in ("attn", "local_attn"):
                    total += d * hd * (n_q + 2 * n_kv) + n_q * hd * d
                    if blk.cross_attn:
                        total += d * hd * (n_q + 2 * n_kv) + n_q * hd * d
                elif blk.mixer == "mlstm":
                    up = int(d * self.proj_factor)
                    total += 2 * d * up + 3 * up * up // max(n_q, 1) + up * d
                elif blk.mixer == "slstm":
                    total += 4 * d * d + 4 * d * (d // max(n_q, 1)) + d * d
                elif blk.mixer == "rglru":
                    rnn = self.d_rnn or d
                    total += 2 * d * rnn + 2 * rnn * rnn // 8 + rnn * d
                if blk.mlp == "dense":
                    ff = self.dense_d_ff or self.d_ff
                    total += d * ff * (3 if self.gated_mlp else 2)
                elif blk.mlp == "moe":
                    ff = self.moe_d_ff or self.d_ff
                    total += self.n_experts * d * ff * 3 + d * self.n_experts
                    total += self.n_shared_experts * d * ff * 3
        return total

    def active_param_count(self) -> int:
        """Parameters a token touches (MoE: the routed experts it is not
        sent to left out), for model FLOPs = 6 · N_active · tokens."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        ff = self.moe_d_ff or self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * d * ff * 3
        moe_layers = self.num_layers - self.first_k_dense
        return self.param_count() - moe_layers * inactive

    def layer_plan(self) -> List[Segment]:
        """Decoder segments: the xLSTM pattern for ``ssm``, the Griffin
        pattern for ``hybrid``, the MoE pattern for a config with
        experts, one stacked segment of dense attention blocks
        otherwise (with cross attention in an encoder-decoder)."""
        if self.family == "ssm":
            return self._xlstm_plan()
        if self.family == "hybrid":
            return self._rglru_plan()
        if self.n_experts > 0:
            return self._moe_plan()
        blocks = (BlockSpec("attn", "dense",
                            cross_attn=self.is_encoder_decoder),)
        return [Segment(blocks, repeats=self.num_layers)]

    def encoder_plan(self) -> List[Segment]:
        """The encoder tower of an encoder-decoder: ``encoder_layers``
        dense attention blocks (run without a causal mask)."""
        if not self.is_encoder_decoder:
            raise ValueError(f"{self.name} has no encoder")
        return [Segment((BlockSpec("attn", "dense"),),
                        repeats=self.encoder_layers)]

    def _moe_plan(self) -> List[Segment]:
        """``first_k_dense`` dense attention blocks, then MoE blocks."""
        segs: List[Segment] = []
        if self.first_k_dense:
            segs.append(Segment((BlockSpec("attn", "dense"),),
                                repeats=self.first_k_dense))
        segs.append(Segment((BlockSpec("attn", "moe"),),
                            repeats=self.num_layers - self.first_k_dense))
        return segs

    def _xlstm_plan(self) -> List[Segment]:
        """(slstm_every − 1) mLSTM blocks then one sLSTM block, repeated;
        all mLSTM when the depth is not a multiple of ``slstm_every``."""
        k = self.slstm_every or self.num_layers + 1
        if self.num_layers % k == 0:
            blocks = tuple(BlockSpec("mlstm", "none") for _ in range(k - 1)) \
                + (BlockSpec("slstm", "none"),)
            return [Segment(blocks, repeats=self.num_layers // k)]
        return [Segment((BlockSpec("mlstm", "none"),),
                        repeats=self.num_layers)]

    def _rglru_plan(self) -> List[Segment]:
        """Griffin residual pattern: 2 recurrent blocks, 1 local-attn
        block, repeated; the remainder as trailing recurrent blocks."""
        period = self.rglru_pattern
        full, extra = divmod(self.num_layers, period)
        blocks = tuple(BlockSpec("rglru", "dense") for _ in range(period - 1)) \
            + (BlockSpec("local_attn", "dense"),)
        segs = [Segment(blocks, repeats=full)]
        if extra:
            segs.append(Segment(tuple(BlockSpec("rglru", "dense")
                                      for _ in range(extra)), repeats=1))
        return segs


_REGISTRY: Dict[str, ArchConfig] = {}
_TINY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig, tiny: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _TINY[cfg.name] = tiny
    return cfg


def get_config(name: str, *, tiny: bool = False) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers the configs)
    table = _TINY if tiny else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_REGISTRY)}")
    return table[name]


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
