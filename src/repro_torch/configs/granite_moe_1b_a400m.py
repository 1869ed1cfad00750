"""Granite-3.0-1B-A400M, as ``repro/configs/granite_moe_1b_a400m.py``:
MoE, 32 experts, top-8.

24 layers, d_model 1024, 16 heads (GQA, 8 kv heads) of 64, experts 512
wide, vocab 49155 (padded to 49664), tied embeddings, RoPE, RMSNorm,
SwiGLU experts, no shared experts and no dense layers.  The reference's
``attn_chunk`` is not carried: the port's attention is the flash kernel
at every length.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    tie_embeddings=True,
    rope_theta=10_000.0,
    ce_chunk=1024,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

TINY = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=32,
    vocab_size=512,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=32,
    tie_embeddings=True,
    source="tiny twin",
)

register(CONFIG, TINY)
