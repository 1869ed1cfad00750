"""GLM-4-9B, as ``repro/configs/glm4_9b.py``.

40 layers, d_model 4096, 32 heads (GQA, 2 kv heads) of 128, d_ff 13696,
vocab 151552.  Partial rotary (half of each head), QKV bias, RMSNorm,
SwiGLU, untied head.  The reference's ``attn_chunk`` is not carried:
the port's attention is the flash kernel at every length.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rotary_pct=0.5,
    qkv_bias=True,
    rope_theta=10_000.0,
    ce_chunk=1024,
    source="hf:THUDM/glm-4-9b",
)

TINY = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    rotary_pct=0.5,
    qkv_bias=True,
    source="tiny twin",
)

register(CONFIG, TINY)
