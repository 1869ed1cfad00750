"""Qwen1.5-32B, as ``repro/configs/qwen15_32b.py``.

64 layers, d_model 5120, 40 heads (MHA) of 128, d_ff 27392, vocab
152064.  QKV bias, RMSNorm, SwiGLU, untied head, RoPE theta 1e6.
Prefill and training attention pad the 40 heads to 48 (``pad_heads_to``:
zero heads, sliced off before ``w_o``), as the reference does so that
the heads divide its 16-way model axis; the weights keep 40 heads, and
the rule overrides leave their head dims unsharded.  The reference's
``attn_chunk`` is not carried.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    ce_chunk=1024,
    train_accum=4,
    pad_heads_to=48,
    rule_overrides=(("heads", ()), ("kv_heads", ())),
    source="hf:Qwen/Qwen1.5-32B",
)

TINY = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    source="tiny twin",
)

register(CONFIG, TINY)
