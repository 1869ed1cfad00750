"""InternVL2-26B, as ``repro/configs/internvl2_26b.py``: the language
backbone with the InternViT frontend stubbed to patch embeddings.

48 layers, d_model 6144, 48 query heads over 8 kv heads (GQA 6:1) of
128, d_ff 16384, vocab 92553; an InternLM2-20B-style backbone (RoPE
theta 1e6, SwiGLU, RMSNorm, untied head).  ``vision_prefix_len`` = 1024
precomputed ViT patch embeddings (``pixel_embeds``, (B, 1024, d_model))
go ahead of the tokens; the causal mask and RoPE positions cover them,
and training's loss skips them.  The reference's ``attn_chunk`` is not
carried: the port's attention is the flash kernel at every length.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    vision_prefix_len=1024,
    ce_chunk=1024,
    train_accum=2,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B",
)

TINY = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    vision_prefix_len=8,
    source="tiny twin",
)

register(CONFIG, TINY)
