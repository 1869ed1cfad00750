"""DeepSeek-LLM 7B, as ``repro/configs/deepseek_7b.py``.

30 layers, d_model 4096, 32 heads (MHA) of 128, d_ff 11008, vocab
102400.  The Llama architecture: RoPE, RMSNorm, SwiGLU, no biases,
untied head.  The reference's ``attn_chunk`` is not carried: the port's
attention is the flash kernel at every length.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10_000.0,
    ce_chunk=1024,
    source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-7b-base",
)

TINY = ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    source="tiny twin",
)

register(CONFIG, TINY)
