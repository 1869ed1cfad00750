"""RecurrentGemma-9B (Griffin: RG-LRU + local attention, 2:1), as
``repro/configs/recurrentgemma_9b.py``.

38 layers, d_model 4096, 16 query heads with one kv head (MQA), head_dim
256, d_ff 12288 GeGLU (tanh), d_rnn 4096, conv width 4, sliding window
2048, vocab 256000, tied embeddings scaled by sqrt(d_model).  Pattern:
(rglru, rglru, local_attn) × 12 + 2 trailing rglru blocks.  Training
reads the reference's ``ce_chunk`` (1024) and ``train_accum`` (2).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    sliding_window=2048,
    d_rnn=4096,
    rglru_pattern=3,
    conv_width=4,
    act="gelu_tanh",
    tie_embeddings=True,
    rope_theta=10_000.0,
    ce_chunk=1024,
    train_accum=2,
    source="arXiv:2402.19427; hf:google/recurrentgemma-9b",
)

TINY = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    sliding_window=8,
    d_rnn=64,
    rglru_pattern=3,
    conv_width=4,
    act="gelu_tanh",
    tie_embeddings=True,
    source="tiny twin",
)

register(CONFIG, TINY)
