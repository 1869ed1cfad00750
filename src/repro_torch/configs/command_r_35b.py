"""Command-R 35B (c4ai-command-r-v01), as ``repro/configs/command_r_35b.py``.

40 layers, d_model 8192, 64 heads (GQA, 8 kv heads) of 128, d_ff 22528,
vocab 256000.  Parallel attention + MLP blocks (one shared pre-norm, the
Cohere / GPT-J form), LayerNorm, no biases, tied embeddings, RoPE theta
8e6.  The reference's ``attn_chunk`` is not carried: the port's
attention is the flash kernel at every length.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    parallel_block=True,
    norm_type="layernorm",
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    ce_chunk=1024,
    train_accum=2,
    source="hf:CohereForAI/c4ai-command-r-v01",
)

TINY = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    parallel_block=True,
    norm_type="layernorm",
    tie_embeddings=True,
    source="tiny twin",
)

register(CONFIG, TINY)
