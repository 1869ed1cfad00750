"""Whisper-medium, as ``repro/configs/whisper_medium.py``: the
encoder-decoder backbone with the conv frontend stubbed to frame
embeddings.

24 encoder + 24 decoder layers, d_model 1024, 16 heads of 64 (MHA),
d_ff 4096, vocab 51865.  LayerNorm, GeLU (not gated) with biases, QKV
biases, tied embeddings, sinusoidal absolute positions in both towers
(the reference's adaptation: the decoder's learned positions are
replaced by sinusoids).  Each decoder block attends to the encoder's
output (``cross_attn``); the encoder reads ``encoder_seq`` = 1500
precomputed frame embeddings (``audio_embeds``, (B, 1500, d_model)).
The reference's ``attn_chunk`` is not carried: the port's attention is
the flash kernel at every length.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=24,
    encoder_seq=1500,
    use_rope=False,
    norm_type="layernorm",
    act="gelu",
    gated_mlp=False,
    mlp_bias=True,
    qkv_bias=True,
    tie_embeddings=True,
    source="arXiv:2212.04356; hf:openai/whisper-medium",
)

TINY = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    is_encoder_decoder=True,
    encoder_layers=2,
    encoder_seq=16,
    use_rope=False,
    norm_type="layernorm",
    act="gelu",
    gated_mlp=False,
    mlp_bias=True,
    qkv_bias=True,
    tie_embeddings=True,
    source="tiny twin",
)

register(CONFIG, TINY)
