"""DeepSeekMoE-16B, as ``repro/configs/deepseek_moe_16b.py``: fine-grained
experts, 2 shared + 64 routed, top-6.

28 layers, d_model 2048, 16 heads (MHA, 16 kv heads) of 128, vocab
102400 (already a multiple of 512), untied head.  The first layer is
dense (d_ff 10944, as in the release); the other 27 are MoE layers of
64 routed experts 1408 wide (6 a token) beside 2 shared experts.  The
reference's ``attn_chunk`` is not carried: the port's attention is the
flash kernel at every length.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_k_dense=1,
    dense_d_ff=10944,
    rope_theta=10_000.0,
    ce_chunk=1024,
    source="arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base",
)

TINY = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=48,
    vocab_size=512,
    n_experts=8,
    n_shared_experts=2,
    experts_per_token=2,
    moe_d_ff=48,
    first_k_dense=1,
    dense_d_ff=128,
    source="tiny twin",
)

register(CONFIG, TINY)
