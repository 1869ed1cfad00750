"""xLSTM-125M (mLSTM + sLSTM blocks), as ``repro/configs/xlstm_125m.py``.

12 layers, d_model 768, 4 heads, d_ff 0 (each block carries its own
up- and down-projections: mLSTM proj factor 2, so its heads are 384
wide), conv width 4, vocab 50304 (padded to 50688), untied head.
Pattern: (mLSTM ×3, sLSTM) × 3.  Nothing is 16-way model-shardable, so
the rule overrides make the production layout pure data parallelism over
every mesh axis, as the reference's.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=4,
    proj_factor=2.0,
    conv_width=4,
    rule_overrides=(
        ("act_batch", (("pod", "data", "model"), ("data", "model"),
                       ("pod", "data"), ("data",))),
        ("act_seq", ()), ("act_rnn", ()), ("act_heads", ()),
        ("rnn", ()), ("heads", ()),
    ),
    source="arXiv:2405.04517",
)

TINY = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    slstm_every=4,
    proj_factor=2.0,
    conv_width=4,
    source="tiny twin",
)

register(CONFIG, TINY)
