"""The frozen counters against hand-computed values at both cells'
shapes, and the configuration files against the program's parameter
tree."""
import json

import pytest

import portbench_testlib as tl
from portbench import counters, harness

DENSE = json.loads((tl.ROOT / "portbench/configs/deepseek-7b.json").read_text())
MOE = json.loads((tl.ROOT / "portbench/configs/deepseek-moe-16b.json")
                 .read_text())
PEAKS = {"bf16_flop_per_s": 989e12, "hbm_byte_per_s": 3.35e12}


def test_prefill_flops_dense_at_1536():
    T = 1536
    proj = 2 * T * 4096 * 128 * (32 + 32 + 32 + 32)  # q, k, v, o
    attn = 4 * 32 * 128 * T * (T + 1) // 2         # causal pairs
    mlp = 2 * T * 3 * 4096 * 11008
    head = 2 * 4096 * 102400                        # last position only
    assert counters.prefill_flops(DENSE, T) == 30 * (proj + attn + mlp) + head
    assert counters.prefill_flops(DENSE, T) == 19_231_932_416_000


def test_prefill_flops_moe_at_1536():
    T = 1536
    proj = 2 * T * 2048 * 128 * (16 + 16 + 16 + 16)
    attn = 4 * 16 * 128 * T * (T + 1) // 2
    dense_mlp = 2 * T * 3 * 2048 * 10944
    moe = 2 * T * (2048 * 64 + 3 * 2048 * 1408 * (6 + 2))  # router, 6 + 2
    head = 2 * 2048 * 102400
    want = 28 * (proj + attn) + dense_mlp + 27 * moe + head
    assert counters.prefill_flops(MOE, T) == want == 7_671_944_052_736


@pytest.mark.parametrize("T,heads,ops,nbytes", [
    (1536, 32, 4 * 32 * 128 * 1536 * 1537 // 2, 2 * 1536 * 128 * 128),
    (3584, 16, 4 * 16 * 128 * 3584 * 3585 // 2, 2 * 3584 * 128 * 64)])
def test_flash_counts_and_bound(T, heads, ops, nbytes):
    assert counters.flash_ops(T, heads, 128) == ops
    assert counters.flash_bytes(T, heads, heads, 128) == nbytes
    bound = counters.flash_bound_s(T, heads, heads, 128, PEAKS)
    assert bound == max(ops / 989e12, nbytes / 3.35e12)
    assert bound == ops / 989e12            # causal hd 128: compute-bound


def test_kv_bytes_per_token():
    assert counters.kv_bytes_per_token(DENSE) == 491_520
    assert counters.kv_bytes_per_token(MOE) == 229_376


def test_dense_decode_bytes():
    layer = 2 * (4 * 4096 * 4096 + 3 * 4096 * 11008) + 4 * 2 * 4096
    weights = 30 * layer + 4 * 4096 + 2 * 4096 * 102400
    assert counters.dense_weight_bytes(DENSE) == weights == 12_982_370_304
    # 16 active slots holding 30,000 positions in all, the new ones too
    want = weights + 2 * 16 * 4096 + 491_520 * (30_000 + 16)
    assert counters.dense_decode_bytes(DENSE, 16, 30_000) == want
    with pytest.raises(ValueError):
        counters.dense_weight_bytes(MOE)


@pytest.mark.parametrize("cfg,count", [(DENSE, 6_910_365_696),
                                       (MOE, 16_375_728_128)])
def test_configs_are_whole(cfg, count):
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import count_params
    assert count_params(tf.model_specs(harness.arch_config(cfg))) == count
