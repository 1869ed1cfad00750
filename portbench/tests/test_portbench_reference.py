"""The plain reference against the program's float32 tiny twins on the
CPU: prefill and then decoding through the cache, dense and MoE (with
capacity drops), and the fp8 control's departure from it."""
import numpy as np
import pytest
import torch

import portbench_testlib as tl
from portbench import harness, weights
from portbench.reference import deepseek

CPU = torch.device("cpu")


def program_logits(cfg_file, params, prompt, follow):
    """The program's logits at the prompt's last position, then at each
    followed token through its decode state (float32 twin)."""
    from repro_torch.models import transformer as tf
    cfg = harness.arch_config(cfg_file, dtype="float32")
    with torch.no_grad():
        lg, st = tf.prefill(params, {"tokens": torch.as_tensor(prompt)[None]},
                            cfg, len(prompt) + len(follow) + 1)
        out = [lg[0, :cfg.vocab_size]]
        for t in follow:
            lg, st = tf.decode_step(params, torch.tensor([[int(t)]]), st, cfg)
            out.append(lg[0, :cfg.vocab_size])
    return torch.stack(out)


def twin(cfg_file, seed):
    from repro_torch.models import transformer as tf
    cfg = harness.arch_config(cfg_file, dtype="float32")
    return weights.draw(tf.model_specs(cfg), lambda _: torch.float32, seed, CPU)


def reference(cfg_file, params, prompt, follow, precision="float32"):
    seq = torch.as_tensor(np.concatenate([prompt, follow]), dtype=torch.int64)
    return deepseek.logits(cfg_file, params, [seq], [len(prompt)],
                           [len(prompt) - 1], precision)[0]


@pytest.mark.parametrize("cfg_file", [tl.TINY_DENSE, tl.TINY_MOE],
                         ids=["dense", "moe"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_reference_matches_the_program_twin(cfg_file, seed):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 512, 40)
    follow = rng.integers(0, 512, 10)
    params = twin(cfg_file, seed)
    ref = reference(cfg_file, params, prompt, follow)
    got = program_logits(cfg_file, params, prompt, follow)
    assert ref.shape == (11, 512)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-5 * float(
        ref.abs().max()))


def test_the_moe_twin_drops_choices_and_the_reference_follows():
    """At 40 prompt tokens, 8 experts, top-2 and factor 1.25 an expert
    takes 12 choices; the prompt's routing overflows some, and dropping
    them changes the logits by far more than the tolerance above."""
    cfg = tl.TINY_MOE
    params = twin(cfg, 3)
    rng = np.random.default_rng(3)
    prompt, follow = rng.integers(0, 512, 40), rng.integers(0, 512, 6)
    m = deepseek._Math(cfg, "float32")
    dropped = 0
    x = params["embed"][torch.as_tensor(prompt)].float()
    for layer in deepseek.layers(params):
        x = x + m.attention(m.norm(x, layer["norm1"]["scale"]), layer["mixer"])
        h = m.norm(x, layer["norm2"]["scale"])
        if "w_router" in layer["mlp"]:
            probs = torch.softmax(h @ layer["mlp"]["w_router"], -1)
            idx = torch.sort(probs, dim=-1, descending=True,
                             stable=True).indices[:, :2]
            dropped += int((~m.keep(idx, len(prompt))).sum())
            x = x + m.moe(h, layer["mlp"], len(prompt))
        else:
            mlp = layer["mlp"]
            x = x + m.swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"])
    assert dropped > 0
    no_drops = dict(cfg, capacity_factor=100.0)
    a = reference(cfg, params, prompt, follow)
    b = reference(no_drops, params, prompt, follow)
    assert float((a - b).abs().max()) > 1e-3 * float(a.abs().max())


@pytest.mark.parametrize("cfg_file", [tl.TINY_DENSE, tl.TINY_MOE],
                         ids=["dense", "moe"])
def test_fp8_control_departs_from_the_reference(cfg_file):
    params = twin(cfg_file, 5)
    rng = np.random.default_rng(5)
    prompt, follow = rng.integers(0, 512, 40), rng.integers(0, 512, 10)
    ref = reference(cfg_file, params, prompt, follow)
    low = reference(cfg_file, params, prompt, follow, "fp8")
    assert float((ref - low).abs().max()) > 100 * 2e-5 * float(
        ref.abs().max())


def test_unknown_precision_and_ragged_groups_are_refused():
    with pytest.raises(ValueError):
        deepseek._Math(tl.TINY_MOE, "int4")
    m = deepseek._Math(dict(tl.TINY_MOE, moe_group_tokens=16), "float32")
    with pytest.raises(ValueError):
        m.keep(torch.zeros(40, 2, dtype=torch.int64), 40)
