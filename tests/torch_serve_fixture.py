"""Building a serve fixture of ``repro_torch.serve.golden`` with the JAX
package (the reference): the arrays ``golden.replay`` holds the port to.

Imported by the test files that own a fixture and rebuild it with
``--regen``; it needs JAX, so they import it after
``pytest.importorskip("jax")``.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine

from repro_torch.models.params import tree_digest
from repro_torch.serve import golden

# The reference's entry points jitted (the same functions; eager, their
# op-by-op dispatch takes seconds a step on the CPU).
REF_PREFILL = jax.jit(ref_tf.prefill, static_argnums=(2, 3))
REF_DECODE = jax.jit(ref_tf.decode_step, static_argnums=(3,))


def _to_jax(tree) -> None:
    """Each numpy leaf replaced by a JAX array in place, so the numpy
    arrays are freed one by one."""
    for key, val in list(tree.items() if isinstance(tree, dict)
                         else enumerate(tree)):
        if isinstance(val, (dict, list)):
            _to_jax(val)
        else:
            tree[key] = jnp.asarray(val)


def build(fixture: golden.Fixture) -> dict:
    """The fixture's arrays, computed by the JAX package on the CPU from
    the parameters, modality input and tokens of ``fixture``."""
    ref_cfg = golden.config(fixture, ref_get_config(fixture.arch))
    tree = golden.parameters(fixture)
    digest = tree_digest(tree)
    _to_jax(tree)
    extra = golden.extra_inputs(fixture)
    tokens, prompts = golden.inputs(fixture)
    lg, *decode = golden.logits(
        fixture, REF_PREFILL, REF_DECODE, tree, ref_cfg, tokens, jnp.asarray,
        {k: jnp.asarray(np.repeat(v[None], 2, 0)) for k, v in extra.items()})
    clock, sleep = golden.virtual_clock()
    eng = ref_engine.ServeEngine(ref_cfg, tree, ref_engine.EngineConfig(
        num_slots=fixture.slots, cache_len=fixture.cache_len),
        extra_inputs=extra, clock=clock)
    reqs = golden.requests(fixture, ref_engine, prompts)
    metrics = ref_engine.run_server(eng, reqs, log=lambda s: None,
                                    clock=clock, sleep=sleep)
    width = max(len(r.tokens) for r in reqs)
    return {
        "seed": np.asarray(fixture.seed), "params_digest": np.asarray(digest),
        "extra_digest": np.asarray(tree_digest(extra)),
        "tokens": tokens, "prefill_logits": np.asarray(lg),
        "decode_logits": np.stack([np.asarray(d) for d in decode]),
        "engine_prompts": np.concatenate(prompts),
        "engine_tokens": np.asarray(
            [r.tokens + [-1] * (width - len(r.tokens)) for r in reqs],
            np.int32),
        "engine_stamps": np.asarray([(r.first_token_at, r.done_at)
                                     for r in reqs]),
        "engine_metrics": np.asarray([metrics[k]
                                      for k in golden.METRIC_KEYS])}
