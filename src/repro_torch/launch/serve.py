"""Serving launcher: ``python -m repro_torch.launch.serve [--full]``.

The flags and the request stream of ``repro/launch/serve.py``: a
``ServeEngine`` (continuous batching) behind ``run_server``, fed
``--requests`` synthetic prompts of 4–16 tokens with exponential
inter-arrival times, printing latency and throughput — the service job
the orchestrator deploys.  ``--arch`` chooses among the port's archs
(the tiny twin by default, ``--full`` for the published widths, with
random weights drawn from ``--seed`` in the serving dtypes).  Whisper
(``audio``) gets one set of ``audio_embeds`` (encoder_seq, d_model) and
InternVL2 (``vlm``) one set of ``pixel_embeds`` (vision_prefix_len,
d_model) for every request, drawn as the reference's CLI draws them;
InternVL2's cache must hold the patches as well as the prompt
(``--cache-len``).  It runs on the card; ``--device cpu`` asks for the
plain PyTorch path on the CPU, and without a card and without that flag
it raises.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.params import init_params
from repro_torch.serve.engine import (EngineConfig, Request, ServeEngine,
                                      run_server)
from repro_torch.serve.sampling import SamplingConfig


def extra_inputs(cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """The modality input of ``cfg``'s family (none for a text-only
    arch), without a batch axis, as the reference's CLI draws it:
    ``0.02 * default_rng(seed).standard_normal(...)`` in float32 (its
    seed is 0)."""
    if cfg.family == "vlm":
        name, shape = "pixel_embeds", (cfg.vision_prefix_len, cfg.d_model)
    elif cfg.family == "audio":
        name, shape = "audio_embeds", (cfg.encoder_seq, cfg.d_model)
    else:
        return {}
    return {name: 0.02 * np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)}


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="deepseek-7b",
                    choices=list_archs())
    ap.add_argument("--tiny", action="store_true", default=True,
                    help="use the reduced smoke config (the default)")
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mean-interarrival-s", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, tiny=args.tiny)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(tf.model_specs(cfg), gen, dev,
                         dtype=tf.serving_dtype(cfg))
    engine = ServeEngine(cfg, params, EngineConfig(
        num_slots=args.slots, cache_len=args.cache_len,
        sampling=SamplingConfig(temperature=args.temperature)),
        extra_inputs=extra_inputs(cfg), device=dev)

    rng = np.random.default_rng(args.seed)
    t = 0.0
    requests = []
    for i in range(args.requests):
        t += float(rng.exponential(args.mean_interarrival_s))
        plen = int(rng.integers(4, 17))
        requests.append(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, plen),
            max_new_tokens=args.max_new_tokens, submitted_at=t))
    metrics = run_server(engine, requests)
    print(f"[serve] {metrics}")
    return metrics


if __name__ == "__main__":
    main()
