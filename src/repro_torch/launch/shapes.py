"""The assigned input shapes and their input specs, as
``repro/launch/shapes.py``.

Four shapes per LM architecture:
  train_4k     seq 4096,   global batch 256   -> train step
  prefill_32k  seq 32768,  global batch 32    -> serve prefill
  decode_32k   cache 32768, global batch 128  -> serve decode (1 token)
  long_500k    cache 524288, global batch 1   -> decode, sub-quadratic only

``long_500k`` is skipped for the full-attention families.  The specs are
tensors on the meta device (shape and dtype, no storage), the torch
stand-in for ``jax.ShapeDtypeStruct``; the vlm and audio families carry
their stubbed patch and frame embeddings.  A decode cell's state is
``init_decode_state`` on the meta device with one scalar position per
cache (a uniform decode wave).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable?, the reason when skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("full quadratic attention: a 500k-token KV cache/"
                       "attention row is out of scope by design (DESIGN.md "
                       "§5)")
    return True, ""


def cells(archs: List[str]) -> List[Tuple[str, str]]:
    from repro_torch.configs import get_config
    return [(arch, shape.name) for arch in archs
            for shape in SHAPES.values()
            if applicable(get_config(arch), shape)[0]]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _act_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    accum = max(cfg.train_accum, 1)
    if B % accum:
        raise ValueError(f"global batch {B} does not split into {accum} "
                         "microbatches")
    lead = (accum,) if accum > 1 else ()
    B //= accum
    S_text = S - cfg.vision_prefix_len if cfg.family == "vlm" else S
    batch = {
        "tokens": _spec(lead + (B, S_text), torch.int32),
        "labels": _spec(lead + (B, S_text), torch.int32),
        "loss_mask": _spec(lead + (B, S_text), torch.float32),
    }
    if cfg.family == "vlm":
        batch["pixel_embeds"] = _spec(
            lead + (B, cfg.vision_prefix_len, cfg.d_model), _act_dtype(cfg))
    if cfg.family == "audio":
        batch["audio_embeds"] = _spec(
            lead + (B, cfg.encoder_seq, cfg.d_model), _act_dtype(cfg))
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    S_text = S - cfg.vision_prefix_len if cfg.family == "vlm" else S
    batch = {"tokens": _spec((B, S_text), torch.int32)}
    if cfg.family == "vlm":
        batch["pixel_embeds"] = _spec((B, cfg.vision_prefix_len, cfg.d_model),
                                      _act_dtype(cfg))
    if cfg.family == "audio":
        batch["audio_embeds"] = _spec((B, cfg.encoder_seq, cfg.d_model),
                                      _act_dtype(cfg))
    return batch


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec
                       ) -> Tuple[torch.Tensor, List]:
    """(token spec, decode-state specs) for one decode step."""
    B, S = shape.global_batch, shape.seq_len
    states = tf.init_decode_state(cfg, B, S, dtype=_act_dtype(cfg),
                                  device="meta", per_example_pos=False)
    return _spec((B, 1), torch.int32), states


def input_specs(cfg: ArchConfig, shape_name: str) -> Dict:
    """Every model input of an (arch, shape) cell, as meta tensors."""
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape_name} skipped: {why}")
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    tokens, states = decode_input_specs(cfg, shape)
    return {"tokens": tokens, "states": states}
