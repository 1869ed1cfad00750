"""Synthetic deterministic LM batches, the port's copy of
``repro/train/data.py`` (NumPy only; its batches are ``==`` the
reference's for the same config, seed, step and host).

``batch(step)`` is pure: deterministic per (seed, step, host), so the
dataset's "checkpointed" state is the step counter and a resumed trainer
sees the batches an uninterrupted one would.  The token stream is a fixed
periodic pattern per seed, seen through per-step noise and a per-row
phase, so a small model's loss falls.  The vlm family's batches also
carry ``pixel_embeds`` (..., vision_prefix_len, d_model) and the audio
family's ``audio_embeds`` (..., encoder_seq, d_model), drawn from the
same generator after the tokens, as the reference draws them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8            # per-host examples per step
    seq_len: int = 128
    seed: int = 0
    accum: int = 1                 # leading microbatch axis if > 1
    pattern_period: int = 16       # learnable structure in the stream


class SyntheticLM:
    """Deterministic synthetic LM batches: batch(step) is pure."""

    def __init__(self, cfg: ArchConfig, data_cfg: DataConfig,
                 host_id: int = 0, num_hosts: int = 1):
        self.cfg = cfg
        self.dc = data_cfg
        self.host_id = host_id
        self.num_hosts = num_hosts

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        dc, cfg = self.dc, self.cfg
        shape = (dc.accum, dc.batch_size, dc.seq_len + 1) if dc.accum > 1 \
            else (dc.batch_size, dc.seq_len + 1)
        rng = np.random.default_rng(
            (dc.seed * 1_000_003 + step) * 65_537 + self.host_id)
        pat_rng = np.random.default_rng(dc.seed * 7_919 + 13 * self.host_id)
        base = pat_rng.integers(0, cfg.vocab_size, size=(dc.pattern_period,))
        reps = -(-(dc.seq_len + 1) // dc.pattern_period) + 1
        track = np.tile(base, reps)
        phase = rng.integers(0, dc.pattern_period, size=shape[:-1])
        idx = phase[..., None] + np.arange(dc.seq_len + 1)
        stream = track[idx]
        noise = rng.integers(0, cfg.vocab_size, size=shape)
        noisy = rng.random(shape) < 0.1
        tokens = np.where(noisy, noise, stream).astype(np.int32)
        out = {"tokens": tokens[..., :-1],
               "labels": tokens[..., 1:],
               "loss_mask": np.ones(shape[:-1] + (dc.seq_len,), np.float32)}
        if cfg.family == "vlm":
            out["pixel_embeds"] = 0.02 * rng.standard_normal(
                shape[:-1] + (cfg.vision_prefix_len, cfg.d_model)
            ).astype(np.float32)
        if cfg.family == "audio":
            out["audio_embeds"] = 0.02 * rng.standard_normal(
                shape[:-1] + (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
