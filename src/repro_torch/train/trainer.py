"""Trainer: the runnable training job the orchestrator schedules, as
``repro/train/trainer.py``.

It keeps the *moveable / checkpointable* job contract:

* periodic checkpoints at step boundaries (durable progress);
* cooperative preemption: ``request_stop()`` (the orchestrator's evict
  signal, a ``threading.Event`` any thread may set) makes the loop
  checkpoint and return ``{"completed": 0.0, ...}``;
* resume from the latest checkpoint on construction, so a job evicted
  and rescheduled continues where it stopped.  The checkpoints are the
  JAX package's format, so a JAX trainer resumes a torch one's and the
  reverse.

The state lives on ``device`` (``None`` is the card; the CPU runs only
when the caller asks for it) and the step updates it in place, where the
reference donates it to ``jax.jit``.  One departure: a checkpoint of the
step that was just saved is not written again (the reference re-saves
the last periodic step at the end of ``run`` and on a stop right after
one); the files on disk are the same.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 2
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: OptimizerConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 log_fn: Callable[[str], None] = print, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = SyntheticLM(cfg, data_cfg)
        self.log = log_fn
        self._stop = threading.Event()
        self.step = 0
        self._saved_step: Optional[int] = None
        self.history: List[Dict[str, float]] = []
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir,
                                       keep=tcfg.keep_checkpoints)
                     if tcfg.checkpoint_dir else None)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(tcfg.seed)
        self.state = init_train_state(gen, cfg, self.device)
        if self.ckpt and self.ckpt.latest_step() is not None:
            self.state, self.step, _ = self.ckpt.restore(self.state,
                                                         into=True)
            self._saved_step = self.step
            self.log(f"[trainer] resumed from step {self.step}")
        self._step_fn = make_train_step(cfg, opt_cfg, accum=data_cfg.accum)

    # -- the orchestrator's evict signal -----------------------------------
    def request_stop(self) -> None:
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def checkpoint(self) -> None:
        if self.ckpt and self._saved_step != self.step:
            self.ckpt.save(self.step, self.state)
            self._saved_step = self.step

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch(step).items()}

    # -- main loop -------------------------------------------------------
    def run(self) -> Dict[str, float]:
        t0 = time.time()
        while self.step < self.tcfg.total_steps:
            if self._stop.is_set():
                self.checkpoint()
                self.log(f"[trainer] preempted at step {self.step}; "
                         "checkpointed")
                return {"completed": 0.0, "step": float(self.step)}
            self.state, metrics = self._step_fn(self.state,
                                                self._batch(self.step))
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or \
               self.step == self.tcfg.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step
                self.history.append(m)
                self.log(f"[trainer] step {self.step} "
                         f"loss={m['loss']:.4f} acc={m['accuracy']:.3f} "
                         f"gnorm={m['grad_norm']:.2f}")
            if self.tcfg.checkpoint_every and \
               self.step % self.tcfg.checkpoint_every == 0:
                self.checkpoint()
        self.checkpoint()
        dt = time.time() - t0
        self.log(f"[trainer] done: {self.step} steps in {dt:.1f}s")
        return {"completed": 1.0, "step": float(self.step),
                "final_loss": self.history[-1]["loss"] if self.history else -1}
