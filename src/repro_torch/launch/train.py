"""Training launcher: ``python -m repro_torch.launch.train [--full]``.

The flags of ``repro/launch/train.py``, over the port's ``Trainer``:
synthetic data, AdamW, periodic checkpoints and resume from
``--checkpoint-dir``.  ``--arch`` chooses among the port's archs (the
tiny twin by default, ``--full`` for the published widths).  It runs on
the card; ``--device cpu`` asks for the plain PyTorch path on the CPU,
and without a card and without that flag it raises.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.configs import get_config, list_archs
from repro_torch.train.data import DataConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="deepseek-7b",
                    choices=list_archs())
    ap.add_argument("--tiny", action="store_true", default=True,
                    help="use the reduced smoke config (the default)")
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, tiny=args.tiny)
    trainer = Trainer(
        cfg,
        OptimizerConfig(learning_rate=args.lr, warmup_steps=args.warmup,
                        total_steps=args.steps),
        DataConfig(batch_size=args.batch_size, seq_len=args.seq_len,
                   accum=args.accum, seed=args.seed),
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=args.checkpoint_dir, seed=args.seed),
        device=args.device,
    )
    result = trainer.run()
    print(f"[train] result: {result}")
    return result


if __name__ == "__main__":
    main()
