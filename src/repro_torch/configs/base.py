"""Architecture config: the fields of ``repro/configs/base.py ArchConfig``
that the port's mLSTM block reads.

The reference's config carries every LM option; the forecaster's trunk
reads only the widths below (``proj_factor`` and ``conv_width`` at
``configs/base.py:82-83``), plus a name and family for labels.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|audio|vlm
    d_model: int
    num_heads: int
    proj_factor: float = 2.0      # mLSTM up-projection
    conv_width: int = 4
