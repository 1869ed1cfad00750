"""Process groups and device meshes, as ``repro/launch/mesh.py``.

Functions, not module constants, so importing this module starts no
process group.  :func:`init_distributed` starts the default group: NCCL
for the card (``device=None`` or ``"cuda"``; no card raises, as
``resolve_device`` does), gloo for ``device="cpu"``.  Rank and world
come from the arguments only (default: rank 0 of a world of 1; the
module reads no environment variable); without an ``init_method`` a
world of 1 rendezvouses on a file store in a fresh temporary directory,
removed when the process exits, and a larger world must be given its
rendezvous (``tcp://host:port`` or ``file://path``).

The meshes are ``torch.distributed.device_mesh.DeviceMesh``\\ es with
named dimensions, the torch form of ``jax.sharding.Mesh``:
:func:`make_production_mesh` is the reference's (16, 16) ``("data",
"model")`` pod of 256 cards or (2, 16, 16) ``("pod", "data", "model")``
pair of pods, 512 cards, and raises, naming the size, on another world.
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def init_distributed(device=None, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None) -> torch.device:
    """Start the default process group (once) and return this rank's
    device: ``cuda:<local rank>`` for NCCL (``local_rank`` defaults to
    ``rank``), the CPU for gloo."""
    dev = resolve_device(device)
    rank = 0 if rank is None else rank
    world = 1 if world_size is None else world_size
    if dev.type == "cuda":
        local = rank if local_rank is None else local_rank
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if init_method is None:
            if world == 1:
                root = tempfile.mkdtemp(prefix="repro_dist_")
                atexit.register(shutil.rmtree, root, True)
                init_method = f"file://{os.path.join(root, 'store')}"
            else:
                raise ValueError(
                    f"a world of {world} needs an init_method "
                    "(tcp://host:port or file://path)")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, rank=rank,
                                world_size=world)
    return dev


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A mesh of ``shape`` with dimension names ``axes`` over the whole
    world (elastic resizing, tests)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda"):
    """One pod: 16 x 16 = 256 cards ("data", "model").  Two pods:
    2 x 16 x 16 = 512 cards ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def local_mesh(device_type: str = "cuda"):
    """Every rank of the world as a 1-D ("data",) mesh."""
    return make_mesh((dist.get_world_size(),), ("data",), device_type)
