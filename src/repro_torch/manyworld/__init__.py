"""Many-world lanes: batched PyTorch evaluation of independent simulations.

`repro_torch.manyworld.lanes` is the lane engine, `.select` the masked
argmin placement select (a CUDA kernel on the card, plain PyTorch on the
CPU), and `.evaluator` the ``run_cells(..., workers="lanes")`` backend that
rebuilds serial bit-identical result rows.
"""
from repro_torch.manyworld.evaluator import lane_eligible, run_cells_lanes
from repro_torch.manyworld.lanes import (LaneBatch, lane_batch_from_numpy,
                                         next_pow2, run_lane_batch,
                                         stack_lanes)
from repro_torch.manyworld.select import masked_argmin, masked_argmin_plain

__all__ = ["LaneBatch", "lane_batch_from_numpy", "next_pow2",
           "run_lane_batch", "stack_lanes", "lane_eligible",
           "run_cells_lanes", "masked_argmin", "masked_argmin_plain"]
