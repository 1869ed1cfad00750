"""Many-world lanes: batched PyTorch evaluation of independent simulations.

`repro_torch.manyworld.lanes` is the lane engine (on the card one launch of
the lane-program kernel of `.lane_kernel`; on the CPU the lockstep
program), `.select` the masked argmin placement select of the lockstep
program (a CUDA kernel on the card, plain PyTorch on the CPU), and
`.evaluator` the ``run_cells(..., workers="lanes")`` backend that
rebuilds serial bit-identical result rows.
"""
from repro_torch.manyworld.evaluator import lane_eligible, run_cells_lanes
from repro_torch.manyworld.lane_kernel import (lane_program,
                                               lane_program_plain)
from repro_torch.manyworld.lanes import (LaneBatch, lane_batch_from_numpy,
                                         next_pow2, run_lane_batch,
                                         run_lane_batch_lockstep, stack_lanes)
from repro_torch.manyworld.select import masked_argmin, masked_argmin_plain

__all__ = ["LaneBatch", "lane_batch_from_numpy", "next_pow2",
           "run_lane_batch", "run_lane_batch_lockstep", "stack_lanes",
           "lane_program", "lane_program_plain", "lane_eligible",
           "run_cells_lanes", "masked_argmin", "masked_argmin_plain"]
