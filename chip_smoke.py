#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``), the CUDA
   version PyTorch was built with, and ``nvcc --version``;
2. build   — builds every kernel of the port (every ``csrc/*.cu`` under
   ``src/repro_torch``) with ``nvcc``, one process per source, started
   together;
3. kernel  — the masked argmin against its plain PyTorch version on the
   card at the lane path's shape and at edge shapes (``torch.equal``),
   and its device time over many launches beside its bound, the plain
   version's time and a library yardstick;
4. golden  — the lane-program kernel (one launch a batch) over every
   batch of ``tests/data/torch_lane_golden.npz`` (outputs of the JAX
   reference) and the lockstep program with the select kernel over 8 of
   each batch's 16 lanes (``GOLDEN_LOCKSTEP_LANES``), on the card, bit
   for bit, after rebuilding the fixture's input columns with the port's
   own generators;
5. main    — ``run_cells(cells, workers="lanes")`` on 2048 heavy-tail
   cells (1000 jobs each, ``MAIN_JOBS``, 64 m2.small nodes, best-fit,
   void/void) through the lane-program kernel: lanes/s, the stage split
   of the wall (``evaluator.stage_s``), kernel launches, host syncs, peak
   device memory; the kernel alone on the same batch (CUDA events), its
   longest lane's chain of dependent steps and its bound; then the
   lockstep program on that batch with the select kernel (a profiled
   window of its inner steps) and with the plain select, whose outputs
   must equal the kernel's;
6. mlstm   — the chunkwise-mLSTM kernels against their plain version
   (``allclose``: float32 ``atol 2e-4, rtol 2e-3``, bfloat16 ``5e-2``) at
   the forecaster's shape over the golden dataset's 8668 windows, the
   JAX kernel test's shapes in both dtypes, T = L, dv not a multiple of
   32, a given initial state and the returned final state, the row
   kernel's envelope from both sides, xLSTM-125M's 384-wide heads (the
   serving prefill's shape (1, 4, 3072, 384) bfloat16 with the state out,
   float32 with a state in and out, T = L = 64 in both dtypes), the
   parallel kernel's envelope (a state in and out, B*H > 4, dv != dk,
   T 3008), xLSTM-125M's training call in phase 33 ((4, 4, 512, 384)
   bfloat16, the parallel kernel, also without the state out) and the
   forecaster's training batch (B 64) (each case through
   the kernel the wrapper picks; all three kernels must be reached; the
   parallel kernel's cases also against its algorithm in plain PyTorch
   with the same bfloat16 hi/lo operands); at the forecaster's shape the
   row kernel, the block kernel and the plain version, and at xLSTM's
   prefill shape with T 256, 1024, 2048 and 3072 the parallel kernel and
   the block kernel side by side (and the plain version at T 3072), timed
   by CUDA events with the launches queued behind a device sleep, each
   beside its bound and with its largest error as a share of the
   tolerance;
7. forecast golden — ``load_forecaster`` on the fixture
   ``tests/data/torch_forecaster_golden`` (a forecaster trained and
   saved by the JAX package, and its outputs): the dataset rebuilt with
   the port's generators must hash to the fixture's digest, and
   ``apply_forecast`` on its 8668 windows, the val log-MSE and the
   per-bin ``(rate, conf)`` of one flash-crowd trace must match;
8. forecast main — batched ``apply_forecast`` over the 8668 windows at
   full width (cold and warm, windows/s), mlstm kernel launches, peak
   device memory, ``LearnedForecaster.predict`` latency over a whole
   flash-crowd trace's bins, and the val log-MSE of the mLSTM, EWMA and
   AR(1) forecasters;
9. flash   — the flash-attention kernel against its plain version on
   edge shapes (bfloat16: the tensor-core kernel's tiles, windows, GQA,
   padded hd), at the serving shape (B 1, 16 query heads, 1 kv head,
   T 3072, hd 256, window 2048, bfloat16), at the MoE cells' shapes
   (DeepSeekMoE-16B: 16 heads of 128, MHA, causal, T 3072; Granite:
   GQA 16/8 at hd 64, T 1024), at the dense cells' shapes (Command-R-35B:
   GQA 64/8 at hd 128, causal; Qwen1.5-32B padded to 48 heads, MHA; each
   at T 512 and 3072), at Whisper-medium's (the encoder's T = S = 1500
   and cross attention's T 4 and 384 against S 1500, both without a mask;
   the decoder's causal T 384; 16 heads of 64) and InternVL2-26B's (GQA
   48/8 at hd 128, causal, T 1088 and 3072) shapes, in bf16 and float32,
   at phase 33's MoE training shape (B 4, 16 heads of 128, causal,
   T 512) and at the training shape (B 2, T 4096); device
   times at T 3072 and 1674 of the serving shape and at DeepSeekMoE's,
   Command-R's, Whisper's and InternVL2's shapes of the bf16 kernel, the
   float32 kernel, the plain version and
   ``scaled_dot_product_attention`` with the same mask as a yardstick,
   each with its TFLOP/s and share of the bound; the kernel's registers
   and spills from the ptxas log; then the soft-capped kernels
   (``softcap=2`` on logits ~N(0, 16)) against the plain version with the
   cap at the serving, Command-R, DeepSeekMoE, Whisper and training
   shapes in bf16 and one float32 shape per head dim (each bf16 case also
   at the tolerance scaled to each query row's rms), each also at least
   10 x its tolerance from the uncapped plain version, the capped and
   uncapped kernels' times at the serving shape and Whisper's encoder
   shape beside the capped bound (tensor cores, special-function unit,
   bytes) and compiled FlexAttention with the cap as its ``score_mod``
   as the yardstick, and a gate that no capped instantiation spills more
   than its uncapped one;
10. rglru  — the RG-LRU scan kernels against their plain version on
   edge shapes of both (the chunked kernel up to 24 MB of input, the ring
   kernel above), at the serving shape (B 1, T 3072, R 4096, float32
   in, bfloat16 out) and at the training shape (B 2, T 4096), failing
   unless both kernels ran; at T 3072, 1674
   and 512 the ring kernel and the chunked kernel (the PR 13 design) on
   the same inputs, timed by CUDA events with the launches queued behind
   a device sleep, beside the bound; the plain version's time at T 3072
   and 512;
11. serve golden — the fixture ``tests/data/torch_serve_golden`` (an
   8-layer float32 RecurrentGemma twin's parameters and JAX's prefill and
   decode logits and greedy engine tokens): the port on the card through
   both kernels reproduces them;
12. serve main — full-width RecurrentGemma-9B (38 layers, 8.58 G
   parameters drawn on the card in bfloat16 from a seeded CUDA
   generator) behind ``ServeEngine(num_slots=8, cache_len=4096)``,
   greedy, 16 requests at t = 0 with prompts of 256–3072 tokens and 64
   new tokens each, through ``run_server``: tokens/s, mean TTFT, prefill
   ms by prompt length, decode step ms, peak device memory, the launches
   of each kernel (the RG-LRU ring and chunked kernels apart; the run
   fails unless each ran), profiled windows of decode steps and of one
   prefill, and decode logits against teacher-forced ``forward_train``
   logits for a request past the window;
13. grad   — one backward through each of flash attention, the RG-LRU
   scan and the mLSTM cell at each of its main paths' shapes (serving and
   training; the forecaster's inference and training, xLSTM's prefill;
   flash with a soft cap at the live MoE job's shape):
   the wrapper launches its kernel once through its
   ``autograd.Function``, and the gradients for a seeded cotangent match
   autograd through the plain version at the forward's tolerance;
14. train golden — the fixture ``tests/data/torch_train_golden.npz``
   (JAX's 3 AdamW steps of a 3-layer float32 RecurrentGemma twin, accum
   2, chunked cross-entropy): ``make_train_step`` on the card from its
   parameters reproduces each step's loss, grad norm and lr and the
   parameters' update, through both model kernels;
15. forecast train — ``train_forecaster`` at the golden forecaster's
   configuration (1000 steps, batch 64, lr 3e-3) on the golden dataset,
   through the mLSTM row kernel: seconds per step, launches, val
   log-MSE beside JAX's and the EWMA and AR(1) baselines' (it must beat
   both), and a ``save_forecaster`` → ``load_forecaster`` round trip
   that predicts the same;
16. train main — RecurrentGemma-9B at its published widths cut to 3
   layers (one Griffin superblock, 1.64 G parameters, float32
   masters, bfloat16 compute, AdamW state on the card) trained through
   ``Trainer`` for 2 steps of 2 × 2 × 4096 tokens (accum 2, chunked
   cross-entropy, remat per superblock): step ms, tokens/s, model
   FLOP/s, peak device memory, kernel launches per step, the
   plain-version backwards' share (CUDA events); then a trainer
   checkpointing every 2 steps, preempted by ``request_stop`` after
   step 1 (its 19.7 GB checkpoint is the one the phase writes), and one
   resumed from that checkpoint, whose loss must equal (``==``) the
   uninterrupted run's, whose final train state (parameters, AdamW
   moments and step) must equal the uninterrupted trainer's leaf for
   leaf (by per-leaf digests of the bits), and whose step runs under
   ``torch.profiler``, split into the port's kernels, cuBLAS, the
   plain-version backward recomputes and the rest;
17. xlstm golden — the fixture ``tests/data/torch_xlstm_serve_golden``
   (a float32 xLSTM-125M twin at full width cut to 8 layers, its
   parameters redrawn from the fixture's seed and checked by digest;
   JAX's prefill and decode logits and greedy engine tokens): the port
   on the card through the mLSTM block kernel at dk 384 (float32 calls
   never take the parallel kernel) reproduces them
   (``repro_torch.serve.golden.replay``);
18. xlstm serve main — xLSTM-125M at its published widths cut to 4 of its
   12 layers (3 mLSTM + 1 sLSTM, ``SERVE_CUT_LAYERS``; parameters drawn on
   the card in bfloat16 from a seeded CUDA generator) behind
   ``ServeEngine(num_slots=8, cache_len=4096)``, greedy, 16 requests at t
   = 0 with prompts of 64 × [4, 48] tokens and 64 new tokens each, through
   ``run_server``: tokens/s, mean TTFT, prefill ms by prompt length,
   decode step ms, peak device memory, the mLSTM kernels' launches (the
   run fails unless every prefill call took the parallel kernel), profiled
   windows of decode steps and of one prefill, one sLSTM layer's prefill
   walk, and decode logits against teacher-forced ``forward_train`` logits
   for the longest prompt;
19. moe golden — the fixture ``tests/data/torch_moe_serve_golden`` (a
   float32 DeepSeekMoE-16B twin at full width cut to 3 layers, 1 dense +
   2 MoE, parameters redrawn from the fixture's seed and checked by
   digest; JAX's chosen experts, logits of a 1024-token prefill, whose
   two groups drop choices at capacity 60, and of 8 decode steps, and
   its greedy engine tokens): the port on the card reproduces them
   (``repro_torch.serve.golden.replay``), the experts ``==`` (read by
   wrapping ``moe.route``, ``golden.routing_report``);
20. moe serve main — DeepSeekMoE-16B at its published widths cut to 7 of
   its 28 layers (the dense first layer and 6 MoE layers,
   ``SERVE_CUT_LAYERS``; parameters drawn on the card in bfloat16 from a
   seeded CUDA generator) behind ``ServeEngine(num_slots=8,
   cache_len=4096)``, greedy, 16 requests at t = 0 of 64 new tokens with
   prompts drawn from {128, ..., 512, 1024, ..., 3072} (the reference's
   MoE takes at most one group of 512 or whole groups): tokens/s, mean
   TTFT, prefill ms (the run's, and timed at 512, 1024, 2048 and 3072
   tokens), decode step ms, peak device memory with weights and KV cache
   apart, flash launches (one a layer a prefill), profiled windows of
   decode steps and of one prefill, and decode logits against teacher
   forcing on a 3072-token prompt at capacity factor 8 (nothing dropped,
   as the reference's consistency test);
21. granite — full-width Granite-3.0-1B-A400M (GQA 16/8, top-8 of 32,
   tied embeddings): prefill + 8 decode steps against teacher forcing
   at capacity factor 8, and one short ``run_server``;
22. dense golden — the fixture ``tests/data/torch_dense_serve_golden``
   (a float32 Command-R-35B twin at full width cut to 2 layers,
   parameters redrawn from the fixture's seed and checked by digest;
   JAX's logits of a 512-token prefill and 8 decode steps, and its greedy
   engine tokens): the port on the card reproduces them
   (``repro_torch.serve.golden.replay``), flash launched in every
   prefill;
23. command-r serve main — Command-R-35B at its published widths cut to 10
   of its 40 parallel blocks (``SERVE_CUT_LAYERS``; parameters drawn on
   the card in bfloat16 from a seeded CUDA generator, a leaf above 2^30
   values in pieces) behind ``ServeEngine(num_slots=8, cache_len=4096)``,
   greedy, phase 12's burst (16 requests at t = 0, prompts of 256–3072
   tokens, 64 new tokens each): what phase 20 reports (tokens/s, mean
   TTFT, prefill ms in the run and timed at 512–3072 tokens, decode step
   ms, weight and KV-cache bytes, the serving peak and the peak while
   drawing, which must stay below the card's memory, profiled decode and
   prefill windows, one flash launch a layer a prefill) and decode against
   teacher forcing on a 3072-token prompt;
24. qwen check — Qwen1.5-32B at full width (40 heads of 128 padded to
   48 in prefill, QKV bias) cut to 8 of its 64 layers: on float32
   activations over the same weights, decode from an unquantised cache
   and from the int8 cache after one prefill, the int8 decode held to
   the unquantised one within what that cache moved by half an int8
   step on every element does, and two planted faults in the int8 cache
   held to exceed that limit; in bf16, decode from each cache against
   teacher forcing (the int8 one allowed that limit more); the padded
   prefill ``==`` the unpadded one on the real heads, flash timed at 48
   and at 40 heads, and a short ``run_server`` on the int8 cache (flash
   launched once a layer a prefill, counted from 0 just before it) with
   both layouts' KV-cache bytes;
25. whisper golden — the fixture ``tests/data/torch_whisper_serve_golden``
   (a float32 Whisper-medium twin at full width cut to 2 encoder + 2
   decoder layers, the encoder over 1500 frames; parameters and frames
   redrawn from the fixture's seed and checked by digest; JAX's logits of
   a 64-token prefill and 8 decode steps, and its greedy engine tokens):
   the port on the card reproduces them, flash launched 6 times a
   prefill (encoder, decoder and cross attention in each layer);
26. whisper serve main — Whisper-medium at its published widths and full
   depth (24 encoder + 24 decoder layers, bf16 weights drawn on the card
   from a seed) behind ``ServeEngine(num_slots=8, cache_len=448)`` with
   one set of 1500 frames for every request (``extra_inputs``, the serve
   CLI's draw), 16 requests at t = 0 of 4–384 tokens and 64 new tokens
   each: what phase 23 reports, and 72 flash launches a prefill (24
   encoder, 24 decoder, 24 cross), decode against teacher forcing on a
   384-token prompt;
27. vlm golden — the fixture ``tests/data/torch_vlm_serve_golden`` (a
   float32 InternVL2-26B twin at full width cut to 2 layers and 256
   patches): the port on the card reproduces it, flash launched once a
   layer a prefill;
28. internvl serve main — InternVL2-26B at its published widths cut to 12
   of its 48 layers (GQA 48/8, ``SERVE_CUT_LAYERS``; bf16 weights drawn on
   the card) behind ``ServeEngine(num_slots=8, cache_len=4096)`` with one
   set of 1024 patches for every request, 16 requests at t = 0 of 16–2000
   tokens after the patches and 64 new tokens each: what phase 23 reports,
   one flash launch a layer a prefill, and decode against teacher forcing
   over 3072 positions (the patches and 2048 tokens);
29. distributed — ``init_distributed()`` (NCCL, a world of 1, a file
   store), ``local_mesh()`` and a (1, 1) ``("data", "model")`` mesh;
   DeepSeek-7B at its published widths cut to 2 layers (float32 masters
   drawn on the card): two plain train steps and two of the same step on
   the state distributed on the mesh under ``sharding_ctx`` (DTensors,
   flash under ``local_map``), alternating, from the same state on a
   2 x 2048-token batch (the first of each warms up), every updated leaf
   and the losses held equal (the largest difference as a share of each
   leaf's scale, at most 1e-6), flash launched as often in the sharded
   steps as in the plain ones; the compressed DDP
   step on a (1, 1, 1) ``("pod", "data", "model")`` mesh with compression
   on and off (relative gradient error under 0.02, the all-reduces and
   their bytes, the sync's ms); then ``CheckpointManager.save`` of the
   stepped state and ``restore_elastic`` onto the (1, 1) mesh, every
   leaf's ``full_tensor()`` equal to the saved one;
30. dryrun — the production dry run (``repro_torch.launch.dryrun``)
   against the card: phase 29's cell (DeepSeek-7B's widths at 2 layers,
   2 x 2048 tokens, a (1, 1) mesh) runs one warm sharded step, whose
   peak above what was allocated before the state and batch existed and
   whose flash launches are recorded; the same cell's dry run, in a
   process of its own on a fake world of 1, must estimate that peak
   within 10 % and count as many flash calls as were launched (its
   FLOPs over the step's time are printed as model TFLOP/s, with no
   gate); DeepSeek-7B x train_4k and x decode_32k on a fake world of 256
   and x train_4k on one of 512, each in a process of its own (all four
   dry runs started before phase 14), must return ``ok`` with every key,
   each per-card peak printed beside the card's memory;
31. orchestrate — the paper's orchestrator (``repro_torch.core``, the
   serial simulator on the card's host): the two golden event logs
   (``tests/data/golden_trace*.json``) replayed on both engines, ``==``;
   the Fig. 3 combos at seed 0 and the three Fig. 4 baselines ``==`` the
   JAX fixture ``tests/data/torch_orchestrate_golden.json``; then the
   learned cell at full size: ``run_experiment`` of flash-crowd (2000
   jobs, seed 0) under ``PredictiveAutoscaler`` with the forecaster of
   ``tests/data/torch_forecaster_golden`` loaded on the card
   (``device=None``), every ``predict`` call's ``(rate, conf)`` within
   ``FORECAST_TOL`` of the fixture's, the row ``==`` the fixture's, and
   the row kernel launched once a call that reached the model (counted
   from 0 just before the run); the run's wall split into the simulator
   and ``predict``, ``predict``'s median and p99, the row kernel's ms at
   a ``predict``'s shape (B 1, CUDA events behind a device sleep) beside
   its bound and the plain version, and the cost against the non-binding
   row (``==`` the fixture's); last, 8 of phase 5's heavy-tail cells
   through ``run_cells(workers="lanes")`` and ``workers=1``, rows ``==``.
32. chaos_search_obs — F3's mixed batch on the card: 64 of phase 5's
   heavy-tail cells with four cells outside the lane envelope (the
   binding autoscaler, one a chaos spot-spike cell), an infeasible and a
   zero-pod cell, through ``run_cells(workers="lanes")`` (one lane-program
   launch; the rest serially in place) against ``workers=1``, rows ``==``
   in submission order; ``capture_chaos_trace`` of the three chaos
   families on both engines ``==`` ``tests/data/golden_chaos_trace.json``
   and ``run_chaos_cell`` at 400 jobs ``==``
   ``tests/data/torch_chaos_rows.json``; the NSGA-II micro-search on both
   engines ``==`` ``tests/data/golden_search.json``, a pool of 2 (in a
   child process that imports no torch, killed at a deadline) and
   ``workers="lanes"`` ``==`` serial, ``build_report`` against
   ``baseline_rows``; then phase 31's learned cell with the flight
   recorder on (``obs=True``, the forecaster on the card): the row ``==``
   the fixture's, the row kernel launched as often as in phase 31, every
   forecast event the ring retains within ``FORECAST_TOL`` of the
   fixture's last calls, the
   bundle through ``save_bundle`` / ``load_bundle`` in JSON and NPZ,
   ``render_report``; its wall beside phase 31's and its events by kind;
33. live — the paper's orchestrator scheduling real training jobs on the
   card (``repro_torch.cloud.local_provider``): job A, xLSTM-125M at its
   published widths cut to 4 of its 12 layers (3 mLSTM + 1 sLSTM), and job
   B, DeepSeekMoE-16B's widths cut to 2 of 28 layers (a dense layer and
   one MoE layer of 64 routed + 2 shared experts), 4 steps of 4 × 512
   tokens each (phases 6 and 9 hold both kernels against their plain
   versions at these jobs' shapes); first each alone (step ms, tokens/s,
   model FLOP/s by active parameters, peak memory, launches a step: 6 of
   the parallel mLSTM kernel for A, 4 of flash for B; A's last step calls
   the sLSTM walk without its 256-step remat: the peak of a step with and
   without it, and of one walk alone both ways); then both as batch pods
   bound by best fit to one static node of ``LocalCloudProvider`` and
   trained at once in their threads, job A evicted once its trainer has
   finished step 2, checkpointed, rebound and resumed: both pods
   ``SUCCEEDED``, each job's losses ``==`` its solo run's, the node
   billed, the launches as predicted, no exception in a job thread; the
   live wall against the solo walls, A's checkpoint save and restore
   seconds, the cycles; last ``repro_torch.launch.orchestrate --compare
   --workload mixed`` in process, its rows ``==`` phase 31's fixture rows;
34. softcap golden — the fixture ``tests/data/torch_softcap_serve_golden``
   (phase 25's float32 Whisper twin with its attention logits
   soft-capped at ``golden.SOFTCAP_CAP``): the port on the card
   reproduces JAX's logits and greedy engine tokens, flash launched 6
   times a prefill;
35. softcap serve main — Whisper-medium at its published widths and full
   depth with the same cap, bf16 weights from seed 0, behind
   ``ServeEngine(num_slots=8, cache_len=448)``: 4 requests of 4–384
   tokens and 64 new tokens each through ``run_server`` (72 capped flash
   launches a prefill), decode against teacher forcing on a 384-token
   prompt, and one 64-token prefill with and without the cap on the same
   weights, whose logits must differ.  A run check: random weights leave
   attention near uniform, so the cap moves the logits by about one bf16
   step, inside both gates; phase 34 is what holds the cap.

It then prints the kernels line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Without a CUDA card it exits
non-zero before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import atexit
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_LANES = 2048
MAIN_NODES = 64
# Jobs a lane: the heavy-tail trace cut from its 2,000 to keep the
# lockstep runs of phase 4 short (about 8,300 host syncs for 16 lanes at
# 1,000 jobs, 32,400 at 2,000).
MAIN_JOBS = 1000
GOLDEN = ROOT / "tests" / "data" / "torch_lane_golden.npz"
FORECASTER = ROOT / "tests" / "data" / "torch_forecaster_golden"
FORECAST_FAMILIES = ("diurnal", "flash-crowd", "heavy-tail", "mix-ramp",
                     "scale-stress", "multi-tenant")
FORECAST_SEEDS = 48
FLASH_SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP64_OPS_PER_S = 34e12           # H100 SXM FP64 outside the tensor cores
FP32_OPS_PER_S = 67e12           # H100 SXM FP32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
SERVE_GOLDEN = ROOT / "tests" / "data" / "torch_serve_golden" / "expected.npz"
# mlstm kernel vs plain: the JAX kernel test's tolerances.
MLSTM_TOL = {"float32": dict(atol=2e-4, rtol=2e-3),
             "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# Forecaster outputs (float32 log1p rates) vs the JAX fixture.
FORECAST_TOL = dict(atol=2e-5, rtol=2e-5)


_STARTED = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also carries ``t_s``, the
    seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _STARTED}
    print(json.dumps(obj), flush=True)


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def _smi_clocks() -> str:
    """The card's SM clock, power draw, power limit and temperature."""
    return _run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
                 "temperature.gpu", "--format=csv,noheader"])


def phase_device(torch) -> dict:
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    from repro_torch import _build
    nvcc = _run([_build._nvcc(), "--version"]).splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "torch_cuda": torch.version.cuda,
            "nvcc": nvcc, "triton": triton_version,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"seconds": r["seconds"], "cached": r["cached"],
                             "ptxas": [ln for ln in r["log"].splitlines()
                                       if "registers" in ln or "spill" in ln]}
                      for name, r in report.items()}})


def _call_ms(torch, fn, iters: int, warmup: int = 20) -> float:
    """Wall time per call over ``iters`` back-to-back calls (CUDA events):
    the rate at which the host can issue the call, device work included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(prof):
    """(name, start_us, end_us) of every device-side event (kernels,
    copies, fills) that torch.profiler recorded, without user annotations
    and the profiler's own ``ProfilerStep#N`` spans, which it also places
    on the device timeline and which cover whole steps.  Reads kineto's
    raw events: ``prof.events()`` builds the whole event tree, which takes
    minutes for a window of 10^5 kernels (an xLSTM prefill)."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.is_user_annotation():
            continue
        name = ev.name()
        if not name.startswith("ProfilerStep"):
            start = ev.start_ns() * 1e-3
            out.append((name, start, start + ev.duration_ns() * 1e-3))
    return out


def _timed_ms(torch, fn, iters: int, warmup: int) -> dict:
    """The CUDA-event time per call over back-to-back calls (``ms``) and,
    beside it, the device time per call from torch.profiler.  The
    profiler is not trusted for ``ms``: after earlier profiler runs it
    has recorded no device event of a ctypes kernel, or a quarter of
    them (a flash time below its bound on an H100)."""
    device = _device_ms(torch, fn, iters, warmup)
    events = _call_ms(torch, fn, iters, warmup)
    return {"ms": events, "profiler_ms": device, "cuda_event_ms": events}


def _device_ms(torch, fn, iters: int, warmup: int = 20) -> float:
    """Device time per call: the summed durations of the kernels (and
    copies) that ``iters`` calls ran on the card, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(end - start for _, start, end in _device_events(prof))
    return us / iters * 1e-3


_SLEEP_MS_PER_CYCLE = []


def _sleep_ms_per_cycle(torch) -> float:
    """Milliseconds per cycle of ``torch.cuda._sleep``, measured once."""
    if not _SLEEP_MS_PER_CYCLE:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_MS_PER_CYCLE.append(start.elapsed_time(end) / 20_000_000)
    return _SLEEP_MS_PER_CYCLE[0]


def _queued_ms(torch, fn, iters: int, warmup: int = 10) -> dict:
    """Device time per call by CUDA events over ``iters`` calls queued
    behind a device sleep longer than their host issue, so that the
    device never waits on the host (a ctypes wrapper's issue time, tens
    of us, would otherwise set the number of a kernel near 40 us).  The
    sleep doubles until the host finishes issuing inside it, at most
    three times; ``host_bound`` says if it never did."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    issue_ms = (time.perf_counter() - t0) / warmup * 1e3
    torch.cuda.synchronize()
    sleep_ms = 2.0 * issue_ms * iters + 5.0
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms / _sleep_ms_per_cycle(torch)))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < sleep_ms:
            break
        sleep_ms *= 2
    return {"ms": start.elapsed_time(end) / iters, "iters": iters,
            "host_issue_ms": host_ms, "sleep_ms": sleep_ms,
            "host_bound": host_ms >= sleep_ms}


def _select_cases(torch, np, dev):
    """(name, scores, mask) on the card: the main path's shape, then the
    edges the lane engine can hit."""
    rng = np.random.default_rng(0)
    cases = []
    # Main path: L=2048 lanes x N=64 nodes, best-fit-like scores (free
    # memory, many exact ties) with about half the nodes feasible.
    free = rng.integers(0, 8, (MAIN_LANES, MAIN_NODES)) * 512.0
    cases.append(("main_2048x64", free, rng.random(free.shape) < 0.5))
    cases.append(("n1", rng.standard_normal((300, 1)),
                  rng.random((300, 1)) < 0.5))
    cases.append(("n1000", rng.standard_normal((257, 1000)),
                  rng.random((257, 1000)) < 0.3))
    s = rng.standard_normal((64, 64))
    m = rng.random((64, 64)) < 0.5
    m[::3] = False                                   # all-masked rows
    cases.append(("all_masked_rows", s, m))
    ties = rng.integers(0, 2, (128, 96)).astype(np.float64)
    cases.append(("exact_ties", ties, np.ones_like(ties, bool)))
    z = np.where(rng.random((128, 40)) < 0.5, 0.0, -0.0)
    cases.append(("signed_zero_ties", z, rng.random(z.shape) < 0.8))
    inf = np.where(rng.random((128, 50)) < 0.7, np.inf, 1.0)
    inf[:32] = np.inf
    cases.append(("inf_scores", inf, rng.random(inf.shape) < 0.9))
    return [(name, torch.from_numpy(np.ascontiguousarray(s)).to(dev),
             torch.from_numpy(np.ascontiguousarray(m)).to(dev))
            for name, s, m in cases]


def phase_kernel(torch, np, dev) -> dict:
    from repro_torch.manyworld import select
    results = {}
    cases = _select_cases(torch, np, dev)
    for name, s, m in cases:
        got = select.masked_argmin(s, m)
        torch.cuda.synchronize()
        want = select.masked_argmin_plain(s, m)
        ok = torch.equal(got, want)
        err = int((got.long() - want.long()).abs().max())
        results[name] = {"shape": list(s.shape), "match": ok,
                         "max_abs_err": err}
        if not ok:
            emit({"phase": "kernel", "cases": results})
            raise SystemExit(f"masked_argmin disagrees with its plain "
                             f"version on {name}")
    _, s, m = cases[0]
    L, N = s.shape
    iters = 1000
    calls = {
        "kernel": lambda: select.masked_argmin(s, m),
        "plain": lambda: select.masked_argmin_plain(s, m),
        "library": lambda: torch.argmin(torch.where(m, s, torch.inf), dim=1),
    }
    device_ms = {k: _device_ms(torch, fn, iters) for k, fn in calls.items()}
    call_ms = {k: _call_ms(torch, fn, iters) for k, fn in calls.items()}
    bytes_moved = 9 * L * N + 4 * L
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = L * N / FP64_OPS_PER_S * 1e3
    line = {"phase": "kernel", "cases": results, "shape": [L, N],
            "iters": iters, "kernel_ms": device_ms["kernel"],
            "plain_ms": device_ms["plain"],
            "library_ms": device_ms["library"],
            "call_ms": call_ms,
            "library_call": "torch.argmin(torch.where(mask, scores, inf)) "
                            "(two calls)",
            "bytes": bytes_moved, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": max(r["max_abs_err"] for r in results.values())}
    emit(line)
    return line


# The fixture's lanes whose lockstep run stays short on the card (about
# 3,400 host syncs a scheduler for the eight, against 11,300-12,800 for
# all sixteen, at about 1.2 ms a sync); the lane-program kernel runs all.
GOLDEN_LOCKSTEP_LANES = (0, 4, 5, 10, 12, 13, 14, 15)


def phase_golden(torch, np, dev) -> None:
    from repro_torch.manyworld import lane_kernel, lanes
    from repro_torch.scenarios import build_scenario
    with np.load(GOLDEN, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    recipes = list(zip(fx["lane_scenario"].tolist(), fx["lane_seed"].tolist(),
                       fx["lane_n_jobs"].tolist()))
    report = {}
    for sched in lanes.SCHEDULERS:
        inputs = {name: fx[f"{sched}/in/{name}"]
                  for name in lanes.BATCH_FIELDS}
        # The port's generators and stacker rebuild the fixture's inputs.
        lane_dicts = []
        for i, (scen, seed, n_jobs) in enumerate(recipes):
            d = build_scenario(scen, seed=seed, n_jobs=n_jobs).to_lane_arrays()
            d.update(n_nodes=int(inputs["n_nodes"][i]),
                     alloc_cpu=float(inputs["alloc_cpu"][i]),
                     alloc_mem=float(inputs["alloc_mem"][i]),
                     weights=tuple(inputs["weights"][i]))
            lane_dicts.append(d)
        rebuilt = lanes.stack_lanes(lane_dicts, sched,
                                    p_pad=inputs["arrival_t"].shape[1],
                                    device=dev)
        for name, want in inputs.items():
            got = getattr(rebuilt, name).cpu().numpy()
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise SystemExit(f"golden {sched}: rebuilt input {name} "
                                 "differs from the fixture")
        want_keys = {k.split("/", 2)[2] for k in fx
                     if k.startswith(f"{sched}/out/")}
        entry = report[sched] = {"lanes": int(inputs["valid"].shape[0]),
                                 "lockstep_lanes": list(GOLDEN_LOCKSTEP_LANES)}
        sub = list(GOLDEN_LOCKSTEP_LANES)

        class Rows:
            scheduler = sched
        for name in lanes.BATCH_FIELDS:
            setattr(Rows, name, inputs[name][sub])
        # The lane-program kernel (run_lane_batch on the card) on every
        # lane, then the lockstep program with the select kernel on the
        # sub-batch (lanes are independent: each keeps its outputs).
        for name, run, batch, rows in (
                ("kernel", lanes.run_lane_batch, rebuilt, None),
                ("lockstep", lanes.run_lane_batch_lockstep,
                 lanes.lane_batch_from_numpy(Rows, device=dev), sub)):
            lane_kernel.launches = 0
            lanes.host_syncs = 0
            t0 = time.perf_counter()
            out = run(batch, device=dev)
            wall = time.perf_counter() - t0
            bad = []
            for key, val in out.items():
                want = fx[f"{sched}/out/{key}"]
                if rows is not None and key == "n_cycles":
                    continue                 # the sub-batch's own count
                if rows is not None:
                    want = want[rows]
                if key in ("used_cpu", "used_mem", "pcount"):
                    # a sub-batch pads fewer nodes: the rest must be 0
                    if want[:, val.shape[1]:].any():
                        bad.append(key)
                    want = want[:, :val.shape[1]]
                if val.dtype != want.dtype or not np.array_equal(val, want):
                    bad.append(key)
            if set(out) != want_keys:
                bad.append("keys")
            entry[name] = {"n_cycles": int(out["n_cycles"]),
                           "lane_program_launches": lane_kernel.launches,
                           "host_syncs": lanes.host_syncs, "wall_s": wall,
                           "equal": not bad}
            if bad or (name == "kernel" and lane_kernel.launches != 1):
                emit({"phase": "golden", "batches": report})
                raise SystemExit(f"golden {sched} ({name}): outputs differ "
                                 f"or wrong launches: {bad}")
    emit({"phase": "golden", "batches": report})


def _profile_window(torch, lanes, batch, dev, start: int, steps: int):
    """Run ``batch`` through the lockstep program with the select kernel
    while torch.profiler records
    ``steps`` inner loop steps after the first ``start`` (one step per
    host sync).  Returns the outputs and the window's numbers, or
    ``None`` for them when the run had fewer steps."""
    from torch.profiler import ProfilerActivity, profile, schedule
    warmup = 5
    marks = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=start, warmup=warmup, active=steps,
                                     repeat=1))
    counted_any = lanes._any
    seen = [0]

    def stepping_any(t):
        res = counted_any(t)
        seen[0] += 1
        if seen[0] == start:
            marks["smi"] = _run(["nvidia-smi", "--query-gpu=clocks.sm,"
                                 "power.draw,power.limit,temperature.gpu",
                                 "--format=csv,noheader"])
        elif seen[0] == start + warmup:
            marks["t0"] = time.perf_counter()
        elif seen[0] == start + warmup + steps:
            marks["t1"] = time.perf_counter()
        prof.step()
        return res

    lanes._any = stepping_any
    try:
        with prof:
            out = lanes.run_lane_batch_lockstep(batch, device=dev)
    finally:
        lanes._any = counted_any
    if "t1" not in marks:
        return out, None
    events = sorted(_device_events(prof), key=lambda e: e[1])
    device_us = sum(end - start for _, start, end in events)
    busy_us, reach = 0.0, float("-inf")      # union of the intervals
    by_name = {}
    for name, start_us, end_us in events:
        busy_us += max(0.0, end_us - max(start_us, reach))
        reach = max(reach, end_us)
        tot = by_name.setdefault(name, [0, 0.0])
        tot[0] += 1
        tot[1] += end_us - start_us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    select_us = sum(v[1] for k, v in by_name.items() if "masked_argmin" in k)
    window_s = marks["t1"] - marks["t0"]
    return out, {"steps": steps, "after_steps": start,
                 "nvidia_smi_clocks_power": marks.get("smi"),
                 "window_s": window_s, "ms_per_step": window_s / steps * 1e3,
                 "device_busy_share": busy_us * 1e-6 / window_s,
                 "device_ms_per_step": device_us * 1e-3 / steps,
                 "device_busy_ms_per_step": busy_us * 1e-3 / steps,
                 "select_kernel_ms_per_step": select_us * 1e-3 / steps,
                 "top_device_events": [
                     {"name": k[:90], "count": v[0],
                      "ms_per_step": v[1] * 1e-3 / steps} for k, v in top],
                 "device_events_per_step": len(events) / steps}


# FP64 operations of a best-fit wave attempt per node: the two frees and
# the slack add of the mask (the score is the free memory itself).
BEST_FIT_OPS_PER_NODE = 3
LANE_KERNEL_REPS = 5


def _max_abs_err(np, a: dict, b: dict) -> float:
    """Largest |a - b| over every lane output (0 where equal, inf too)."""
    worst = 0.0
    for key in a:
        x, y = np.asarray(a[key], np.float64), np.asarray(b[key], np.float64)
        with np.errstate(invalid="ignore"):          # inf - inf
            d = np.where(x == y, 0.0, np.abs(x - y))
        worst = max(worst, float(d.max()) if d.size else 0.0)
    return worst


def phase_main(torch, np, dev) -> dict:
    from repro_torch.manyworld import evaluator, lane_kernel, lanes, select
    from repro_torch.search.runner import CellSpec, _get_trace, run_cells
    cells = [CellSpec(scenario="heavy-tail", scheduler="best-fit",
                      autoscaler="void", rescheduler="void", seed=seed,
                      n_jobs=MAIN_JOBS, engine="array",
                      initial_workers=MAIN_NODES)
             for seed in range(MAIN_LANES)]
    t0 = time.perf_counter()
    traces = [_get_trace(c.scenario, c.seed, c.n_jobs) for c in cells]
    setup_s = time.perf_counter() - t0

    # The main path: run_cells through the lane-program kernel.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lane_kernel.launches = 0
    select.launches = 0
    lanes.host_syncs = 0
    t0 = time.perf_counter()
    rows = run_cells(cells, workers="lanes", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel_launches = lane_kernel.launches
    main_select_launches, syncs = select.launches, lanes.host_syncs
    stages = dict(evaluator.stage_s)
    peak = torch.cuda.max_memory_allocated()
    if kernel_launches == 0:
        raise SystemExit("main path ran without launching lane_program")
    bad = [r["label"] for r in rows
           if not (isinstance(r["cost"], float) and np.isfinite(r["cost"])
                   and r["n_jobs"] == MAIN_JOBS
                   and r["max_nodes"] == MAIN_NODES
                   and 0.0 <= r["avg_ram_ratio"] <= 1.0)]
    if len(rows) != MAIN_LANES or bad:
        raise SystemExit(f"main path rows malformed: {bad[:5]}")

    # The kernel alone on the same batch (CUDA events), then the lockstep
    # program with the select kernel (profiled window) and with the plain
    # select; all three lane outputs must agree.
    lane_dicts = []
    for tr in traces:
        d = tr.to_lane_arrays()
        d.update(n_nodes=MAIN_NODES, alloc_cpu=940.0, alloc_mem=3584.0)
        lane_dicts.append(d)
    batch = lanes.stack_lanes(lane_dicts, "best-fit", device=dev)
    kernel_ms = []
    for _ in range(LANE_KERNEL_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        res = lane_kernel.lane_program(batch)
        end.record()
        torch.cuda.synchronize()
        kernel_ms.append(start.elapsed_time(end))
    out_kernel = lane_kernel.lane_outputs(res)
    stats = res["lane_stats"].cpu().numpy()
    steps = stats.sum(axis=1)
    longest = int(np.argmax(steps))
    in_bytes = sum(getattr(batch, name).nbytes for name in lanes.BATCH_FIELDS)
    out_bytes = sum(res[key].nbytes for key, _, _ in lane_kernel.OUTPUTS)
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops = int(stats[:, 2].sum()) * MAIN_NODES * BEST_FIT_OPS_PER_NODE
    ops_ms = ops / FP64_OPS_PER_S * 1e3

    select.launches = 0
    lanes.host_syncs = 0
    t0 = time.perf_counter()
    out_k, window = _profile_window(torch, lanes, batch, dev,
                                    start=3000, steps=300)
    lockstep_wall = time.perf_counter() - t0
    lockstep_select_launches = select.launches
    lockstep_syncs = lanes.host_syncs
    if lockstep_select_launches == 0:
        raise SystemExit("the lockstep run never launched masked_argmin")
    t0 = time.perf_counter()
    out_p = lanes.run_lane_batch_lockstep(batch, device=dev,
                                          select=select.masked_argmin_plain)
    plain_wall = time.perf_counter() - t0
    for name, other in (("lockstep with the select kernel", out_k),
                        ("lockstep with the plain select", out_p)):
        differ = [key for key in out_kernel
                  if not (out_kernel[key].dtype == other[key].dtype
                          and np.array_equal(out_kernel[key], other[key]))]
        if differ:
            raise SystemExit(f"lane_program and the {name} differ: {differ}")
    if [r["completed"] for r in rows] != out_kernel["completed"].tolist():
        raise SystemExit("rows disagree with the lane outputs")
    line = {"phase": "main", "lanes": MAIN_LANES, "p_pad": batch.p_pad,
            "n_pad": batch.n_pad, "trace_setup_s": setup_s,
            "wall_s": wall, "lanes_per_s": MAIN_LANES / wall,
            "stage_s": stages,
            "lane_program_launches": kernel_launches,
            "host_syncs": syncs, "select_launches": main_select_launches,
            "peak_device_bytes": peak,
            "n_cycles": int(out_kernel["n_cycles"]),
            "completed_lanes": int(out_kernel["completed"].sum()),
            "lane_program_ms": kernel_ms,
            "lane_program_ms_median": float(np.median(kernel_ms)),
            "longest_lane": {"lane": longest,
                             "dependent_steps": int(steps[longest]),
                             **{k: int(v) for k, v in
                                zip(lane_kernel.STATS, stats[longest])}},
            "steps_all_lanes": {k: int(v) for k, v in
                                zip(lane_kernel.STATS, stats.sum(axis=0))},
            "bytes_in_out": in_bytes + out_bytes, "fp64_ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "lockstep_select_kernel_run_wall_s": lockstep_wall,
            "lockstep_select_launches": lockstep_select_launches,
            "lockstep_host_syncs": lockstep_syncs,
            "lockstep_plain_select_run_wall_s": plain_wall,
            "kernel_vs_lockstep_outputs_equal": True,
            "max_abs_err": _max_abs_err(np, out_kernel, out_p),
            "profile_window": window}
    emit(line)
    return line


# The forecaster's training shape: a batch of 64 windows
# (train_forecaster's default), the last case of MLSTM_CASES and the
# training shape of phase 13's gradient check.
MLSTM_TRAIN_CASE = (64, 2, 16, 32, 32, 64, "float32", False)
# xLSTM-125M's prefill of the serve cell's longest prompt (phase 18): q,
# k, v (1, 4, 3072, 384) bfloat16, chunk 64, the final state out; timed
# in phase 6 and the serving shape of phase 13's gradient check.
MLSTM_XLSTM_CASE = (1, 4, 3072, 384, 384, 64, "bfloat16", False)
# xLSTM-125M's training call in phase 33 (job A: 4 sequences of 512
# tokens, no state in or out); checked in phase 6 both with the state
# out and as the training path calls it, without.
MLSTM_LIVE_CASE = (4, 4, 512, 384, 384, 64, "bfloat16", False)
# Prefill lengths at which phase 6 times the parallel kernel beside the
# block kernel (the serve cell's prompts run 256-3008 tokens).
MLSTM_XLSTM_TIMED_T = (256, 1024, 2048, 3072)

# (B, H, T, dk, dv, chunk, dtype, initial state): the forecaster's cell at
# the golden dataset's batch (the main path's call; first), the JAX kernel
# test's shapes in both dtypes, T = L, dv not a multiple of the block
# kernel's 32-column slice, a given initial state, and the block kernel's
# limits; then the row kernel's envelope (L = 32 with dk = dv = 64,
# several chunks with a state in and out, an odd count of (b, h) two to a
# warp, bfloat16 with a state) and a dk just outside it; xLSTM-125M's
# 384-wide heads (the serving prefill's shape, MLSTM_XLSTM_CASE, with the
# state out; float32 with a state in and out; T = L = 64 in both
# dtypes); the parallel kernel's envelope (a state in and out at dk 384,
# B*H > 4 with dv != dk, T 3008 with dv > dk); xLSTM-125M's training
# shape in the live phase (MLSTM_LIVE_CASE); last, the forecaster's
# training shape.
MLSTM_CASES = (
    (8668, 2, 16, 32, 32, 64, "float32", False),
    (1, 1, 128, 64, 64, 64, "float32", False),
    (1, 1, 128, 64, 64, 64, "bfloat16", False),
    (2, 2, 128, 32, 32, 32, "float32", False),
    (2, 2, 128, 32, 32, 32, "bfloat16", False),
    (4, 2, 64, 32, 32, 64, "float32", False),
    (2, 2, 64, 32, 48, 16, "float32", False),
    (3, 1, 32, 24, 20, 16, "float32", True),
    (1, 2, 128, 128, 64, 64, "float32", True),
    (5, 3, 96, 64, 64, 32, "float32", True),
    (64, 2, 64, 32, 32, 16, "float32", True),
    (7, 1, 16, 32, 32, 64, "bfloat16", False),
    (3, 3, 48, 16, 24, 16, "bfloat16", True),
    (1, 2, 32, 18, 36, 16, "float32", True),
    MLSTM_XLSTM_CASE,
    (2, 4, 256, 384, 384, 64, "float32", True),
    (1, 4, 64, 384, 384, 64, "float32", False),
    (1, 4, 64, 384, 384, 64, "bfloat16", False),
    (2, 4, 256, 384, 384, 64, "bfloat16", True),
    (5, 2, 192, 64, 128, 64, "bfloat16", True),
    (3, 2, 3008, 128, 320, 64, "bfloat16", True),
    MLSTM_LIVE_CASE,
    MLSTM_TRAIN_CASE,
)


def _mlstm_inputs(torch, np, case, dev):
    B, H, T, dk, dv, _, dtype, with_state = case
    rng = np.random.default_rng(B * 1000 + T + dk + dv)
    arrays = [rng.standard_normal((B, H, T, dk)),
              rng.standard_normal((B, H, T, dk)) / np.sqrt(dk),
              rng.standard_normal((B, H, T, dv)),
              rng.standard_normal((B, H, T)),
              rng.standard_normal((B, H, T)) + 2.0]
    inputs = [torch.tensor(a, dtype=getattr(torch, dtype), device=dev)
              for a in arrays]
    state = None
    if with_state:
        state = tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                      for a in (rng.standard_normal((B, H, dk, dv)),
                                np.abs(rng.standard_normal((B, H, dk))),
                                rng.standard_normal((B, H))))
    return inputs, state


def _mlstm_work(B, H, T, dk, dv, L, elem_bytes):
    """(bytes, float operations) of a cell call with no state in or out,
    as the model path calls it: q, k, v and the gates read once and h
    written once; the products q.k and (S o qk).v over the pairs j <= i
    of each chunk, and q.C and the C update only between chunks (C is
    zero before the first)."""
    nbytes = B * H * T * (2 * dk + 2 * dv + 2) * elem_bytes
    n_chunks = T // L
    pairs = L * (L + 1) // 2
    ops = B * H * n_chunks * 2 * pairs * (dk + dv)
    ops += B * H * 2 * L * dk * dv * 2 * (n_chunks - 1)
    return nbytes, ops


def _mlstm_state_work(B, H, dk, dv, L):
    """(bytes, float operations) that asking for the final state adds:
    C, n and m written once in float32, and the last chunk's C update."""
    return B * H * (dk * dv + dk + 1) * 4, B * H * 2 * L * dk * dv


def _share_of_tol(a, b, tol) -> float:
    """The largest |a - b| over what allclose allows at that element: the
    margin left under the tolerance (1 = none)."""
    return float(((a.float() - b.float()).abs()
                  / (tol["atol"] + tol["rtol"] * b.float().abs())).max())


def _mlstm_name(case) -> str:
    B, H, T, dk, dv, chunk, dtype, with_state = case
    return f"{B}x{H}x{T}x{dk}x{dv}/L{min(chunk, T)}/{dtype}" + (
        "/state" if with_state else "")


def phase_mlstm(torch, np, dev) -> dict:
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    results = {}
    before = (mlstm.launches, mlstm.row_launches, mlstm.parallel_launches)
    for case in MLSTM_CASES:
        B, H, T, dk, dv, chunk, dtype, with_state = case
        name = _mlstm_name(case)
        inputs, state = _mlstm_inputs(torch, np, case, dev)
        h, s = mlstm.mlstm_chunkwise(*inputs, state=state, chunk=chunk)
        torch.cuda.synchronize()
        want_h, want_s = mlstm.mlstm_chunkwise_plain(*inputs, state=state,
                                                     chunk=chunk)
        tol = MLSTM_TOL[dtype]
        pairs = [(h.float(), want_h.float())] + list(zip(s, want_s))
        ok = h.dtype == want_h.dtype and all(
            torch.allclose(a, b, **tol) for a, b in pairs)
        kernel = mlstm.pick_kernel(min(chunk, T), dk, dv,
                                   getattr(torch, dtype), inputs,
                                   state or ())
        results[name] = {
            "dtype": dtype, "state_in": with_state, "match": ok,
            "dk": dk,
            "kernel": {"rows": "mlstm_rows", "block": "mlstm_chunkwise",
                       "parallel": "mlstm_parallel"}[kernel],
            "max_abs_err_h": float((pairs[0][0] - pairs[0][1]).abs().max()),
            "max_abs_err_state": max(float((a - b).abs().max())
                                     for a, b in pairs[1:]),
            "worst_share_of_tol": max(_share_of_tol(a, b, tol)
                                      for a, b in pairs)}
        if kernel == "parallel":
            # Against the kernel's own algorithm with its bfloat16 hi/lo
            # operands: what remains is summation order.
            ph, ps = mlstm.mlstm_chunkwise_parallel_plain(
                *inputs, state=state, chunk=chunk, rounding="bf16x2")
            results[name]["worst_share_of_tol_vs_parallel_plain"] = max(
                _share_of_tol(a, b, tol)
                for a, b in [(h, ph)] + list(zip(s, ps)))
        if case == MLSTM_LIVE_CASE:
            # The training path's call: the parallel kernel, no state out.
            h_train, s_train = mlstm.mlstm_chunkwise(
                *inputs, chunk=chunk, return_state=False)
            torch.cuda.synchronize()
            ok = (ok and kernel == "parallel" and s_train is None
                  and torch.allclose(h_train.float(), want_h.float(), **tol))
            results[name]["train_call_max_abs_err"] = float(
                (h_train.float() - want_h.float()).abs().max())
        if not ok:
            emit({"phase": "mlstm", "cases": results})
            raise SystemExit(f"mlstm_chunkwise disagrees with its plain "
                             f"version on {name}")
    row_launches = mlstm.row_launches - before[1]
    parallel_launches = mlstm.parallel_launches - before[2]
    block_launches = (mlstm.launches - before[0] - row_launches
                      - parallel_launches)
    if not (row_launches and block_launches and parallel_launches):
        raise SystemExit("mlstm cases did not reach all three kernels")
    # The forecaster's shape: the row kernel (the wrapper's pick), the
    # block kernel (the kernel outside the other two envelopes) on the
    # same inputs, and the plain version, each timed by CUDA events behind
    # a device sleep.
    case = MLSTM_CASES[0]
    B, H, T, dk, dv, chunk = case[:6]
    L = min(chunk, T)
    inputs, _ = _mlstm_inputs(torch, np, case, dev)
    if not mlstm.takes_row_kernel(L, dk, dv, torch.float32, inputs):
        raise SystemExit("mlstm: the forecaster's call falls outside the "
                         "row kernel's envelope")
    want_h, _ = mlstm.mlstm_chunkwise_plain(*inputs, chunk=chunk,
                                            return_state=False)
    block_h, _ = mlstm._mlstm_chunkwise_cuda(*inputs, None, chunk, False,
                                             kernel="block")
    torch.cuda.synchronize()
    if not torch.allclose(block_h, want_h, **MLSTM_TOL["float32"]):
        raise SystemExit("mlstm block kernel disagrees with its plain "
                         "version at the forecaster's shape")
    calls = {
        "kernel": lambda: mlstm.mlstm_chunkwise(*inputs, chunk=chunk,
                                                return_state=False),
        "block_kernel": lambda: mlstm._mlstm_chunkwise_cuda(
            *inputs, None, chunk, False, kernel="block"),
        "plain": lambda: mlstm.mlstm_chunkwise_plain(*inputs, chunk=chunk,
                                                     return_state=False),
    }
    timed = {"kernel": _queued_ms(torch, calls["kernel"], 200),
             "block_kernel": _queued_ms(torch, calls["block_kernel"], 200),
             "plain": _queued_ms(torch, calls["plain"], 5, warmup=2)}
    ms = {k: v["ms"] for k, v in timed.items()}
    nbytes, ops = _mlstm_work(B, H, T, dk, dv, L, 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    del inputs, want_h, block_h
    # xLSTM-125M's prefill shape at several lengths, with the state out as
    # the serving path asks for it: the parallel kernel (the wrapper's
    # pick, bf16 tensor cores: bound by bytes) and the block kernel
    # (float32 on the CUDA cores: bound by its float32 operations)
    # on the same inputs, each against the plain version.
    x_by_t = {}
    xlstm_tol = MLSTM_TOL[MLSTM_XLSTM_CASE[6]]
    for T in MLSTM_XLSTM_TIMED_T:
        B, H, _, dk, dv, chunk = MLSTM_XLSTM_CASE[:6]
        x_case = (B, H, T) + MLSTM_XLSTM_CASE[3:]
        x_inputs, _ = _mlstm_inputs(torch, np, x_case, dev)
        want_h, want_s = mlstm.mlstm_chunkwise_plain(*x_inputs, chunk=chunk)
        if mlstm.pick_kernel(chunk, dk, dv, x_inputs[0].dtype,
                             x_inputs) != "parallel":
            raise SystemExit("mlstm: xLSTM's prefill falls outside the "
                             "parallel kernel's envelope")
        runs = {"parallel": lambda: mlstm.mlstm_chunkwise(
                    *x_inputs, chunk=chunk),
                "block": lambda: mlstm._mlstm_chunkwise_cuda(
                    *x_inputs, None, chunk, True, kernel="block")}
        nbytes_x, ops_x = (a + b for a, b in zip(
            _mlstm_work(B, H, T, dk, dv, chunk, 2),
            _mlstm_state_work(B, H, dk, dv, chunk)))
        bytes_x = nbytes_x / HBM_BYTES_PER_S * 1e3
        row = {"bytes": nbytes_x, "flops": ops_x}
        for kname, run in runs.items():
            h, st = run()
            torch.cuda.synchronize()
            ops_rate = BF16_OPS_PER_S if kname == "parallel" \
                else FP32_OPS_PER_S
            ops_x_ms = ops_x / ops_rate * 1e3
            t = _queued_ms(torch, run, 50 if kname == "parallel" else 10,
                           warmup=3)
            bound = max(bytes_x, ops_x_ms)
            row[kname] = {
                "ms": t["ms"], "timed": t, "bound_ms": bound,
                "bound_by": "bytes" if bytes_x >= ops_x_ms
                            else "operations",
                "ops_rate": ops_rate, "share_of_bound": bound / t["ms"],
                "max_abs_err": max(float((a.float() - b.float()).abs()
                                         .max()) for a, b in
                                   [(h, want_h)] + list(zip(st, want_s))),
                "worst_share_of_tol": max(
                    _share_of_tol(a, b, xlstm_tol)
                    for a, b in [(h, want_h)] + list(zip(st, want_s)))}
            del h, st
        if T == MLSTM_XLSTM_CASE[2]:
            row["plain_ms"] = _queued_ms(
                torch, lambda: mlstm.mlstm_chunkwise_plain(
                    *x_inputs, chunk=chunk), 5, warmup=2)["ms"]
            row["parallel_plain_ms"] = _queued_ms(
                torch, lambda: mlstm.mlstm_chunkwise_parallel_plain(
                    *x_inputs, chunk=chunk, rounding="bf16x2"),
                5, warmup=2)["ms"]
        row["speedup"] = row["block"]["ms"] / row["parallel"]["ms"]
        x_by_t[T] = row
        del x_inputs, want_h, want_s
        torch.cuda.empty_cache()
    x = x_by_t[MLSTM_XLSTM_CASE[2]]
    B, H, T, dk, dv, chunk = MLSTM_XLSTM_CASE[:6]
    xlstm = {"shape": [B, H, T, dk, dv], "chunk": chunk,
             "dtype": MLSTM_XLSTM_CASE[6], "state_out": True,
             "kernel": "mlstm_parallel",
             "kernel_ms": x["parallel"]["ms"],
             "block_kernel_ms": x["block"]["ms"],
             "plain_ms": x["plain_ms"],
             "parallel_plain_ms": x["parallel_plain_ms"], "library_ms": None,
             "bytes": x["bytes"], "flops": x["flops"],
             "bound_ms": x["parallel"]["bound_ms"],
             "bound_by": x["parallel"]["bound_by"],
             "share_of_bound": x["parallel"]["share_of_bound"],
             "block_bound_ms": x["block"]["bound_ms"],
             "block_bound_by": x["block"]["bound_by"],
             "block_share_of_bound": x["block"]["share_of_bound"],
             "by_T": x_by_t,
             "max_abs_err": max(
                 max(r["max_abs_err_h"], r["max_abs_err_state"])
                 for r in results.values()
                 if r["kernel"] == "mlstm_parallel"),
             "worst_share_of_tol": max(
                 r["worst_share_of_tol"] for r in results.values()
                 if r["kernel"] == "mlstm_parallel")}
    f32 = [r for r in results.values() if r["dtype"] == "float32"]
    line = {"phase": "mlstm", "cases": results, "tolerance": MLSTM_TOL,
            "shape": list(case[:5]), "chunk": L,
            "timing": "CUDA events, launches queued behind a device sleep",
            "kernel": "mlstm_rows", "kernel_ms": ms["kernel"],
            "block_kernel_ms": ms["block_kernel"],
            "plain_ms": ms["plain"], "library_ms": None,
            "library_call": "no single PyTorch call computes this function",
            "timed": timed, "bytes": nbytes, "flops": ops,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": {k: bound_ms / v for k, v in ms.items()},
            "launches": {"rows": row_launches, "block": block_launches,
                         "parallel": parallel_launches},
            "max_abs_err": max(max(r["max_abs_err_h"], r["max_abs_err_state"])
                               for r in f32),
            # float32 cases for the row and block kernels, as before the
            # parallel kernel (which takes only bfloat16) came.
            "max_abs_err_by_kernel": {
                kernel: max(max(r["max_abs_err_h"], r["max_abs_err_state"])
                            for r in (results.values()
                                      if kernel == "mlstm_parallel" else f32)
                            if r["kernel"] == kernel)
                for kernel in ("mlstm_rows", "mlstm_chunkwise",
                               "mlstm_parallel")},
            "max_abs_err_bf16": max(r["max_abs_err_h"] for r in
                                    results.values()
                                    if r["dtype"] == "bfloat16"),
            "xlstm": xlstm}
    emit(line)
    return line


def _dataset_digest(np, data) -> str:
    """sha256 over the dataset's four arrays, as the fixture records it."""
    h = hashlib.sha256()
    for key in ("X_train", "y_train", "X_val", "y_val"):
        h.update(np.ascontiguousarray(data[key], np.float64).tobytes())
    return h.hexdigest()


def _windows(np, data):
    X = np.concatenate([data["X_train"], data["X_val"]])
    return np.log1p(X.astype(np.float32))


def _val_log_mse(np, outputs, data) -> float:
    n_train = data["X_train"].shape[0]
    y = np.log1p(data["y_val"].astype(np.float32))
    return float(np.mean((outputs[n_train:] - y) ** 2))


def _flash_rates(window):
    from repro_torch.forecast import features
    from repro_torch.scenarios import build_scenario
    trace = build_scenario("flash-crowd", seed=FLASH_SEED)
    return features.bin_rates(trace.arrival_time, window.bin_s)


def phase_forecast_golden(torch, np, dev):
    from repro_torch.forecast import features, model
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    with np.load(FORECASTER / "expected.npz", allow_pickle=False) as z:
        want = {key: z[key] for key in z.files}
    t0 = time.perf_counter()
    data = features.make_dataset(FORECAST_FAMILIES, range(FORECAST_SEEDS),
                                 features.WindowConfig())
    dataset_s = time.perf_counter() - t0
    if _dataset_digest(np, data) != str(want["digest"]):
        raise SystemExit("forecast golden: the port's dataset differs from "
                         "the fixture's (digest)")
    fc = model.load_forecaster(str(FORECASTER / "checkpoint"))
    if fc.device.type != dev.type:
        raise SystemExit(f"load_forecaster put the model on {fc.device}")
    before = mlstm.launches
    with torch.inference_mode():
        out = model.apply_forecast(
            fc.params, torch.from_numpy(_windows(np, data)).to(dev),
            fc.arch).cpu().numpy()
    launched = mlstm.launches - before
    mse = _val_log_mse(np, out, data)
    rates = _flash_rates(fc.window)
    seq = []
    for r in rates:
        fc.observe_bin(r)
        seq.append(fc.predict())
    seq = np.asarray(seq, np.float64)
    checks = {
        "windows": int(out.shape[0]),
        "outputs_within_tol": bool(np.allclose(out, want["outputs"],
                                               **FORECAST_TOL)),
        "outputs_max_abs_err": float(np.abs(out - want["outputs"]).max()),
        "val_log_mse": mse, "val_log_mse_jax": float(want["val_log_mse"]),
        "val_log_mse_within_1e-4": abs(mse - float(want["val_log_mse"]))
        < 1e-4,
        "flash_bins": int(rates.size),
        "flash_rates_equal": bool(np.array_equal(rates,
                                                 want["flash_rates"])),
        "per_bin_within_tol": bool(
            seq.shape == want["per_bin"].shape
            and np.allclose(seq, want["per_bin"], rtol=1e-4, atol=1e-6)),
        "per_bin_max_abs_err": float(np.abs(seq - want["per_bin"]).max()),
        "mlstm_launches": launched}
    emit({"phase": "forecast_golden", "dataset_s": dataset_s,
          "digest_equal": True, **checks})
    bad = [key for key in ("outputs_within_tol", "val_log_mse_within_1e-4",
                           "flash_rates_equal", "per_bin_within_tol")
           if not checks[key]]
    if launched != 1:
        bad.append("mlstm_launches")
    if bad:
        raise SystemExit(f"forecast golden: checks failed: {bad}")
    return data


def _ewma_log_mse(np, X, y) -> float:
    """The online EWMA scored as ``scripts/forecast.py`` scores it: each
    example's history through a fresh forecaster, one prediction."""
    from repro_torch.forecast import EwmaForecaster
    errs = []
    for hist, target in zip(X, y):
        f = EwmaForecaster()
        for r in hist:
            f.observe_bin(float(r))
        pred, _ = f.predict()
        errs.append((np.log1p(pred) - np.log1p(float(target))) ** 2)
    return float(np.mean(errs))


def phase_forecast_main(torch, np, dev, data) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.forecast import Ar1Baseline, model
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    fc = model.load_forecaster(str(FORECASTER / "checkpoint"))
    X = torch.from_numpy(_windows(np, data))
    n = X.shape[0]

    def forecast():
        with torch.inference_mode():
            y = model.apply_forecast(fc.params, X.to(dev), fc.arch)
        torch.cuda.synchronize()
        return y

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mlstm.launches = mlstm.row_launches = 0
    t0 = time.perf_counter()
    out = forecast()
    cold_s = time.perf_counter() - t0
    warm = []
    for _ in range(20):
        t0 = time.perf_counter()
        forecast()
        warm.append(time.perf_counter() - t0)
    batched_launches = mlstm.launches
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forecast()
    events = _device_events(prof)
    by_name = {}
    for name, start_us, end_us in events:
        by_name[name] = by_name.get(name, 0.0) + (end_us - start_us) * 1e-3
    device_ms = sum(by_name.values())
    mlstm_ms = sum(v for k, v in by_name.items() if "mlstm" in k)

    online = model.LearnedForecaster(fc.params, fc.arch, fc.window)
    latency = []
    for r in _flash_rates(fc.window):
        online.observe_bin(r)
        t0 = time.perf_counter()
        online.predict()
        latency.append(time.perf_counter() - t0)
    ran = np.asarray(latency[fc.window.history_bins - 1:]) * 1e3
    launches = mlstm.launches
    if mlstm.row_launches == 0 or len(ran) == 0:
        raise SystemExit("forecast main path ran without launching "
                         "the mlstm row kernel")
    out = out.cpu().numpy()
    if out.shape != (n,) or not np.isfinite(out).all():
        raise SystemExit("forecast main path outputs malformed")
    ar1 = Ar1Baseline.fit(data["X_train"], data["y_train"])
    ar1_mse = float(np.mean(
        (np.log1p(np.maximum(ar1.predict_batch(data["X_val"]), 0.0))
         - np.log1p(data["y_val"])) ** 2))
    warm_s = float(np.median(warm))
    line = {"phase": "forecast_main", "windows": n,
            "d_model": fc.arch.d_model, "heads": fc.arch.num_heads,
            "history_bins": fc.window.history_bins,
            "cold_s": cold_s, "warm_s_median": warm_s,
            "warm_s_min": min(warm), "warm_s_max": max(warm),
            "windows_per_s_warm": n / warm_s, "windows_per_s_cold": n / cold_s,
            "batched_calls": 1 + len(warm),
            "batched_mlstm_launches": batched_launches,
            "mlstm_launches": launches,
            "mlstm_row_launches": mlstm.row_launches,
            "peak_device_bytes": peak,
            "profiled_call": {
                "device_ms": device_ms, "mlstm_kernel_ms": mlstm_ms,
                "device_events": len(events),
                "top_device_events": [
                    {"name": k[:90], "ms": v} for k, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:8]]},
            "predict_bins": len(latency), "predict_model_calls": len(ran),
            "predict_ms_median": float(np.median(ran)),
            "predict_ms_mean": float(ran.mean()),
            "predict_ms_p99": float(np.percentile(ran, 99)),
            "predict_ms_max": float(ran.max()),
            "val_log_mse": {"mlstm": _val_log_mse(np, out, data),
                            "ewma": _ewma_log_mse(np, data["X_val"],
                                                  data["y_val"]),
                            "ar1": ar1_mse}}
    emit(line)
    return line


# The training cell's shape (phase 16: 2 sequences of 4096 tokens a
# microbatch at d_rnn 4096, the ring kernel), the last case of
# RGLRU_CASES and the training shape of phase 13's gradient check.
RGLRU_TRAIN_CASE = (2, 4096, 4096, "float32", "bfloat16")

# (B, T, R, input dtype, output dtype): the serving shape first (float32
# coefficients from _coeffs, bfloat16 out), then T = 1, T and R not
# multiples of any block, B > 1, bfloat16 inputs (all these but the
# serving shape take the chunked kernel, inputs of up to 24 MB); then the
# ring kernel's edges: 8191 steps at B 4, rows that are not whole
# 16-byte pieces, T shorter than one 64-step tile, bfloat16 in and out;
# last, the training cell's shape.
RGLRU_CASES = (
    (1, 3072, 4096, "float32", "bfloat16"),
    (1, 1, 4096, "float32", "float32"),
    (3, 517, 100, "float32", "float32"),
    (2, 33, 4096, "bfloat16", "bfloat16"),
    (2, 200, 257, "bfloat16", "float32"),
    (1, 15, 31, "float32", "bfloat16"),
    (1, 3072, 4096, "float32", "float32"),
    (4, 8191, 256, "float32", "float32"),
    (2, 1600, 2051, "bfloat16", "float32"),
    (1, 40, 160000, "float32", "bfloat16"),
    (1, 2000, 4096, "bfloat16", "bfloat16"),
    RGLRU_TRAIN_CASE,
)
# Prompt lengths of the serve cell timed besides the serving shape: the
# ring kernel at a mid-length prompt, the chunked kernel at a short one.
RGLRU_TIMED_T = (3072, 1674, 512)
# The chunked kernel chains its chunks' carries in another order than
# the sequential walk (float32 rounding; a bfloat16 output may round one
# ulp apart); the ring kernel walks the sequential order.
RGLRU_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=1e-2, rtol=1e-2)}


def _rglru_inputs(torch, np, case, dev):
    B, T, R, dtype, _ = case
    rng = np.random.default_rng(B * 7919 + T * 31 + R)
    a = rng.uniform(0.5, 0.999, (B, T, R))
    b = 0.1 * rng.standard_normal((B, T, R))
    return [torch.tensor(x, dtype=getattr(torch, dtype), device=dev)
            for x in (a, b)]


def phase_rglru(torch, np, dev) -> dict:
    from repro_torch.kernels import rglru_scan as rglru
    results = {}
    before = (rglru.launches, rglru.chunked_launches)
    for case in RGLRU_CASES:
        B, T, R, dtype, out_dtype = case
        name = f"{B}x{T}x{R}/{dtype}->{out_dtype}"
        a, b = _rglru_inputs(torch, np, case, dev)
        od = getattr(torch, out_dtype)
        h = rglru.rglru_scan(a, b, out_dtype=od)
        torch.cuda.synchronize()
        want = rglru.rglru_scan_plain(a, b, out_dtype=od)
        ok = h.dtype == want.dtype == od and torch.allclose(
            h.float(), want.float(), **RGLRU_TOL[out_dtype])
        results[name] = {
            "match": ok, "kernel": "chunked" if rglru.takes_chunked_kernel(a)
            else "ring",
            "max_abs_err": float((h.float() - want.float()).abs().max())}
        if not ok:
            emit({"phase": "rglru", "cases": results})
            raise SystemExit(f"rglru_scan disagrees with its plain version "
                             f"on {name}")
    chunked_launches = rglru.chunked_launches - before[1]
    ring_launches = rglru.launches - before[0] - chunked_launches
    if not chunked_launches or not ring_launches:
        raise SystemExit("rglru cases did not launch both kernels: "
                         f"ring {ring_launches}, chunked {chunked_launches}")
    # Device time at the serving shape and at the other timed prompt
    # lengths: the ring kernel and the chunked kernel (the PR 13 design,
    # the parent's kernel at every length) on the same inputs, both by
    # CUDA events behind a device sleep; the plain version, an eager loop
    # over T issued from the host, by back-to-back CUDA events (its host
    # issue is its time), at the longest and the shortest length.
    bf16 = torch.bfloat16
    by_t = {}
    for T in RGLRU_TIMED_T:
        B, R = RGLRU_CASES[0][0], RGLRU_CASES[0][2]
        a, b = _rglru_inputs(torch, np, (B, T, R, "float32", "bfloat16"),
                             dev)
        want = rglru.rglru_scan_plain(a, b, out_dtype=bf16)
        timed, errs = {}, {}
        for kernel, chunked in (("ring", False), ("chunked", True)):
            def run(chunked=chunked):
                return rglru._rglru_scan_cuda(a, b, bf16, chunked=chunked)
            h = run()
            torch.cuda.synchronize()
            if not torch.allclose(h.float(), want.float(),
                                  **RGLRU_TOL["bfloat16"]):
                raise SystemExit(f"rglru {kernel} kernel disagrees at T {T}")
            errs[kernel] = float((h.float() - want.float()).abs().max())
            timed[kernel] = _queued_ms(torch, run, 200)
        if T in (RGLRU_TIMED_T[0], RGLRU_TIMED_T[-1]):
            timed["plain"] = {"ms": _call_ms(torch, lambda: (
                rglru.rglru_scan_plain(a, b, out_dtype=bf16)), 3, 2),
                "how": "back-to-back CUDA events"}
        nbytes = B * T * R * (4 + 4 + 2)   # a, b float32 in, h bfloat16 out
        ops = 2 * B * T * R                # a multiply and an add each
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        by_t[T] = {"ms": {k: v["ms"] for k, v in timed.items()},
                   "share_of_bound": {k: bound_ms / v["ms"]
                                      for k, v in timed.items()},
                   "picked": "chunked" if rglru.takes_chunked_kernel(a)
                   else "ring",
                   "timed": timed, "bytes": nbytes, "ops": ops,
                   "bound_ms": bound_ms,
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations",
                   "max_abs_err": errs}
    long, short = by_t[RGLRU_TIMED_T[0]], by_t[RGLRU_TIMED_T[-1]]
    if long["picked"] != "ring" or short["picked"] != "chunked":
        raise SystemExit("rglru timed lengths do not cover both kernels")
    line = {"phase": "rglru", "cases": results, "tolerance": RGLRU_TOL,
            "case_launches": {"ring": ring_launches,
                              "chunked": chunked_launches},
            "timing": "CUDA events, launches queued behind a device sleep",
            "ring": {"T": RGLRU_TIMED_T[0], "ms": long["ms"]["ring"],
                     "parent_ms": long["ms"]["chunked"],
                     "plain_ms": long["ms"]["plain"],
                     "bound_ms": long["bound_ms"],
                     "bound_by": long["bound_by"],
                     "share_of_bound": long["share_of_bound"]["ring"]},
            "chunked": {"T": RGLRU_TIMED_T[-1], "ms": short["ms"]["chunked"],
                        "ring_ms": short["ms"]["ring"],
                        "plain_ms": short["ms"]["plain"],
                        "bound_ms": short["bound_ms"],
                        "bound_by": short["bound_by"],
                        "share_of_bound":
                            short["share_of_bound"]["chunked"]},
            "library_ms": None,
            "library_call": "no single PyTorch call computes this "
                            "recurrence",
            "by_T": by_t,
            "max_abs_err": {
                kernel: max([r["max_abs_err"] for r in results.values()
                             if r["kernel"] == kernel]
                            + [t["max_abs_err"][kernel]
                               for t in by_t.values()])
                for kernel in ("ring", "chunked")}}
    emit(line)
    return line


# The training cell's shape (phase 16: 2 sequences of 4096 tokens a
# microbatch at the serving heads and window), the last case of
# FLASH_CASES and the training shape of phase 13's gradient check.
FLASH_TRAIN_CASE = (2, 16, 1, 4096, 4096, 256, True, 2048, "bfloat16")
# DeepSeekMoE-16B's attention at its serve cell's longest prompt (phase
# 20): MHA, 16 heads of 128, causal, no window; timed in phase 9 beside
# the serving shape.  Granite-3.0-1B-A400M's: GQA 16/8 at hd 64.
FLASH_MOE_CASE = (1, 16, 16, 3072, 3072, 128, True, 0, "bfloat16")
FLASH_GRANITE_CASE = (1, 16, 8, 1024, 1024, 64, True, 0, "bfloat16")
# DeepSeekMoE-16B's attention in training in phase 33 (job B: 4
# sequences of 512 tokens).
FLASH_LIVE_CASE = (4, 16, 16, 512, 512, 128, True, 0, "bfloat16")
# Command-R-35B's attention at its serve cell's longest prompt (phase
# 23): GQA 64/8 at hd 128, causal, no window; timed in phase 9.  Qwen1.5-
# 32B's prefill after padding 40 heads to 48 (phase 24, which times it
# beside the unpadded 40).  Each also at T 512 (checked first).
FLASH_COMMAND_R_CASE = (1, 64, 8, 3072, 3072, 128, True, 0, "bfloat16")
FLASH_QWEN_CASE = (1, 48, 48, 3072, 3072, 128, True, 0, "bfloat16")
# Whisper-medium's attention (phase 26): the encoder's (MHA, 16 heads of
# 64, T = S = 1500 with no mask: 1500 leaves a partial tail in both the
# 128-query blocks and the 64-key tiles), cross attention at prefill (the
# prompt, 4 to 384 tokens, against the 1500 frames, no mask) and the
# decoder's causal self-attention at the longest prompt.  InternVL2-26B's
# prefill (phase 28): GQA 48/8 at hd 128, causal, the 1024 patches and
# a prompt (1088 and 3072 positions).  Each timed in phase 9.
FLASH_WHISPER_CASES = {
    "encoder": (1, 16, 16, 1500, 1500, 64, False, 0, "bfloat16"),
    "cross_T4": (1, 16, 16, 4, 1500, 64, False, 0, "bfloat16"),
    "cross_T384": (1, 16, 16, 384, 1500, 64, False, 0, "bfloat16"),
    "decoder_T384": (1, 16, 16, 384, 384, 64, True, 0, "bfloat16")}
FLASH_INTERNVL_CASES = {
    "T1088": (1, 48, 8, 1088, 1088, 128, True, 0, "bfloat16"),
    "T3072": (1, 48, 8, 3072, 3072, 128, True, 0, "bfloat16")}

# (B, Hq, Hkv, T, S, hd, causal, window, dtype): the serving shape first,
# then tests/test_kernels.py's sweep (MHA, GQA, MQA with hd 256), a
# window, a window wider than T with T not a multiple of the block,
# T = 1, hd 48 (zero-padded in the kernel), a non-causal call, and the
# serving shape in float32; then the bfloat16 tensor-core kernel's
# edges: T and S not multiples of its 128-query or 64-key tiles (77,
# 130, 1000, 2990 at the serving heads), a window edge inside a tile,
# GQA 8/2 at hd 128, hd 48, 80, 32 and 33 zero-padded (33: the copy for
# hd not a multiple of 8), S > T with a window and no causal mask, and
# T = S = 1 without a causal mask; the model cells' shapes, Whisper's and
# InternVL2's also in float32 (their fixtures' dtype, phases 25 and 27);
# the live phase's MoE training shape (FLASH_LIVE_CASE); last, the
# training cell's shape.
FLASH_CASES = (
    (1, 16, 1, 3072, 3072, 256, True, 2048, "bfloat16"),
    (1, 1, 1, 128, 128, 64, True, 0, "float32"),
    (2, 4, 4, 256, 256, 64, True, 0, "bfloat16"),
    (2, 8, 2, 256, 256, 128, True, 0, "float32"),
    (2, 8, 2, 256, 256, 128, True, 0, "bfloat16"),
    (1, 6, 1, 384, 384, 256, True, 0, "bfloat16"),
    (1, 6, 1, 384, 384, 256, True, 0, "float32"),
    (2, 2, 2, 256, 256, 64, True, 64, "float32"),
    (1, 2, 1, 100, 100, 128, True, 300, "float32"),
    (1, 4, 1, 1, 1, 256, True, 16, "bfloat16"),
    (2, 3, 1, 77, 77, 48, True, 0, "float32"),
    (1, 2, 2, 130, 130, 64, False, 0, "float32"),
    (1, 16, 1, 3072, 3072, 256, True, 2048, "float32"),
    (2, 3, 1, 77, 77, 48, True, 0, "bfloat16"),
    (1, 2, 2, 130, 130, 64, False, 0, "bfloat16"),
    (1, 4, 2, 1000, 1000, 80, True, 0, "bfloat16"),
    (1, 16, 1, 2990, 2990, 256, True, 2048, "bfloat16"),
    (1, 4, 1, 384, 384, 256, True, 100, "bfloat16"),
    (1, 2, 1, 50, 90, 32, False, 20, "bfloat16"),
    (1, 2, 1, 70, 70, 33, True, 0, "bfloat16"),
    (1, 3, 1, 1, 1, 64, False, 0, "bfloat16"),
    FLASH_MOE_CASE,
    FLASH_GRANITE_CASE,
    (1, 64, 8, 512, 512, 128, True, 0, "bfloat16"),
    (1, 48, 48, 512, 512, 128, True, 0, "bfloat16"),
    FLASH_COMMAND_R_CASE,
    FLASH_QWEN_CASE,
    *FLASH_WHISPER_CASES.values(),
    *FLASH_INTERNVL_CASES.values(),
    (1, 16, 16, 1500, 1500, 64, False, 0, "float32"),
    (1, 16, 16, 384, 1500, 64, False, 0, "float32"),
    (1, 48, 8, 1088, 1088, 128, True, 0, "float32"),
    FLASH_LIVE_CASE,
    FLASH_TRAIN_CASE,
)
# Serving-path lengths timed in phase 9: the longest prompt's bucket and
# a mid-length prompt of the serve cell.
FLASH_TIMED_T = (3072, 1674)
# tests/test_kernels.py's tolerances for the Pallas kernel against its
# oracle: float32 sums in another order, bfloat16 outputs rounded.
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# Soft-capped flash: the cap, and the scale of q that puts the logits
# (~N(0, 16)) where a cap of 2 bends them, so that each capped case is at
# least 10 x its tolerance away from the uncapped plain version.  The
# cases: RecurrentGemma's serving shape, Command-R's, DeepSeekMoE's,
# Whisper's four and the training shape in bf16, then one float32 case
# per head dim (256, 128, 64).
FLASH_SOFTCAP = 2.0
FLASH_SOFTCAP_Q_SCALE = 4.0
FLASH_SOFTCAP_CASES = (
    FLASH_CASES[0], FLASH_COMMAND_R_CASE, FLASH_MOE_CASE,
    *FLASH_WHISPER_CASES.values(), FLASH_TRAIN_CASE,
    (1, 6, 1, 384, 384, 256, True, 0, "float32"),
    (2, 8, 2, 256, 256, 128, True, 0, "float32"),
    (1, 16, 16, 384, 1500, 64, False, 0, "float32"),
)
# Special-function (MUFU: ex2, tanh, rcp) operations a second on an H100
# SXM (FlashAttention-3, arXiv:2407.08608).
SFU_OPS_PER_S = 3.9e12


def _flash_inputs(torch, np, case, dev):
    B, Hq, Hkv, T, S, hd, _, _, dtype = case
    rng = np.random.default_rng(B + Hq * 10 + T + hd)
    return [torch.tensor(rng.standard_normal(shape),
                         dtype=getattr(torch, dtype), device=dev)
            for shape in ((B, Hq, T, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]


def _ptxas_by_kernel(log: str) -> dict:
    """{"<dtype>/hd<HD>[/softcap]": {registers, spill_stores,
    spill_loads}} of the flash kernel's instantiations, from its ``nvcc
    -Xptxas -v`` log (a source from before the cap has no ``/softcap``
    instantiations, and its names read the same)."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            hit = re.search(r"flash_attention_(bf16|f32)(_softcap)?ILi(\d+)E"
                            r"(Lb([01])E)?", ln)
            name = (f"{hit.group(1)}/hd{hit.group(3)}"
                    + ("/softcap" if hit.group(2) or hit.group(5) == "1"
                       else "") if hit else None)
            if name:
                out[name] = {}
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   ln).group(1))
    return out


def _flash_work(B, Hq, Hkv, T, S, hd, mask):
    """(operations, bytes, bound ms, bound_by) of one bf16 call."""
    ops = B * Hq * int(mask.sum()) * 4 * hd  # q.k and p.v, 2 each per elt
    nbytes = 2 * (2 * B * Hq * T * hd + 2 * B * Hkv * S * hd)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    return (ops, nbytes, max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def _flash_name(case) -> str:
    B, Hq, Hkv, T, S, hd, causal, window, dtype = case
    return (f"{B}x{Hq}/{Hkv}x{T}x{S}x{hd}/"
            f"{'causal' if causal else 'full'}/w{window}/{dtype}")


def _flash_timed(torch, np, flash, dev, shape) -> dict:
    """Device time at ``shape`` (B, Hq, Hkv, T, S, hd, causal, window):
    the bf16 tensor-core kernel, the float32 SIMT kernel on the same
    values in float32, the plain version and SDPA with the same mask (the
    yardstick); operations and share of the bf16 bound for each."""
    import torch.nn.functional as F
    B, Hq, Hkv, T, S, hd, causal, window = shape
    q, k, v = _flash_inputs(torch, np, (*shape, "bfloat16"), dev)
    q32, k32, v32 = q.float(), k.float(), v.float()
    mask = flash._mask(T, S, causal, window, dev)
    calls = {
        "kernel": lambda: flash.flash_attention(
            q, k, v, causal=causal, window=window),
        "kernel_f32": lambda: flash.flash_attention(
            q32, k32, v32, causal=causal, window=window),
        "plain": lambda: flash.flash_attention_plain(
            q, k, v, causal=causal, window=window),
        "library": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True),
    }
    timed = {k_: _timed_ms(torch, fn, 20, 3) for k_, fn in calls.items()}
    ops, nbytes, bound_ms, bound_by = _flash_work(B, Hq, Hkv, T, S, hd, mask)
    return {
        "ms": {k_: v_["ms"] for k_, v_ in timed.items()},
        "tflops": {k_: ops / (v_["ms"] * 1e-3) / 1e12
                   for k_, v_ in timed.items()},
        "share_of_bound": {k_: bound_ms / v_["ms"]
                           for k_, v_ in timed.items()},
        "timing": timed, "visible_pairs_per_head": int(mask.sum()),
        "flops": ops, "bytes": nbytes, "bound_ms": bound_ms,
        "bound_by": bound_by}


def _flash_shape_line(case, timed, results) -> dict:
    """A timed shape's numbers for the phase's line and the kernels
    line."""
    return {"shape": list(case[:6]), "causal": case[6], "window": case[7],
            "kernel_ms": timed["ms"]["kernel"],
            "kernel_f32_ms": timed["ms"]["kernel_f32"],
            "plain_ms": timed["ms"]["plain"],
            "library_ms": timed["ms"]["library"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "flops": timed["flops"], "bytes": timed["bytes"],
            "visible_pairs_per_head": timed["visible_pairs_per_head"],
            "tflops": timed["tflops"],
            "share_of_bound": timed["share_of_bound"],
            "max_abs_err": results[_flash_name(case)]["max_abs_err"]
            if results else None}


def _flash_model_shape(torch, np, flash, dev, case, results) -> dict:
    """A model's shape timed as :func:`_flash_timed` times it (calls back
    to back, host issue included), and the kernel and SDPA also queued
    behind a device sleep (device time alone: at Whisper's shapes a call
    takes tens of microseconds, near a ctypes call's issue time)."""
    import torch.nn.functional as F
    T, S, _, causal, window = case[3:8]
    line = _flash_shape_line(case, _flash_timed(torch, np, flash, dev,
                                                case[:8]), results)
    q, k, v = _flash_inputs(torch, np, case, dev)
    mask = flash._mask(T, S, causal, window, dev)
    line["kernel_queued_ms"] = _queued_ms(
        torch, lambda: flash.flash_attention(q, k, v, causal=causal,
                                             window=window), 50)["ms"]
    line["library_queued_ms"] = _queued_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), 50)["ms"]
    return line


def _capped_inputs(torch, np, case, dev):
    q, k, v = _flash_inputs(torch, np, case, dev)
    return q * FLASH_SOFTCAP_Q_SCALE, k, v


def _flash_capped_bound(flash, shape, cap) -> tuple:
    """(ms by resource, bound ms, the resource that binds) of one capped
    bf16 call at ``shape`` (B, Hq, Hkv, T, S, hd, causal, window): the
    largest of its tensor-core time (4 hd operations a visible pair), its
    special-function time (:func:`flash.flash_sfu_ops`) and its bytes
    time (q, k, v read and o written once)."""
    B, Hq, Hkv, T, S, hd, causal, window = shape
    pairs = B * Hq * flash.visible_pairs(T, S, causal, window)
    times = {"tensor_core": pairs * 4 * hd / BF16_OPS_PER_S * 1e3,
             "special_function": flash.flash_sfu_ops(
                 B, Hq, T, S, causal, window, cap) / SFU_OPS_PER_S * 1e3,
             "bytes": 2 * (2 * B * Hq * T * hd + 2 * B * Hkv * S * hd)
             / HBM_BYTES_PER_S * 1e3}
    bound_by = max(times, key=times.get)
    return times, times[bound_by], bound_by


def _flex_mods(torch, causal, window, cap):
    """FlexAttention's ``score_mod`` (the cap, on the scaled logit) and
    ``mask_mod`` (None without a mask) for the flash kernel's function."""
    def score_mod(score, b, h, i, j):
        return torch.tanh(score / cap) * cap

    def mask_mod(b, h, i, j):
        visible = j <= i if causal else j >= 0
        return visible & (j > i - window) if window > 0 else visible
    return score_mod, (mask_mod if causal or window > 0 else None)


def _flex_capped(torch, case, cap, dev):
    """The yardstick of a capped call: one library call that computes the
    same function, ``torch.compile``d FlexAttention with the cap as its
    ``score_mod`` and the mask as its block mask.  Timed only here; the
    port never calls it."""
    import torch._inductor.config as inductor
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    B, Hq, Hkv, T, S, hd, causal, window, _ = case
    inductor.compile_threads = 1       # no compile worker processes
    score_mod, mask_mod = _flex_mods(torch, causal, window, cap)
    block_mask = None if mask_mod is None else create_block_mask(
        mask_mod, None, None, T, S, device=dev)
    compiled = torch.compile(flex_attention, dynamic=False)
    return lambda q, k, v: compiled(q, k, v, score_mod=score_mod,
                                    block_mask=block_mask,
                                    enable_gqa=Hq != Hkv)


def _row_scaled_check(out, want, tol) -> tuple:
    """(within, worst): ``out`` against ``want`` with ``tol``'s atol
    scaled to the rms of each query row of ``want``.  A capped softmax
    spreads over many keys, so its rows lie far below unit scale, where
    an unscaled atol would pass a capped logit off by 10 %."""
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    err = (out - want).abs()
    within = bool((err <= tol["atol"] * rms + tol["rtol"] * want.abs()).all())
    return within, float((err / rms).max())


def _flash_softcap(torch, np, flash, dev) -> dict:
    """The capped kernels: each of :data:`FLASH_SOFTCAP_CASES` against
    the plain version with the cap within ``FLASH_TOL``, and each bf16
    case also within ``FLASH_TOL`` scaled to its rows
    (:func:`_row_scaled_check`), where the uncapped plain version must
    lie at least 10 x the tolerance's atol away; then at the serving
    shape and Whisper's encoder shape the capped and uncapped kernels'
    device times and the yardstick's (:func:`_flex_capped`, held to the
    plain version first), queued behind a device sleep, and the capped
    plain version's, beside the capped call's bound
    (:func:`_flash_capped_bound`)."""
    cases = {}
    for case in FLASH_SOFTCAP_CASES:
        causal, window, dtype = case[6:]
        name = _flash_name(case)
        q, k, v = _capped_inputs(torch, np, case, dev)
        kw = dict(causal=causal, window=window)
        out = flash.flash_attention(q, k, v, softcap=FLASH_SOFTCAP, **kw)
        torch.cuda.synchronize()
        want = flash.flash_attention_plain(q, k, v, softcap=FLASH_SOFTCAP,
                                           **kw).float()
        bent = float((want - flash.flash_attention_plain(
            q, k, v, **kw).float()).abs().max())
        ok = out.dtype == q.dtype and torch.allclose(
            out.float(), want, **FLASH_TOL[dtype])
        scaled, worst = _row_scaled_check(out.float(), want,
                                          FLASH_TOL[dtype])
        cases[name] = {"match": ok, "max_abs_err": float(
            (out.float() - want).abs().max()),
            "max_err_over_row_rms": worst, "bent_by_cap": bent,
            "bent_share_of_atol": bent / FLASH_TOL[dtype]["atol"]}
        if dtype == "bfloat16":
            cases[name]["match_row_scaled"] = scaled
            ok = ok and scaled
        del q, k, v, out, want
        if not ok or bent < 10 * FLASH_TOL[dtype]["atol"]:
            emit({"phase": "flash_softcap", "cases": cases})
            raise SystemExit(f"capped flash_attention disagrees with its "
                             f"plain version on {name}, or the cap does "
                             "not move the plain version")
    timed = {}
    for label, case in (("serve", FLASH_CASES[0]),
                        ("whisper_encoder", FLASH_WHISPER_CASES["encoder"])):
        causal, window = case[6:8]
        q, k, v = _capped_inputs(torch, np, case, dev)
        ms = {}
        for key, cap in (("uncapped", 0.0), ("capped", FLASH_SOFTCAP)):
            ms[key] = _queued_ms(torch, lambda: flash.flash_attention(
                q, k, v, causal=causal, window=window, softcap=cap),
                50)["ms"]
        want = flash.flash_attention_plain(q, k, v, causal=causal,
                                           window=window,
                                           softcap=FLASH_SOFTCAP)
        ms["plain"] = _call_ms(torch, lambda: flash.flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=FLASH_SOFTCAP),
            10, 2)
        library = {"call": "torch.compile(flex_attention)(q, k, v, "
                           "score_mod=cap * tanh(score / cap), block_mask="
                           "the mask, enable_gqa=Hq != Hkv)"}
        try:
            t0 = time.perf_counter()
            flex = _flex_capped(torch, case, FLASH_SOFTCAP, dev)
            got = flex(q, k, v).float()
            torch.cuda.synchronize()
            library["compile_s"] = time.perf_counter() - t0
            library["max_abs_err"] = float((got - want.float()).abs().max())
            library["match"] = torch.allclose(got, want.float(),
                                              **FLASH_TOL["bfloat16"])
            library["ms"] = _queued_ms(torch, lambda: flex(q, k, v),
                                       50)["ms"] if library["match"] else None
            del got
        except Exception as exc:   # the yardstick's fault, not the port's
            library.update(error=f"{type(exc).__name__}: {exc}"[:500],
                           ms=None)
        times, bound_ms, bound_by = _flash_capped_bound(
            flash, case[:8], FLASH_SOFTCAP)
        timed[label] = {"shape": list(case[:6]), "causal": causal,
                        "window": window, "softcap": FLASH_SOFTCAP,
                        "capped_ms": ms["capped"],
                        "uncapped_ms": ms["uncapped"],
                        "plain_capped_ms": ms["plain"],
                        "library_ms": library["ms"], "library": library,
                        "capped_over_uncapped": ms["capped"]
                        / ms["uncapped"],
                        "bound_ms_by_resource": times,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "capped_share_of_bound": bound_ms / ms["capped"]}
        del q, k, v, want
    return {"softcap": FLASH_SOFTCAP, "q_scale": FLASH_SOFTCAP_Q_SCALE,
            "cases": cases, "timed": timed,
            "max_abs_err_bf16": max(r["max_abs_err"] for n, r in
                                    cases.items() if n.endswith("bfloat16")),
            "max_abs_err_f32": max(r["max_abs_err"] for n, r in
                                   cases.items() if n.endswith("float32"))}


def phase_flash(torch, np, dev) -> dict:
    from repro_torch import _build
    from repro_torch.kernels import flash_attention as flash
    results = {}
    for case in FLASH_CASES:
        B, Hq, Hkv, T, S, hd, causal, window, dtype = case
        name = _flash_name(case)
        q, k, v = _flash_inputs(torch, np, case, dev)
        out = flash.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
        ok = out.dtype == want.dtype and torch.allclose(
            out.float(), want.float(), **FLASH_TOL[dtype])
        results[name] = {"match": ok, "max_abs_err": float(
            (out.float() - want.float()).abs().max())}
        if not ok:
            emit({"phase": "flash", "cases": results})
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version on {name}")
    # Device time at the serving shape and a mid-length prompt, and at
    # DeepSeekMoE-16B's prefill shape.
    B, Hq, Hkv, _, _, hd, causal, window, _ = FLASH_CASES[0]
    by_t = {T: _flash_timed(torch, np, flash, dev, (B, Hq, Hkv, T, T, hd,
                                                    causal, window))
            for T in FLASH_TIMED_T}
    moe = _flash_timed(torch, np, flash, dev, FLASH_MOE_CASE[:8])
    command_r = _flash_timed(torch, np, flash, dev, FLASH_COMMAND_R_CASE[:8])
    modality = {
        family: {name: _flash_model_shape(torch, np, flash, dev, case,
                                          results)
                 for name, case in cases.items()}
        for family, cases in (("whisper", FLASH_WHISPER_CASES),
                              ("internvl", FLASH_INTERNVL_CASES))}
    ptxas = _ptxas_by_kernel(
        _build.build_all(["flash_attention"])["flash_attention"]["log"])
    softcap = _flash_softcap(torch, np, flash, dev)
    # Trouble spot of the cap at hd 256: the capped instantiation may not
    # spill more than the uncapped one.
    more_spills = [n for n in ptxas if n.endswith("/softcap") and ptxas[n][
        "spill_stores"] > ptxas[n[:-len("/softcap")]]["spill_stores"]]
    serve = by_t[FLASH_TIMED_T[0]]
    line = {"phase": "flash", "cases": results, "tolerance": FLASH_TOL,
            "shape": [B, Hq, Hkv, FLASH_TIMED_T[0], FLASH_TIMED_T[0], hd],
            "window": window,
            "kernel_ms": serve["ms"]["kernel"],
            "kernel_f32_ms": serve["ms"]["kernel_f32"],
            "plain_ms": serve["ms"]["plain"],
            "library_ms": serve["ms"]["library"],
            "library_call": "F.scaled_dot_product_attention(q, k, v, "
                            "attn_mask=bool mask, enable_gqa=True)",
            "kernel_not_slower_than_library":
                serve["ms"]["kernel"] <= serve["ms"]["library"],
            "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
            "kernel_tflops": serve["tflops"]["kernel"],
            "by_T": by_t, "ptxas": ptxas,
            "moe_shape": _flash_shape_line(FLASH_MOE_CASE, moe, results),
            "command_r_shape": _flash_shape_line(
                FLASH_COMMAND_R_CASE, command_r, results),
            "whisper_shapes": modality["whisper"],
            "internvl_shapes": modality["internvl"],
            "softcap": softcap, "softcap_spills_more": more_spills,
            # the path's call (the serving shape), then the worst by dtype
            "max_abs_err": next(iter(results.values()))["max_abs_err"],
            "max_abs_err_train": list(results.values())[-1]["max_abs_err"],
            "max_abs_err_f32": max(r["max_abs_err"] for n, r in
                                   results.items() if n.endswith("float32")),
            "max_abs_err_bf16": max(r["max_abs_err"] for n, r in
                                    results.items()
                                    if n.endswith("bfloat16"))}
    emit(line)
    if more_spills:
        raise SystemExit(f"the capped flash kernels {more_spills} spill "
                         "more than the uncapped ones")
    return line


# The serve fixture's runs, as tests/test_torch_serve.py makes them:
# prefill of 13 tokens into a cache of 32 then 5 decode steps, and the
# engine run (prompt length, max_new_tokens, submitted_at) on 2 slots.
SERVE_PREFILL_LEN, SERVE_DECODE_STEPS, SERVE_PREFILL_CACHE = 13, 5, 32
SERVE_ENGINE_REQS = ((13, 6, 0.0), (4, 8, 0.0), (21, 5, 1.0), (9, 7, 2.5),
                     (17, 4, 2.5))
SERVE_METRIC_KEYS = ("elapsed_s", "mean_ttft_s", "requests", "tokens",
                     "tokens_per_s")
SERVE_TOL = dict(atol=1e-4, rtol=1e-3)     # float32 logits vs JAX


def phase_serve_golden(torch, np, dev) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rglru_scan as rglru
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import map_tree, params_from_numpy
    from repro_torch.serve import engine as serve
    with np.load(SERVE_GOLDEN, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", tiny=True),
                              num_layers=8, dtype="float32")
    tree = map_tree(lambda path, _: fx["param/" + "/".join(map(str, path))],
                    tf.model_specs(cfg))
    params = params_from_numpy(tree, dev, dtype=tf.serving_dtype(cfg))
    before = (flash.launches, rglru.launches)
    tokens = torch.from_numpy(fx["tokens"]).long().to(dev)
    L = SERVE_PREFILL_LEN
    lg, states = tf.prefill(params, {"tokens": tokens[:, :L]}, cfg,
                            SERVE_PREFILL_CACHE)
    errs = [float(np.abs(lg.cpu().numpy() - fx["prefill_logits"]).max())]
    ok = np.allclose(lg.cpu().numpy(), fx["prefill_logits"], **SERVE_TOL)
    for s in range(SERVE_DECODE_STEPS):
        lg, states = tf.decode_step(params, tokens[:, L + s:L + s + 1],
                                    states, cfg)
        got = lg.cpu().numpy()
        errs.append(float(np.abs(got - fx["decode_logits"][s]).max()))
        ok = ok and np.allclose(got, fx["decode_logits"][s], **SERVE_TOL)
    now = [0.0]

    def clock():
        now[0] += 0.25
        return now[0]

    def sleep(dt):
        now[0] += dt

    eng = serve.ServeEngine(cfg, params, serve.EngineConfig(
        num_slots=2, cache_len=40), clock=clock, device=dev)
    reqs, at = [], 0
    for i, (n, new, t) in enumerate(SERVE_ENGINE_REQS):
        reqs.append(serve.Request(uid=i, prompt=fx["engine_prompts"][at:at + n],
                                  max_new_tokens=new, submitted_at=t))
        at += n
    metrics = serve.run_server(eng, reqs, log=lambda s: None, clock=clock,
                               sleep=sleep)
    tokens_equal = all(r.tokens == [int(t) for t in want if t >= 0]
                       for r, want in zip(reqs, fx["engine_tokens"]))
    stamps_equal = np.array_equal(np.asarray(
        [(r.first_token_at, r.done_at) for r in reqs]), fx["engine_stamps"])
    metrics_equal = [metrics[k] for k in SERVE_METRIC_KEYS] == \
        fx["engine_metrics"].tolist()
    launched = (flash.launches - before[0], rglru.launches - before[1])
    emit({"phase": "serve_golden", "layers": cfg.num_layers,
          "logits_within_tol": bool(ok), "tolerance": SERVE_TOL,
          "logits_max_abs_err": max(errs), "engine_tokens_equal": tokens_equal,
          "engine_stamps_equal": stamps_equal,
          "engine_metrics_equal": metrics_equal,
          "flash_launches": launched[0], "rglru_launches": launched[1]})
    if not (ok and tokens_equal and stamps_equal and metrics_equal) \
            or min(launched) == 0:
        raise SystemExit("serve golden: the port on the card does not "
                         "reproduce the JAX fixture through both kernels")


SERVE_REQUESTS = 16
SERVE_NEW_TOKENS = 64
SERVE_SLOTS = 8
SERVE_CACHE = 4096
# Decode against teacher forcing at full width in bfloat16: the prefill
# kernel and decode sum over keys in other orders and tiles, and decode
# carries the RG-LRU state in float32 where the prefill scan rounds it,
# over 38 layers.
SERVE_CONSISTENCY_REL = 0.1
# Serve cells at their published widths cut in depth to keep the whole
# script inside its time limit (a quarter of each model's layers in
# whole superblocks): xLSTM-125M one superblock (3 mLSTM + 1 sLSTM) of
# 12 layers, DeepSeekMoE-16B the dense first layer and 6 MoE layers of
# 28, Command-R-35B 10 of 40, InternVL2-26B 12 of 48 (its 1024 patch
# embeddings as before).  RecurrentGemma-9B (phase 12) and
# Whisper-medium (phases 26 and 35) run at full depth.
SERVE_CUT_LAYERS = {"xlstm-125m": 4, "deepseek-moe-16b": 7,
                    "command-r-35b": 10, "internvl2-26b": 12}


def _busy(events, wall_s):
    """(device busy ms, summed device ms, top ops) over sorted events."""
    events = sorted(events, key=lambda e: e[1])
    busy_us, reach, by_name = 0.0, float("-inf"), {}
    for name, start_us, end_us in events:
        busy_us += max(0.0, end_us - max(start_us, reach))
        reach = max(reach, end_us)
        tot = by_name.setdefault(name, [0, 0.0])
        tot[0] += 1
        tot[1] += end_us - start_us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_us * 1e-3,
            "device_ms": sum(v[1] for v in by_name.values()) * 1e-3,
            "device_busy_share": busy_us * 1e-6 / wall_s,
            "device_events": len(events),
            "top_device_ops": [{"name": k[:80], "count": v[0],
                                "ms": v[1] * 1e-3} for k, v in top]}


def _profiled(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _busy(_device_events(prof), wall)


def phase_serve_main(torch, np, dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rglru_scan as rglru
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serve import engine as serve
    cfg = get_config("recurrentgemma-9b")
    specs = tf.model_specs(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(specs, gen, dev, dtype=tf.serving_dtype(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       _leaves(params))
    rng = np.random.default_rng(0)
    lengths = rng.integers(256, 3073, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    reqs = [serve.Request(uid=i, prompt=p, max_new_tokens=SERVE_NEW_TOKENS,
                          submitted_at=0.0) for i, p in enumerate(prompts)]
    eng = serve.ServeEngine(cfg, params, serve.EngineConfig(
        num_slots=SERVE_SLOTS, cache_len=SERVE_CACHE), device=dev)

    def reset_counts():
        flash.launches = 0
        rglru.launches = rglru.chunked_launches = 0

    metrics, wall, prefill_ms, step_ms, peak = _drive_engine(
        torch, eng, reqs, reset_counts)
    launches = {"flash_attention": flash.launches,
                "rglru_ring": rglru.launches - rglru.chunked_launches,
                "rglru_chunked": rglru.chunked_launches}
    bad = [r.uid for r in reqs if len(r.tokens) != SERVE_NEW_TOKENS
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    if bad or metrics["requests"] != SERVE_REQUESTS:
        raise SystemExit(f"serve main: malformed outputs for {bad}")
    if min(launches.values()) == 0:
        raise SystemExit(f"serve main ran without launching a kernel: "
                         f"{launches}")

    longest = int(np.argmax(lengths))
    smi, decode_window, prefill_window = _serve_windows(
        torch, eng, params, cfg, prompts, longest)
    # Self-consistency at full width: prefill a prompt past the window,
    # decode 8 tokens, and hold the logits to teacher forcing.
    consistency = _teacher_forcing(torch, np, tf, params, cfg,
                                   prompts[longest], rng)
    steps = np.asarray(step_ms)
    line = {"phase": "serve_main", "arch": cfg.name,
            "layers": cfg.num_layers, "params": count_params(specs),
            "weight_bytes": weight_bytes, "param_init_s": init_s,
            "num_slots": SERVE_SLOTS, "cache_len": SERVE_CACHE,
            "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW_TOKENS,
            "prompt_tokens": int(lengths.sum()),
            "prompts_past_window": int((lengths > cfg.sliding_window).sum()),
            "run_server": metrics, "wall_s": wall,
            "prefill_ms_by_prompt_len": sorted(prefill_ms),
            "decode_steps": len(step_ms),
            "decode_step_ms_median": float(np.median(steps)),
            "decode_step_ms_p99": float(np.percentile(steps, 99)),
            "decode_step_ms_max": float(steps.max()),
            "peak_device_bytes": peak, "launches": launches,
            "nvidia_smi_clocks_power": smi,
            "decode_window": decode_window, "prefill_window": prefill_window,
            "consistency": consistency}
    emit(line)
    if not consistency["within_limit"]:
        raise SystemExit("serve main: decode logits disagree with teacher "
                         "forcing at full width")
    return line


def _serve_windows(torch, eng, params, cfg, prompts, longest, inputs=None):
    """Profiled windows: 8 decode steps with every slot busy (each slot
    admitted with the first 256 tokens of a prompt), and one prefill of
    the longest prompt (with the modality ``inputs``, (1, ...) each); and
    the card's clocks and power beside them."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine as serve
    for i in range(SERVE_SLOTS):
        eng.admit(serve.Request(uid=100 + i, prompt=prompts[i][:256],
                                max_new_tokens=SERVE_NEW_TOKENS))
    eng.step()
    smi = _smi_clocks()
    decode_window = _profiled(torch, lambda: [eng.step() for _ in range(8)])
    decode_window["steps"] = 8
    tokens = torch.as_tensor(prompts[longest], dtype=torch.int64,
                             device=params["embed"].device)[None]
    prefill_window = _profiled(
        torch, lambda: tf.prefill(params, {"tokens": tokens,
                                           **(inputs or {})}, cfg,
                                  eng.ecfg.cache_len))
    prefill_window["prompt_tokens"] = len(prompts[longest])
    return smi, decode_window, prefill_window


def _drive_engine(torch, eng, reqs, reset_counts):
    """``run_server`` over ``reqs`` with each ``admit`` (a prefill) and
    ``step`` timed on the host clock (each ends in a host read); the
    kernels' counts are set to 0 by ``reset_counts`` just before.
    Returns (metrics, wall s, [(prompt tokens, prefill ms)], [step ms],
    peak device bytes)."""
    from repro_torch.serve import engine as serve
    prefill_ms, step_ms = [], []
    admit, step = eng.admit, eng.step

    def timed_admit(req):
        t = time.perf_counter()
        ok = admit(req)
        if ok:
            prefill_ms.append((len(req.prompt),
                               (time.perf_counter() - t) * 1e3))
        return ok

    def timed_step():
        t = time.perf_counter()
        out = step()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng.admit, eng.step = timed_admit, timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = serve.run_server(eng, reqs, log=lambda s: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del eng.admit, eng.step           # the class's methods again, no cycle
    return metrics, wall, prefill_ms, step_ms, peak


def _teacher_forcing(torch, np, tf, params, cfg, prompt, rng, K=8,
                     multiple=1, rel=SERVE_CONSISTENCY_REL, extra=0.0,
                     inputs=None):
    """Prefill ``prompt``, decode K - 1 tokens, and hold the K logit rows
    to ``forward_train`` over the prompt and the decoded tokens, padded
    with more random tokens to a length that is a multiple of
    ``multiple`` (the mLSTM cell's chunk): the largest error against
    ``rel`` of the largest logit plus ``extra``, and argmax agreement.
    ``inputs``: the modality inputs, (1, ...) each, which both read
    (patches ahead of the tokens shift forward_train's rows)."""
    dev = params["embed"].device
    inputs = inputs or {}
    prefix = inputs["pixel_embeds"].shape[1] if "pixel_embeds" in inputs \
        else 0
    P = len(prompt)
    n_full = -(-(P + K - 1) // multiple) * multiple
    seq = torch.as_tensor(np.concatenate([prompt, rng.integers(
        0, cfg.vocab_size, max(K, n_full - P)).astype(np.int32)]),
        dtype=torch.int64, device=dev)[None]
    lg, st = tf.prefill(params, {"tokens": seq[:, :P], **inputs}, cfg,
                        SERVE_CACHE)
    dec = [lg]
    for i in range(P, P + K - 1):
        lg, st = tf.decode_step(params, seq[:, i:i + 1], st, cfg)
        dec.append(lg)
    del st
    full, _ = tf.forward_train(params, {"tokens": seq[:, :n_full], **inputs},
                               cfg)
    want = full[0, prefix + P - 1:prefix + P + K - 1].float()
    del full
    return _against_teacher(cfg, torch.cat(dec).float(), want, P, n_full,
                            rel * float(want.abs().max()) + extra)


def _against_teacher(cfg, got, want, P, n_full, limit) -> dict:
    """K decoded logit rows (the prefill's, then K - 1 decode steps')
    against forward_train's rows at the same positions: the largest
    error against ``limit``, and argmax agreement."""
    K = got.shape[0]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    argmax_agree = int((got[:, :cfg.vocab_size].argmax(-1)
                        == want[:, :cfg.vocab_size].argmax(-1)).sum())
    return {"prompt_tokens": P, "decode_steps": K - 1,
            "teacher_forcing_tokens": n_full, "max_abs_err": err,
            "max_abs_logit": scale, "limit_rel": limit / scale,
            "limit": limit, "argmax_agree": argmax_agree, "of": K,
            "within_limit": err <= limit}



XLSTM_GOLDEN = ROOT / "tests" / "data" / "torch_xlstm_serve_golden" / \
    "expected.npz"
XLSTM_CHUNK = 64       # the mLSTM cell's chunk: prompts of 64 or more
                       # tokens are multiples of it


def phase_xlstm_golden(torch, np, dev) -> dict:
    """The fixture ``tests/data/torch_xlstm_serve_golden`` (a float32
    xLSTM-125M twin at full width, 8 layers, parameters redrawn from the
    fixture's seed and checked by digest; JAX's prefill and decode logits
    and greedy engine tokens): the port on the card through the mLSTM
    block kernel at dk 384 reproduces them (a float32 call never takes
    the parallel kernel)."""
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    from repro_torch.serve import golden
    with np.load(XLSTM_GOLDEN, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    t0 = time.perf_counter()
    before = (mlstm.launches, mlstm.row_launches, mlstm.parallel_launches)
    report = golden.replay(golden.XLSTM, fx, dev)
    rows = mlstm.row_launches - before[1]
    parallel = mlstm.parallel_launches - before[2]
    block = mlstm.launches - before[0] - rows - parallel
    line = {"phase": "xlstm_golden", "layers": golden.XLSTM.layers,
            **report,
            "mlstm_block_launches": block, "mlstm_row_launches": rows,
            "mlstm_parallel_launches": parallel,
            "seconds": time.perf_counter() - t0}
    emit(line)
    if not report["ok"] or block == 0:
        raise SystemExit("xlstm golden: the port on the card does not "
                         "reproduce the JAX fixture through the mLSTM "
                         "kernel")
    return line


def phase_xlstm_serve_main(torch, np, dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    from repro_torch.models import transformer as tf
    from repro_torch.models import xlstm
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serve import engine as serve
    cfg = dataclasses.replace(get_config("xlstm-125m"),
                              num_layers=SERVE_CUT_LAYERS["xlstm-125m"])
    specs = tf.model_specs(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(specs, gen, dev, dtype=tf.serving_dtype(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       _leaves(params))
    rng = np.random.default_rng(0)
    lengths = XLSTM_CHUNK * rng.integers(4, 49, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    reqs = [serve.Request(uid=i, prompt=p, max_new_tokens=SERVE_NEW_TOKENS,
                          submitted_at=0.0) for i, p in enumerate(prompts)]
    eng = serve.ServeEngine(cfg, params, serve.EngineConfig(
        num_slots=SERVE_SLOTS, cache_len=SERVE_CACHE), device=dev)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(eng.states))

    def reset_counts():
        mlstm.launches = mlstm.row_launches = mlstm.parallel_launches = 0

    metrics, wall, prefill_ms, step_ms, peak = _drive_engine(
        torch, eng, reqs, reset_counts)
    launches = {"mlstm_parallel": mlstm.parallel_launches,
                "mlstm_chunkwise": mlstm.launches - mlstm.row_launches
                - mlstm.parallel_launches,
                "mlstm_rows": mlstm.row_launches}
    bad = [r.uid for r in reqs if len(r.tokens) != SERVE_NEW_TOKENS
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    if bad or metrics["requests"] != SERVE_REQUESTS:
        raise SystemExit(f"xlstm serve main: malformed outputs for {bad}")
    if launches["mlstm_parallel"] == 0 or launches["mlstm_chunkwise"] or \
            launches["mlstm_rows"]:
        raise SystemExit(f"xlstm serve main: every mLSTM prefill call must "
                         f"take the parallel kernel: {launches}")
    longest = int(np.argmax(lengths))
    smi, decode_window, prefill_window = _serve_windows(
        torch, eng, params, cfg, prompts, longest)

    # One sLSTM layer's prefill walk (the eager time loop) at the longest
    # prompt's length, on the host clock around a synchronised call.
    seg = cfg.layer_plan()[0]
    j = next(j for j, b in enumerate(seg.blocks) if b.mixer == "slstm")
    p_slstm = tf._segment_layers(seg, params["segments"][0])[0][
        f"block{j}"]["mixer"]
    x = torch.randn((1, int(lengths[longest]), cfg.d_model), generator=gen,
                    device=dev).to(getattr(torch, cfg.dtype))
    walk_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        xlstm.slstm_prefill(p_slstm, x, cfg)
        torch.cuda.synchronize()
        walk_ms.append((time.perf_counter() - t) * 1e3)
    del x

    consistency = _teacher_forcing(torch, np, tf, params, cfg,
                                   prompts[longest], rng,
                                   multiple=XLSTM_CHUNK)
    steps = np.asarray(step_ms)
    line = {"phase": "xlstm_serve_main", "arch": cfg.name,
            "layers": cfg.num_layers, "params": count_params(specs),
            "weight_bytes": weight_bytes, "param_init_s": init_s,
            "num_slots": SERVE_SLOTS, "cache_len": SERVE_CACHE,
            "decode_state_bytes": state_bytes,
            "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW_TOKENS,
            "prompt_tokens": int(lengths.sum()),
            "run_server": metrics, "wall_s": wall,
            "prefill_ms_by_prompt_len": sorted(prefill_ms),
            "decode_steps": len(step_ms),
            "decode_step_ms_median": float(np.median(steps)),
            "decode_step_ms_p99": float(np.percentile(steps, 99)),
            "decode_step_ms_max": float(steps.max()),
            "peak_device_bytes": peak, "launches": launches,
            "slstm_layer_prefill_ms": {"prompt_tokens": int(lengths[longest]),
                                       "cold": walk_ms[0],
                                       "warm": walk_ms[1]},
            "nvidia_smi_clocks_power": smi,
            "decode_window": decode_window, "prefill_window": prefill_window,
            "consistency": consistency}
    emit(line)
    if not consistency["within_limit"]:
        raise SystemExit("xlstm serve main: decode logits disagree with "
                         "teacher forcing at full width")
    return line


MOE_GOLDEN = ROOT / "tests" / "data" / "torch_moe_serve_golden" / \
    "expected.npz"
# The DeepSeekMoE-16B cell's prompt lengths, drawn from seed 0: at most
# one group (512 tokens) or a whole number of groups, as the reference's
# apply_moe takes them.
MOE_PROMPT_LENS = (128, 256, 384, 512, 1024, 1536, 2048, 2560, 3072)
MOE_PREFILL_TIMED = (512, 1024, 2048, 3072)
# Teacher forcing of the MoE cells at a capacity no group overflows, as
# the reference's own consistency test (tests/test_models_consistency.py):
# at T = 1 a decode step drops nothing, a full sequence at 1.25 would.
MOE_CONSISTENCY_CF = 8.0
MOE_TF_PROMPT = 3072
GRANITE_TF_PROMPT = 1024
GRANITE_REQS = ((64, 16), (512, 16), (1024, 16), (37, 16))


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _init_model(torch, cfg, dev, seed=0):
    """bf16 serving weights drawn from ``seed`` on the card: (params,
    seconds, weight bytes, peak device bytes of the draw)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import init_params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(tf.model_specs(cfg), gen, dev,
                         dtype=tf.serving_dtype(cfg))
    torch.cuda.synchronize()
    return (params, time.perf_counter() - t0,
            sum(t.numel() * t.element_size() for t in _leaves(params)),
            torch.cuda.max_memory_allocated())


def phase_moe_golden(torch, np, dev) -> dict:
    """The fixture ``tests/data/torch_moe_serve_golden`` (a float32
    DeepSeekMoE-16B twin at full width cut to 3 layers, its parameters
    redrawn from the fixture's seed and checked by digest; JAX's chosen
    experts, prefill and decode logits and greedy engine tokens): the
    port on the card through the flash kernel (float32) reproduces
    them."""
    from unittest import mock
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import moe
    from repro_torch.serve import golden
    with np.load(MOE_GOLDEN, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    allocated = _free(torch)
    t0 = time.perf_counter()
    before = flash.launches
    seen, route = [], moe.route

    def recording(p, xg, cfg):
        seen.append(route(p, xg, cfg))
        return seen[-1]
    with mock.patch.object(moe, "route", recording):
        report = golden.replay(golden.MOE, fx, dev)
    report.update(golden.routing_report(golden.MOE, fx, seen))
    del seen
    line = {"phase": "moe_golden", "arch": golden.MOE.arch,
            "layers": golden.MOE.layers, "prefill_tokens": golden.MOE.prefill,
            **report, "routing_min_gap": float(fx["routing_min_gap"]),
            "flash_launches": flash.launches - before,
            "allocated_before_bytes": allocated,
            "seconds": time.perf_counter() - t0}
    emit(line)
    if not (report["ok"] and report["routing_equal"]) or \
            line["flash_launches"] == 0:
        raise SystemExit("moe golden: the port on the card does not "
                         "reproduce the JAX fixture through the flash "
                         "kernel")
    return line


def _timed_prefills(torch, tf, params, cfg, rng, lengths, inputs=None):
    """Prefill ms at each length (B = 1, a random prompt, with the
    modality ``inputs``), on the host clock around synchronised calls:
    (cold, warm) each."""
    out = {}
    dev = params["embed"].device
    for n in lengths:
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                                 dtype=torch.int64, device=dev)[None]
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tf.prefill(params, {"tokens": tokens, **(inputs or {})}, cfg,
                       SERVE_CACHE)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out[n] = {"cold": ms[0], "warm": ms[1]}
    return out


def phase_moe_serve_main(torch, np, dev) -> dict:
    """DeepSeekMoE-16B at its published widths cut to
    ``SERVE_CUT_LAYERS`` of its 28 layers (the dense first layer and 6
    MoE layers) behind the engine: 16 requests at t = 0 of 64 new tokens
    each."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import count_params
    from repro_torch.serve import engine as serve
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              num_layers=SERVE_CUT_LAYERS["deepseek-moe-16b"])
    allocated = _free(torch)
    params, init_s, weight_bytes, init_peak = _init_model(torch, cfg, dev)
    rng = np.random.default_rng(0)
    lengths = rng.choice(MOE_PROMPT_LENS, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    reqs = [serve.Request(uid=i, prompt=p, max_new_tokens=SERVE_NEW_TOKENS,
                          submitted_at=0.0) for i, p in enumerate(prompts)]
    eng = serve.ServeEngine(cfg, params, serve.EngineConfig(
        num_slots=SERVE_SLOTS, cache_len=SERVE_CACHE), device=dev)
    kv_bytes = sum(t.numel() * t.element_size() for t in _leaves(eng.states))

    def reset_counts():
        flash.launches = 0

    metrics, wall, prefill_ms, step_ms, peak = _drive_engine(
        torch, eng, reqs, reset_counts)
    launches = {"flash_attention": flash.launches}
    bad = [r.uid for r in reqs if len(r.tokens) != SERVE_NEW_TOKENS
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    if bad or metrics["requests"] != SERVE_REQUESTS:
        raise SystemExit(f"moe serve main: malformed outputs for {bad}")
    if launches["flash_attention"] != cfg.num_layers * SERVE_REQUESTS:
        raise SystemExit(f"moe serve main: {launches} flash launches, not "
                         f"{cfg.num_layers} a prefill")
    longest = int(np.argmax(lengths))
    smi, decode_window, prefill_window = _serve_windows(
        torch, eng, params, cfg, prompts, longest)
    del eng
    _free(torch)
    prefill_timed = _timed_prefills(torch, tf, params, cfg, rng,
                                    MOE_PREFILL_TIMED)
    consistency = _teacher_forcing(
        torch, np, tf, params,
        dataclasses.replace(cfg, capacity_factor=MOE_CONSISTENCY_CF),
        rng.integers(0, cfg.vocab_size, MOE_TF_PROMPT).astype(np.int32),
        rng, multiple=512)
    consistency["capacity_factor"] = MOE_CONSISTENCY_CF
    steps = np.asarray(step_ms)
    line = {"phase": "moe_serve_main", "arch": cfg.name,
            "layers": cfg.num_layers, "params": count_params(
                tf.model_specs(cfg)),
            "weight_bytes": weight_bytes, "param_init_s": init_s,
            "param_init_peak_device_bytes": init_peak,
            "allocated_before_bytes": allocated,
            "num_slots": SERVE_SLOTS, "cache_len": SERVE_CACHE,
            "kv_cache_bytes": kv_bytes,
            "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW_TOKENS,
            "prompt_lens": [int(n) for n in lengths],
            "prompt_tokens": int(lengths.sum()),
            "run_server": metrics, "wall_s": wall,
            "prefill_ms_by_prompt_len": sorted(prefill_ms),
            "prefill_ms_timed": prefill_timed,
            "decode_steps": len(step_ms),
            "decode_step_ms_median": float(np.median(steps)),
            "decode_step_ms_p99": float(np.percentile(steps, 99)),
            "decode_step_ms_max": float(steps.max()),
            "peak_device_bytes": peak, "launches": launches,
            "flash_launches_per_prefill": launches["flash_attention"]
            / SERVE_REQUESTS,
            "nvidia_smi_clocks_power": smi,
            "decode_window": decode_window, "prefill_window": prefill_window,
            "consistency": consistency}
    emit(line)
    del params
    _free(torch)
    if not consistency["within_limit"]:
        raise SystemExit("moe serve main: decode logits disagree with "
                         "teacher forcing at full width")
    return line


def phase_granite(torch, np, dev) -> dict:
    """Granite-3.0-1B-A400M at its published widths and depth (GQA 16/8,
    top-8 of 32, tied embeddings, vocab 49155 padded to 49664): prefill +
    8 decode steps against teacher forcing, and one short run_server."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import count_params
    from repro_torch.serve import engine as serve
    cfg = get_config("granite-moe-1b-a400m")
    allocated = _free(torch)
    params, init_s, weight_bytes, _ = _init_model(torch, cfg, dev)
    rng = np.random.default_rng(0)
    consistency = _teacher_forcing(
        torch, np, tf, params,
        dataclasses.replace(cfg, capacity_factor=MOE_CONSISTENCY_CF),
        rng.integers(0, cfg.vocab_size, GRANITE_TF_PROMPT).astype(np.int32),
        rng, multiple=512)
    consistency["capacity_factor"] = MOE_CONSISTENCY_CF
    reqs = [serve.Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=new)
        for i, (n, new) in enumerate(GRANITE_REQS)]
    eng = serve.ServeEngine(cfg, params, serve.EngineConfig(
        num_slots=4, cache_len=2048), device=dev)
    before = flash.launches
    t0 = time.perf_counter()
    metrics = serve.run_server(eng, reqs, log=lambda s: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = flash.launches - before
    ok_tokens = all(len(r.tokens) == new and
                    all(0 <= t < cfg.vocab_size for t in r.tokens)
                    for r, (_, new) in zip(reqs, GRANITE_REQS))
    line = {"phase": "granite", "arch": cfg.name, "layers": cfg.num_layers,
            "params": count_params(tf.model_specs(cfg)),
            "weight_bytes": weight_bytes, "param_init_s": init_s,
            "allocated_before_bytes": allocated,
            "consistency": consistency, "run_server": metrics,
            "wall_s": wall, "flash_launches": launched,
            "tokens_ok": ok_tokens}
    emit(line)
    del eng, params
    _free(torch)
    if not (consistency["within_limit"] and ok_tokens) or \
            launched != cfg.num_layers * len(GRANITE_REQS):
        raise SystemExit("granite: decode disagrees with teacher forcing, "
                         "malformed tokens, or flash did not run in every "
                         "prefill")
    return line


DENSE_GOLDEN = ROOT / "tests" / "data" / "torch_dense_serve_golden" / \
    "expected.npz"
COMMAND_R_PREFILL_TIMED = (512, 1024, 2048, 3072)
COMMAND_R_TF_PROMPT = 3072
# Qwen1.5-32B at full width cut to 8 of its 64 layers (5.76 G parameters,
# 11.5 GB of bf16 weights); its full depth (70.39 GB) leaves no room on
# one card for a useful cache.
QWEN_LAYERS = 8
QWEN_TF_PROMPT = 3072
QWEN_EQUAL_PROMPT = 3072
QWEN_REQS = ((64, 16), (512, 16), (1024, 16), (3072, 16))
# The int8 cache holds each k, v element within half a quantisation step
# of the value it replaces: 1/254 of the largest |value| of its row (the
# float16 scale adds at most 2^-11 of that).
KV_QUANT_HALF_STEP = 1 / 254


def phase_dense_golden(torch, np, dev) -> dict:
    """The fixture ``tests/data/torch_dense_serve_golden`` (a float32
    Command-R-35B twin at full width cut to 2 layers, its parameters
    redrawn from the fixture's seed and checked by digest; JAX's logits of
    a 512-token prefill and 8 decode steps, and its greedy engine tokens):
    the port on the card through the flash kernel (float32, GQA 64/8)
    reproduces them, flash launched in every prefill."""
    from repro_torch.serve import golden
    return _serve_golden(torch, np, dev, "dense_golden", golden.DENSE,
                         DENSE_GOLDEN)


def _check_init_peak(torch, name, init_peak) -> int:
    total = torch.cuda.get_device_properties(0).total_memory
    if init_peak >= total:
        raise SystemExit(f"{name}: drawing the weights peaked at "
                         f"{init_peak} B, not below the card's {total} B")
    return total


def phase_command_r_serve_main(torch, np, dev) -> dict:
    """Command-R-35B at its published widths cut to ``SERVE_CUT_LAYERS``
    of its 40 layers (parallel blocks, GQA 64/8) behind the engine: 16
    requests at t = 0 of 256-3072 tokens and 64 new tokens each, the
    RecurrentGemma cell's burst."""
    return _serve_cell(torch, np, dev, "command_r_serve_main",
                       "command-r-35b", (256, 3072), SERVE_CACHE,
                       COMMAND_R_PREFILL_TIMED, COMMAND_R_TF_PROMPT,
                       overrides={"num_layers": SERVE_CUT_LAYERS[
                           "command-r-35b"]})


def _padded_equals_unpadded(torch, np, tf, layers, params, cfg, prompt):
    """Qwen's prefill with its heads padded 40 -> 48 against the same
    prefill unpadded: the first layer's attention core on its real heads,
    the last-position logits and every cache, each ``torch.equal``."""
    import dataclasses
    unpadded = dataclasses.replace(cfg, pad_heads_to=0)
    dev = params["embed"].device
    tokens = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    seg = params["segments"][0]["block0"]
    layer0 = {k: v[0] for k, v in seg["mixer"].items()}
    x = params["embed"][tokens].to(getattr(torch, cfg.dtype))
    h = layers.apply_norm({k: v[0] for k, v in seg["norm1"].items()}, x, cfg)
    pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                       device=dev)[None]
    q, k, v = layers._project_qkv(layer0, h, cfg, pos, True)
    core = [layers.attention_from_qkv(q, k, v, pad_heads_to=n)
            for n in (cfg.pad_heads_to, 0)]
    runs = [tf.prefill(params, {"tokens": tokens}, c, SERVE_CACHE)
            for c in (cfg, unpadded)]
    (lp, sp), (lu, su) = runs
    states_equal = all(torch.equal(a, b) for a, b in zip(_leaves(sp),
                                                         _leaves(su)))
    return {"prompt_tokens": len(prompt),
            "core_real_heads_equal": torch.equal(*core),
            "core_max_abs_err": float((core[0].float()
                                       - core[1].float()).abs().max()),
            "logits_equal": torch.equal(lp, lu),
            "states_equal": states_equal}


def _caches(states):
    """The attention caches (dicts holding "k") of a decode state tree."""
    return [st for seg in states for st in seg.values() if "k" in st]


def _half_step_off(torch, states, P, gen) -> None:
    """Move every written k, v element (positions < P) of an unquantised
    cache by KV_QUANT_HALF_STEP of its row's largest |value|, a random
    sign each."""
    for st in _caches(states):
        for name in ("k", "v"):
            x = st[name][..., :P, :].float()
            amax = x.abs().amax(-1, keepdim=True)
            sign = torch.randint(0, 2, x.shape, generator=gen,
                                 device=x.device, dtype=torch.float32)
            x += (2 * sign - 1) * amax * KV_QUANT_HALF_STEP
            st[name][..., :P, :] = x.to(st[name].dtype)


def _kv_quant_consistency(torch, np, tf, layers, params, cfg, prompt, rng,
                          K=8) -> dict:
    """Prefill ``prompt`` into an unquantised cache and, with
    ``kv_quant``, into an int8 one, and decode the same K - 1 tokens from
    each.  Run on float32 activations, so that no rounding of the
    residual stream blurs the comparison (in bfloat16 a perturbation
    this small flips roundings, and the two errors meet at that floor).

    The int8 decode's largest logit error against the unquantised decode
    is the quantisation's alone.  Its limit is the error of the
    unquantised cache with every written element moved by half an int8
    step (:func:`_half_step_off`): the quantiser's largest error on
    every element, where its own errors spread evenly below it (RMS
    1/sqrt(3) of that).  Two planted faults in the int8 cache,
    ``v_scale`` zeroed and ``k_scale`` 1 (a scale left unapplied), go
    through the same comparison and must exceed the limit.  The int8
    prefill must write ``quantize_kv`` of the unquantised cache, its
    logits ``==``."""
    import dataclasses
    from repro_torch.models.params import map_tree
    quant = dataclasses.replace(cfg, kv_quant=True)
    dev = params["embed"].device
    P = len(prompt)
    seq = torch.as_tensor(np.concatenate([prompt, rng.integers(
        0, cfg.vocab_size, K - 1).astype(np.int32)]), dtype=torch.int64,
        device=dev)[None]
    first, plain = tf.prefill(params, {"tokens": seq[:, :P]}, cfg,
                              SERVE_CACHE)
    first_q, q8 = tf.prefill(params, {"tokens": seq[:, :P]}, quant,
                             SERVE_CACHE)
    prefill_equal = torch.equal(first, first_q)
    for b, c in zip(_caches(plain), _caches(q8)):
        for name in ("k", "v"):
            payload, scale = layers.quantize_kv(b[name][..., :P, :])
            prefill_equal &= (torch.equal(payload, c[name][..., :P, :]) and
                              torch.equal(scale, c[f"{name}_scale"][..., :P]))

    def clone(states):
        return map_tree(lambda _, t: t.clone(), states)

    half = clone(plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    _half_step_off(torch, half, P, gen)
    faults = {"v_scale_zeroed": ("v_scale", 0.0),
              "k_scale_unapplied": ("k_scale", 1.0)}
    faulty = {}
    for fault, (name, value) in faults.items():
        faulty[fault] = clone(q8)
        for c in _caches(faulty[fault]):
            c[name][..., :P] = value

    def decode(states, c):
        rows = []
        for i in range(P, P + K - 1):
            lg, states = tf.decode_step(params, seq[:, i:i + 1], states, c)
            rows.append(lg)
        return torch.cat(rows).float()

    runs = {"unquantised": decode(plain, cfg), "int8": decode(q8, quant),
            "half_step": decode(half, cfg),
            **{f: decode(st, quant) for f, st in faulty.items()}}
    del plain, q8, half, faulty
    diff = {name: rows - runs["unquantised"] for name, rows in runs.items()}
    err = {name: float(d.abs().max()) for name, d in diff.items()}
    rms = {name: float(d.pow(2).mean().sqrt()) for name, d in diff.items()}
    limit = err["half_step"]
    return {"dtype": cfg.dtype, "prompt_tokens": P, "decode_steps": K - 1,
            "half_step_rel": KV_QUANT_HALF_STEP,
            "max_abs_err": err["int8"], "limit": limit,
            "max_abs_logit": float(runs["unquantised"].abs().max()),
            "rms_err": rms["int8"], "half_step_rms_err": rms["half_step"],
            "within_limit": err["int8"] <= limit,
            "faults": {f: err[f] for f in faults},
            "faults_exceed_limit": all(err[f] > limit for f in faults),
            "prefill_equal": prefill_equal}


def phase_qwen_check(torch, np, dev) -> dict:
    """Qwen1.5-32B at full width (40 heads of 128 padded to 48 in prefill,
    QKV bias, d_ff 27392, vocab 152064) cut to QWEN_LAYERS layers: the
    int8 cache's decode against an unquantised cache's on float32
    activations (:func:`_kv_quant_consistency`), the bf16 serving path's
    decode from either cache against teacher forcing; the padded prefill
    ``==`` the unpadded one on the real heads; flash timed at 48 and at
    40 heads; a short run_server on the int8 cache, flash counted from 0
    just before it and required once a layer a prefill."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import count_params, map_tree
    from repro_torch.serve import engine as serve
    cfg = dataclasses.replace(get_config("qwen1.5-32b"),
                              num_layers=QWEN_LAYERS)
    quant = dataclasses.replace(cfg, kv_quant=True)
    allocated = _free(torch)
    params, init_s, weight_bytes, init_peak = _init_model(torch, cfg, dev)
    _check_init_peak(torch, "qwen check", init_peak)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, QWEN_TF_PROMPT).astype(np.int32)
    # the int8 cache against an unquantised one, on float32 activations
    # over the same (bfloat16-valued) weights
    int8 = _kv_quant_consistency(
        torch, np, tf, layers, map_tree(lambda _, t: t.float(), params),
        dataclasses.replace(cfg, dtype="float32"), prompt,
        np.random.default_rng(1))
    _free(torch)
    # the serving path against teacher forcing; the int8 cache may add
    # what the quantisation moved the float32 logits by (int8's limit)
    consistency = {
        "bfloat16_cache": _teacher_forcing(torch, np, tf, params, cfg,
                                           prompt, np.random.default_rng(1)),
        "int8_cache": _teacher_forcing(torch, np, tf, params, quant, prompt,
                                       np.random.default_rng(1),
                                       extra=int8["limit"]),
        "int8_against_unquantised_float32": int8}
    padding = _padded_equals_unpadded(
        torch, np, tf, layers, params, cfg,
        rng.integers(0, cfg.vocab_size, QWEN_EQUAL_PROMPT).astype(np.int32))
    _free(torch)
    flash_by_heads = {}
    for heads in (cfg.pad_heads_to, cfg.num_heads):
        case = (1, heads, heads, 3072, 3072, cfg.head_dim_, True, 0)
        flash_by_heads[heads] = _flash_shape_line(
            case, _flash_timed(torch, np, flash, dev, case), None)
    padding_cost = (flash_by_heads[cfg.pad_heads_to]["kernel_ms"]
                    / flash_by_heads[cfg.num_heads]["kernel_ms"])
    kv_bytes = {name: sum(t.numel() * t.element_size() for t in _leaves(
        tf.init_decode_state(c, SERVE_SLOTS, SERVE_CACHE,
                             dtype=torch.bfloat16, device="meta")))
        for name, c in (("bfloat16", cfg), ("int8", quant))}
    reqs = [serve.Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=new)
        for i, (n, new) in enumerate(QWEN_REQS)]
    eng = serve.ServeEngine(quant, params, serve.EngineConfig(
        num_slots=SERVE_SLOTS, cache_len=SERVE_CACHE), device=dev)
    engine_kv = sum(t.numel() * t.element_size() for t in _leaves(eng.states))
    flash.launches = 0
    t0 = time.perf_counter()
    metrics = serve.run_server(eng, reqs, log=lambda s: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = flash.launches
    ok_tokens = all(len(r.tokens) == new and
                    all(0 <= t < cfg.vocab_size for t in r.tokens)
                    for r, (_, new) in zip(reqs, QWEN_REQS))
    line = {"phase": "qwen_check", "arch": cfg.name, "layers": QWEN_LAYERS,
            "published_layers": get_config("qwen1.5-32b").num_layers,
            "params": count_params(tf.model_specs(cfg)),
            "weight_bytes": weight_bytes, "param_init_s": init_s,
            "param_init_peak_device_bytes": init_peak,
            "allocated_before_bytes": allocated,
            "pad_heads_to": cfg.pad_heads_to, "num_heads": cfg.num_heads,
            "consistency": consistency, "padding": padding,
            "flash_by_heads": flash_by_heads,
            "flash_padded_over_unpadded": padding_cost,
            "kv_cache_bytes": kv_bytes, "engine_kv_cache_bytes": engine_kv,
            "run_server_int8": metrics, "wall_s": wall,
            "tokens_ok": ok_tokens, "flash_launches": launched,
            "flash_launches_expected": QWEN_LAYERS * len(QWEN_REQS)}
    emit(line)
    del eng, params
    _free(torch)
    checks = (all(consistency[c]["within_limit"] for c in consistency)
              and int8["faults_exceed_limit"]
              and int8["prefill_equal"]
              and padding["core_real_heads_equal"]
              and padding["logits_equal"] and padding["states_equal"]
              and ok_tokens and engine_kv == kv_bytes["int8"]
              and launched == QWEN_LAYERS * len(QWEN_REQS))
    if not checks:
        raise SystemExit("qwen check: teacher forcing, the int8 decode "
                         "against the unquantised one or its planted "
                         "faults, the "
                         "padding's equality, the int8 engine or its flash "
                         "launches (one a layer a prefill) failed")
    return line


WHISPER_GOLDEN = ROOT / "tests" / "data" / "torch_whisper_serve_golden" / \
    "expected.npz"
VLM_GOLDEN = ROOT / "tests" / "data" / "torch_vlm_serve_golden" / \
    "expected.npz"
# Whisper-medium's serve cell: prompts of 4-384 tokens and 64 new ones
# in Whisper's decoder context of 448 positions.
WHISPER_PROMPT = (4, 384)
WHISPER_CACHE = 448
WHISPER_PREFILL_TIMED = (4, 64, 384)
# InternVL2-26B's serve cell: prompts of 16-2000 tokens after the 1024
# patches; teacher forcing over 3072 positions (the patches and 2048
# tokens).
INTERNVL_PROMPT = (16, 2000)
INTERNVL_PREFILL_TIMED = (16, 512, 2048)
INTERNVL_TF_PROMPT = 2048


def _serve_golden(torch, np, dev, phase, fixture, path) -> dict:
    """A float32 serve fixture replayed on the card
    (``repro_torch.serve.golden.replay``), flash launched
    :func:`_flash_per_prefill` times in each of its prefills (counted
    from 0 just before the replay)."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.serve import golden
    with np.load(path, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    allocated = _free(torch)
    t0 = time.perf_counter()
    per_prefill = _flash_per_prefill(golden.config(fixture))
    flash.launches = 0
    report = golden.replay(fixture, fx, dev)
    launched = flash.launches
    want = per_prefill * (1 + len(fixture.requests))
    line = {"phase": phase, "arch": fixture.arch, "layers": fixture.layers,
            "overrides": dict(fixture.overrides),
            "prefill_tokens": fixture.prefill, **report,
            "flash_launches": launched, "flash_launches_expected": want,
            "allocated_before_bytes": allocated,
            "seconds": time.perf_counter() - t0}
    emit(line)
    if not report["ok"] or launched != want:
        raise SystemExit(f"{phase}: the port on the card does not "
                         "reproduce the JAX fixture, or flash did not run "
                         f"{per_prefill} times a prefill")
    return line


def phase_whisper_golden(torch, np, dev) -> dict:
    """The fixture ``tests/data/torch_whisper_serve_golden`` (a float32
    Whisper-medium twin at full width cut to 2 encoder + 2 decoder
    layers, the encoder over 1500 frames; parameters and frames redrawn
    from the fixture's seed and checked by digest): JAX's logits and
    greedy engine tokens through the float32 flash kernel, 3 launches a
    layer a prefill (encoder, decoder, cross)."""
    from repro_torch.serve import golden
    return _serve_golden(torch, np, dev, "whisper_golden", golden.WHISPER,
                         WHISPER_GOLDEN)


def phase_vlm_golden(torch, np, dev) -> dict:
    """The fixture ``tests/data/torch_vlm_serve_golden`` (a float32
    InternVL2-26B twin at full width cut to 2 layers and 256 patches):
    JAX's logits and greedy engine tokens through the float32 flash
    kernel (GQA 48/8), once a layer a prefill."""
    from repro_torch.serve import golden
    return _serve_golden(torch, np, dev, "vlm_golden", golden.VLM,
                         VLM_GOLDEN)


def _flash_per_prefill(cfg) -> int:
    """Flash launches a prefill of a prompt above one token: one a
    decoder layer, and with an encoder one a cross attention and one an
    encoder layer."""
    cross = cfg.num_layers if cfg.is_encoder_decoder else 0
    return cfg.num_layers + cross + cfg.encoder_layers


def _serve_cell(torch, np, dev, phase, arch, prompt_range, cache_len,
                timed, tf_prompt, overrides=None, n_requests=SERVE_REQUESTS,
                windows=True, check=None) -> dict:
    """``arch`` at its published widths and full depth (bf16 weights
    drawn on the card; its config's fields ``overrides`` replaced)
    behind the engine, with the serve CLI's modality input for every
    request where the arch has one: ``n_requests`` requests at t = 0 of
    ``prompt_range`` tokens and 64 new tokens each, flash required
    :func:`_flash_per_prefill` times a prefill (counted from 0 just
    before ``run_server``); profiled decode and prefill windows (unless
    not ``windows``); prefill ms timed at ``timed`` prompt lengths;
    decode against teacher forcing on a ``tf_prompt``-token prompt; and
    ``check(params, cfg, inputs, rng)``, a dict whose ``ok`` must hold,
    where given."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.serve import extra_inputs
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import count_params
    from repro_torch.serve import engine as serve
    cfg = dataclasses.replace(get_config(arch), **(overrides or {}))
    allocated = _free(torch)
    params, init_s, weight_bytes, init_peak = _init_model(torch, cfg, dev)
    total = _check_init_peak(torch, phase, init_peak)
    extra = extra_inputs(cfg)
    inputs = {k: torch.as_tensor(v)[None].to(dev) for k, v in extra.items()}
    rng = np.random.default_rng(0)
    lengths = rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    reqs = [serve.Request(uid=i, prompt=p, max_new_tokens=SERVE_NEW_TOKENS,
                          submitted_at=0.0) for i, p in enumerate(prompts)]
    eng = serve.ServeEngine(cfg, params, serve.EngineConfig(
        num_slots=SERVE_SLOTS, cache_len=cache_len), extra_inputs=extra,
        device=dev)
    kv_bytes = sum(t.numel() * t.element_size() for t in _leaves(eng.states))

    def reset_counts():
        flash.launches = 0

    per_prefill = _flash_per_prefill(cfg)
    metrics, wall, prefill_ms, step_ms, peak = _drive_engine(
        torch, eng, reqs, reset_counts)
    launches = {"flash_attention": flash.launches}
    bad = [r.uid for r in reqs if len(r.tokens) != SERVE_NEW_TOKENS
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    if bad or metrics["requests"] != n_requests:
        raise SystemExit(f"{phase}: malformed outputs for {bad}")
    if launches["flash_attention"] != per_prefill * n_requests:
        raise SystemExit(f"{phase}: {launches} flash launches, not "
                         f"{per_prefill} a prefill")
    longest = int(np.argmax(lengths))
    smi, decode_window, prefill_window = _serve_windows(
        torch, eng, params, cfg, prompts, longest, inputs) if windows else (
        _smi_clocks(), None, None)
    del eng
    _free(torch)
    prefill_timed = _timed_prefills(torch, tf, params, cfg, rng, timed,
                                    inputs)
    consistency = _teacher_forcing(
        torch, np, tf, params, cfg,
        rng.integers(0, cfg.vocab_size, tf_prompt).astype(np.int32), rng,
        inputs=inputs)
    checked = check(params, cfg, inputs, rng) if check else None
    steps = np.asarray(step_ms)
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers,
            "overrides": overrides or {},
            "modality_input": {k: list(v.shape) for k, v in extra.items()},
            "params": count_params(tf.model_specs(cfg)),
            "weight_bytes": weight_bytes, "param_init_s": init_s,
            "param_init_peak_device_bytes": init_peak,
            "device_total_bytes": total,
            "allocated_before_bytes": allocated,
            "num_slots": SERVE_SLOTS, "cache_len": cache_len,
            "kv_cache_bytes": kv_bytes,
            "requests": n_requests, "new_tokens": SERVE_NEW_TOKENS,
            "prompt_lens": [int(n) for n in lengths],
            "prompt_tokens": int(lengths.sum()),
            "run_server": metrics, "wall_s": wall,
            "prefill_ms_by_prompt_len": sorted(prefill_ms),
            "prefill_ms_timed": prefill_timed,
            "decode_steps": len(step_ms),
            "decode_step_ms_median": float(np.median(steps)),
            "decode_step_ms_p99": float(np.percentile(steps, 99)),
            "decode_step_ms_max": float(steps.max()),
            "peak_device_bytes": peak, "launches": launches,
            "flash_launches_per_prefill": launches["flash_attention"]
            / n_requests,
            "flash_launches_per_prefill_expected": per_prefill,
            "nvidia_smi_clocks_power": smi,
            "decode_window": decode_window, "prefill_window": prefill_window,
            "consistency": consistency, "check": checked}
    emit(line)
    del params, inputs
    _free(torch)
    if not consistency["within_limit"]:
        raise SystemExit(f"{phase}: decode logits disagree with teacher "
                         "forcing at full width")
    if checked is not None and not checked["ok"]:
        raise SystemExit(f"{phase}: its check failed: {checked}")
    return line


def phase_whisper_serve_main(torch, np, dev) -> dict:
    """Whisper-medium at its published widths and full depth (24 encoder
    + 24 decoder layers) behind the engine, one set of 1500 frames for
    every request: 72 flash launches a prefill (24 encoder, 24 decoder,
    24 cross)."""
    return _serve_cell(torch, np, dev, "whisper_serve_main",
                       "whisper-medium", WHISPER_PROMPT, WHISPER_CACHE,
                       WHISPER_PREFILL_TIMED, WHISPER_PROMPT[1])


def phase_internvl_serve_main(torch, np, dev) -> dict:
    """InternVL2-26B at its published widths cut to ``SERVE_CUT_LAYERS``
    of its 48 layers (GQA 48/8) behind the engine, one set of 1024
    patches for every request: one flash launch a layer a prefill."""
    return _serve_cell(torch, np, dev, "internvl_serve_main",
                       "internvl2-26b", INTERNVL_PROMPT, SERVE_CACHE,
                       INTERNVL_PREFILL_TIMED, INTERNVL_TF_PROMPT,
                       overrides={"num_layers": SERVE_CUT_LAYERS[
                           "internvl2-26b"]})


SOFTCAP_GOLDEN = ROOT / "tests" / "data" / "torch_softcap_serve_golden" / \
    "expected.npz"
# The soft-capped Whisper cell: 4 requests (not 16) to fit the script's
# time limit, and the prompt of the cap's check.
SOFTCAP_REQUESTS = 4
SOFTCAP_CHECK_PROMPT = 64


def phase_softcap_golden(torch, np, dev) -> dict:
    """The fixture ``tests/data/torch_softcap_serve_golden`` (the Whisper
    fixture's float32 twin, 2 + 2 layers at full width, with its
    attention logits soft-capped at ``golden.SOFTCAP_CAP``): JAX's logits
    and greedy engine tokens through the capped float32 flash kernel,
    3 launches a layer a prefill, the capped decode and the capped
    one-token cross attention."""
    from repro_torch.serve import golden
    return _serve_golden(torch, np, dev, "softcap_golden", golden.SOFTCAP,
                         SOFTCAP_GOLDEN)


def _cap_moves_logits(torch, tf, cap_cfg, uncapped_cfg):
    """A check for :func:`_serve_cell`: one prefill of a random
    ``SOFTCAP_CHECK_PROMPT``-token prompt with the cap and without it on
    the same weights; the cap must change the logits.  A run check only:
    random weights leave attention near uniform, so the cap moves these
    logits by about one bf16 step, far inside the teacher-forcing
    limit, and neither gate can tell a capped run from an uncapped one.
    What holds the cap at full width is phase 34's float32 fixture."""
    def check(params, cfg, inputs, rng):
        tokens = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, SOFTCAP_CHECK_PROMPT),
            dtype=torch.int64, device=params["embed"].device)[None]
        got = {key: tf.prefill(params, {"tokens": tokens, **inputs}, c,
                               SERVE_CACHE)[0].float()
               for key, c in (("capped", cap_cfg), ("uncapped", uncapped_cfg))}
        diff = float((got["capped"] - got["uncapped"]).abs().max())
        return {"prompt_tokens": SOFTCAP_CHECK_PROMPT,
                "max_abs_logit_diff": diff,
                "max_abs_logit": float(got["uncapped"].abs().max()),
                "argmax_equal": bool(torch.equal(
                    got["capped"].argmax(-1), got["uncapped"].argmax(-1))),
                "ok": diff > 0}
    return check


def phase_softcap_serve_main(torch, np, dev) -> dict:
    """Whisper-medium at its published widths and full depth (24 encoder
    + 24 decoder layers, bf16 weights from seed 0) with its attention
    logits soft-capped at ``golden.SOFTCAP_CAP`` (the cap chosen against
    the float32 fixture's logits) behind the engine: 4 requests, 72
    capped flash launches a prefill (encoder, causal decoder, cross
    attention), the capped decode self and cross attention, decode
    against teacher forcing, and a prefill whose logits the cap must
    change.  It shows that the capped path runs at full width and depth;
    it does not hold the cap (see :func:`_cap_moves_logits`): phase 34
    does."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import golden
    overrides = {"attn_logit_softcap": golden.SOFTCAP_CAP}
    base = get_config("whisper-medium")
    return _serve_cell(
        torch, np, dev, "softcap_serve_main", "whisper-medium",
        WHISPER_PROMPT, WHISPER_CACHE, WHISPER_PREFILL_TIMED,
        WHISPER_PROMPT[1], overrides=overrides, n_requests=SOFTCAP_REQUESTS,
        windows=False, check=_cap_moves_logits(
            torch, tf, dataclasses.replace(base, **overrides), base))


def phase_grad(torch, np, dev) -> dict:
    """One backward through each model kernel's wrapper at each main
    path's shape (serving and training; the forecaster's inference and
    training batch): from inputs that require grad the wrapper launches
    the kernel once through its ``autograd.Function`` and returns a
    result with a ``grad_fn``; the gradients for a seeded cotangent must
    match autograd through the plain version on the same inputs, at the
    forward's tolerance."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    from repro_torch.kernels import rglru_scan as rglru
    rng = np.random.default_rng(16)

    def rglru_check(case):
        od = getattr(torch, case[4])
        return (rglru, lambda a, b: rglru.rglru_scan(a, b, out_dtype=od),
                lambda a, b: rglru.rglru_scan_plain(a, b, out_dtype=od),
                lambda: _rglru_inputs(torch, np, case, dev),
                RGLRU_TOL[case[4]])

    def flash_check(case):
        window = case[7]
        return (flash, lambda q, k, v: flash.flash_attention(
                    q, k, v, window=window),
                lambda q, k, v: flash.flash_attention_plain(
                    q, k, v, window=window),
                lambda: _flash_inputs(torch, np, case, dev),
                FLASH_TOL[case[8]])

    def capped_flash_check(case):
        causal, window = case[6:8]
        kw = dict(causal=causal, window=window, softcap=FLASH_SOFTCAP)
        return (flash, lambda q, k, v: flash.flash_attention(q, k, v, **kw),
                lambda q, k, v: flash.flash_attention_plain(q, k, v, **kw),
                lambda: _capped_inputs(torch, np, case, dev),
                FLASH_TOL[case[8]])

    def mlstm_check(case):
        chunk = case[5]
        return (mlstm, lambda *x: mlstm.mlstm_chunkwise(
                    *x, chunk=chunk, return_state=False)[0],
                lambda *x: mlstm.mlstm_chunkwise_plain(
                    *x, chunk=chunk, return_state=False)[0],
                lambda: _mlstm_inputs(torch, np, case, dev)[0],
                MLSTM_TOL[case[6]])

    checks = {
        "rglru_scan/serve": rglru_check(RGLRU_CASES[0]),
        "rglru_scan/train": rglru_check(RGLRU_TRAIN_CASE),
        "flash_attention/serve": flash_check(FLASH_CASES[0]),
        "flash_attention/train": flash_check(FLASH_TRAIN_CASE),
        "flash_attention/softcap_live": capped_flash_check(FLASH_LIVE_CASE),
        "mlstm_chunkwise/forecast": mlstm_check(MLSTM_CASES[0]),
        "mlstm_chunkwise/forecast_train": mlstm_check(MLSTM_TRAIN_CASE),
        "mlstm_chunkwise/xlstm_serve": mlstm_check(MLSTM_XLSTM_CASE),
    }
    report = {}
    for name, (module, kernel_fn, plain_fn, make, tol) in checks.items():
        inputs = [t.detach().requires_grad_() for t in make()]
        before = module.launches
        out = kernel_fn(*inputs)
        launched = module.launches - before
        cot = torch.tensor(rng.standard_normal(tuple(out.shape)),
                           dtype=out.dtype, device=dev)
        t0 = time.perf_counter()
        grads = torch.autograd.grad(out, inputs, cot)
        torch.cuda.synchronize()
        backward_s = time.perf_counter() - t0
        want = torch.autograd.grad(plain_fn(*inputs), inputs, cot)
        errs = [float((g.float() - w.float()).abs().max())
                for g, w in zip(grads, want)]
        ok = (out.grad_fn is not None and launched == 1 and all(
            g.dtype == w.dtype and torch.isfinite(g).all() and
            torch.allclose(g.float(), w.float(), **tol)
            for g, w in zip(grads, want)))
        report[name] = {"shapes": [list(t.shape) for t in inputs],
                        "grad_fn": type(out.grad_fn).__name__,
                        "forward_launches": launched,
                        "backward_s": backward_s, "tolerance": tol,
                        "max_abs_err_by_input": errs, "match": ok}
        if not ok:
            emit({"phase": "grad", "kernels": report})
            raise SystemExit(f"{name}: gradients through the kernel "
                             "disagree with the plain version's")
        del inputs, out, cot, grads, want
        torch.cuda.empty_cache()
    line = {"phase": "grad", "kernels": report}
    emit(line)
    return line


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_GOLDEN = ROOT / "tests" / "data" / "torch_train_golden.npz"
# One Griffin superblock (rglru, rglru, local_attn).  The cell ran at 6
# layers (two stacked superblocks) until the Whisper and InternVL2 phases
# were added, and was cut to keep the whole script well inside its time
# limit; the stacked layers' training on the card stays held to the CPU
# by tests/test_torch_gpu.py::test_train_step_on_cuda_matches_cpu.
TRAIN_LAYERS = 3
TRAIN_SEQ = 4096               # train_4k's sequence length
TRAIN_BATCH = 2                # sequences a microbatch (accum from config)
# 2 uninterrupted steps, then a trainer preempted after step 1 and one
# resumed for step 2, the profiled step.  The resumed step's loss reads
# only the restored parameters, so the final states are compared too:
# the restored moments and step count reach them.
TRAIN_STEPS = 2
TRAIN_PREEMPT_AT = 1
# FORECAST_eval.json's configuration (the golden forecaster's): 1000
# steps at train_forecaster's batch 64 and lr 3e-3.  At its 300-step
# default neither package beats AR(1) on every seed
# (scripts/forecast_steps_torch.py).
FORECAST_TRAIN_STEPS = 1000
CUBLAS_NAMES = ("gemm", "cutlass", "nvjet", "xmma", "cublas", "gemv")


def phase_train_golden(torch, np, dev) -> dict:
    """The 3-layer float32 RecurrentGemma twin runs 3 AdamW steps through
    ``make_train_step`` on the card from the fixture's parameters (JAX's
    init) on the fixture's batches; loss, grad norm and lr of every step
    and the parameters after step 3 must match JAX's within
    ``repro_torch.train.golden.TOL``."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rglru_scan as rglru
    from repro_torch.train import golden
    t_phase = time.perf_counter()
    with np.load(TRAIN_GOLDEN, allow_pickle=False) as z:
        fx = {key: z[key] for key in z.files}
    before = (flash.launches, rglru.launches)
    r = golden.replay(fx, dev)
    launched = (flash.launches - before[0], rglru.launches - before[1])
    shares = r["worst_share_of_tol"]
    line = {"phase": "train_golden", "layers": r["cfg"].num_layers,
            "dtype": r["cfg"].dtype, "steps": int(fx["steps"]),
            "accum": r["accum"], "ce_chunk": r["cfg"].ce_chunk,
            "per_step": r["per_step"],
            "want": {k: fx[k].tolist() for k in ("loss", "grad_norm", "lr")},
            "update_rel_err": r["update_rel_err"],
            "params_max_abs_err": r["params_max_abs_err"],
            "tolerance": golden.TOL, "worst_share_of_tol": shares,
            "flash_launches": launched[0], "rglru_launches": launched[1],
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if max(shares.values()) > 1.0 or min(launched) == 0:
        raise SystemExit("train golden: the train step on the card does not "
                         "reproduce the JAX fixture through both kernels")
    return line


def _categorise(prof, plain_name: str) -> dict:
    """A profiled step's device time in four parts: the port's kernels
    (flash, RG-LRU), cuBLAS outside the plain-version backwards, the
    plain-version backward recomputes (every kernel whose launching op
    began inside a ``_autograd.PLAIN_BACKWARD`` range) and the rest.
    Reads kineto's raw events: building torch.profiler's event tree for
    a step of about a million ops takes minutes."""
    import bisect
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    ranges, cpu_start, kernels = [], {}, []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name == plain_name:
                ranges.append((ev.start_ns(), ev.start_ns()
                               + ev.duration_ns()))
            elif ev.linked_correlation_id() == 0:    # an op, not runtime
                cpu_start[ev.correlation_id()] = ev.start_ns()
        elif not (ev.is_user_annotation() or name == plain_name
                  or name.startswith("ProfilerStep")):
            kernels.append((name, ev.duration_ns(),
                            ev.linked_correlation_id()))
    ranges.sort()
    starts = [a for a, _ in ranges]
    parts = {"kernels": 0, "cublas": 0, "plain_backward": 0,
             "plain_backward_cublas": 0, "rest": 0}
    for name, ns, corr in kernels:
        low = name.lower()
        t = cpu_start.get(corr)
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        cublas = any(n in low for n in CUBLAS_NAMES)
        if k >= 0 and t <= ranges[k][1]:
            parts["plain_backward"] += ns
            parts["plain_backward_cublas"] += ns if cublas else 0
        elif "flash" in low or "rglru" in low:
            parts["kernels"] += ns
        elif cublas:
            parts["cublas"] += ns
        else:
            parts["rest"] += ns
    out = {f"{k}_ms": v * 1e-6 for k, v in parts.items()}
    out.update({"device_ms": sum(parts.values()) * 1e-6
                - out["plain_backward_cublas_ms"],
                "device_kernels": len(kernels),
                "plain_backward_ranges": len(ranges)})
    return out


def _plain_backward_timer(torch):
    """Wrap ``_autograd._PlainBackward._backward`` so each call is
    bracketed by CUDA events in stream order; returns (pairs, undo)."""
    from repro_torch.kernels import _autograd
    orig = _autograd._PlainBackward._backward
    pairs = []

    def timed(ctx, *grads):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(ctx, *grads)
        end.record()
        pairs.append((start, end))
        return out

    _autograd._PlainBackward._backward = staticmethod(timed)

    def undo():
        _autograd._PlainBackward._backward = staticmethod(orig)
    return pairs, undo


def _state_digest(torch, state) -> dict:
    """{key: [sum, weighted sum]} of a train state's leaves, keyed as
    ``flatten_with_keys`` keys them: each tensor's bit patterns read as
    integers of its width and summed in int64 on the card (wrapping),
    plainly and weighted by position within 2^26-element pieces.  Two
    states whose digests are equal hold the same bits leaf for leaf up
    to a collision; one changed element changes both sums.  A leaf that
    is not a tensor is kept as it is."""
    from repro_torch.train.checkpoint import flatten_with_keys
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    piece = 1 << 26
    weight = None
    sums = {}
    for key, leaf in flatten_with_keys(state):
        if not torch.is_tensor(leaf):
            sums[key] = leaf
            continue
        bits = leaf.detach().contiguous().view(
            ints[leaf.element_size()]).reshape(-1)
        if weight is None:
            weight = torch.arange(1, piece + 1, device=bits.device,
                                  dtype=torch.int64)
        acc = torch.zeros(2, dtype=torch.int64, device=bits.device)
        for i in range(0, bits.numel(), piece):
            b = bits[i:i + piece].long()
            acc[0] += b.sum()
            acc[1] += (b * weight[:b.numel()]).sum()
        sums[key] = acc
    out = {k: v.tolist() if torch.is_tensor(v) else v
           for k, v in sums.items()}
    return out


def phase_train_main(torch, np, dev, steps: int = TRAIN_STEPS) -> dict:
    """Full-width RecurrentGemma-9B cut to 3 layers, trained through
    ``Trainer`` on the card: ``steps`` steps of 2 × 2 × 4096 tokens; then
    a second trainer, checkpointing every 2 steps, preempted by
    ``request_stop`` after step ``TRAIN_PREEMPT_AT``, and a third that
    resumes from that checkpoint and runs under ``torch.profiler`` (the
    profiled step), whose losses must equal (``==``) the first run's:
    the restored state is bit for bit the saved one, and
    every kernel, cuBLAS call and reduction of a step sums in a fixed
    order.  The third trainer's final state (parameters, AdamW moments,
    step) must equal the first's leaf for leaf (``_state_digest``): its
    losses read only the restored parameters, the final state also the
    restored moments and step count.

    One checkpoint of this state is 19.7 GB (float32 parameters and AdamW
    moments), so the phase writes one, the preempted trainer's, and keeps
    a run's disk writes near that size: the first run keeps no
    checkpoints, and the resumed trainer's saves (its last step) are
    counted, not written."""
    import dataclasses
    import gc
    import os
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import _autograd
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rglru_scan as rglru
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import count_params
    from repro_torch.train.data import DataConfig
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              num_layers=TRAIN_LAYERS)
    n_params = count_params(tf.model_specs(cfg))
    opt_cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=20,
                              total_steps=steps)
    data_cfg = DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                          accum=cfg.train_accum, seed=0)
    tokens = TRAIN_BATCH * TRAIN_SEQ * cfg.train_accum
    root = tempfile.mkdtemp(prefix="repro_torch_train_")
    line = {"phase": "train_main", "arch": cfg.name,
            "layers": cfg.num_layers, "params": n_params,
            "seq_len": TRAIN_SEQ, "microbatch": TRAIN_BATCH,
            "accum": cfg.train_accum, "tokens_per_step": tokens,
            "ce_chunk": cfg.ce_chunk, "steps": steps}

    def make(ckpt_dir=None, log=lambda s: None):
        return Trainer(cfg, opt_cfg, data_cfg, TrainerConfig(
            total_steps=steps, checkpoint_every=2, checkpoint_dir=ckpt_dir,
            keep_checkpoints=1, log_every=1, seed=0), log_fn=log,
            device=dev)

    def instrument(tr, name, step_ms, per_step, pairs=(), plain_ms=None):
        inner = tr._step_fn

        def timed_step(state, batch):
            before = (flash.launches, rglru.launches,
                      rglru.chunked_launches)
            n0 = len(pairs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            if plain_ms is not None:
                plain_ms.append(sum(s.elapsed_time(e)
                                    for s, e in pairs[n0:]))
            per_step.append({
                "flash_attention": flash.launches - before[0],
                "rglru_ring": (rglru.launches - before[1])
                - (rglru.chunked_launches - before[2]),
                "rglru_chunked": rglru.chunked_launches - before[2]})
            emit({"phase": "train_main_step", "run": name,
                  "ms": step_ms[-1], "launches": per_step[-1]})
            return out

        tr._step_fn = timed_step

    def free(tr):
        tr.state = None
        gc.collect()
        torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    gc.collect()                      # earlier phases' cycles hold GBs
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        tr = make()
        torch.cuda.synchronize()
        line["init_s"] = time.perf_counter() - t0
        step_ms, per_step, plain_ms = [], [], []
        pairs, undo = _plain_backward_timer(torch)
        instrument(tr, "uninterrupted", step_ms, per_step, pairs, plain_ms)
        torch.cuda.reset_peak_memory_stats()
        flash.launches = 0
        rglru.launches = rglru.chunked_launches = 0
        t0 = time.perf_counter()
        try:
            result = tr.run()
        finally:
            undo()
        line["run_s"] = time.perf_counter() - t0
        launches = {"flash_attention": flash.launches,
                    "rglru_ring": rglru.launches - rglru.chunked_launches,
                    "rglru_chunked": rglru.chunked_launches}
        line["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in tr.history]
        med = float(np.median(step_ms))
        flops = 6 * n_params * tokens
        line.update({
            "result": result, "losses": losses,
            "grad_norms": [h["grad_norm"] for h in tr.history],
            "lrs": [h["lr"] for h in tr.history],
            "step_ms": step_ms, "step_ms_median": med,
            "tokens_per_s": tokens / (med * 1e-3),
            "model_flops_per_step": flops,
            "model_tflops_per_s": flops / (med * 1e-3) / 1e12,
            "share_of_989_tflops": flops / (med * 1e-3) / BF16_OPS_PER_S,
            "launches": launches, "launches_by_step": per_step,
            "plain_backward_calls": len(pairs),
            "plain_backward_ms_by_step": plain_ms,
            # after the first (warm-up) step
            "plain_backward_share": sum(plain_ms[1:]) / sum(step_ms[1:])})
        emit({k: line[k] for k in ("phase", "step_ms", "losses",
                                   "launches", "peak_device_bytes",
                                   "plain_backward_share")})
        t0 = time.perf_counter()
        want_digest = _state_digest(torch, tr.state)
        digest_s = time.perf_counter() - t0

        free(tr)
        del tr

        # Preemption after TRAIN_PREEMPT_AT (one checkpoint written), then
        # resume.
        holder = []

        def stop_after(msg):
            if msg.startswith(f"[trainer] step {TRAIN_PREEMPT_AT} "):
                holder[0].request_stop()

        ckpt_dir = os.path.join(root, "preempted")
        tr2 = make(ckpt_dir, log=stop_after)
        holder.append(tr2)
        t0 = time.perf_counter()
        r2 = tr2.run()
        run2_s = time.perf_counter() - t0
        free(tr2)
        del tr2, holder[:]
        t0 = time.perf_counter()
        tr3 = make(ckpt_dir)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resumed_at = tr3.step
        not_written = []
        tr3.ckpt.save = lambda step, *a, **kw: not_written.append(step)
        # The resumed trainer's step runs under torch.profiler: the
        # profiled step (its run() of one step, batch and logging in).
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r3 = tr3.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        split = _categorise(prof, _autograd.PLAIN_BACKWARD)
        split.update({"wall_ms": wall * 1e3,
                      "analysis_s": time.perf_counter() - t0})
        del prof
        line["profiled_step"] = split
        emit({"phase": "train_main_profile", **split})
        resumed = {h["step"]: h["loss"] for h in tr3.history}
        got_digest = _state_digest(torch, tr3.state)
        free(tr3)
        del tr3
        diffs = {s: resumed[s] - losses[s - 1] for s in resumed}
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(ckpt_dir) for f in fs)
        line["preempt"] = {
            "preempted_result": r2, "preempted_run_s": run2_s,
            "checkpoint_bytes": ckpt_bytes,
            "resume_construct_s": resume_s, "resumed_at": resumed_at,
            "resumed_result": r3, "saves_not_written": not_written,
            "resumed_losses": {str(s): v for s, v in resumed.items()},
            "loss_diff_vs_uninterrupted": {str(s): d
                                           for s, d in diffs.items()},
            "equal": all(d == 0.0 for d in diffs.values()),
            "state_leaves": len(want_digest),
            "state_leaves_equal": sum(got_digest.get(k) == v
                                      for k, v in want_digest.items()),
            "state_equal": got_digest == want_digest,
            "state_digest_s": digest_s}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    ok = (len(losses) == steps and all(np.isfinite(losses))
          and all(p["flash_attention"] > 0 and p["rglru_ring"]
                  + p["rglru_chunked"] > 0 for p in per_step)
          and r2["completed"] == 0.0 and r2["step"] == TRAIN_PREEMPT_AT
          and resumed_at == TRAIN_PREEMPT_AT and r3["completed"] == 1.0
          and sorted(resumed) == list(range(TRAIN_PREEMPT_AT + 1,
                                            steps + 1))
          and line["preempt"]["equal"] and line["preempt"]["state_equal"])
    if not ok:
        raise SystemExit("train main: the run, its kernel launches or its "
                         "preemption and resume failed, or the resumed "
                         "losses or final state differ from the "
                         "uninterrupted run's")
    return line


def phase_forecast_train(torch, np, dev, data, forecast_line) -> dict:
    """``train_forecaster`` on the golden dataset at the golden
    forecaster's configuration on the card, from the port's own init;
    its val log-MSE must beat EWMA's and AR(1)'s, and
    ``save_forecaster`` → ``load_forecaster`` must predict the same."""
    import shutil
    import tempfile
    from repro_torch.forecast import features, model
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    t_phase = time.perf_counter()
    with np.load(FORECASTER / "expected.npz", allow_pickle=False) as z:
        jax_val = float(z["val_log_mse"])
    window = features.WindowConfig()
    mlstm.launches = mlstm.row_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.train_forecaster(
        data["X_train"], data["y_train"], window=window,
        X_val=data["X_val"], y_val=data["y_val"], seed=0,
        steps=FORECAST_TRAIN_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (mlstm.launches, mlstm.row_launches)
    X = torch.from_numpy(_windows(np, data)).to(dev)
    root = tempfile.mkdtemp(prefix="repro_torch_forecaster_")
    try:
        model.save_forecaster(root, res, step=FORECAST_TRAIN_STEPS)
        fc = model.load_forecaster(root, device=dev)
        with torch.inference_mode():
            a = model.apply_forecast(res.params, X, res.arch)
            b = model.apply_forecast(fc.params, X, fc.arch)
        round_trip = bool(torch.equal(a, b))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    base = forecast_line["val_log_mse"]
    line = {"phase": "forecast_train", "steps": FORECAST_TRAIN_STEPS,
            "train_windows": int(data["X_train"].shape[0]),
            "wall_s": wall, "s_per_step": wall / FORECAST_TRAIN_STEPS,
            "mlstm_launches": launches[0],
            "mlstm_row_launches": launches[1],
            "loss_first": float(res.losses[0]),
            "loss_last10_mean": float(np.mean(res.losses[-10:])),
            "val_log_mse": res.val_mse,
            "val_log_mse_jax": jax_val,
            "val_log_mse_ewma": base["ewma"], "val_log_mse_ar1": base["ar1"],
            "save_load_predictions_equal": round_trip,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if not (np.isfinite(res.losses).all() and res.val_mse < base["ar1"]
            and res.val_mse < base["ewma"] and round_trip
            and launches[1] > 0):
        raise SystemExit("forecast train: the trained forecaster does not "
                         "beat the baselines, or its round trip differs")
    return line


def _leaves(tree):
    from repro_torch.models.params import leaves_with_paths
    return [t for _, t in leaves_with_paths(tree)]


DIST_LAYERS = 2
DIST_BATCH, DIST_SEQ = 2, 2048
DIST_STEPS = 2
DIST_SHARE_TOL = 1e-6          # sharded vs plain, share of a leaf's scale
DIST_COMPRESS_REL = 0.02       # the reference's bound on the int8 sync
DRYRUN_TIMEOUT_S = 600


def _state_leaves(state):
    """(name, tensor) of a TrainState's leaves, the step included."""
    from repro_torch.train.checkpoint import flatten_with_keys
    return flatten_with_keys(state)


def _synced_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_distributed(torch, np, dev, smi: str) -> dict:
    """Phase 29: the distributed layer on the card (see the module
    docstring)."""
    import contextlib
    import dataclasses
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression
    from repro_torch.distributed.elastic import restore_elastic
    from repro_torch.distributed.sharding import (ShardingCtx,
                                                  distribute_tree, map_axes,
                                                  rules_for, sharding_ctx)
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.mesh import (init_distributed, local_mesh,
                                         make_mesh)
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptimizerConfig
    t_phase = time.perf_counter()
    _free(torch)
    # one temporary root for the process group's file store and the
    # checkpoint, removed at the end
    root = tempfile.mkdtemp(prefix="repro_torch_dist_")
    try:
        rank_dev = init_distributed(
            dev, init_method=f"file://{os.path.join(root, 'store')}")
        lm = local_mesh(dev.type)
        mesh = make_mesh((1, 1), ("data", "model"), dev.type)
        cfg = dataclasses.replace(get_config("deepseek-7b"),
                                  num_layers=DIST_LAYERS)
        line = {"phase": "distributed", "nvidia_smi": smi,
                "backend": dist.get_backend(),
                "world": dist.get_world_size(), "device": str(rank_dev),
                "local_mesh": list(lm.mesh.shape),
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                "arch": cfg.name, "layers": cfg.num_layers,
                "batch": DIST_BATCH, "seq_len": DIST_SEQ}
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t0 = time.perf_counter()
        state = ts.init_train_state(gen, cfg, dev)
        ctx = ShardingCtx(mesh, rules_for(cfg))
        axes = ts.train_state_axes(cfg)
        sh_state = distribute_tree(
            ctx, map_axes(lambda _, t: t.clone(), axes, state), axes)
        torch.cuda.synchronize()
        line["init_s"] = time.perf_counter() - t0
        data = SyntheticLM(cfg, DataConfig(batch_size=DIST_BATCH,
                                           seq_len=DIST_SEQ, seed=0))
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(0).items()}
        sh_batch = distribute_tree(ctx, batch, ts.batch_axes(cfg))
        step = ts.make_train_step(cfg, OptimizerConfig(warmup_steps=1))

        # DIST_STEPS steps of each, alternating, from equal states (the
        # first of each warms up): the main path is the sharded step.
        runs = {"plain": (state, batch, contextlib.nullcontext),
                "sharded": (sh_state, sh_batch,
                            lambda: sharding_ctx(mesh, ctx.rules))}
        for name in runs:
            line.update({f"{name}_step_ms": [], f"{name}_losses": [],
                         f"{name}_flash_launches": 0})
        torch.cuda.reset_peak_memory_stats()
        for _ in range(DIST_STEPS):
            for name, (st, b, scope) in runs.items():
                flash.launches = 0
                with scope():
                    (_, m), ms = _synced_ms(torch, lambda: step(st, b))
                line[f"{name}_flash_launches"] += flash.launches
                line[f"{name}_step_ms"].append(ms)
                line[f"{name}_losses"].append(float(m["loss"]))
        line["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        emit({"phase": "distributed_steps", **{
            k: line[k] for k in ("init_s", "plain_step_ms",
                                 "sharded_step_ms", "plain_losses",
                                 "plain_flash_launches",
                                 "sharded_flash_launches",
                                 "peak_device_bytes")}})
        shares = {}
        for (key, a), (_, b) in zip(_state_leaves(sh_state),
                                    _state_leaves(state)):
            full = a.full_tensor().float()
            ref = b.float()
            scale = float(ref.abs().max())
            diff = float((full - ref).abs().max())
            shares[key] = diff / scale if scale > 0 else diff
        worst = max(shares, key=shares.get)
        line.update({
            "losses_equal": line["plain_losses"] == line["sharded_losses"],
            "leaves": len(shares),
            "leaves_equal": sum(v == 0.0 for v in shares.values()),
            "worst_leaf": worst, "worst_share_of_scale": shares[worst]})
        del sh_state, sh_batch
        _free(torch)

        # compressed DDP sync on a (1, 1, 1) ("pod", "data", "model") mesh
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), dev.type)

        def loss_fn(params, b):
            return ts._loss_fn(params, b, cfg, True)[0]

        grads = {}
        for compress in (True, False):
            ddp = compression.make_compressed_ddp_step(
                loss_fn, mesh3, compress=compress)
            compression.reset_sync_stats()
            (loss, g), ms = _synced_ms(torch,
                                       lambda: ddp(state.params, batch))
            grads[compress] = g
            key = "int8" if compress else "float32"
            line[f"ddp_{key}"] = {"step_ms": ms, "loss": float(loss),
                                  **compression.SYNC_STATS}
        pod = mesh3.get_group("pod")
        intra = [mesh3.get_group(a) for a in ("data", "model")]
        for compress in (True, False):
            key = "int8" if compress else "float32"
            compression.reset_sync_stats()
            _, ms = _synced_ms(torch, lambda: compression.
                               hierarchical_grad_sync(grads[False], intra,
                                                      pod, compress))
            line[f"ddp_{key}"].update(sync_ms=ms, sync_all_reduces=(
                compression.SYNC_STATS["all_reduce"]),
                sync_bytes=compression.SYNC_STATS["bytes"])
        num = max(float((a - b).abs().max()) for a, b in
                  zip(_leaves(grads[True]), _leaves(grads[False])))
        den = max(float(b.abs().max()) for b in _leaves(grads[False]))
        line["compress_rel_err"] = num / den
        emit({"phase": "distributed_ddp",
              "compress_rel_err": line["compress_rel_err"],
              "int8": line["ddp_int8"], "float32": line["ddp_float32"]})
        del grads
        _free(torch)

        # save the stepped state, restore it onto the (1, 1) mesh
        ckpt = CheckpointManager(os.path.join(root, "ckpt"))
        t0 = time.perf_counter()
        path = ckpt.save(1, state)
        line["save_s"] = time.perf_counter() - t0
        line["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(dp, f))
            for dp, _, fs in os.walk(path) for f in fs)
        t0 = time.perf_counter()
        restored, r_step, _ = restore_elastic(ckpt, cfg, mesh)
        torch.cuda.synchronize()
        line["restore_s"] = time.perf_counter() - t0
        line["restored_step"] = r_step
        line["restore_equal"] = r_step == 1 and all(
            torch.equal(a.full_tensor(), b) for (_, a), (_, b) in
            zip(_state_leaves(restored), _state_leaves(state)))
        del restored, state
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    _free(torch)
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    bad = []
    if line["worst_share_of_scale"] > DIST_SHARE_TOL:
        bad.append(f"leaf {line['worst_leaf']} off by "
                   f"{line['worst_share_of_scale']} of its scale")
    if any(abs(a - b) > DIST_SHARE_TOL * abs(b) for a, b in
           zip(line["sharded_losses"], line["plain_losses"])):
        bad.append("loss differs")
    if not 0 < line["sharded_flash_launches"] == \
            line["plain_flash_launches"]:
        bad.append("flash launches differ or are none")
    if not line["compress_rel_err"] < DIST_COMPRESS_REL:
        bad.append(f"compressed sync off by {line['compress_rel_err']}")
    if not line["restore_equal"]:
        bad.append("elastic restore differs")
    if bad:
        raise RuntimeError("distributed phase: " + "; ".join(bad))
    return line


DRYRUN_PEAK_TOL = 0.10        # estimated peak vs the measured one
# Phase 29's cell on a fake world of 1, held to the card's step.
DRYRUN_PHASE29 = (("deepseek-7b", "phase29", False),)
# Production cells run on fake worlds of 256 and 512 ranks.
DRYRUN_CELLS = (("deepseek-7b", "train_4k", False),
                ("deepseek-7b", "decode_32k", False),
                ("deepseek-7b", "train_4k", True))
DRYRUN_KEYS = {"memory": ("argument_bytes", "output_bytes", "temp_bytes",
                          "peak_estimate_bytes"),
               "cost": ("flops_per_device", "bytes_per_device"),
               "collectives_per_device": ("all-gather", "all-reduce",
                                          "reduce-scatter", "all-to-all",
                                          "collective-permute", "total")}
# One dry run in a process of its own (no NCCL group, no card): phase
# 29's cell on a fake world of 1, or a production cell.
_DRYRUN_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import dryrun, shapes
arch, shape, multi = json.loads(sys.argv[2])
if shape == "phase29":
    seq, batch, layers = json.loads(sys.argv[3])
    r = dryrun.run_cell(arch, shapes.ShapeSpec(shape, seq, batch, "train"),
                        False, cfg_overrides={"num_layers": layers},
                        mesh=((1, 1), ("data", "model")))
else:
    r = dryrun.run_cell(arch, shape, multi)
print("DRYRUN " + json.dumps(r))
"""


def _dryrun_process(cell):
    return subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CHILD, str(ROOT / "src"),
         json.dumps(cell), json.dumps([DIST_SEQ, DIST_BATCH, DIST_LAYERS])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def _dryrun_result(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"dry-run process failed ({proc.returncode}):\n"
                           + err[-3000:])
    return json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("DRYRUN "))[len("DRYRUN "):])


def _dryrun_key(cell) -> str:
    arch, shape, multi = cell
    return f"{arch}|{shape}|{'multi' if multi else 'single'}"


def start_dryruns(cells) -> dict:
    """Start the dry runs of ``cells`` now, one process each; phase 30
    collects them, and any still running when the script exits are
    killed.  They need the host and not the card (6-20 s of tracing
    each, the 512-rank cell the longest), so ``main`` starts them all
    before the training phases, whose steps keep the card busy."""
    procs = {_dryrun_key(c): _dryrun_process(c) for c in cells}
    atexit.register(_stop_processes, list(procs.values()))
    return procs


def _stop_processes(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def phase_dryrun(torch, np, dev, smi: str, started=None) -> dict:
    """Phase 30: the dry run's accounting against the card (phase 29's
    cell: one warm sharded step, its peak above what was allocated
    before the state and batch, its flash launches) and the production
    cells on fake worlds (see the module docstring); ``started`` holds
    dry runs already running (:func:`start_dryruns`)."""
    import dataclasses
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (ShardingCtx,
                                                  distribute_tree, rules_for,
                                                  sharding_ctx)
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptimizerConfig
    t_phase = time.perf_counter()
    # the dry runs start first, one process each, and run on the host
    # beside the card's step
    procs = dict(started or {})
    procs.update(start_dryruns([c for c in DRYRUN_PHASE29 + DRYRUN_CELLS
                                if _dryrun_key(c) not in procs]))
    procs["cell"] = procs.pop(_dryrun_key(DRYRUN_PHASE29[0]))
    line = {"phase": "dryrun", "nvidia_smi": smi, "arch": "deepseek-7b",
            "layers": DIST_LAYERS, "batch": DIST_BATCH, "seq_len": DIST_SEQ,
            "mesh": [1, 1]}
    root = tempfile.mkdtemp(prefix="repro_torch_dryrun_")
    try:
        base = _free(torch)
        init_distributed(dev, init_method=f"file://{os.path.join(root, 's')}")
        mesh = make_mesh((1, 1), ("data", "model"), dev.type)
        cfg = dataclasses.replace(get_config("deepseek-7b"),
                                  num_layers=DIST_LAYERS)
        ctx = ShardingCtx(mesh, rules_for(cfg))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = distribute_tree(ctx, ts.init_train_state(gen, cfg, dev),
                                ts.train_state_axes(cfg))
        data = SyntheticLM(cfg, DataConfig(batch_size=DIST_BATCH,
                                           seq_len=DIST_SEQ, seed=0))
        batch = distribute_tree(ctx, {k: torch.from_numpy(v).to(dev)
                                      for k, v in data.batch(0).items()},
                                ts.batch_axes(cfg))
        step = ts.make_train_step(cfg, OptimizerConfig(warmup_steps=1))
        with sharding_ctx(mesh, ctx.rules):
            step(state, batch)                               # warm-up
            _free(torch)
            torch.cuda.reset_peak_memory_stats()
            flash.launches = 0
            _, ms = _synced_ms(torch, lambda: step(state, batch))
        line.update(step_ms=ms, flash_launches=flash.launches,
                    state_batch_bytes=_free(torch) - base,
                    measured_peak_bytes=torch.cuda.max_memory_allocated()
                    - base)
        del state, batch
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    _free(torch)
    try:
        runs = {key: _dryrun_result(p) for key, p in procs.items()}
    finally:
        _stop_processes(procs.values())
    cell = runs.pop("cell")
    est = cell["memory"]["peak_estimate_bytes"]
    line.update(
        estimated_peak_bytes=est,
        peak_rel_err=(est - line["measured_peak_bytes"])
        / line["measured_peak_bytes"],
        argument_bytes=cell["memory"]["argument_bytes"],
        counted_flash_calls=cell["kernel_calls"].get("flash_attention", 0),
        flops=cell["cost"]["flops_per_device"],
        model_tflops_per_s=cell["cost"]["flops_per_device"]
        / (line["step_ms"] * 1e-3) / 1e12,
        dryrun_trace_s=cell["trace_s"])
    card = torch.cuda.get_device_properties(0).total_memory
    line["production"] = {key: {
        "ok": r.get("ok"), "devices": r["devices"], "trace_s": r["trace_s"],
        "peak_estimate_bytes": r["memory"]["peak_estimate_bytes"],
        "card_bytes": card, "argument_bytes": r["memory"]["argument_bytes"],
        "flops_per_device": r["cost"]["flops_per_device"],
        "collectives_per_device": r["collectives_per_device"],
        "missing": [f"{g}.{k}" for g, ks in DRYRUN_KEYS.items()
                    for k in ks if k not in r.get(g, {})]
        + [k for k in ("arch", "shape", "mesh", "devices", "ok", "tag",
                       "trace_s", "ops") if k not in r]}
        for key, r in runs.items()}
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    bad = []
    if not abs(line["peak_rel_err"]) <= DRYRUN_PEAK_TOL:
        bad.append(f"estimated peak {est} is {line['peak_rel_err']:+.3f} "
                   f"of the measured {line['measured_peak_bytes']}")
    if not 0 < line["counted_flash_calls"] == line["flash_launches"]:
        bad.append(f"{line['counted_flash_calls']} flash calls counted, "
                   f"{line['flash_launches']} launched")
    if len(runs) != len(DRYRUN_CELLS):
        bad.append(f"{len(runs)} production cells of {len(DRYRUN_CELLS)}")
    for key, r in line["production"].items():
        if r["ok"] is not True or r["missing"]:
            bad.append(f"{key}: ok {r['ok']}, missing {r['missing']}")
    if bad:
        raise RuntimeError("dryrun phase: " + "; ".join(bad))
    return line


# One predict call's mLSTM cell: B 1, H 2, T = L = 16, dk = dv = 32.
PREDICT_CASE = (1, 2, 16, 32, 32, 64, "float32", False)
ORCH_LANE_CELLS = 8


def _strip_wall(rows):
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]


def phase_orchestrate(torch, np, dev) -> dict:
    from repro_torch.core import (ExperimentSpec, golden, reset_id_counters,
                                  run_all_combos, run_experiment,
                                  run_k8s_baseline)
    from repro_torch.core.experiment import build_simulation
    from repro_torch.forecast import model
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    from repro_torch.manyworld import lane_kernel
    from repro_torch.search.runner import CellSpec, run_cells
    t_phase = time.perf_counter()
    checks = {}
    for case, (spec, _) in sorted(golden.GOLDEN_TRACE_CASES.items()):
        want = golden.load_trace_fixture(case)
        for engine in ("array", "object"):
            checks[f"golden_trace/{case}/{engine}"] = (
                golden.capture_trace(engine, spec) == want)
    with open(golden.ORCHESTRATE_FIXTURE) as f:
        fx = json.load(f)
    t0 = time.perf_counter()
    for w in golden.FIG3_WORKLOADS:
        reset_id_counters()
        checks[f"fig3/{w}"] = [golden.result_row(r) for r in
                               run_all_combos(w, 0)] == fx["fig3"][w]
        checks[f"fig4/{w}"] = (golden.result_row(run_k8s_baseline(w, 0))
                               == fx["fig4"][w])
    figs_s = time.perf_counter() - t0

    # The learned cell: the forecaster on the card, the simulator on the
    # host; the row kernel's count from 0 just before the run.
    fc = model.load_forecaster(str(FORECASTER / "checkpoint"))
    if fc.device.type != "cuda":
        raise SystemExit(f"orchestrate: load_forecaster put the model on "
                         f"{fc.device}")
    rec = golden.RecordingForecaster(fc)
    spec = ExperimentSpec(**golden.LEARNED_SPEC, forecaster_obj=rec)
    reset_id_counters()
    torch.cuda.synchronize()
    mlstm.launches = mlstm.row_launches = mlstm.parallel_launches = 0
    row, wall = golden.run_recorded(build_simulation, spec, rec)
    torch.cuda.synchronize()
    row_launches, all_launches = mlstm.row_launches, mlstm.launches
    want = fx["learned"]
    got_calls, want_calls = np.asarray(rec.calls), np.asarray(want["calls"])
    same = got_calls.shape == want_calls.shape
    checks["learned/calls"] = same
    checks["learned/now_equal"] = same and bool(
        np.array_equal(got_calls[:, 0], want_calls[:, 0]))
    checks["learned/forecasts_within_tol"] = same and bool(
        np.allclose(got_calls[:, 1:], want_calls[:, 1:], **FORECAST_TOL))
    checks["learned/row_equal"] = row == want["row"]
    checks["learned/row_launch_per_model_call"] = (
        row_launches == rec.model_calls == want["model_calls"]
        and all_launches == row_launches)
    reset_id_counters()
    nb = golden.result_row(run_experiment(ExperimentSpec(
        **dict(golden.LEARNED_SPEC, autoscaler="non-binding"))))
    checks["non_binding/row_equal"] = nb == fx["non_binding"]
    predict_s = float(np.sum(rec.latency_s))
    lat = np.asarray(rec.model_latency_s) * 1e3

    # The row kernel at one predict call's shape against its plain
    # version, timed behind a device sleep.
    B, H, T, dk, dv, chunk = PREDICT_CASE[:6]
    L = min(chunk, T)
    inputs, _ = _mlstm_inputs(torch, np, PREDICT_CASE, dev)
    checks["predict_shape/row_kernel"] = (
        mlstm.pick_kernel(L, dk, dv, torch.float32, inputs) == "rows")
    h, _ = mlstm.mlstm_chunkwise(*inputs, chunk=chunk, return_state=False)
    want_h, _ = mlstm.mlstm_chunkwise_plain(*inputs, chunk=chunk,
                                            return_state=False)
    torch.cuda.synchronize()
    checks["predict_shape/match"] = bool(
        torch.allclose(h, want_h, **MLSTM_TOL["float32"]))
    kernel_t = _queued_ms(torch, lambda: mlstm.mlstm_chunkwise(
        *inputs, chunk=chunk, return_state=False), 200)
    plain_t = _queued_ms(torch, lambda: mlstm.mlstm_chunkwise_plain(
        *inputs, chunk=chunk, return_state=False), 50, warmup=5)
    nbytes, ops = _mlstm_work(B, H, T, dk, dv, L, 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3

    # Lanes against serial on phase 5's heavy-tail cells.
    cells = [CellSpec(scenario="heavy-tail", scheduler="best-fit",
                      autoscaler="void", rescheduler="void", seed=seed,
                      engine="array", initial_workers=MAIN_NODES)
             for seed in range(ORCH_LANE_CELLS)]
    lane_kernel.launches = 0
    t0 = time.perf_counter()
    lane_rows = run_cells(cells, workers="lanes", device=dev)
    lanes_s = time.perf_counter() - t0
    lane_launches = lane_kernel.launches
    t0 = time.perf_counter()
    serial_rows = run_cells(cells, workers=1)
    serial_s = time.perf_counter() - t0
    checks["lanes_equal_serial"] = (
        _strip_wall(lane_rows) == _strip_wall(serial_rows)
        and lane_launches > 0)

    line = {"phase": "orchestrate", "checks": checks,
            "figs_s": figs_s,
            "learned": {
                "completed": row["completed"],
                "predict_calls": len(rec.calls),
                "model_calls": rec.model_calls,
                "mlstm_row_launches": row_launches,
                "mlstm_launches": all_launches,
                "wall_s": wall, "predict_s": predict_s,
                "simulator_s": wall - predict_s,
                "predict_ms_median": float(np.median(lat)),
                "predict_ms_p99": float(np.percentile(lat, 99)),
                "predict_ms_max": float(lat.max()),
                "forecast_max_abs_err": float(np.abs(
                    got_calls[:, 1:] - want_calls[:, 1:]).max())
                if same else None,
                "max_nodes": row["max_nodes"], "cost": row["cost"],
                "cost_non_binding": nb["cost"],
                "cost_over_non_binding": row["cost"] / nb["cost"]},
            "predict_shape": {
                "shape": list(PREDICT_CASE[:5]), "chunk": L,
                "kernel_ms": kernel_t["ms"], "kernel_timed": kernel_t,
                "plain_ms": plain_t["ms"],
                "max_abs_err": float((h - want_h).abs().max()),
                "bytes": nbytes, "flops": ops,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"},
            "lanes": {"cells": ORCH_LANE_CELLS,
                      "lane_program_launches": lane_launches,
                      "lanes_s": lanes_s, "serial_s": serial_s},
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"orchestrate: checks failed: {bad}")
    return line


# Phase 32: the F3 mixed batch's lane cells (phase 5's heavy-tail cells
# at the family's 2000 jobs on 64 m2.small nodes), the search's pinned
# micro-search (tests/data/golden_search.json) and the pool's deadline.
F3_LANE_CELLS = 64
SEARCH_SCENARIOS = ("diurnal", "heavy-tail")
SEARCH_SETTINGS = dict(generations=2, pop_size=6, seed=7, n_jobs=40)
SEARCH_ROW_KEYS = ("completed", "infeasible", "cost", "mean_pending_s",
                   "avg_ram_ratio", "evictions", "scale_outs", "scale_ins",
                   "max_nodes")
SEARCH_POOL_TIMEOUT_S = 300
CHAOS_TRACE = ROOT / "tests" / "data" / "golden_chaos_trace.json"
CHAOS_ROWS = ROOT / "tests" / "data" / "torch_chaos_rows.json"
SEARCH_GOLDEN = ROOT / "tests" / "data" / "golden_search.json"


def _f3_cells(CellSpec):
    """The mixed batch: F3_LANE_CELLS lane-eligible heavy-tail cells with,
    spread between them, four cells outside the lane envelope (the
    binding autoscaler, one a chaos spot-spike cell), one infeasible cell
    (diurnal's pods on m2.tiny) and one zero-pod cell."""
    lanes = [CellSpec(scenario="heavy-tail", scheduler="best-fit",
                      autoscaler="void", rescheduler="void", seed=seed,
                      engine="array", initial_workers=MAIN_NODES)
             for seed in range(F3_LANE_CELLS)]
    others = [
        CellSpec(scenario="heavy-tail", autoscaler="binding",
                 rescheduler="non-binding", seed=0, n_jobs=400),
        CellSpec(scenario="diurnal", autoscaler="binding", seed=1,
                 n_jobs=400),
        CellSpec(scenario="flash-crowd", scheduler="k8s-default",
                 autoscaler="binding", rescheduler="binding", seed=2,
                 n_jobs=400),
        CellSpec(scenario="spot-spike", autoscaler="binding",
                 rescheduler="non-binding", seed=0, chaos=True),
        CellSpec(scenario="diurnal", autoscaler="void", rescheduler="void",
                 seed=0, initial_workers=2, template_name="m2.tiny"),
        CellSpec(scenario="heavy-tail", autoscaler="void",
                 rescheduler="void", seed=0, n_jobs=0,
                 initial_workers=MAIN_NODES)]
    cells, step = [], len(lanes) // len(others)
    for i, other in enumerate(others):
        cells.extend(lanes[i * step:(i + 1) * step])
        cells.append(other)
    cells.extend(lanes[len(others) * step:])
    return cells


def _rows_equal(got, want, fields) -> bool:
    keys = tuple(fields) + ("label", "infeasible", "n_jobs", "cell")
    return len(got) == len(want) and all(
        type(g[k]) is type(w[k]) and g[k] == w[k]
        for g, w in zip(got, want) for k in keys)


def _search_doc(res) -> dict:
    """A ``SearchResult`` in ``tests/data/golden_search.json``'s layout
    (JSON round-tripped), plus the final population."""
    doc = {
        "scenarios": list(res.scenarios),
        "settings": dict(SEARCH_SETTINGS),
        "evaluations": res.evaluations,
        "history": res.history,
        "front": [{
            "vector": list(ind.vector), "config": ind.config,
            "objectives": list(ind.objectives),
            "per_scenario": {sc: {k: row[k] for k in SEARCH_ROW_KEYS}
                             for sc, row in ind.per_scenario.items()},
        } for ind in res.front],
        "population": [[list(ind.vector), list(ind.objectives)]
                       for ind in res.population]}
    return json.loads(json.dumps(doc))


def _pool_child() -> None:
    """Body of the pool's process (``python3 -c``): the micro-search on a
    pool of 2, printed as one JSON line with the modules it imported."""
    from repro_torch.search import default_space, run_search
    res = run_search(default_space(), SEARCH_SCENARIOS, workers=2,
                     **SEARCH_SETTINGS)
    print(json.dumps({"doc": _search_doc(res),
                      "torch_imported": "torch" in sys.modules}))


def _run_pool_child() -> dict:
    """The 2-worker search in a process of its own, in its own session:
    it imports no torch, so the pool's workers (started by fork, the
    platform's default) inherit no CUDA context from this process.  Past
    SEARCH_POOL_TIMEOUT_S the whole session (the child and its workers)
    is killed and the phase fails."""
    import signal
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import chip_smoke; chip_smoke._pool_child()")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=SEARCH_POOL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"chaos_search_obs: the 2-worker search passed "
                         f"its {SEARCH_POOL_TIMEOUT_S} s deadline")
    if proc.returncode != 0:
        raise SystemExit(f"chaos_search_obs: the 2-worker search failed "
                         f"(rc {proc.returncode}): {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_chaos_search_obs(torch, np, dev, orch) -> dict:
    """Phase 32: F3's mixed batch on the card, the chaos families, the
    NSGA-II search and the flight recorder on the learned cell.

    The search's pool runs in a child process started from this one
    (see ``_run_pool_child``): that child imports no torch, and its
    fork-started workers do no CUDA work; a child that hangs is killed
    with its workers at a deadline and fails the phase."""
    import tempfile
    from repro_torch.core import ExperimentSpec, golden, reset_id_counters
    from repro_torch.core.experiment import build_simulation
    from repro_torch.forecast import model
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    from repro_torch.manyworld import evaluator, lane_kernel
    from repro_torch.obs import (EventLog, load_bundle, render_report,
                                 save_bundle)
    from repro_torch.obs.recorder import EV_FORECAST, KIND_NAMES
    from repro_torch.scenarios.chaos import (CHAOS_SCENARIOS, GOLDEN_JOBS,
                                             capture_chaos_trace,
                                             run_chaos_cell)
    from repro_torch.search import (baseline_rows, build_report,
                                    default_space, run_search, summarize)
    from repro_torch.search.runner import (_RESULT_FIELDS, CellSpec,
                                           run_cells)
    t_phase = time.perf_counter()
    checks, line = {}, {"phase": "chaos_search_obs"}

    # F3: one mixed batch through the lane engine on the card, against
    # the serial simulator, in submission order.
    cells = _f3_cells(CellSpec)
    lane_kernel.launches = 0
    t0 = time.perf_counter()
    lane_rows = run_cells(cells, workers="lanes", device=dev)
    lanes_s = time.perf_counter() - t0
    f3_launches = lane_kernel.launches
    stages = dict(evaluator.stage_s)
    t0 = time.perf_counter()
    serial_rows = run_cells(cells, workers=1)
    serial_s = time.perf_counter() - t0
    n_eligible = sum(evaluator.lane_eligible(c) for c in cells)
    checks["f3/rows_equal_serial"] = _rows_equal(lane_rows, serial_rows,
                                                 _RESULT_FIELDS)
    checks["f3/one_launch_per_bucket"] = f3_launches == 1
    checks["f3/labels_in_order"] = ([r["label"] for r in lane_rows]
                                    == [c.label for c in cells])
    checks["f3/infeasible_and_zero_pod"] = (
        sum(r["infeasible"] for r in lane_rows) == 1
        and sum(r["n_jobs"] == 0 for r in lane_rows) == 1)
    line["f3"] = {"cells": len(cells), "lane_eligible": n_eligible,
                  "serial_in_batch": len(cells) - n_eligible,
                  "lane_program_launches": f3_launches,
                  "lanes_path_s": lanes_s, "stage_s": stages,
                  "serial_path_s": serial_s}

    # Chaos: the golden traces on both engines, the 400-job rows.
    t0 = time.perf_counter()
    with open(CHAOS_TRACE) as f:
        golden_traces = json.load(f)
    for name in CHAOS_SCENARIOS:
        for engine in ("array", "object"):
            checks[f"chaos_trace/{name}/{engine}"] = (
                capture_chaos_trace(name, engine, seed=0,
                                    n_jobs=GOLDEN_JOBS)
                == golden_traces[name])
    traces_s = time.perf_counter() - t0
    with open(CHAOS_ROWS) as f:
        want_rows = json.load(f)
    chaos_rows = {}
    t0 = time.perf_counter()
    for name in CHAOS_SCENARIOS:
        row = run_chaos_cell(name, seed=0, engine="array")
        chaos_rows[name] = row
        checks[f"chaos_rows/{name}"] = (
            {k: v for k, v in row.items() if k != "wall_s"}
            == want_rows[name])
    rows_s = time.perf_counter() - t0
    line["chaos"] = {"traces_s": traces_s, "rows_s": rows_s,
                     "rows": chaos_rows}

    # Search: the pinned micro-search on both engines, a pool of 2 in a
    # child process, workers="lanes", and the report.
    with open(SEARCH_GOLDEN) as f:
        want_search = json.load(f)
    t0 = time.perf_counter()
    results = {engine: run_search(default_space(), SEARCH_SCENARIOS,
                                  workers=1, engine=engine,
                                  **SEARCH_SETTINGS)
               for engine in ("array", "object")}
    docs = {engine: _search_doc(res) for engine, res in results.items()}
    for engine, doc in docs.items():
        checks[f"search/golden/{engine}"] = all(
            doc[k] == want_search[k] for k in want_search)
    serial_res = results["array"]
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pooled = _run_pool_child()
    pool_s = time.perf_counter() - t0
    checks["search/pool_equal_serial"] = pooled["doc"] == docs["array"]
    checks["search/pool_child_no_torch"] = not pooled["torch_imported"]
    lane_kernel.launches = 0
    t0 = time.perf_counter()
    lanes_res = run_search(default_space(), SEARCH_SCENARIOS,
                           workers="lanes", **SEARCH_SETTINGS)
    search_lanes_s = time.perf_counter() - t0
    checks["search/lanes_equal_serial"] = (_search_doc(lanes_res)
                                           == docs["array"])
    report = build_report(serial_res, baseline_rows(
        SEARCH_SCENARIOS, seed=SEARCH_SETTINGS["seed"],
        n_jobs=SEARCH_SETTINGS["n_jobs"]))
    summary = summarize(report)
    checks["search/report_renders"] = (
        bool(json.dumps(report)) and summary[0].startswith("Pareto front"))
    line["search"] = {"serial_both_engines_s": search_s,
                      "pool_of_2_s": pool_s, "lanes_s": search_lanes_s,
                      "lanes_launches": lane_kernel.launches,
                      "front": len(serial_res.front),
                      "evaluations": serial_res.evaluations,
                      "summary": summary}

    # The flight recorder on phase 31's learned cell, the forecaster on
    # the card; the row kernel's count from 0 just before the run.
    with open(golden.ORCHESTRATE_FIXTURE) as f:
        want = json.load(f)["learned"]
    fc = model.load_forecaster(str(FORECASTER / "checkpoint"))
    spec = ExperimentSpec(**golden.LEARNED_SPEC, forecaster_obj=fc,
                          obs=True)
    reset_id_counters()
    sim = build_simulation(spec)
    torch.cuda.synchronize()
    mlstm.launches = mlstm.row_launches = mlstm.parallel_launches = 0
    t0 = time.perf_counter()
    result = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row_launches, all_launches = mlstm.row_launches, mlstm.launches
    result.workload = spec.workload_label()
    row = golden.result_row(result)
    rec = sim.obs
    checks["obs/row_equal_fixture"] = row == want["row"]
    checks["obs/row_launches_equal_phase_31"] = (
        row_launches == orch["learned"]["mlstm_row_launches"]
        == want["model_calls"] and all_launches == row_launches)
    # The ring keeps the latest ObsConfig().capacity events: its forecast
    # events are the last predict calls of the fixture's run.
    cols = rec.events.columns()
    fc_ev = cols["kind"] == EV_FORECAST
    n_fc = int(fc_ev.sum())
    calls = np.asarray(want["calls"])[-n_fc:] if n_fc else np.zeros((0, 3))
    checks["obs/ring_holds_latest"] = (
        len(rec.events) == min(rec.events.n_seen, rec.events.capacity))
    checks["obs/forecast_events"] = n_fc > 0 and bool(
        np.array_equal(cols["t"][fc_ev], calls[:, 0])
        and np.allclose(cols["rate"][fc_ev], calls[:, 1], **FORECAST_TOL)
        and np.allclose(cols["conf"][fc_ev], calls[:, 2], **FORECAST_TOL))
    bundle = rec.bundle()
    with tempfile.TemporaryDirectory(prefix="repro_torch_obs_") as root:
        for suffix in (".json", ".npz"):
            path = os.path.join(root, f"bundle{suffix}")
            t0 = time.perf_counter()
            save_bundle(bundle, path)
            back = load_bundle(path)
            checks[f"obs/bundle_round_trip{suffix}"] = (
                EventLog.from_payload(back["events"]).same_as(rec.events)
                and back["meta"] == bundle["meta"]
                and back["profile"]["names"] == bundle["profile"]["names"]
                and np.array_equal(back["profile"]["count"],
                                   bundle["profile"]["count"])
                and np.array_equal(back["node_count_n"],
                                   bundle["node_count_n"]))
            line.setdefault("bundle", {})[suffix] = {
                "bytes": os.path.getsize(path),
                "save_load_s": time.perf_counter() - t0}
    text = render_report(bundle, limit=20)
    checks["obs/report_renders"] = ("cycle-phase profile" in text
                                    and "forecast" in text)
    counts = np.bincount(cols["kind"].astype(np.int64),
                         minlength=len(KIND_NAMES))
    line["obs"] = {
        "completed": row["completed"], "wall_s": wall,
        "phase_31_wall_s": orch["learned"]["wall_s"],
        "wall_over_phase_31": wall / orch["learned"]["wall_s"],
        "mlstm_row_launches": row_launches, "mlstm_launches": all_launches,
        "events_seen": rec.events.n_seen,
        "events_retained": len(rec.events),
        "retained_by_kind": {n: int(c) for n, c in zip(KIND_NAMES, counts)},
        "forecast_events_checked": n_fc,
        "profiled_spans": rec.prof.n_spans_seen,
        "report_lines": len(text.splitlines())}
    line["checks"] = checks
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"chaos_search_obs: checks failed: {bad}")
    return line


# Phase 33: the live cluster.  Two torch training jobs on one card under
# the paper's orchestrator: job A, xLSTM-125M at its published widths cut
# to one superblock of its 12 layers (3 mLSTM + 1 sLSTM; the whole depth
# took 7.5 s a step, host bound in the sLSTM's walk), evicted once and
# resumed from its checkpoint; job B, DeepSeekMoE-16B's widths cut to 2
# of its 28 layers (the dense first layer and one MoE layer), never
# evicted.
LIVE_SEQ = 512                 # two sLSTM remat chunks; one MoE group
LIVE_BATCH = 4
LIVE_STEPS = 4
LIVE_EVICT_AT = 2              # evict job A once it has finished step 2
LIVE_XLSTM_LAYERS = 4
LIVE_MOE_LAYERS = 2
LIVE_CYCLE_S = 0.1
LIVE_TIMEOUT_S = 300.0
# Launches a step, predicted from the step's structure: a superblock's
# forward runs twice (the step's, and its checkpoint's recompute in the
# backward, whose own backward differentiates the plain version), so
# the xLSTM cut's 3 mLSTM blocks launch the parallel mLSTM kernel 6 times
# a step, and the MoE cut's 2 attention layers launch flash 4 times.
LIVE_MLSTM_PER_STEP = 6
LIVE_FLASH_PER_STEP = 4
# Job B's losses in the live run are held to its solo run's with ``==``,
# as job A's: the MoE layer's dispatch adds in a fixed order.  Its
# forward copies each kept choice to its own row (index_copy) and sums a
# token's K rows along a fixed axis; the backward of the gathers adds
# through index_put(accumulate=True), which on CUDA sorts the indices
# stably and adds each row's values in that order.


def _whole_walk(xlstm):
    """The sLSTM walk without the remat plan (one loop over all T, every
    step's autograd state kept), for the phase's memory comparison."""
    def walk(gx, r_h, bias, cfg):
        st = xlstm.slstm_decode_init(cfg, gx.shape[0], gx.device)
        return xlstm._walk_steps(gx, r_h, bias,
                                 *(st[k] for k in ("c", "n", "m", "h")))
    return walk


def _walk_peak(torch, xlstm, cfg, dev, walk) -> dict:
    """One sLSTM layer's walk alone at the job's shape (gx (B, T, 4, D),
    r_h and bias in bfloat16, as the train step hands them over): the
    peak of its forward and backward above what was allocated before,
    and its seconds."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, T, D, H = LIVE_BATCH, LIVE_SEQ, cfg.d_model, cfg.num_heads
    bf16 = torch.bfloat16
    gx = torch.randn((B, T, 4, D), generator=gen, device=dev).to(bf16)
    r_h = (0.1 * torch.randn((H, D // H, 4, D // H), generator=gen,
                             device=dev)).to(bf16)
    bias = torch.zeros((4, D), device=dev, dtype=bf16)
    for t in (gx, r_h, bias):
        t.requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    walk(gx, r_h, bias, cfg)[0].sum().backward()
    torch.cuda.synchronize()
    return {"peak_above_inputs_bytes": torch.cuda.max_memory_allocated()
            - base, "seconds": time.perf_counter() - t0}


def phase_live(torch, np, dev) -> dict:
    """The paper's orchestrator scheduling real training jobs on the
    card: ``LiveCluster.run`` → ``Orchestrator.cycle`` → ``_sync_jobs``
    → ``LiveJob.start`` → ``Trainer.run`` in a thread → ``evict`` →
    ``request_stop`` → checkpoint → rebind → resume.

    First each job alone (its solo run: step ms, tokens/s, model FLOP/s,
    peak memory, launches a step), job A's last step with the sLSTM walk
    called without the remat plan (the peak of a step with and without
    it), and one sLSTM walk alone both ways; then both jobs as two batch
    pods on one static node of ``LocalCloudProvider(Resources(2000,
    8192))``, best-fit binding both, job A evicted once its trainer has
    finished step ``LIVE_EVICT_AT``.  Gates: both pods ``SUCCEEDED``; A
    evicted once and resumed at the step it stopped at; each job's
    losses ``==`` its solo run's; the node billed; the kernels launched
    as predicted in every run, at the shapes phases 6 and 9 hold against
    the plain versions (``MLSTM_LIVE_CASE``, ``FLASH_LIVE_CASE``); no
    exception in a job
    thread (caught by ``threading.excepthook``: a job thread that raises
    dies without a result, and the cluster would wait on it until its
    timeout).  Last,
    ``repro_torch.launch.orchestrate --compare --workload mixed`` in
    process: its rows ``==`` phase 31's fixture rows and its text
    ``==`` those rows printed."""
    import contextlib
    import dataclasses
    import gc
    import io
    import shutil
    import tempfile
    import threading
    from repro_torch.cloud.local_provider import (LiveCluster,
                                                  LocalCloudProvider)
    from repro_torch.configs import get_config
    from repro_torch.core import (CostModel, ExperimentResult, PodKind,
                                  PodPhase, PodSpec, Resources, golden,
                                  reset_id_counters)
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import mlstm_chunkwise as mlstm
    from repro_torch.launch import orchestrate
    from repro_torch.models import transformer as tf
    from repro_torch.models import xlstm
    from repro_torch.models.params import count_params
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import DataConfig
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    cfgs = {"A": dataclasses.replace(get_config("xlstm-125m"),
                                     num_layers=LIVE_XLSTM_LAYERS),
            "B": dataclasses.replace(get_config("deepseek-moe-16b"),
                                     num_layers=LIVE_MOE_LAYERS)}
    tokens = LIVE_BATCH * LIVE_SEQ
    n_model = {"A": count_params(tf.model_specs(cfgs["A"])),
               "B": cfgs["B"].active_param_count()}
    line = {"phase": "live", "steps": LIVE_STEPS, "batch": LIVE_BATCH,
            "seq_len": LIVE_SEQ, "tokens_per_step": tokens,
            "evict_after_step": LIVE_EVICT_AT,
            "jobs": {"A": {"arch": cfgs["A"].name,
                           "layers": cfgs["A"].num_layers,
                           "params": n_model["A"]},
                     "B": {"arch": cfgs["B"].name,
                           "layers": cfgs["B"].num_layers,
                           "params": count_params(tf.model_specs(cfgs["B"])),
                           "active_params": n_model["B"]}},
            "predicted_per_step": {"mlstm_parallel": LIVE_MLSTM_PER_STEP,
                                   "flash_attention": LIVE_FLASH_PER_STEP}}
    # The kernels' calls on this path are the cases phases 6 and 9 checked.
    _, heads, dh = xlstm._dims(cfgs["A"])
    checks = {
        "cases/mlstm_live_shape_checked": MLSTM_LIVE_CASE == (
            LIVE_BATCH, heads, LIVE_SEQ, dh, dh, xlstm.MLSTM_CHUNK,
            cfgs["A"].dtype, False),
        "cases/flash_live_shape_checked": FLASH_LIVE_CASE == (
            LIVE_BATCH, cfgs["B"].num_heads, cfgs["B"].num_kv_heads,
            LIVE_SEQ, LIVE_SEQ, cfgs["B"].head_dim_, True,
            cfgs["B"].sliding_window, cfgs["B"].dtype)}

    def counts():
        return {"mlstm_parallel": mlstm.parallel_launches,
                "mlstm_other": mlstm.launches - mlstm.parallel_launches,
                "flash_attention": flash.launches}

    def zero_counts():
        mlstm.launches = mlstm.row_launches = mlstm.parallel_launches = 0
        flash.launches = 0

    def factory(job, ckpt_dir, built, log=lambda s: None):
        def build():
            tr = Trainer(cfgs[job], OptimizerConfig(
                learning_rate=1e-3, warmup_steps=2, total_steps=LIVE_STEPS),
                DataConfig(batch_size=LIVE_BATCH, seq_len=LIVE_SEQ, seed=0),
                TrainerConfig(total_steps=LIVE_STEPS,
                              checkpoint_every=2 if ckpt_dir else 0,
                              checkpoint_dir=ckpt_dir, keep_checkpoints=1,
                              log_every=1, seed=0),
                log_fn=log, device=dev)
            built.append(tr)
            return tr
        return build

    def losses(trainers):
        return [h["loss"] for tr in trainers for h in tr.history]

    def release(trainers):
        for tr in trainers:
            tr.state = None
        trainers.clear()
        gc.collect()
        torch.cuda.empty_cache()

    # Each job alone: the yardstick of the live run.  Job A's last step
    # calls the sLSTM walk without the remat plan (the step's forward, so
    # its loss, is the same): the peak of a step with and without it.
    solo = {}
    whole_walk = _whole_walk(xlstm)
    for job in ("A", "B"):
        gc.collect()
        torch.cuda.empty_cache()
        built = []
        zero_counts()
        t0 = time.perf_counter()
        tr = factory(job, None, built)()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        state_bytes = torch.cuda.memory_allocated()
        inner = tr._step_fn
        step_ms, per_step, step_peak = [], [], []

        def timed(state, batch, inner=inner, step_ms=step_ms,
                  per_step=per_step, step_peak=step_peak,
                  last_whole=job == "A"):
            before = counts()
            walk = xlstm._walk
            if last_whole and len(step_ms) == LIVE_STEPS - 1:
                xlstm._walk = whole_walk
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                out = inner(state, batch)
                torch.cuda.synchronize()
            finally:
                xlstm._walk = walk
            step_ms.append((time.perf_counter() - t) * 1e3)
            step_peak.append(torch.cuda.max_memory_allocated())
            per_step.append({k: v - before[k] for k, v in counts().items()})
            return out

        tr._step_fn = timed
        t0 = time.perf_counter()
        result = tr.run()
        run_s = time.perf_counter() - t0
        remat = step_ms[:-1] if job == "A" else step_ms
        med = float(np.median(remat))
        flops = 6 * n_model[job] * tokens
        solo[job] = {
            "result": result, "losses": losses([tr]),
            "init_s": init_s, "run_s": run_s, "wall_s": init_s + run_s,
            "state_bytes": state_bytes, "step_ms": step_ms,
            "step_ms_median": med, "tokens_per_s": tokens / (med * 1e-3),
            "model_flops_per_step": flops,
            "model_tflops_per_s": flops / (med * 1e-3) / 1e12,
            "share_of_989_tflops": flops / (med * 1e-3) / BF16_OPS_PER_S,
            "peak_device_bytes": max(step_peak), "step_peak_bytes": step_peak,
            "launches_by_step": per_step}
        if job == "A":
            solo[job]["slstm_memory"] = {
                "step_peak_bytes_remat": max(step_peak[:-1]),
                "step_peak_bytes_whole_walk": step_peak[-1],
                "step_ms_median_remat": med,
                "step_ms_whole_walk": step_ms[-1],
                "walk_only": {plan: _walk_peak(torch, xlstm, cfgs["A"], dev,
                                               walk)
                              for plan, walk in (("remat", xlstm._walk),
                                                 ("whole_walk",
                                                  whole_walk))}}
        release(built)
        emit({"phase": "live_solo", "job": job, "arch": cfgs[job].name,
              **{k: solo[job][k] for k in (
                  "losses", "step_ms", "step_ms_median", "tokens_per_s",
                  "model_tflops_per_s", "peak_device_bytes", "init_s",
                  "run_s")},
              "slstm_memory": solo[job].get("slstm_memory")})
    checks["solo/completed"] = all(solo[j]["result"]["completed"] == 1.0
                                   and len(solo[j]["losses"]) == LIVE_STEPS
                                   for j in solo)
    checks["solo/A_launches"] = all(
        s == {"mlstm_parallel": LIVE_MLSTM_PER_STEP, "mlstm_other": 0,
              "flash_attention": 0}
        for s in solo["A"]["launches_by_step"])
    checks["solo/B_launches"] = all(
        s == {"mlstm_parallel": 0, "mlstm_other": 0,
              "flash_attention": LIVE_FLASH_PER_STEP}
        for s in solo["B"]["launches_by_step"])

    # The live run.
    root = tempfile.mkdtemp(prefix="repro_torch_live_")
    errors, events = [], []
    prev_hook = threading.excepthook

    def hook(args):
        errors.append(f"{args.thread.name}: {args.exc_type.__name__}: "
                      f"{args.exc_value}")
        prev_hook(args)

    ckpt_s = {"save": [], "restore": []}
    orig_save, orig_restore = CheckpointManager.save, CheckpointManager.restore

    def timed_save(self, *a, **kw):
        t = time.perf_counter()
        out = orig_save(self, *a, **kw)
        ckpt_s["save"].append(time.perf_counter() - t)
        return out

    def timed_restore(self, *a, **kw):
        t = time.perf_counter()
        out = orig_restore(self, *a, **kw)
        torch.cuda.synchronize()
        ckpt_s["restore"].append(time.perf_counter() - t)
        return out

    built = {"A": [], "B": []}
    logs_a = []
    try:
        threading.excepthook = hook
        CheckpointManager.save = timed_save
        CheckpointManager.restore = timed_restore
        gc.collect()
        torch.cuda.empty_cache()
        cost = CostModel()
        provider = LocalCloudProvider(Resources(2000, 8192), cost)
        live = LiveCluster(provider, cycle_period_s=LIVE_CYCLE_S,
                           log=events.append)
        cycles = [0]
        inner_cycle = live.orch.cycle

        def counted_cycle(now):
            cycles[0] += 1
            return inner_cycle(now)

        live.orch.cycle = counted_cycle
        live.add_static_nodes(1)
        pod_a = live.submit(
            PodSpec(cfgs["A"].name, PodKind.BATCH, Resources(1000, 4096),
                    checkpointable=True),
            factory("A", os.path.join(root, "A"), built["A"],
                    logs_a.append))
        pod_b = live.submit(
            PodSpec(cfgs["B"].name, PodKind.BATCH, Resources(1000, 4096)),
            factory("B", None, built["B"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        first_cycle = []

        def until_evict():
            if not first_cycle:
                first_cycle.append([(p.phase, p.node_id)
                                    for p in (pod_a, pod_b)])
            return bool(errors) or (bool(built["A"]) and
                                    built["A"][0].step >= LIVE_EVICT_AT)

        ran_to_evict = live.run(until=until_evict, timeout_s=LIVE_TIMEOUT_S)
        both_bound = (first_cycle[0][0][0] == first_cycle[0][1][0]
                      == PodPhase.BOUND and first_cycle[0][0][1]
                      == first_cycle[0][1][1] is not None)
        t_evict = time.perf_counter()
        live.evict(pod_a)
        evict_s = time.perf_counter() - t_evict
        after_evict = (pod_a.phase, pod_a.incarnation)
        stopped = built["A"][0].step if built["A"] else None
        first_result = live.jobs[pod_a.uid].result
        ran_to_end = live.run(until=lambda: bool(errors) or live.batch_done(),
                              timeout_s=LIVE_TIMEOUT_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        peak = torch.cuda.max_memory_allocated()
        total_cost = cost.total_cost(time.time())
        live_losses = {j: losses(built[j]) for j in built}
        results = {j: [live.jobs[p.uid].result] for j, p in
                   (("A", pod_a), ("B", pod_b))}
        incarnations = {j: p.incarnation for j, p in (("A", pod_a),
                                                      ("B", pod_b))}
        phases = {j: p.phase.value for j, p in (("A", pod_a), ("B", pod_b))}
        resumed_at = [m for m in logs_a if m.startswith("[trainer] resumed")]
        trainers = {j: len(built[j]) for j in built}
    finally:
        threading.excepthook = prev_hook
        CheckpointManager.save, CheckpointManager.restore = (orig_save,
                                                             orig_restore)
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(root) for f in fs)
        shutil.rmtree(root, ignore_errors=True)
        for trs in built.values():
            release(trs)
    steps = LIVE_STEPS
    checks.update({
        "live/no_thread_exception": not errors,
        "live/run_returned_true": ran_to_evict and ran_to_end,
        "live/both_bound_to_one_node": both_bound,
        "live/both_succeeded": phases == {"A": "succeeded",
                                          "B": "succeeded"},
        "live/A_evicted_pending_incarnation_1": (
            after_evict == (PodPhase.PENDING, 1) and incarnations["A"] == 1
            and trainers["A"] == 2),
        "live/A_stopped_at_or_after_evict_step": (
            stopped is not None and LIVE_EVICT_AT <= stopped < steps
            and first_result == {"completed": 0.0, "step": float(stopped)}),
        "live/A_resumed_where_it_stopped": resumed_at == [
            f"[trainer] resumed from step {stopped}"],
        "live/A_losses_equal_solo": live_losses["A"] == solo["A"]["losses"],
        "live/B_never_evicted": incarnations["B"] == 0 and trainers["B"] == 1,
        "live/B_losses_finite": len(live_losses["B"]) == steps and bool(
            np.all(np.isfinite(live_losses["B"]))),
        "live/B_losses_equal_solo": live_losses["B"] == solo["B"]["losses"],
        "live/billed": total_cost > 0,
        "live/launches": launched == {
            "mlstm_parallel": steps * LIVE_MLSTM_PER_STEP, "mlstm_other": 0,
            "flash_attention": steps * LIVE_FLASH_PER_STEP}})
    b_diff = (float(np.max(np.abs(np.subtract(live_losses["B"],
                                               solo["B"]["losses"]))))
              if len(live_losses["B"]) == steps else None)
    line["live"] = {
        "wall_s": wall, "solo_wall_sum_s": solo["A"]["wall_s"]
        + solo["B"]["wall_s"],
        "wall_over_solo_sum": wall / (solo["A"]["wall_s"]
                                      + solo["B"]["wall_s"]),
        "cycles": cycles[0], "evict_s": evict_s, "stopped_at": stopped,
        "first_result": first_result, "resumed": resumed_at,
        "incarnations": incarnations,
        "results": results, "losses": live_losses,
        "B_max_abs_loss_diff": b_diff, "launches": launched,
        "peak_device_bytes": peak, "total_cost": total_cost,
        "checkpoint_save_s": ckpt_s["save"],
        "checkpoint_restore_s": ckpt_s["restore"],
        "checkpoint_bytes_left": ckpt_bytes, "events": events,
        "thread_errors": errors}
    emit({"phase": "live_run", **{k: line["live"][k] for k in (
        "wall_s", "solo_wall_sum_s", "cycles", "stopped_at", "launches",
        "checkpoint_save_s", "checkpoint_restore_s", "B_max_abs_loss_diff",
        "total_cost")}})

    # The orchestration CLI in process, against phase 31's fixture.
    with open(golden.ORCHESTRATE_FIXTURE) as f:
        fx = json.load(f)
    recorded = {}
    inner_fns = (orchestrate.run_all_combos, orchestrate.run_k8s_baseline)
    orchestrate.run_all_combos = lambda *a, **kw: recorded.setdefault(
        "fig3", inner_fns[0](*a, **kw))
    orchestrate.run_k8s_baseline = lambda *a, **kw: recorded.setdefault(
        "fig4", inner_fns[1](*a, **kw))
    got_text = io.StringIO()
    t0 = time.perf_counter()
    try:
        reset_id_counters()
        with contextlib.redirect_stdout(got_text):
            orchestrate.main(["--compare", "--workload", "mixed"])
    finally:
        orchestrate.run_all_combos, orchestrate.run_k8s_baseline = inner_fns
    cli_s = time.perf_counter() - t0
    want_text = io.StringIO()
    k8s = ExperimentResult(**fx["fig4"]["mixed"])
    with contextlib.redirect_stdout(want_text):
        print("[orchestrate] workload=mixed (Fig. 3 + Fig. 4)")
        print(f"  K8S-static n={k8s.max_nodes} cost=${k8s.cost:8.2f} "
              f"dur={k8s.duration_s:7.0f}s")
        for row in fx["fig3"]["mixed"]:
            orchestrate._print(ExperimentResult(**row), k8s.cost)
    checks["cli/fig3_rows_equal"] = [golden.result_row(r) for r in
                                     recorded.get("fig3", [])] \
        == fx["fig3"]["mixed"]
    checks["cli/fig4_row_equal"] = ("fig4" in recorded and golden.result_row(
        recorded["fig4"]) == fx["fig4"]["mixed"])
    checks["cli/text_equal"] = got_text.getvalue() == want_text.getvalue()
    line.update({"solo": solo, "checks": checks, "cli_s": cli_s,
                 "cli_text": got_text.getvalue().splitlines(),
                 "seconds": time.perf_counter() - t_phase})
    emit(line)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"live: checks failed: {bad}")
    return line


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np
    dev = torch.device("cuda")
    info = phase_device(torch)
    phase_build()
    k = phase_kernel(torch, np, dev)
    phase_golden(torch, np, dev)
    main_line = phase_main(torch, np, dev)
    m = phase_mlstm(torch, np, dev)
    data = phase_forecast_golden(torch, np, dev)
    forecast_line = phase_forecast_main(torch, np, dev, data)
    fl = phase_flash(torch, np, dev)
    rg = phase_rglru(torch, np, dev)
    phase_serve_golden(torch, np, dev)
    serve_line = phase_serve_main(torch, np, dev)
    phase_grad(torch, np, dev)
    early = start_dryruns(DRYRUN_PHASE29 + DRYRUN_CELLS)
    t0 = time.perf_counter()
    phase_train_golden(torch, np, dev)
    ft = phase_forecast_train(torch, np, dev, data, forecast_line)
    tm = phase_train_main(torch, np, dev)
    emit({"phase": "train_phases", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    xg = phase_xlstm_golden(torch, np, dev)
    xs = phase_xlstm_serve_main(torch, np, dev)
    emit({"phase": "xlstm_phases", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    mg = phase_moe_golden(torch, np, dev)
    moe_line = phase_moe_serve_main(torch, np, dev)
    gr = phase_granite(torch, np, dev)
    emit({"phase": "moe_phases", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    dg = phase_dense_golden(torch, np, dev)
    cr = phase_command_r_serve_main(torch, np, dev)
    qw = phase_qwen_check(torch, np, dev)
    emit({"phase": "dense_phases", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    wg = phase_whisper_golden(torch, np, dev)
    ws = phase_whisper_serve_main(torch, np, dev)
    vg = phase_vlm_golden(torch, np, dev)
    vs = phase_internvl_serve_main(torch, np, dev)
    emit({"phase": "modality_phases", "seconds": time.perf_counter() - t0})
    dp = phase_distributed(torch, np, dev, info["nvidia_smi"])
    dr = phase_dryrun(torch, np, dev, info["nvidia_smi"], early)
    orch = phase_orchestrate(torch, np, dev)
    cso = phase_chaos_search_obs(torch, np, dev, orch)
    live = phase_live(torch, np, dev)
    t0 = time.perf_counter()
    scg = phase_softcap_golden(torch, np, dev)
    sc = phase_softcap_serve_main(torch, np, dev)
    emit({"phase": "softcap_phases", "seconds": time.perf_counter() - t0})
    emit({"kernels": [{
        "name": "lane_program", "route": "cuda",
        "source": "src/repro_torch/manyworld/csrc/lane_program.cu",
        "replaces": "src/repro/manyworld/lanes.py:196 + "
                    "src/repro/manyworld/select.py:65",
        "launches": main_line["lane_program_launches"],
        "launches_by_path": {
            "main": main_line["lane_program_launches"],
            "orchestrate_lanes": orch["lanes"]["lane_program_launches"],
            "f3_mixed_batch": cso["f3"]["lane_program_launches"]},
        "max_abs_err": main_line["max_abs_err"],
        "ms": main_line["lane_program_ms_median"],
        "plain_ms": main_line["lockstep_plain_select_run_wall_s"] * 1e3,
        "library_ms": None, "bound_ms": main_line["bound_ms"],
        "bound_by": main_line["bound_by"]}, {
        "name": "masked_argmin", "route": "cuda",
        "source": "src/repro_torch/manyworld/csrc/masked_argmin.cu",
        "replaces": "src/repro/manyworld/select.py:65",
        "launches": main_line["lockstep_select_launches"],
        "match": True, "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"], "library_ms": k["library_ms"],
        "bound_ms": k["bound_ms"], "bound_us": k["bound_ms"] * 1e3,
        "bound_by": k["bound_by"]}, {
        "name": "mlstm_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_chunkwise.cu",
        "replaces": "src/repro/kernels/mlstm_chunkwise.py:31",
        "launches": forecast_line["mlstm_row_launches"],
        "launches_by_path": {
            "forecast": forecast_line["mlstm_row_launches"],
            "forecast_train": ft["mlstm_row_launches"],
            "orchestrate": orch["learned"]["mlstm_row_launches"],
            "orchestrate_obs": cso["obs"]["mlstm_row_launches"]},
        "predict_shape": orch["predict_shape"]["shape"],
        "predict_shape_ms": orch["predict_shape"]["kernel_ms"],
        "predict_shape_plain_ms": orch["predict_shape"]["plain_ms"],
        "predict_shape_bound_ms": orch["predict_shape"]["bound_ms"],
        "predict_shape_max_abs_err": orch["predict_shape"]["max_abs_err"],
        "max_abs_err": m["max_abs_err_by_kernel"]["mlstm_rows"],
        "ms": m["kernel_ms"], "block_kernel_ms": m["block_kernel_ms"],
        "plain_ms": m["plain_ms"], "library_ms": None,
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "design": "a lane per row of a chunk, one or two (b, h) a warp, "
                  "no block barrier; persistent blocks whose warps keep "
                  "the next chunk in a cp.async ring"}, {
        "name": "mlstm_parallel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_parallel.cu",
        "replaces": "src/repro/kernels/mlstm_chunkwise.py:31",
        "launches": xs["launches"]["mlstm_parallel"],
        "on_main_path": True,
        "launches_by_path": {
            "xlstm_serve": xs["launches"]["mlstm_parallel"],
            "xlstm_golden_float32": xg["mlstm_parallel_launches"],
            "live_xlstm": live["live"]["launches"]["mlstm_parallel"]},
        "edge_case_launches": m["launches"]["parallel"],
        "live_shape": list(MLSTM_LIVE_CASE[:5]),
        "live_shape_max_abs_err": m["cases"][_mlstm_name(
            MLSTM_LIVE_CASE)]["max_abs_err_h"],
        "live_train_call_max_abs_err": m["cases"][_mlstm_name(
            MLSTM_LIVE_CASE)]["train_call_max_abs_err"],
        "shape": m["xlstm"]["shape"], "dtype": m["xlstm"]["dtype"],
        "max_abs_err": m["xlstm"]["max_abs_err"],
        "worst_share_of_tol": m["xlstm"]["worst_share_of_tol"],
        "ms": m["xlstm"]["kernel_ms"], "plain_ms": m["xlstm"]["plain_ms"],
        "parallel_plain_ms": m["xlstm"]["parallel_plain_ms"],
        "block_kernel_ms": m["xlstm"]["block_kernel_ms"],
        "library_ms": None, "bound_ms": m["xlstm"]["bound_ms"],
        "bound_by": m["xlstm"]["bound_by"],
        "ms_by_T": {t: r["parallel"]["ms"]
                    for t, r in m["xlstm"]["by_T"].items()},
        "design": "chunk-parallel on the tensor cores: a gate pass, a "
                  "state pass (a warpgroup per (b, h, 64 x 128 tile of C) "
                  "walking the chunks, the states out as bf16 hi/lo tiles "
                  "by bulk copy) and an output pass (a warpgroup per (b, "
                  "h, chunk, 64 columns), wgmma over dk in 64-wide "
                  "panels)"}, {
        "name": "mlstm_chunkwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_chunkwise.cu",
        "replaces": "src/repro/kernels/mlstm_chunkwise.py:31",
        "launches": xg["mlstm_block_launches"],
        "on_main_path": False,
        "serves": "float32 calls outside the row kernel's envelope (the "
                  "xLSTM float32 twin of phase 17, float32 edge cases) "
                  "and bfloat16 calls outside the parallel kernel's (L "
                  "!= 64, dk or dv not whole 64-wide tiles)",
        "launches_by_path": {
            "xlstm_golden_float32": xg["mlstm_block_launches"],
            "xlstm_serve": xs["launches"]["mlstm_chunkwise"],
            "forecast": forecast_line["mlstm_launches"]
                        - forecast_line["mlstm_row_launches"]},
        "edge_case_launches": m["launches"]["block"],
        "shape": m["xlstm"]["shape"], "dtype": m["xlstm"]["dtype"],
        "max_abs_err": m["max_abs_err_by_kernel"]["mlstm_chunkwise"],
        "ms": m["xlstm"]["block_kernel_ms"],
        "plain_ms": m["xlstm"]["plain_ms"],
        "library_ms": None, "bound_ms": m["xlstm"]["block_bound_ms"],
        "bound_by": m["xlstm"]["block_bound_by"],
        "ms_by_T": {t: r["block"]["ms"]
                    for t, r in m["xlstm"]["by_T"].items()},
        "forecast_shape_ms": m["block_kernel_ms"],
        "design": "a block per (b, h) and 32 columns of C; q and k pass "
                  "through shared memory in 128-column panels, each "
                  "thread summing a register tile of q.k, q.C and the C "
                  "update"}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:39",
        "launches": serve_line["launches"]["flash_attention"],
        "launches_by_path": {
            "serve": serve_line["launches"]["flash_attention"],
            "train": tm["launches"]["flash_attention"],
            "moe_serve": moe_line["launches"]["flash_attention"],
            "moe_golden_float32": mg["flash_launches"],
            "granite": gr["flash_launches"],
            "command_r_serve": cr["launches"]["flash_attention"],
            "dense_golden_float32": dg["flash_launches"],
            "qwen_check": qw["flash_launches"],
            "whisper_serve": ws["launches"]["flash_attention"],
            "whisper_golden_float32": wg["flash_launches"],
            "internvl_serve": vs["launches"]["flash_attention"],
            "vlm_golden_float32": vg["flash_launches"],
            "sharded_train": dp["sharded_flash_launches"],
            "dryrun_check": dr["flash_launches"],
            "live_moe": live["live"]["launches"]["flash_attention"],
            "softcap_serve": sc["launches"]["flash_attention"],
            "softcap_golden_float32": scg["flash_launches"]},
        "live_shape": list(FLASH_LIVE_CASE[:6]),
        "live_shape_max_abs_err": fl["cases"][_flash_name(
            FLASH_LIVE_CASE)]["max_abs_err"],
        "moe_shape": fl["moe_shape"],
        "command_r_shape": fl["command_r_shape"],
        "whisper_shapes": fl["whisper_shapes"],
        "internvl_shapes": fl["internvl_shapes"],
        "qwen_shape_padded": qw["flash_by_heads"][qw["pad_heads_to"]],
        "qwen_shape_unpadded": qw["flash_by_heads"][qw["num_heads"]],
        "softcap": {key: fl["softcap"][key] for key in (
            "softcap", "timed", "max_abs_err_bf16", "max_abs_err_f32")},
        "max_abs_err": fl["max_abs_err"],
        "max_abs_err_train": fl["max_abs_err_train"], "ms": fl["kernel_ms"],
        "plain_ms": fl["plain_ms"], "library_ms": fl["library_ms"],
        "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"]}, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:35",
        "launches": serve_line["launches"]["rglru_ring"],
        "launches_by_path": {"serve": serve_line["launches"]["rglru_ring"],
                             "train": tm["launches"]["rglru_ring"]},
        "max_abs_err": rg["max_abs_err"]["ring"], "T": rg["ring"]["T"],
        "ms": rg["ring"]["ms"], "parent_ms": rg["ring"]["parent_ms"],
        "plain_ms": rg["ring"]["plain_ms"], "library_ms": None,
        "bound_ms": rg["ring"]["bound_ms"],
        "bound_by": rg["ring"]["bound_by"],
        "design": "the ring kernel, for inputs over 24 MB: a and b stream "
                  "once through a shared-memory ring kept full by seven "
                  "copier warps while warp 0 walks each channel in "
                  "order"}, {
        "name": "rglru_chunked", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:35",
        "launches": serve_line["launches"]["rglru_chunked"],
        "launches_by_path": {
            "serve": serve_line["launches"]["rglru_chunked"],
            "train": tm["launches"]["rglru_chunked"]},
        "max_abs_err": rg["max_abs_err"]["chunked"],
        "T": rg["chunked"]["T"], "ms": rg["chunked"]["ms"],
        "plain_ms": rg["chunked"]["plain_ms"], "library_ms": None,
        "bound_ms": rg["chunked"]["bound_ms"],
        "bound_by": rg["chunked"]["bound_by"],
        "design": "the PR 13 kernel, unchanged, for inputs of up to 24 MB: "
                  "16 time chunks a block, each walked twice, the second "
                  "walk from L2"}]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
