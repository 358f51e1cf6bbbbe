#!/usr/bin/env python3
"""Build the PyTorch/CUDA port (``src/repro_torch``) on one GPU and drive it.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --sim-apps 2100  # the full 2,100-app trace
    python3 chip_smoke.py --sim-apps 300   # shorter main-path traces
    python3 chip_smoke.py --parent DIR     # the K1, K2, K3 and K7 sweeps
                                           # beside the kernels of the
                                           # checkout in DIR

Phases (any failure raises and the script exits non-zero):

1. build every CUDA source of the port, one ``nvcc`` each, all at once,
   and print ptxas's register / shared-memory / spill report, with a
   summary for the attention, grouped-matmul and SSD kernels and the
   tensor-core instruction count of the prefill-attention and
   grouped-matmul (HGMMA) and SSD (HMMA) libraries (none fails);
2. the main path: ``run_sim`` on an open-arrival trace at ``SimConfig()``
   defaults on ``cuda`` (the fused walk kernel, K1), with every kernel
   launch counter set to 0 just before and read just after.  The trace is
   the first 1,400 applications of a 2,100-app trace by default, so that
   this phase and the next, which runs the same trace, fit the script's
   time; ``--sim-apps 2100`` runs all of it.  It prints K1's rows per
   launch (mean, median, max), read from each call's arguments;
3. the composed path: the same trace with ``RefreshConfig(rank_in_kernel=
   False)`` (the per-phase walk kernel, K2, with compaction between
   phases), counters reset and read around it; its completion order and
   ACTs must equal phase 2's.  It prints K2's launches per refresh call and
   lanes per launch (mean, median, max) and the commonest launch shapes,
   read from each call's arguments;
4. the posterior path: the drift benchmark's full scenario with online
   posterior learning (K1 with posterior operands) on ``cuda``, counters
   reset and read around it, and on the CPU: identical completion order,
   ACTs within 1e-6 relative;
5. hold each kernel against its plain PyTorch version on the card
   (bitwise) at 4,096 apps: K1 at the main path's walker count and
   override width as phase 2 left them (also at the median and largest
   row count of its launches there) and at W=512 with override width 64,
   with each walker's steps printed; K1 with posterior tables; K2 launch
   by launch at the composed path's median and largest launch, through
   the compacted walk of 4,096 apps and once single-phase with posterior
   tables; time each with CUDA events beside its bound (of the tables,
   only the rows the launch's lanes name); then K1's sweep over max_steps
   1, 8, 64 with arrival rows off and on (what its time is made of) and
   K2's over the same launches with arrivals off and on, with
   ``--parent`` beside the parent's kernels (parent, this tree, this
   tree, parent, each in a process of its own);
6. delta refresh ticks on a 16,384-slot arena with 8 % dirty slots and
   prewarming on at the main path's walker count, with the rank in the
   kernel and composed from K2, from the same arena state: bitwise equal,
   timed and profiled;
7. a small trace on ``cuda`` and on the CPU (the plain versions):
   identical completion order and ACTs; then the threefry walker (no
   kernel) on the first 100 applications of phase 2's trace, composed
   with Gittins and with ``srpt_mean``, on ``cuda`` and on the CPU:
   identical schedules, ms per refresh call;
8. hold each model kernel against its plain PyTorch version on the card
   at the reference's tolerances (2e-5 float32, 2e-2 bfloat16): RMSNorm
   (K3), prefill attention (K4) and decode attention (K5), at the serve
   path's shapes and at full-width Llama-3-8B shapes (K4 also at
   qwen2-7b's G = 7 and Whisper's 1,500 frames; K5 over one to 16
   sequence splits, two launches bitwise equal), each timed beside its
   bound, its plain version and one PyTorch library call; K3 also at
   every launch plan (D from 64 to 16,384, an input off 16-byte
   alignment) and its sweep, with ``--parent`` beside the parent's kernel;
   K5's bfloat16-scores option (``decode_f32_scores=False``: each q.k
   rounded to bfloat16 before the scale) at the engine's shape, over 8
   rows of up to 8,192 positions and in the partial mode, each timed;
9. Llama-3-8B at full width cut to 2 layers: a 24-token prompt and 8
   teacher-forced decode steps on ``cuda`` (through K3-K5) and on the CPU
   (the plain versions) from the same weights: logits within 5e-2;
10. the serve path: ``repro_torch.launch.serve`` with ``--apps 10`` on a
   full-width Llama-3-8B (32 layers, bfloat16, random weights drawn on the
   card), counters reset and read around it: every LLM request of the
   trace served, K3-K5 launched, the scheduler in the reference's bare
   default (``composed``: threefry host samples, no K1); then one decode
   step timed and profiled;
11. a tiny float32 Llama-3 through the engine on ``cuda`` and on the CPU:
   identical output tokens, completion order, prefix flags and LoRA
   counters;
12. hold the grouped expert matmul (K6) against its plain version on the
   card at the reference's tolerances for it (1e-4 float32, 2e-2
   bfloat16): Qwen1.5-MoE's decode, short-prefill and 2,048-token
   prefill (C = 160) products, Phi-3.5-MoE's, the reference's test sweep
   and the tiny models' shapes, in both dtypes, each timed beside its
   bound, its plain version and ``torch.bmm``;
13. Qwen1.5-MoE-A2.7B at full width cut to 2 of its 24 layers, in
   float32: a 24-token prompt and 8 teacher-forced decode steps on
   ``cuda`` (K3-K6) and on the CPU from the same weights: logits within
   1e-4, and the tokens whose expert sets differ counted per layer;
14. the MoE serve path: phase 10 on a full-width Qwen1.5-MoE-A2.7B (24
   layers, bfloat16, random weights drawn on the card): every LLM request
   served, K3-K6 launched; one decode step timed and profiled;
15. phase 11 on a tiny float32 Qwen1.5-MoE;
16. hold the SSD chunk scan (K7) against its plain chunked version on the
   card at the reference's SSD tolerances (1e-4 float32, 5e-2 bfloat16),
   y and the final state: the reference's test sweep, the SSM serve path's
   prompts (S = 8, 24), mamba2-1.3b's widths at S = 2,048 and a ragged
   S = 300, in both dtypes, each timed beside its bound and its plain
   version (no single PyTorch call computes the scan); then its sweep over
   the same shapes, with ``--parent`` beside the parent's kernel and the
   parent's time split by stage (its source cut after each stage);
17. mamba2-1.3b at full width cut to 2 of its 48 layers, in float32: a
   300-token prompt (two full chunks and a 44-token tail, through K7) and
   8 teacher-forced decode steps on ``cuda`` and on the CPU from the same
   weights: logits within 1e-4;
18. the SSM serve path: phase 10 on a full-width mamba2-1.3b (48 layers,
   bfloat16, random weights drawn on the card): every LLM request served,
   K3 and K7 launched; one decode step timed and profiled;
19. phase 11 on a tiny float32 mamba2-1.3b and a tiny float32
   jamba-1.5-large-398b (two periods of one attention and seven Mamba
   layers, MoE in every second: K3-K7 in one model);
20. phase 8's checks at the encoder-decoder's and the VLM's shapes: K4 not
   causal at Whisper's cross-attention (B = 1 and 4, Sq = 4 and 24, Skv =
   1,500, H = K = 20, hd 64) and causal at InternVL's prefill (S = 1,048,
   H = 48, K = 8, hd 128); K5 over 1,500 frames in full rows (B*K = 20 and
   80, G = 1) and at InternVL's decode; K3 at InternVL's d_model 6,144; in
   both dtypes, each timed beside its bound, its plain version and a
   PyTorch library call;
21. whisper-large-v3 at full width cut to 2 encoder and 2 decoder layers,
   bfloat16: 1,500 frames, a 24-token prompt and 8 teacher-forced decode
   steps on ``cuda`` (K4, K5; its norms are LayerNorm) and on the CPU from
   the same weights: logits within 5e-2;
22. internvl2-26b at full width cut to 2 of its 48 layers, bfloat16: 1,024
   patch embeddings, a 24-token prompt and 8 teacher-forced decode steps,
   ``cuda`` (K3-K5) against the CPU: logits within 5e-2 (the CPU side
   timed);
23. the two families' main paths, through the model API (the engine feeds
   tokens only, as the reference's): whisper-large-v3 at full depth (32 +
   32 layers, 448 learned positions), 4 utterances of 1,500 frames, a
   4-token start prompt and 32 greedy decode steps; internvl2-26b at full
   depth (48 layers, 39.7 GB of bfloat16 weights drawn on the card), 2
   requests of 1,024 patches and 24 tokens and 16 greedy steps; counters
   reset and read around each, the launch counts the code implies
   asserted (Whisper: K4 = enc_layers + 2 num_layers a prefill, K5 = 2
   num_layers a step, no K3; InternVL: K3 = 2 num_layers + 1 a forward
   pass, K4 = num_layers a prefill, K5 = num_layers a step); prefill ms,
   a batch-1 decode step beside its floor (profiled), peak memory beside
   the weights' bytes;
24. one float32 training step of each family's tiny config with remat
   (dense Llama-3, Qwen1.5-MoE, Mamba2, Jamba, Whisper, InternVL), ``cuda``
   (K3, K4, K6, K7 under autograd: the kernel forward, the plain version's
   backward) against the CPU from the same weights: loss within 1e-4
   relative, each gradient within 1e-4 of its tensor's largest magnitude,
   the weights after one ``adamw_update`` within 1e-4, the MoE tokens
   whose expert sets differ counted, the launches the code implies (each
   period's kernels twice: the forward and its recompute under remat; the
   final norm once; none in the backward);
25. Llama-3-8B at full width cut to 2 layers, bfloat16, one 64-token
   sequence: loss (within 5e-2) and every gradient on ``cuda`` against the
   CPU, each gradient tensor's cosine to the CPU's at least 0.99;
26. the training path: ``run_training`` on a full-width Llama-3-8B cut to
   8 of its 32 layers, bfloat16, the registry's ``microbatch=8`` and
   remat, 8 x 2,048 tokens of the reference's synthetic stream a step, 4
   steps; counters reset and read around it, K3 and K4's launches
   asserted, the losses finite; step ms (steps 2-4), tokens/s, model
   FLOPs as a share of 989 TFLOP/s, peak memory beside the reckoning (16
   bytes a parameter); then one step profiled: device busy and the plain
   backward's device time (its ``plain_vjp`` ranges);
27. restart on the card: the reference's contract (a tiny float32 Llama,
   35 steps, checkpoints every 10, a failure injected at step 17): the
   post-restart losses equal the uninterrupted run's bit for bit, and the
   last checkpoint restored onto the CPU and the card equal bit for bit;
28. the mesh path (``RefreshConfig(mesh_shards=n)``, the shards a loop
   over blocks of one arena on the card): phase 6's 16,384-slot arena
   with prewarming and triage from one state, ticked with 8 % of the
   slots dirty, uniform and skewed (all on shard 0 of 8), as the 1-shard
   delta tick, the mesh at 1 and 8 shards, and the 8-shard mesh with
   ``lane_balance=0.25``, each with K1 and with K2: every mesh tick
   bitwise equal to the delta tick slot by slot (ranks, triage scalars,
   trigger and reach rows, arena rows through ``device_rows``), one K1
   launch for each shard with walk rows; ms per tick, launches per tick
   and walk rows per shard printed; K1 and K2 held to their plain
   versions at the 8-shard launch's rows; then ``run_sim`` at
   ``mesh_shards=8`` on the first 150 applications of phase 2's trace
   against ``SimConfig()`` on the same apps, on ``cuda`` and on the CPU:
   identical completion order and ACTs;
29. the expert-parallel MoE (``moe_impl="ep"``, ``distributed/ep_moe.py``:
   every position of a logical ``(data, model)`` mesh on the one card,
   the three expert products one K6 launch each over all ranks' buffers):
   (a) Qwen1.5-MoE widths at 2 of 24 layers, float32, a 2 x 256-token
   prefill under meshes (1, 1), (1, 4) and (2, 2), ``cuda`` against the
   CPU from the same weights: logits within 1e-4, the same copies kept
   and dropped (counts printed), K6 launched three times a layer; EP (1,
   4) against the sort path within 1e-4 at a capacity factor where
   neither drops a copy; (b) the full-depth bfloat16
   ``PERF_PRESETS["qwen2-moe-a2.7b"]`` (30.29 GB) under
   ``make_host_mesh(4)``: a 4 x 512-token prefill, finite logits, K6's
   launches counted around it, prefill ms beside the sort path's on the
   same weights (median of 3), peak memory, and K6 at the EP buffer
   shapes (64, 208, 2,048, 1,408) and (64, 208, 1,408, 2,048) against its
   plain version, timed beside its bound and ``torch.bmm``; (c) one
   float32 training step of the tiny MoE under EP (1, 4), ``cuda`` against
   the CPU: loss within 1e-4 relative, each gradient within 1e-4 of its
   tensor's largest magnitude, K6's launches as the code implies;
30. the selective remat policies: phase 26's configuration, one step's
   loss and gradients under ``"full"`` (twice), ``"dots"`` and
   ``"offloadable"`` from the same weights and batch, equal to
   ``"full"``'s bit for bit (within the run-to-run gap if two ``"full"``
   runs differ); step ms and peak memory for each;
31. the dry run: ``python -m repro_torch.launch.dryrun --arch
   qwen2-moe-a2.7b --shape train_4k --mesh single --set moe_impl=ep``
   (the step traced as rank 0 of the 256-rank production mesh on
   ``meta``, host work in a process of its own beside phases 36-38)
   exits 0; its record, with the reference's keys (but ``compile_s``)
   and all-to-all bytes, is printed;
32. a process group of one rank over NCCL in this process
   (``launch.mesh.init_process_mesh``): the EP layer at Qwen1.5-MoE's
   full width over the (1, 1) process mesh, its collectives through
   NCCL, bitwise to the one-process body with K6 three times; the mesh
   tick over the one-rank group on phase 28's arena, bitwise to the
   delta tick, with K1 and K2;
33. worlds of 2 and 4 processes over gloo, every rank on cuda:0 (NCCL
   refuses two ranks on one card), spawned as torchrun starts them
   (``launch.procs.spawn``; the kernels built once above): phase 29 (b)'s
   full-depth EP prefill over process meshes (1, 2), (2, 2) and (1, 4),
   each rank drawing its share of the experts layer by layer, its data
   shard's logits bitwise to the one-process EP's with the same product
   shapes (at (2, 2): each half of the batch over (1, 2); the whole batch
   over a logical (2, 2), whose dense products have twice the rows, is
   compared and printed), K6 3 times a layer in every rank, prefill ms
   and peak memory a rank, and the form each collective took;
34. the 4-rank mesh tick on phase 28's arena, each rank holding its block:
   uniform and skewed (lane-balanced) dirty sets with K1 and K2, bitwise
   to the single-arena delta tick in every rank, one K1 launch a tick in
   every rank that walks;
35. ``run_sim`` at ``mesh_shards=4`` on phase 28's 150 applications in
   every rank of the 4-rank world, with the calendar engine and the
   deprecated heap engine: the same result on every rank, equal to phase
   28's ``SimConfig()`` run;
36. the GSPMD train step (``build_model(cfg, mesh=)``: FSDP over the data
   axes, tensor- and vocabulary-parallel over the model axis): Llama-3-8B
   widths cut to 2 layers, bfloat16, 4 x 2,048 tokens, 1 step over
   process mesh (2, 2) and 1 over (4, 1) in a 4-rank gloo world on
   cuda:0, and the gradients at (1, 1) over NCCL in this process; each
   rank's weights drawn whole and cut to its blocks, held to the
   one-process port on the card from the same draw: losses within 5e-2
   (at (2, 2) also the next step's, from the updated weights), each
   gradient's cosine at least 0.99, each rank's weights a quarter of the whole but for the
   replicated norm scales; step ms a rank beside one process's (gloo's
   host copies), peak memory and K3/K4 launches a rank.  The same step
   for every other family (``GSPMD_FAMILIES``): Qwen1.5-MoE (sort
   dispatch) and Mamba2-1.3B at full width cut to 2 layers, bfloat16,
   one step of 4 x 2,048 tokens over (2, 2); the tiny Jamba, float32, 4
   x 256 tokens; Whisper-large-v3 (2 encoder and 2 decoder layers, 4 x
   448 tokens with 4 x 1,500 frames) and InternVL2-26B (2 layers, 4 x
   (1,024 patches + 1,024 tokens)) at full width over (2, 2); and the
   divisibility fallback, Qwen2-7B at full width, 2 layers, over a (1,
   3) mesh of ranks 0-2 (its heads, KV heads, d_ff and projections'
   columns computed whole, its vocabulary split): loss within 5e-2 (f32:
   1e-4), cosines at least 0.99, each rank's bytes its
   ``named_shardings`` blocks', the layers computed whole, tokens whose
   top-k experts differ from one process's printed, K3/K4/K6/K7
   launches a rank, and the same at (1, 1) over NCCL.  Then one step of
   Qwen1.5-MoE under ``PERF_PRESETS`` (``moe_impl="ep"``, full width, 2
   layers, 4 x 1,024 tokens in two microbatches) through
   ``run_training(mesh=)`` over (2, 2), the model placed with its experts
   split (``expert_share=False``): its loss within 5e-2 of the
   one-process port's (its EP body over a logical (2, 2)), the same
   model's gradients' cosines at least 0.99, K6 launched on every rank;
37. the sequence-sharded decode: Llama-3-8B widths cut to 4 layers,
   bfloat16, a 2 x 512-token prompt and 8 greedy steps over (1, 4) (and
   (1, 1) over NCCL), each rank's caches its quarter of the positions,
   attention through K5's partial mode and a merge in rank order: its
   largest |logit - float32 logit| (the float32 model of the same
   weights) at most 1.25 times the one-process bfloat16 port's, its
   distance to that port printed, tokens identical where the one-process
   top-2 margin exceeds 5e-2, K5's partial mode against its plain twin on
   each rank (rows of length 0 included, timed beside
   ``_scaled_dot_product_efficient_attention`` with the log-sum-exp),
   decode ms a step a rank, K5 launches a rank.  The families' decode
   over (1, 4): Qwen1.5-MoE and Mamba2-1.3B a 2 x 512-token prompt and 8
   steps (the MoE's steps through the dense dispatch, a rank's 16
   experts), the tiny Jamba 2 x 64 and 4 steps: the same float32 gap
   and token checks (Jamba: logits within 1e-4), Qwen1.5-MoE's largest
   |logit - one-process logit| at most ``GSPMD_MOE_LOGIT_TOL`` (its
   float32 twin routes otherwise, so the gap alone would let a dropped
   expert pass), a limit the one-process decode with one expert dropped
   must exceed, each rank's caches its
   ``cache_shardings`` blocks (the Mamba state by heads, the conv windows
   by channels, the attention caches by positions, Whisper's cross
   caches whole over ``model``), K3-K7 launches a rank, and the same at
   (1, 1) over NCCL.  Whisper (a 2 x 24-token prompt with 1,500 frames, 8
   steps, its cross-attention through K5's normal mode on a rank's heads)
   and InternVL (2 x (1,024 patches + 24 tokens), 8 steps) over (1, 4);
   Qwen2-7B over (1, 3): a 516-token prompt and 4 steps over 520 cache
   positions, which 3 does not divide (whole caches, K5's normal mode);
   each family's seconds printed;
38. the elastic restart: phase 36's (2, 2) state after 1 step saved
   (gathered whole onto rank 0, which writes), restored onto (1, 4) and
   (4, 1): parameters and moments bitwise (a 64-bit fingerprint of every
   whole tensor's bits), the next step's loss within 5e-2 of the
   unbroken (2, 2) run's.

``--only gspmd`` builds the kernels and runs phases 36-38 alone.

The order they run in: the build, then phases 36-38, while phases 2, 3,
4, 7 and 28's ``run_sim`` runs (host-bound simulator traces) and phase
31 (a trace on ``meta``) each run in a process of its own beside them (``_Background``: spawned, each with
its own launch counters, its result sent back); then the rest in their
numbered order, alone on the card, so that no kernel is timed beside
another process's work.  Every phase prints its own seconds.

Then one JSON line with every kernel's numbers (K3, K4, K6 and K7 also
with their launches on the train path: phase 26 for K3 and K4, phase 24
for K6 and K7; K1 and K2 with their launches on the mesh path: phase 28's
``cuda`` run for K1, its 8-shard K2 ticks for K2; K6 also at the EP
buffer shape, ``moe_gmm:ep``, with its launches in phase 29's full-depth
EP prefill; K1, K2 and K6 also with ``process_launches``, each rank's
launches in phases 32-35, K3, K4, K6 and K7 with theirs in phases 36-37
(the families' train steps and decode prefills); K5's partial mode,
``decode_attention:partial``, with its launches in phase 37), the
card's name and
power limit, and as the last line
``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository around it, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import json
import math
import multiprocessing as mp
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet and Hopper white paper), in
# the units the bound counts: HBM3 bytes/s; float32 instructions/s outside
# the tensor cores (the data sheet's 67 TFLOP/s counts an FMA as two, the
# kernel's compares and adds are one each); int32 instructions/s (64 of the
# 128 lanes per SM)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 33.5e12
PEAK_I32_S = 16.7e12
# dense tensor-core bf16 and plain float32 FLOP/s (an FMA counts as two)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# the reference's kernel tolerances (tests/test_kernels.py) and its bf16
# model tolerance (tests/test_torch_model.py)
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_BF16_TOL = 5e-2
# the reference's grouped-matmul tolerances (tests/test_kernels.py) and its
# float32 model tolerance (tests/test_torch_model.py)
GMM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MODEL_F32_TOL = 1e-4
# the reference's SSD scan tolerances (tests/test_kernels.py)
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# profiler sessions tried before a step profile says "not measured"
PROFILER_SESSIONS = 5
# cycles per second the stream-holding sleep kernel is sized with (at or
# above the card's 1.98 GHz top SM clock, so the hold lasts at least as
# long as asked)
SLEEP_HZ = 2.0e9


# results one phase leaves for a later one
SHARED = {}


def log(*a) -> None:
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def held_ms(fn, iters: int = 10) -> float:
    """Device time per call of ``fn``: CUDA events around ``iters`` calls
    that the host enqueues while a sleep kernel holds the stream, so the
    calls run back to back on the card and no host gap between them is
    timed.  (torch.profiler on this card's stack at times records fewer
    or shorter launches than were made.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    hold_s = 2 * (time.perf_counter() - t0) + 2e-3
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * SLEEP_HZ))
    t0 = time.perf_counter()
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if enqueue_s > hold_s:
        log(f"[timing] enqueueing {iters} calls took {1e3 * enqueue_s:.3f} "
            f"ms, longer than the {1e3 * hold_s:.3f} ms hold: host gaps may "
            "be timed")
    return e0.elapsed_time(e1) / iters


def _sources():
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.pdgraph_walk import kernel as walk_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    return walk_kernel.SOURCES + (rms_kernel.SOURCE, fa_kernel.SOURCE,
                                  dec_kernel.SOURCE, gmm_kernel.SOURCE,
                                  ssd_kernel.SOURCE)


def _sass_count(lib, op):
    """Instructions ``op`` (HGMMA: wgmma; HMMA: mma.sync) in a built
    library's SASS, or None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return sum(1 for line in sass.splitlines()
               if re.search(rf"\b{op}\b", line))


# the tensor-core instruction each tensor-core library must hold
TENSOR_CORE_OPS = {"flash_attention": "HGMMA", "moe_gmm": "HGMMA",
                   "ssd_scan": "HMMA"}


def phase_build():
    """Build every source; log nvcc's output, and for the attention,
    grouped-matmul and SSD kernels (K4-K7) the register and spill lines of
    each entry and the tensor-core instruction count of the K4, K6 (HGMMA)
    and K7 (HMMA) libraries, which must hold some."""
    from repro_torch.kernels import build
    sources = _sources()
    t0 = time.perf_counter()
    built = build.build_all(sources)
    log(f"[build] {[lib.name for lib, _ in built]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, (lib, text) in zip(sources, built):
        for line in (text or "(library already built)").strip().splitlines():
            log(f"[build:{src.stem}] {line}")
        if src.stem not in ("flash_attention", "decode_attention",
                            "moe_gmm", "ssd_scan"):
            continue
        lines = (text or "").splitlines()
        spills = [ln.strip() for ln in lines if "spill" in ln
                  and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "registers" in ln and "Used " in ln]
        log(f"[build:{src.stem}] {len(regs)} entries, registers "
            f"{min(regs, default=None)}-{max(regs, default=None)}, spills: "
            f"{spills or 'none'}")
        op = TENSOR_CORE_OPS.get(src.stem)
        if op is not None:
            n = _sass_count(lib, op)
            log(f"[build:{src.stem}] {op} instructions in the SASS: "
                f"{'not measured (no cuobjdump)' if n is None else n}")
            if n == 0:
                raise AssertionError(f"the {src.stem} library holds no {op} "
                                     "(tensor-core) instruction")


def _bound(n_bytes, f_ops, i_ops):
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger (ms, and which)."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = max(f_ops / PEAK_F32_S, i_ops / PEAK_I32_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _posterior_tables(packed, graph_idx, seed=5):
    """Posterior walk tables of random statistics rows with non-zero
    counts (a third of the units unobserved, so they keep the prior)."""
    import numpy as np
    import torch
    from repro_torch.core.posterior import (posterior_tables, prior_mean,
                                            row_width)
    rng = np.random.default_rng(seed)
    A = graph_idx.shape[0]
    U = packed.samples.shape[1]
    rows = np.zeros((A, U, row_width(U)), np.float32)
    seen = rng.random((A, U)) < 0.67
    rows[..., :U + 1] = rng.integers(0, 6, (A, U, U + 1)) * seen[..., None]
    rows[..., U + 2] = rng.integers(1, 9, (A, U)) * seen
    rows[..., U + 1] = rows[..., U + 2] * rng.uniform(0.1, 30.0, (A, U))
    g = graph_idx.long()
    return posterior_tables(torch.as_tensor(rows, device=packed.device),
                            packed.cum_trans[g],
                            prior_mean(packed.samples, packed.counts)[g],
                            branch_strength=8.0, demand_strength=8.0)


def _kernel_inputs(device, A, So, seed=11):
    """Queue rows: random graphs and positions, overrides of up to ``So``
    samples on a quarter of the rows, padding rows (from 64 rows up)."""
    import numpy as np
    import torch
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.core.pdgraph import pack_graphs
    from repro_torch.kernels.pdgraph_walk.ref import walker_streams
    kb = build_knowledge_base(n_trials=100, seed=3)
    packed = pack_graphs(kb, T_IN, T_OUT, device=device)
    G, U, S = packed.samples.shape
    rng = np.random.default_rng(seed)
    gi = rng.integers(0, G, A).astype(np.int32)
    start = np.where(rng.random(A) < 0.5, packed.entry[gi],
                     rng.integers(0, U, A)).astype(np.int32)
    ex = rng.uniform(0.0, 2.0, A).astype(np.float32)
    att = rng.uniform(0.0, 30.0, A).astype(np.float32)
    valid = np.ones(A, bool)
    if A >= 64:                   # a sixty-fourth of the rows are padding
        valid[-(A // 64):] = False
    ovs = np.zeros((A, U, So), np.float32)
    ovc = np.zeros((A, U), np.int32)
    for a in range(0, A, 4):
        u = int(rng.integers(0, U))
        n = int(rng.integers(1, So + 1))
        ovc[a, u] = n
        ovs[a, u, :n] = rng.uniform(0.05, 20.0, n)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    streams = walker_streams(7, np.arange(A), rng.integers(0, 9, A),
                             device=device)
    return packed, dict(graph_idx=t(gi), start=t(start), executed=t(ex),
                        streams=streams, attained=t(att),
                        ov_samples=t(ovs), ov_counts=t(ovc), valid=t(valid))


def _check_kernel(device, A, W, So, STEPS=64, NB=10, posterior=False):
    """The fused walk against its plain version (single-phase, as the
    kernel walks) at one shape, with posterior tables or without: bitwise
    on every output, both timed, each walker's steps printed, and the
    bound from this run's inputs.  The kernel's time is its device time
    per launch of the wrapper on operands converted beforehand."""
    import torch
    from repro_torch.kernels.pdgraph_walk import kernel, ops
    packed, rows = _kernel_inputs(device, A, So)
    G, U, S = packed.samples.shape
    name = kernel.POSTERIOR_NAME if posterior else kernel.NAME
    tag = f"[kernel:{name} A={A} W={W} So={So}]"
    po = (dict(zip(("po_cum", "po_scale"),
                   _posterior_tables(packed, rows["graph_idx"])))
          if posterior else {})

    def call(fn, **kw):
        r = rows
        return fn(packed.samples, packed.counts, packed.cum_trans,
                  r["graph_idx"], r["start"], r["executed"], r["streams"],
                  r["attained"], r["ov_samples"], r["ov_counts"],
                  valid=r["valid"], n_walkers=W, max_steps=STEPS,
                  n_buckets=NB, track_arrivals=True, **po, **kw)

    def plain_call():
        return call(ops.pdgraph_walk_ranked_plain, compact_schedule=())

    r = rows
    operands = ops.kernel_operands(
        packed.samples, packed.counts, packed.cum_trans, r["graph_idx"],
        r["start"], r["executed"], r["streams"], r["attained"],
        r["ov_samples"], r["ov_counts"], r["valid"], **po)

    def launch():
        return kernel.pdgraph_walk_fused_kernel(
            *operands, n_walkers=W, max_steps=STEPS, n_buckets=NB,
            with_arrivals=True, with_total=False)

    kern = call(ops.pdgraph_walk_ranked)
    plain = plain_call()
    torch.cuda.synchronize()
    keys = ("probs", "edges", "ranks", "a_hist", "a_lo", "a_span", "a_reach")
    err = 0.0
    for k in keys:
        same = torch.equal(kern[k], plain[k])
        d = float((kern[k] - plain[k]).abs().max())
        err = max(err, d)
        log(f"{tag} {k:8s} {tuple(kern[k].shape)} bitwise={same} "
            f"max_abs_err={d}")
        if not same:
            raise AssertionError(f"{name} (W={W}, So={So}): {k} differs "
                                 f"from the plain version (max abs err {d})")
    if not torch.equal(launch()["ranks"], kern["ranks"]):
        raise AssertionError(f"{name}: the wrapper on converted operands "
                             "disagrees with pdgraph_walk_ranked")
    # the kernel's device time (no host gaps: the wrapper's host work takes
    # longer than the kernel on one or two apps); free-running events
    # around the wrapper, and around pdgraph_walk_ranked, printed beside
    ms = held_ms(launch)
    ev_ms = cuda_time_ms(launch, iters=50)
    ops_ms = cuda_time_ms(lambda: call(ops.pdgraph_walk_ranked), iters=50)
    plain_ms = cuda_time_ms(plain_call, iters=3, warmup=1)
    # the least the card could take: every input read once, every output
    # written once (of the override table, only the samples the counts
    # name); operations counted per walker-step this data needs
    n_ov = int(r["ov_counts"].sum())
    in_bytes = 4 * (G * U * S + G * U + G * U * (U + 1)
                    + A * U + n_ov + 5 * A) + A
    if posterior:
        in_bytes += 4 * (A * U * (U + 1) + A * U)
    out_bytes = 4 * (2 * A * NB + A + A * U * (NB + 3))
    steps = plain["walker_steps"]
    lane = _walker_steps(packed, r, W, STEPS,
                         (po["po_cum"].reshape(A * U, U + 1),
                          po["po_scale"].reshape(A * U)) if posterior
                         else (None, None))
    if int(lane.sum()) != steps:
        raise AssertionError(f"{tag}: per-walker steps sum to "
                             f"{int(lane.sum())}, the plain walk took {steps}")
    longest = lane.max(dim=1).values.float()
    log(f"{tag} walker steps: mean {steps / (A * W):.3f} per walker, max "
        f"{int(longest.max())}; an app's longest walker mean "
        f"{float(longest.mean()):.2f}, median {float(longest.median()):.0f}; "
        f"apps with a walker at max_steps "
        f"{int((longest >= STEPS).sum())} of {A}")
    f_ops = (steps * (9 + (U + 1) + (2 if posterior else 0)) + A * W * 4
             + A * 3 * NB * NB)
    i_ops = steps * 16 + A * W * 4
    bound_ms, bound_by = _bound(in_bytes + out_bytes, f_ops, i_ops)
    log(f"{tag} max_steps={STEPS} walker_steps={steps} (mean "
        f"{steps / (A * W):.2f}) bytes={in_bytes + out_bytes} "
        f"f32_ops={f_ops} i32_ops={i_ops}")
    log(f"{tag} kernel {ms:.6f} ms (device; events {ev_ms:.4f}, "
        f"pdgraph_walk_ranked {ops_ms:.4f})  plain {plain_ms:.3f} ms  bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/pdgraph_walk/csrc/"
                      "walk_fused.cu",
            "replaces": "src/repro/kernels/pdgraph_walk/kernel.py:297",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def _phase_runs(device, A, W, So, *, arrivals=True, posterior=False,
                STEPS=64):
    """The launches of one per-phase walk of ``A`` apps of ``W`` walkers on
    the rows of ``_kernel_inputs``, phase by phase as ``ops.pdgraph_walk``
    runs them on the card: compacted between phases by its stage rule (one
    phase below 512 lanes) or, with posterior tables, single-phase.  Each
    entry holds the phase's step range, its lanes, the graphs and apps its
    lanes name, the override samples those apps' counts name, and two
    closures on the phase's input state: ``launch()`` (the kernel's
    wrapper) and ``plain(stats)`` (``walk_phase_ref``).  The state of a
    phase is the kernel's output of the one before, compacted."""
    import torch
    from repro_torch.core.pdgraph import ARRIVAL_NEVER
    from repro_torch.kernels.pdgraph_walk import kernel, ops
    from repro_torch.kernels.pdgraph_walk.ref import walk_phase_ref
    packed, r = _kernel_inputs(device, A, So)
    G, U, S = packed.samples.shape
    N = A * W
    i32 = torch.int32
    rep = lambda t: torch.repeat_interleave(t, W)  # noqa: E731
    tables = (packed.samples, packed.counts.float(), packed.cum_trans)
    flat = (packed.samples.reshape(G * U, S),
            packed.counts.reshape(G * U).float(),
            packed.cum_trans.reshape(G * U, U + 1))
    ov = (r["ov_samples"].reshape(A * U, So),
          r["ov_counts"].reshape(A * U).float())
    pot = (None, None)
    if posterior:
        po_cum, po_scale = _posterior_tables(packed, r["graph_idx"])
        pot = (po_cum.reshape(A * U, U + 1), po_scale.reshape(A * U))
    ovc_app = r["ov_counts"].sum(dim=1)
    st = dict(cur=rep(r["start"]).to(i32),
              total=torch.zeros(N, device=device), done=rep(~r["valid"]),
              gi=rep(r["graph_idx"]).to(i32),
              app=torch.arange(A, device=device,
                               dtype=i32).repeat_interleave(W),
              stream=rep(r["streams"]).to(torch.int64),
              lane=torch.arange(W, device=device, dtype=i32).repeat(A),
              ex=rep(r["executed"]),
              arr=(torch.full((U, N), ARRIVAL_NEVER, device=device)
                   if arrivals else None))
    stages = ([] if posterior
              else ops._stages(((16, 4),), STEPS, N))
    bounds = [(0, None)] + [(s, N // k) for s, k in stages]
    runs = []
    for j, (step0, _) in enumerate(bounds):
        end = bounds[j + 1][0] if j + 1 < len(bounds) else STEPS
        keep = bounds[j + 1][1] if j + 1 < len(bounds) else None
        n_steps = end - step0
        s = dict(st)
        s32 = torch.where(s["stream"] >= 2 ** 31, s["stream"] - 2 ** 32,
                          s["stream"]).to(i32)

        def launch(s=s, s32=s32, step0=step0, n_steps=n_steps):
            return kernel.pdgraph_walk_kernel(
                *tables, *ov, *pot, s["cur"], s["total"], s["done"],
                s["gi"], s["app"], s32, s["lane"], s["ex"], s["arr"],
                step0=step0, n_steps=n_steps, lanes_per_app=W, n_apps=A)

        def plain(stats=None, s=s, step0=step0, n_steps=n_steps):
            return walk_phase_ref(
                *flat, *ov, s["cur"].long(), s["total"], s["done"],
                s["gi"].long(), s["app"].long(), s["stream"],
                s["lane"].long(), s["ex"], step0=step0, n_steps=n_steps,
                lanes_per_app=W,
                arrivals=None if s["arr"] is None else s["arr"].t().clone(),
                stats=stats, fpo_cum=pot[0], fpo_scale=pot[1])

        apps = torch.unique(s["app"]).long()
        runs.append(dict(step0=step0, n_steps=n_steps, lanes=s["cur"].shape[0],
                         graphs=int(torch.unique(s["gi"]).numel()),
                         apps=int(apps.numel()),
                         n_ov=int(ovc_app[apps].sum()), U=U, S=S,
                         first=step0 == 0, launch=launch, plain=plain))
        if keep is None:
            break
        k = launch()
        alive = int((~k[2]).sum())
        if alive > keep:
            raise AssertionError(f"compaction to {keep} lanes spills "
                                 f"({alive} alive)")
        order = torch.argsort(k[2].to(i32), stable=True)[:keep]
        st = {key: v[order] for key, v in s.items()
              if key not in ("arr", "ex")}
        st.update(cur=k[0][order], total=k[1][order], done=k[2][order],
                  arr=k[3][:, order] if arrivals else None, ex=None)
    return runs


def _phase_bound(run, posterior, arrivals, walker_steps):
    """The least time one per-phase launch could take: its lane state read
    and written once, and of the tables only the rows of the graphs and
    apps its lanes name (of the override table, the counts and the samples
    they name); operations per walker-step its data needs."""
    n, U, S = run["lanes"], run["U"], run["S"]
    lane_bytes = n * (4 * 6 + 1 + (4 if run["first"] else 0) + 4 * 2 + 1
                      + (2 * 4 * U if arrivals else 0))
    table_bytes = 4 * (run["graphs"] * U * (S + 1 + U + 1)
                       + run["apps"] * U + run["n_ov"])
    if posterior:
        table_bytes += 4 * run["apps"] * U * (U + 2)
    f_ops = walker_steps * (9 + U + 1 + (2 if posterior else 0))
    return _bound(lane_bytes + table_bytes, f_ops, walker_steps * 16), \
        lane_bytes + table_bytes


def _check_phase_kernel(device, A, W, So, *, arrivals=True, posterior=False):
    """The per-phase walk against its plain version (``walk_phase_ref``)
    launch by launch on the same state (``_phase_runs``): bitwise on cur,
    total, done and the first-arrival times; each launch timed on a held
    stream (CUDA events on its free-running wrapper printed beside); the
    bound from this run's inputs and walker-steps.  Returns the
    kernels-line entry, times and bounds summed over the launches."""
    import torch
    runs = _phase_runs(device, A, W, So, arrivals=arrivals,
                       posterior=posterior)
    label = ("posterior single-phase" if posterior
             else "compacted" if len(runs) > 1 else "single-phase")
    err, ms, plain_ms, bound_ms, steps = 0.0, 0.0, 0.0, 0.0, 0
    for run in runs:
        k = run["launch"]()
        stats = {"walker_steps": 0}
        p = run["plain"](stats)
        torch.cuda.synchronize()
        tag = (f"[kernel:pdgraph_walk_phase A={A} W={W} So={So} {label} "
               f"steps {run['step0']}..{run['step0'] + run['n_steps']} "
               f"lanes={run['lanes']} arrivals={arrivals}]")
        pairs = [("cur", k[0].long(), p[0]), ("total", k[1], p[1]),
                 ("done", k[2], p[2])]
        if arrivals:
            pairs.append(("arrivals", k[3], p[3].t()))
        for name, a, b in pairs:
            same = torch.equal(a, b)
            d = float((a.float() - b.float()).abs().max())
            err = max(err, d)
            log(f"{tag} {name:8s} bitwise={same} max_abs_err={d}")
            if not same:
                raise AssertionError(
                    f"pdgraph_walk_phase ({label}, A={A}, steps "
                    f"{run['step0']}..{run['step0'] + run['n_steps']}): "
                    f"{name} differs from walk_phase_ref (max abs err {d})")
        # the launches are short enough for the wrapper's host work to set
        # the event timing on a slow host: the kernel's time is taken on a
        # held stream, the event time is printed beside
        t_launch = cuda_time_ms(run["launch"], iters=50)
        t_dev = held_ms(run["launch"])
        t_plain = cuda_time_ms(run["plain"], iters=3, warmup=1)
        (b_ms, b_by), n_bytes = _phase_bound(run, posterior, arrivals,
                                             stats["walker_steps"])
        ms += t_dev
        plain_ms += t_plain
        bound_ms += b_ms
        steps += stats["walker_steps"]
        log(f"{tag} kernel {t_dev:.6f} ms (device)  {t_launch:.4f} ms "
            f"(events)  plain {t_plain:.3f} ms  bound {b_ms:.6f} ms ({b_by}; "
            f"bytes={n_bytes}, graphs={run['graphs']}, apps={run['apps']})  "
            f"walker_steps={stats['walker_steps']}")
    log(f"[kernel:pdgraph_walk_phase A={A} W={W}] {label}: kernel "
        f"{ms:.6f} ms  plain {plain_ms:.3f} ms  bound {bound_ms:.6f} ms  "
        f"walker_steps={steps} launches={len(runs)}")
    return {"name": "pdgraph_walk_phase", "route": "cuda",
            "source": "src/repro_torch/kernels/pdgraph_walk/csrc/"
                      "walk_phase.cu",
            "replaces": "src/repro/kernels/pdgraph_walk/kernel.py:221",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": b_by,
            "library_ms": None}


def phase_kernels(device, main_W, main_So, main_rows, phase_apps,
                  parent=None):
    """Each kernel against its plain version: K1 at the main path's walker
    count and override width (the shape its launches there had), at the
    median and largest row count of its launches there and at the W=512
    cell, K1 with posterior tables; K2 at the composed path's median and
    largest launch (``phase_apps``: apps per launch), at A = 4,096
    compacted and single-phase with posterior tables; then K1's and K2's
    sweeps (:func:`walk_sweep`, :func:`phase_sweep`), beside the parent's
    kernels when ``parent`` names its checkout.  Returns the kernels-line
    entries: K2's is the composed path's median launch."""
    entry = _check_kernel(device, 4096, main_W, main_So)
    rows = sorted(set((int(statistics.median(main_rows)), max(main_rows))))
    for A in rows:
        _check_kernel(device, A, main_W, main_So)
    _check_kernel(device, 4096, 512, 64)
    post = _check_kernel(device, 4096, main_W, main_So, posterior=True)
    phase = _check_phase_kernel(device, phase_apps[0], main_W, main_So)
    for A in phase_apps[1:]:
        _check_phase_kernel(device, A, main_W, main_So)
    _check_phase_kernel(device, 4096, main_W, main_So)
    _check_phase_kernel(device, 4096, main_W, main_So, posterior=True)
    _versus_parent("walk", dict(W=main_W, So=main_So, rows=rows), parent)
    _versus_parent("phase", dict(W=main_W, So=main_So, apps=phase_apps),
                   parent)
    return [entry, post, phase]


def _walker_steps(packed, r, W, steps, po=(None, None)):
    """Each walker's steps before absorption (A, W): the plain walk
    (``walk_phase_ref``), single-phase, on the rows of ``_kernel_inputs``."""
    import torch
    from repro_torch.kernels.pdgraph_walk.ref import walk_phase_ref
    G, U, S = packed.samples.shape
    A = r["graph_idx"].shape[0]
    dev = packed.samples.device
    rep = lambda t: torch.repeat_interleave(t, W)  # noqa: E731
    stats = {"walker_steps": 0,
             "lane_steps": torch.zeros(A * W, dtype=torch.int32, device=dev)}
    walk_phase_ref(
        packed.samples.reshape(G * U, S), packed.counts.reshape(G * U).float(),
        packed.cum_trans.reshape(G * U, U + 1),
        r["ov_samples"].reshape(A * U, -1), r["ov_counts"].reshape(A * U)
        .float(), rep(r["start"]).long(), torch.zeros(A * W, device=dev),
        rep(~r["valid"]), rep(r["graph_idx"]).long(),
        torch.arange(A, device=dev).repeat_interleave(W),
        rep(r["streams"]).long(), torch.arange(W, device=dev).repeat(A),
        rep(r["executed"]), step0=0, n_steps=steps, lanes_per_app=W,
        stats=stats, fpo_cum=po[0], fpo_scale=po[1])
    return stats["lane_steps"].reshape(A, W)


# K1's sweep: (max_steps, with_arrivals) at A = 4,096 and the main path's W
WALK_SWEEP = tuple((steps, arr) for steps in (1, 8, 64)
                   for arr in (False, True))


def walk_sweep(device, W, So, rows):
    """Device ms per launch of the fused walk (held stream) over
    ``WALK_SWEEP`` at A = 4,096, at the main path's row counts ``rows``
    (one step and 64, arrival rows off and on: 64 steps with arrival rows
    is how the main path runs it), at W = 512 and with posterior
    tables.  The bound and the walk's work are the same for the
    parent's kernel and this one, so the sweep names only its keys and
    times; it uses only the wrapper's arguments, which the parent's kernel
    shares."""
    from repro_torch.kernels.pdgraph_walk import kernel, ops
    cells = [(4096, W, So, steps, arr, False) for steps, arr in WALK_SWEEP]
    cells += [(A, W, So, steps, arr, False) for A in rows
              for steps, arr in ((1, False), (1, True), (64, False),
                                 (64, True))]
    cells += [(4096, 512, 64, 64, True, False), (4096, W, So, 64, True, True)]
    out = {}
    for A, w, so, steps, arr, post in cells:
        packed, r = _kernel_inputs(device, A, so)
        po = (dict(zip(("po_cum", "po_scale"),
                       _posterior_tables(packed, r["graph_idx"])))
              if post else {})
        operands = ops.kernel_operands(
            packed.samples, packed.counts, packed.cum_trans, r["graph_idx"],
            r["start"], r["executed"], r["streams"], r["attained"],
            r["ov_samples"], r["ov_counts"], r["valid"], **po)
        key = (f"A={A} W={w} So={so} max_steps={steps} arrivals={arr}"
               + (" posterior" if post else ""))
        out[key] = held_ms(lambda: kernel.pdgraph_walk_fused_kernel(
            *operands, n_walkers=w, max_steps=steps, n_buckets=10,
            with_arrivals=arr, with_total=False), iters=20)
    return out


# K3's sweep: the shapes PERF.md's table holds it at (rows, D, dtype)
RMS_SWEEP = ((1, 4096, "bfloat16"), (4096, 4096, "bfloat16"),
             (4097, 4096, "bfloat16"), (4096, 4096, "float32"),
             (4096 * 32, 128, "bfloat16"), (24 * 32, 128, "bfloat16"))


def rmsnorm_sweep(device):
    """Device ms per launch of the RMSNorm kernel (held stream) at each
    shape of ``RMS_SWEEP``, and of a device copy of the same bytes
    (``x.clone()``, no kernel of the port: the floor a pass that reads and
    writes each element once can reach)."""
    import torch
    from repro_torch.kernels.rmsnorm import kernel
    out = {}
    for rows, D, dt in RMS_SWEEP:
        gen = torch.Generator(device=device).manual_seed(0)
        x = _randn((rows, D), getattr(torch, dt), gen, device)
        s = _randn((D,), torch.float32, gen, device)
        out[f"rows={rows} D={D} {dt}"] = held_ms(
            lambda: kernel.rmsnorm_kernel(x, s, eps=1e-5), iters=20)
        out[f"rows={rows} D={D} {dt} copy"] = held_ms(x.clone, iters=20)
    return out


def phase_sweep(device, W, So, apps):
    """Device ms per launch of the per-phase walk (held stream), launch by
    launch through the walks of :func:`_phase_runs`: the composed path's
    median and largest launches (``apps``: apps per launch) with arrivals
    on and off, N = 512 (two apps: steps 0..16, then 48 steps at 128
    lanes), the A = 4,096 compacted walk and the posterior single-phase
    walk.  The parent's wrapper takes the same arguments."""
    cells = [(A, arr, False) for A in apps for arr in (True, False)]
    cells += [(2, True, False), (4096, True, False), (4096, True, True)]
    out = {}
    for A, arr, post in dict.fromkeys(cells):
        for run in _phase_runs(device, A, W, So, arrivals=arr,
                               posterior=post):
            key = (f"A={A} W={W} lanes={run['lanes']} steps "
                   f"{run['step0']}..{run['step0'] + run['n_steps']} "
                   f"arrivals={arr}" + (" posterior" if post else ""))
            out[key] = held_ms(run["launch"], iters=20)
    return out


def ssd_sweep(device):
    """Device ms per launch of the SSD chunk scan (held stream) at every
    shape of ``SSD_SHAPES`` in bfloat16 and float32."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel
    out = {}
    for dt in ("bfloat16", "float32"):
        for B, S, H, P, N, chunk in SSD_SHAPES:
            gen = torch.Generator(device=device).manual_seed(0)
            args = _ssd_inputs(device, B, S, H, P, N, getattr(torch, dt),
                               gen)
            out[f"B={B} S={S} H={H} P={P} N={N} chunk={chunk} {dt}"] = \
                held_ms(lambda: kernel.ssd_scan_kernel(*args, chunk=chunk),
                        iters=10)
    return out


# where ssd_split cuts each form of ssd_scan.cu: its stage markers, and the
# code each cut inserts there.  The chunk-sequential form (one block per
# (batch, head) over the chunks in order, bf16 and f32 alike): a
# `continue` to the next chunk (the rest of the chunk's stages skipped),
# after stage 2 with a store of its products that is never taken (dt > 0)
# but that the compiler cannot drop (it reads this chunk's shared memory),
# so they stay live.  The chunk-parallel form: a `return` (no block then
# waits on a hand-off that never comes), after stage 2 with the same kind
# of store of the chunk's own state.
SSD_SPLIT_CUTS = {
    "sequential": (
        ("stage 1", "// ---- 2.", "continue;\n    "),
        ("stages 1-2", "// ---- 3.",
         "if (dts[0] < 0.0f) {\n      float sink = 0.0f;\n"
         "      for (int j = 0; j < kMaxYTiles; ++j)\n"
         "        for (int i = 0; i < 4; ++i)\n"
         "          for (int q = 0; q < 4; ++q) sink += acc[j][i][q];\n"
         "      y[0] = from_f32<T>(sink);\n    }\n    continue;\n    "),
        ("stages 1-3", "// ---- 4.", "continue;\n    "),
        ("stages 1-4", None, "")),
    "parallel": (
        ("stage 1", "// ---- 2. the chunk's own end state", "return;\n  "),
        ("stages 1-2", "// ---- 3. the hand-off",
         "if (wv[0] < -1.0f) {\n    float sink = 0.0f;\n"
         "    for (int i = 0; i < kStrips; ++i)\n"
         "      for (int j = 0; j < kCols / 8; ++j)\n"
         "        for (int q = 0; q < 4; ++q) sink += st[i][j][q];\n"
         "    p.final_state[0] = sink;\n  }\n  return;\n  "),
        ("stages 1-3", "// ---- 4. y = exp(cum)", "return;\n  "),
        ("stages 1-4", None, "")),
}


def ssd_split(device):
    """Where the SSD kernel's bfloat16 time goes: the package's
    ``ssd_scan.cu`` copied under ``build/ssd_split`` with the kernel cut
    after each stage (``SSD_SPLIT_CUTS``: the chunk-sequential form or
    the chunk-parallel form), each copy built and timed (held
    stream) through the package's own wrapper at mamba2-1.3b's widths,
    S = 24 and 2,048.  Raises on a source without the markers."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import kernel
    text = Path(kernel.SOURCE).read_text()
    form = "parallel" if "mma.sync" in text else "sequential"
    out_dir = build.BUILD_DIR.parent / "ssd_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = []
    for name, mark, cut in SSD_SPLIT_CUTS[form]:
        if mark is not None and mark not in text:
            raise ValueError(f"{kernel.SOURCE} has no stage marker {mark!r}")
        body = text if mark is None else text.replace(mark, cut + mark, 1)
        src = out_dir / f"ssd_scan_{form}_{name.replace(' ', '_')}.cu"
        src.write_text(body)
        srcs.append(src)
    libs = [lib for lib, _ in build.build_all(srcs)]
    load = build.load
    out = {}
    try:
        for S in (24, 2048):
            gen = torch.Generator(device=device).manual_seed(0)
            args = _ssd_inputs(device, 1, S, 64, 64, 128, torch.bfloat16,
                               gen)
            for (name, _, _), lib in zip(SSD_SPLIT_CUTS[form], libs):
                # the wrapper loads the cut library in place of its own
                build.load = lambda source, lib=lib: ctypes.CDLL(str(lib))
                kernel._lib.cache_clear()
                out[f"S={S} bfloat16 {name}"] = held_ms(
                    lambda: kernel.ssd_scan_kernel(*args, chunk=128),
                    iters=10)
    finally:
        build.load = load
        kernel._lib.cache_clear()
    return out


SWEEPS = {"walk": walk_sweep, "rmsnorm": rmsnorm_sweep,
          "phase": phase_sweep, "ssd": ssd_sweep, "ssd_split": ssd_split}


def _sweep_in(src, kind, spec):
    """One sweep in a new process whose ``repro_torch`` is the package under
    ``src`` (this tree's or the parent's): its kernels built from its
    sources."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--sweep", kind,
           "--src", str(src), "--spec", json.dumps(spec)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"the {kind} sweep under {src} failed "
                           f"({out.returncode}):\n{out.stdout[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _versus_parent(kind, spec, parent):
    """The ``kind`` sweep: with ``parent`` (a checkout of the parent
    commit), in the order parent, this tree, this tree, parent, each in a
    new process of its own (so neither side runs in a process that earlier
    phases have used), printed in ms per launch with the ratio of the
    means; without it, once, in this process."""
    import torch
    if parent is None:
        runs = [("change", SWEEPS[kind](torch.device("cuda"), **spec))]
        log(f"[{kind}_sweep] parent: not measured (no --parent checkout)")
    else:
        src = {"parent": Path(parent) / "src", "change": SRC}
        runs = [(who, _sweep_in(src[who], kind, spec))
                for who in ("parent", "change", "change", "parent")]
    for key in runs[-1][1]:
        seq = " -> ".join(f"{who} {t[key]:.6f}" for who, t in runs)
        par = [t[key] for who, t in runs if who == "parent"]
        new = [t[key] for who, t in runs if who == "change"]
        ratio = (f"  parent/change {statistics.mean(par) / statistics.mean(new):.3f}"
                 if par else "")
        log(f"[{kind}_sweep] {key}: {seq} ms{ratio}")


def _profile_tick(tag, tick):
    """Device time of one tick by operator (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, copies): CPU operators carry the
    # same device time again
    evs = sorted((e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in evs)
    log(f"[{tag}:profile] wall={wall:.3f} ms (profiled) device_busy="
        f"{total / 1e3:.3f} ms device_ops={sum(e.count for e in evs)}")
    for e in evs[:8]:
        log(f"[{tag}:profile]   {e.key[:60]:60s} "
            f"device={e.self_device_time_total / 1e3:.3f} ms "
            f"calls={e.count}")


_ARENA_ROWS = ("d_probs", "d_edges", "a_hist", "a_lo", "a_span", "a_reach",
               "trig", "reach")


def phase_delta_tick(device, W):
    """Delta ticks on a 16,384-slot arena, 8 % of the slots dirty: each
    tick runs from the same arena state with the rank in the kernel (K1)
    and composed from the per-phase walk (K2); ranks, histogram and arrival
    rows and prewarm triggers must be the same bits."""
    import copy
    import numpy as np
    import torch
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.core.arena import QueueState
    from repro_torch.core.hermeslet import warmup_time_for
    from repro_torch.core.pdgraph import pack_graphs
    from repro_torch.core.prewarm import build_prewarm_table
    from repro_torch.core.refresh_pipeline import refresh_ranks_delta
    from repro_torch.kernels import LAUNCHES, reset_launches
    CAP, DIRTY, REPS = 16384, 0.08, 6
    kb = build_knowledge_base(n_trials=100, seed=3)
    packed = pack_graphs(kb, T_IN, T_OUT, device=device)
    tab = build_prewarm_table(kb, packed, warmup_time_for)
    qs = QueueState(packed, capacity=CAP)
    rng = np.random.default_rng(4)
    gi = rng.integers(0, len(packed.names), CAP)
    qs.admit_many([(f"a{i}", int(g), int(packed.entry[g]), i, None)
                   for i, g in enumerate(gi)])
    kw = dict(n_walkers=W, prewarm_table=tab, prewarm_k=0.5)
    refresh_ranks_delta(packed, qs, 0, walked=qs.take_dirty(), **kw)
    n_dirty = int(DIRTY * CAP)
    times = {True: [], False: []}
    launches = {}

    def timed(state, walked, in_kernel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick = refresh_ranks_delta(packed, state, 0, walked=walked,
                                   rank_in_kernel=in_kernel, **kw)
        torch.cuda.synchronize()
        times[in_kernel].append((time.perf_counter() - t0) * 1e3)
        return tick

    spill = 0
    for rep in range(REPS):
        for s in rng.choice(CAP, n_dirty, replace=False):
            qs.add_progress(qs.ids[s], 0.25)
            qs.set_unit(qs.ids[s], int(rng.integers(0, packed.n_units)))
        walked = qs.take_dirty()
        composed = copy.deepcopy(qs)
        # alternate which form runs first, so neither always finds the
        # caches warm
        order = (True, False) if rep % 2 == 0 else (False, True)
        ticks = {}
        for in_kernel in order:
            reset_launches()
            ticks[in_kernel] = timed(qs if in_kernel else composed, walked,
                                     in_kernel)
            for k, v in LAUNCHES.items():
                launches[(in_kernel, k)] = launches.get((in_kernel, k), 0) + v
        spill += ticks[False].spill
        occ = qs.occupied()
        if not np.isfinite(ticks[True].ranks[occ]).all():
            raise AssertionError("delta tick produced non-finite ranks")
        if not np.array_equal(ticks[True].ranks[occ],
                              ticks[False].ranks[occ]):
            raise AssertionError("composed delta tick: ranks differ from "
                                 "the in-kernel tick")
        for name in _ARENA_ROWS:
            a, b = getattr(qs, name), getattr(composed, name)
            same = (torch.equal(a[occ], b[occ]) if torch.is_tensor(a)
                    else np.array_equal(a[occ], b[occ]))
            if not same:
                raise AssertionError(f"composed delta tick: {name} differs "
                                     "from the in-kernel tick")
        qs.bump_refresh(walked)
    for in_kernel, label in ((True, "in_kernel"), (False, "composed")):
        t = times[in_kernel]
        per = {k: v / REPS for (ik, k), v in launches.items()
               if ik == in_kernel and v}
        log(f"[delta_tick] {label} cap={CAP} dirty={n_dirty} W={W} "
            f"prewarm=on ms/tick median={statistics.median(t[1:]):.3f} "
            f"min={min(t[1:]):.3f} all={['%.3f' % x for x in t]} "
            f"launches/tick={per}")
    log(f"[delta_tick] composed == in_kernel bitwise over {REPS} ticks "
        f"(ranks, {', '.join(_ARENA_ROWS)}); composed spill={spill}")
    # where one tick's time goes, for each form
    for in_kernel, label in ((True, "in_kernel"), (False, "composed")):
        for s in rng.choice(CAP, n_dirty, replace=False):
            qs.set_unit(qs.ids[s], int(rng.integers(0, packed.n_units)))
        walked = qs.take_dirty()
        _profile_tick(f"delta_tick:{label}", lambda: refresh_ranks_delta(
            packed, qs, 0, walked=walked, rank_in_kernel=in_kernel, **kw))
        qs.bump_refresh(walked)


# the applications of phases 28 and 35's run_sim (a prefix of phase 2's
# trace; 300 before the encoder-decoder, VLM and fallback cases of phases
# 36-37 took its time)
MESH_SIM_APPS = 150
# phase 28's arms: (label, shards, lane_balance); each runs with K1 and K2
MESH_ARMS = (("delta", None, None), ("mesh1", 1, None), ("mesh8", 8, None),
             ("mesh8_lane", 8, 0.25))


def phase_mesh(device, W, So, CAP=16384):
    """The mesh path: phase 6's 16,384-slot arena with prewarming and the
    triage scalars, from one state, in eight arms — the 1-shard delta
    tick, the mesh at 1 and 8 shards, and the 8-shard mesh balancing lanes
    past 0.25, each with K1 and with K2 — over ticks of 8 % dirty slots,
    uniform and skewed (every dirty slot on shard 0 of 8).  Every mesh
    arm's ranks, triage scalars, trigger and reach rows and arena rows
    (read through ``device_rows``) are held bitwise to the delta tick's
    with the same kernel, slot by slot; ms per tick, K1 and K2 launches
    per tick and walk rows per shard are printed.  K1 and K2 are held to
    their plain versions at the 8-shard launch's rows.  (Its ``run_sim``
    arms are ``phase_mesh_sim``.)  Returns the K2 launches of the K2 mesh
    ticks."""
    import numpy as np
    import torch
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.core.arena import QueueState
    from repro_torch.core.hermeslet import warmup_time_for
    from repro_torch.core.pdgraph import pack_graphs
    from repro_torch.core.prewarm import build_prewarm_table
    from repro_torch.core.refresh_mesh import RefreshMesh, refresh_ranks_mesh
    from repro_torch.core.refresh_pipeline import refresh_ranks_delta
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.pdgraph_walk import kernel
    from repro_torch.kernels.pdgraph_walk.ops import pad_rows
    DIRTY, REPS = 0.08, 6
    kb = build_knowledge_base(n_trials=100, seed=3)
    packed = pack_graphs(kb, T_IN, T_OUT, device=device)
    tab = build_prewarm_table(kb, packed, warmup_time_for)
    rng = np.random.default_rng(4)
    gi = rng.integers(0, len(packed.names), CAP)
    rows = [(f"a{i}", int(g), int(packed.entry[g]), i, None)
            for i, g in enumerate(gi)]
    arms = {}
    for label, shards, lane in MESH_ARMS:
        for rik in (True, False):
            qs = QueueState(packed, capacity=CAP, n_shards=shards or 1)
            qs.admit_many(rows)
            mesh = RefreshMesh(shards, device=device) if shards else None
            arms[(label, rik)] = (qs, mesh, lane)
    n_dirty = int(DIRTY * CAP)
    stats = {k: {"uniform": [], "skewed": []} for k in arms}
    k2_launches = 0

    def tick(key, walked, ranked):
        qs, mesh, lane = arms[key]
        rik = key[1]
        kw = dict(n_walkers=W, prewarm_table=tab, prewarm_k=0.5,
                  with_triage=True, rank_in_kernel=rik)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        if mesh is None:
            t = refresh_ranks_delta(packed, qs, 0, walked=walked, **kw)
            ranks = t.ranks
        else:
            t = refresh_ranks_mesh(packed, qs, 0, mesh=mesh, walked=walked,
                                   ranked=ranked, lane_balance=lane, **kw)
            ranks = qs.rank
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return ranks, ms, dict(LAUNCHES), getattr(t, "balanced", False)

    for rep in range(REPS + 1):
        kind = "uniform" if rep % 2 else "skewed"
        if rep:
            pool = (np.arange(0, CAP, 8) if kind == "skewed"
                    else np.arange(CAP))
            dirty = rng.choice(pool, n_dirty, replace=False)
            prog = rng.choice(CAP, n_dirty, replace=False)
            units = rng.integers(0, packed.n_units, n_dirty)
            for qs, _, _ in arms.values():
                for s, u in zip(dirty, units):
                    qs.set_unit(qs.ids[s], int(u))
                for s in prog:
                    qs.add_progress(qs.ids[s], 0.25)
        walks = {k: a[0].take_dirty() for k, a in arms.items()}
        walked = walks[("delta", True)]
        if any(not np.array_equal(w, walked) for w in walks.values()):
            raise AssertionError("mesh arms drained different dirty sets")
        ranked = {}
        for k, (qs, _, _) in arms.items():
            ranked[k] = np.asarray(sorted(qs.take_rank_dirty()
                                          | set(walked.tolist())), np.int64)
        order = list(arms) if rep % 2 == 0 else list(arms)[::-1]
        out = {k: tick(k, walked, ranked[k]) for k in order}
        occ = arms[("delta", True)][0].occupied()
        for k, (ranks, ms, launches, balanced) in out.items():
            qs = arms[k][0]
            ref_qs = arms[("delta", k[1])][0]
            ref_ranks = out[("delta", k[1])][0]
            if rep:
                stats[k][kind].append((ms, launches, balanced))
            if rep and k == ("mesh8", False):
                k2_launches += launches[kernel.PHASE_NAME]
            if k[0] == "delta":
                if not np.isfinite(ranks[occ]).all():
                    raise AssertionError("delta tick: non-finite ranks")
                continue
            bad = [n for n, a, b in (
                ("ranks", ranks[occ], ref_ranks[occ]),
                ("sup", qs.sup[occ], ref_qs.sup[occ]),
                ("opt", qs.opt[occ], ref_qs.opt[occ]),
                ("mean", qs.mean[occ], ref_qs.mean[occ]),
                ("trig", qs.trig[occ], ref_qs.trig[occ]),
                ("reach", qs.reach[occ], ref_qs.reach[occ]))
                if not np.array_equal(a, b)]
            dev_rows = torch.as_tensor(qs.device_rows(occ), device=device)
            bad += [n for n in ("d_probs", "d_edges", "a_hist", "a_lo",
                                "a_span", "a_reach")
                    if not torch.equal(getattr(qs, n)[dev_rows],
                                       getattr(ref_qs, n)[occ])]
            if bad:
                raise AssertionError(f"mesh tick {k} rep {rep}: {bad} differ "
                                     "from the delta tick")
            want = len(set((walked % qs.n_shards).tolist())) if not \
                balanced else min(qs.n_shards, len(walked))
            got = launches[kernel.NAME if k[1] else kernel.PHASE_NAME]
            if device.type == "cuda" and ((got != want) if k[1]
                                          else (got < want)):
                raise AssertionError(f"mesh tick {k}: {got} launches, "
                                     f"{want} shards walked")
            if rep and kind == "skewed" and k[0] == "mesh8_lane" \
                    and not balanced:
                raise AssertionError("the skewed tick did not balance")
        for qs, _, _ in arms.values():
            qs.bump_refresh(walked)
        if rep:
            by_owner = np.bincount(walked % 8, minlength=8)
            by_walker = [len(walked[s::8]) for s in range(8)]
            log(f"[mesh:{kind}] rep {rep}: walk rows per shard by owner "
                f"{by_owner.tolist()}, round-robin {by_walker}; "
                f"ranked {len(ranked[('mesh8', True)])}")
    log(f"[mesh] every mesh arm == the delta tick bitwise over {REPS} "
        f"ticks (ranks, sup, opt, mean, trig, reach, "
        f"{', '.join(_ARENA_ROWS[:6])} through device_rows)")
    for k, by_kind in stats.items():
        for kind, v in by_kind.items():
            t = [x[0] for x in v]
            k1 = [x[1][kernel.NAME] for x in v]
            k2 = [x[1][kernel.PHASE_NAME] for x in v]
            log(f"[mesh] {k[0]} {'K1' if k[1] else 'K2'} {kind} cap={CAP} "
                f"dirty={n_dirty} W={W} ms/tick median="
                f"{statistics.median(t):.3f} min={min(t):.3f} "
                f"all={['%.3f' % x for x in t]} K1/tick={k1} K2/tick={k2} "
                f"balanced={[bool(x[2]) for x in v]}")
    # where an 8-shard K1 tick's time goes (a fresh uniform dirty set)
    qs, mesh, _ = arms[("mesh8", True)]
    for s in rng.choice(CAP, n_dirty, replace=False):
        qs.set_unit(qs.ids[s], int(rng.integers(0, packed.n_units)))
    walked = qs.take_dirty()
    _profile_tick("mesh:mesh8 K1", lambda: refresh_ranks_mesh(
        packed, qs, 0, mesh=mesh, walked=walked, n_walkers=W,
        prewarm_table=tab, prewarm_k=0.5, with_triage=True))
    # K1 and K2 at the 8-shard mesh's launch: the rows a shard walks
    A = pad_rows(-(-n_dirty // 8))
    log(f"[mesh] K1/K2 held to their plain versions at {A} rows a shard")
    _check_kernel(device, A, W, So)
    _check_phase_kernel(device, A, W, So)
    return k2_launches


def phase_mesh_sim(n_apps):
    """Phase 28's ``run_sim`` arms: ``mesh_shards=8`` on the first
    ``n_apps`` applications of phase 2's trace against ``SimConfig()`` on
    the same apps, on ``cuda`` and on the CPU: identical completion order
    and ACTs.  Returns the K1 launches of the ``cuda`` mesh run and the
    ``cuda`` ``SimConfig()`` result (phase 35's reference)."""
    from repro_torch.apps.suite import build_knowledge_base
    from repro_torch.core.refresh_config import RefreshConfig
    from repro_torch.kernels.pdgraph_walk import kernel
    insts = _trace(n_apps)
    kb = build_knowledge_base(n_trials=100, seed=3)
    k1, default = 0, None
    for dev in ("cuda", "cpu"):
        res = {}
        for arm, rc in (("default", None),
                        ("mesh8", RefreshConfig(mesh_shards=8))):
            r, launches, _ = _run_path(
                f"mesh_sim:{arm}:{dev}", kb, insts,
                _main_config(device=dev, refresh=rc))
            _check_completed(f"mesh_sim {arm} ({dev})", r, insts, launches,
                             [kernel.NAME] if dev == "cuda" else [])
            res[arm] = r
            if dev == "cuda" and arm == "default":
                default = r
            if dev == "cuda" and arm == "mesh8":
                k1 = launches[kernel.NAME]
        _same_schedule(f"mesh_sim mesh8 vs default ({dev})", res["default"],
                       res["mesh8"], 0.0)
    return k1, default


def _trace(n_apps):
    from repro_torch.apps.suite import T_IN, T_OUT
    from repro_torch.apps.workload import make_open_workload
    return make_open_workload(4000.0, t_in=T_IN, t_out=T_OUT,
                              target_load=0.85, n_service_slots=128,
                              process="gamma", cv=2.5, tenants=16, seed=1,
                              max_apps=n_apps)


def _run_path(tag, kb, insts, cfg):
    """``ClusterSim.run`` with every launch counter set to 0 just before
    and read just after.  Returns the result, the counts and the sim."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.simulator import ClusterSim
    sim = ClusterSim(kb, cfg)
    reset_launches()
    t0 = time.perf_counter()
    res = sim.run(insts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    log(f"[{tag}] apps={len(insts)} completed={len(res.acts)} "
        f"mean_act={res.mean_act():.3f} s p95_act={res.p95_act():.3f} s "
        f"ticks={res.policy_calls} ms/tick="
        f"{1e3 * res.policy_time_s / max(res.policy_calls, 1):.3f} "
        f"wall={wall:.1f} s spill={sim.sched.fused_spill} "
        f"launches={launches}")
    return res, launches, sim


def _check_completed(tag, res, insts, launches, kernels):
    import numpy as np
    acts = res.act_values()
    if len(res.acts) != len(insts) or not np.isfinite(acts).all() \
            or (acts <= 0).any():
        raise AssertionError(f"{tag}: not every application completed with "
                             "a finite positive ACT")
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{tag} did not launch {missing}: {launches}")


def _same_schedule(tag, ref, res, rtol):
    import numpy as np
    same = res.completion_order == ref.completion_order
    ids = ref.completion_order
    a = np.asarray([ref.acts[i] for i in ids])
    b = np.asarray([res.acts[i] for i in ids]) if same else a + np.inf
    rel = float(np.max(np.abs(b - a) / np.abs(a)))
    log(f"[{tag}] completion_order_equal={same} max_rel_act_diff={rel}")
    if not same or rel > rtol:
        raise AssertionError(f"{tag}: the schedule differs")


def _main_config(**kw):
    from repro_torch.serving.simulator import SimConfig
    return SimConfig(n_llm_slots=128, n_docker_slots=256, n_dnn_slots=24,
                     kv_capacity=128, lora_capacity=64, docker_capacity=256,
                     dnn_capacity=16, seed=2, **kw)


def phase_main_path(device, n_apps):
    """run_sim at SimConfig() defaults (fused_delta, pallas walker, rank in
    kernel, hermes prewarm) over 128 LLM slots on the card.  Returns the
    result, the launch counts, the walker count, the arena's override
    width and K1's rows per launch."""
    from repro_torch.apps.suite import build_knowledge_base
    from repro_torch.kernels.pdgraph_walk import kernel
    kb = build_knowledge_base(n_trials=100, seed=3)
    insts = _trace(n_apps)
    if n_apps < 2100:
        log(f"[main_path] trace cut to its first {len(insts)} of 2,100 apps "
            "(--sim-apps)")
    cfg = _main_config()
    # K1's rows per launch, read from each launch's arguments (host shapes,
    # no device read)
    rows = []
    inner = kernel.pdgraph_walk_fused_kernel

    def recording(*a, **kw):
        rows.append(int(a[7].shape[0]))
        return inner(*a, **kw)

    kernel.pdgraph_walk_fused_kernel = recording
    try:
        res, launches, sim = _run_path("main_path", kb, insts, cfg)
    finally:
        kernel.pdgraph_walk_fused_kernel = inner
    log(f"[main_path] K1 rows per launch: {len(rows)} launches, mean "
        f"{statistics.mean(rows):.2f}, median {statistics.median(rows)}, max "
        f"{max(rows)}, min {min(rows)}; walker-rows {sum(rows)}")
    qs = sim.sched._qstate
    on_card = all(t is not None and t.is_cuda for t in
                  (sim.sched._packed[1].samples, qs.d_probs, qs.d_edges,
                   qs.a_hist))
    ov_width = int(qs.ov_samples.shape[2])
    log(f"[main_path] W={cfg.mc_walkers} override_width={ov_width} "
        f"arena_on_cuda={on_card}")
    _check_completed("main path", res, insts, launches, [kernel.NAME])
    if not on_card:
        raise AssertionError("main path: arena tensors are not on cuda")
    if len(rows) != launches[kernel.NAME]:
        raise AssertionError(f"main path: {len(rows)} K1 calls recorded, "
                             f"{launches[kernel.NAME]} launches counted")
    return res, launches, cfg.mc_walkers, ov_width, rows


def phase_composed_path(device, n_apps):
    """The main path's trace with ``RefreshConfig(rank_in_kernel=False)``:
    every walk goes through the per-phase kernel; the reference's contract
    is the same schedule as the in-kernel rank (the caller holds it to
    phase 2's, which runs beside it).  Records each K2 launch's lanes,
    step range, apps and operands from its arguments (host shapes, no
    device read).  Returns the launch counts, the apps per launch of the
    median and the largest launch, and the result."""
    from repro_torch.apps.suite import build_knowledge_base
    from repro_torch.core.refresh_config import RefreshConfig
    from repro_torch.kernels.pdgraph_walk import kernel
    kb = build_knowledge_base(n_trials=100, seed=3)
    insts = _trace(n_apps)
    calls = []
    inner = kernel.pdgraph_walk_kernel

    def recording(*a, **kw):
        arrivals = a[15] if len(a) > 15 else kw.get("arrivals")
        calls.append((int(a[7].shape[0]), kw["step0"], kw["n_steps"],
                      kw["n_apps"], kw["lanes_per_app"], arrivals is not None,
                      a[5] is not None))
        return inner(*a, **kw)

    kernel.pdgraph_walk_kernel = recording
    try:
        res, launches, _ = _run_path(
            "composed_path", kb, insts,
            _main_config(refresh=RefreshConfig(rank_in_kernel=False)))
    finally:
        kernel.pdgraph_walk_kernel = inner
    _check_completed("composed path", res, insts, launches,
                     [kernel.PHASE_NAME])
    if len(calls) != launches[kernel.PHASE_NAME]:
        raise AssertionError(f"composed path: {len(calls)} K2 calls "
                             f"recorded, {launches[kernel.PHASE_NAME]} "
                             "launches counted")
    lanes = [c[0] for c in calls]
    by_shape = {}
    for c in calls:
        by_shape[c[:5]] = by_shape.get(c[:5], 0) + 1
    common = sorted(by_shape.items(), key=lambda kv: -kv[1])[:6]
    log(f"[composed_path] K2 launches: {len(calls)} in {res.policy_calls} "
        f"refresh calls ({len(calls) / max(res.policy_calls, 1):.3f} a "
        f"call); lanes mean {statistics.mean(lanes):.2f}, median "
        f"{statistics.median(lanes)}, max {max(lanes)}, min {min(lanes)}; "
        f"with arrivals {sum(c[5] for c in calls)}, with posterior tables "
        f"{sum(c[6] for c in calls)}; first phases (step0 = 0) "
        f"{sum(c[1] == 0 for c in calls)}")
    log(f"[composed_path] K2 launch shapes (lanes, step0, n_steps, apps, "
        f"lanes_per_app): count: {common}")
    order = sorted(calls)
    median, largest = order[(len(order) - 1) // 2], order[-1]
    apps = list(dict.fromkeys((median[3], largest[3])))
    log(f"[composed_path] median launch {median[:5]}, largest {largest[:5]}"
        f": apps per launch {apps}")
    return launches, apps, res


# the drift benchmark's full scenario (benchmarks/drift.py, FULL)
DRIFT = dict(duration_s=600.0, shift_at=120.0, rate_per_s=0.3,
             demand_mult=3.0, p_repeat=0.35, n_llm_slots=8, kb_trials=120,
             seed=11, mc_walkers=64,
             mix={"EV": 0.144, "FEV": 0.144, "CC": 0.144, "ALFWI": 0.144,
                  "KBQAV": 0.144, "CG": 0.13, "PE": 0.13},
             drift_apps=("FEV", "ALFWI", "KBQAV"))


def phase_posterior_path(device):
    """Online posterior learning on the drift scenario, on the card and on
    the CPU: the same schedule; every application completes."""
    import numpy as np
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.apps.workload import TenantProfile, make_drift_workload
    from repro_torch.core.posterior import PosteriorConfig
    from repro_torch.kernels.pdgraph_walk import kernel
    from repro_torch.serving.simulator import SimConfig
    p = DRIFT
    insts = make_drift_workload(
        p["duration_s"], t_in=T_IN, t_out=T_OUT, shift_at=p["shift_at"],
        rate_per_s=p["rate_per_s"], demand_mult=p["demand_mult"],
        p_repeat=p["p_repeat"], drift_apps=p["drift_apps"],
        n_service_slots=p["n_llm_slots"],
        tenants=[TenantProfile(name="t0", app_mix=p["mix"])], seed=p["seed"])
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = SimConfig(policy="gittins", seed=5, prewarm_mode="lru",
                        n_llm_slots=p["n_llm_slots"],
                        mc_walkers=p["mc_walkers"],
                        posterior=PosteriorConfig(), device=dev)
        kb = build_knowledge_base(n_trials=p["kb_trials"], seed=3)
        res, launches, sim = _run_path(f"posterior_path:{dev}", kb, insts,
                                       cfg)
        out[dev] = (res, launches)
        drift = [res.acts[i.app_id] for i in insts
                 if i.app_id.startswith("drift")]
        log(f"[posterior_path:{dev}] post-shift apps={len(drift)} "
            f"post_shift_mean_act={float(np.mean(drift)):.3f} s "
            f"observations={sim.sched._post_state.n_observations()}")
    _check_completed("posterior path", out["cuda"][0], insts, out["cuda"][1],
                     [kernel.POSTERIOR_NAME])
    _check_completed("posterior path (cpu)", out["cpu"][0], insts,
                     out["cpu"][1], [])
    _same_schedule("posterior_path cuda vs cpu", out["cpu"][0],
                   out["cuda"][0], 1e-6)
    return out["cuda"][1]


def phase_threefry_path(n_apps=100):
    """The threefry walker (plain PyTorch, no kernel) on the first
    ``n_apps`` applications of the main path's trace: the composed refresh
    with Gittins, and ``srpt_mean`` (host samples in every mode), each on
    the card and on the CPU from the same knowledge base: the same
    schedule; the refresh's ms per call on each."""
    from repro_torch.apps.suite import build_knowledge_base
    from repro_torch.core.refresh_config import RefreshConfig
    insts = _trace(n_apps)
    arms = (("composed", dict(refresh=RefreshConfig(mode="composed"))),
            ("srpt_mean", dict(policy="srpt_mean")))
    for arm, kw in arms:
        out = {}
        for dev in ("cuda", "cpu"):
            kb = build_knowledge_base(n_trials=100, seed=3)
            res, launches, sim = _run_path(f"threefry:{arm}:{dev}", kb,
                                           insts,
                                           _main_config(device=dev, **kw))
            s = sim.sched
            log(f"[threefry:{arm}:{dev}] mode={s.mode} policy="
                f"{s.policy.name} refresh calls={res.policy_calls} ms per "
                f"refresh call="
                f"{1e3 * res.policy_time_s / max(res.policy_calls, 1):.3f}")
            _check_completed(f"threefry {arm} ({dev})", res, insts, launches,
                             [])
            if s._fused_active() or any(launches.values()):
                raise AssertionError(f"threefry {arm}: refreshed through "
                                     f"a kernel: {launches}")
            if dev == "cuda" and not s._base_key.is_cuda:
                raise AssertionError(f"threefry {arm}: the walk keys are "
                                     "not on cuda")
            out[dev] = res
        _same_schedule(f"threefry:{arm} cuda vs cpu", out["cpu"], out["cuda"],
                       1e-6)


def phase_reference_and_threefry():
    """Phase 7: the small trace, then the threefry walker."""
    phase_reference()
    phase_threefry_path()


def phase_reference():
    """A small trace on the card and on the CPU: the kernel path and the
    plain path must schedule identically."""
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.apps.workload import make_workload
    from repro_torch.serving.simulator import SimConfig, run_sim
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = run_sim(build_knowledge_base(n_trials=40, seed=3),
                           make_workload(30, 120.0, seed=29, t_in=T_IN,
                                         t_out=T_OUT),
                           SimConfig(seed=5, n_llm_slots=8, mc_walkers=32,
                                     device=dev))
    _same_schedule("reference: 30-app trace cuda vs cpu", out["cpu"],
                   out["cuda"], 1e-6)



# --------------------------------------------------------------------------
# model kernels (K3-K5), the full-width check, the serve path


def _hold(tag, out, want, dtype_name, tol=None):
    """Raise unless ``out`` matches ``want`` at the dtype's tolerance;
    returns the max abs error."""
    import torch
    tol = KERNEL_TOL[dtype_name] if tol is None else tol
    a, b = out.float(), want.float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{tag}: non-finite output")
    err = float((a - b).abs().max())
    ok = bool(torch.allclose(a, b, rtol=tol, atol=tol))
    log(f"{tag} max_abs_err={err} tol={tol} ok={ok}")
    if not ok:
        raise AssertionError(f"{tag}: differs from the plain version "
                             f"(max abs err {err}, tolerance {tol})")
    return err


# K5's bfloat16-scores checks scale q by this: scores in the hundreds, where
# one bfloat16 step of q.k is a logit step of about 0.1, so the output of
# float32 scores lies several tolerances away (0.12-0.24 on the plain
# version at the checks' shapes) and a kernel that ignored the option fails
BF16_SCORES_Q_SCALE = 16.0


def _apart(tag, out, f32_plain, dtype_name):
    """Raise unless ``out`` (K5 with ``bf16_scores``) lies more than twice
    the dtype's tolerance from ``f32_plain``, the plain version with
    float32 scores: the option did something.  Returns that gap."""
    tol = KERNEL_TOL[dtype_name]
    gap = float((out.float() - f32_plain.float()).abs().max())
    log(f"{tag} max_abs_gap_to_f32_scores={gap} (must exceed {2 * tol})")
    if not gap > 2 * tol:
        raise AssertionError(f"{tag}: within {gap} of the plain version's "
                             "float32 scores: the option changed nothing")
    return gap


def _timed(tag, launch, plain, library, n_bytes, flops=0.0,
           flops_peak=PEAK_BF16_FLOPS):
    """Kernel time per launch (on a held stream; free-running CUDA events
    beside), the plain version's and the library call's device time (None
    where no library call computes the function), and the bound (bytes at
    the memory rate or FLOPs at ``flops_peak``)."""
    ev = cuda_time_ms(launch, iters=20)
    ms = held_ms(launch)
    plain_ms = held_ms(plain, iters=3)
    library_ms = None if library is None else held_ms(library)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / flops_peak
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"{tag} kernel {ms:.6f} ms (device; events {ev:.6f})  plain "
        f"{plain_ms:.6f} ms  library {library_ms} ms  bound "
        f"{bound_ms:.6f} ms ({bound_by}; bytes={n_bytes} flops={flops:.4g})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _free():
    """Release the device memory of dropped models.  The engine and its
    prefix cache refer to each other, so a served model outlives ``del``
    until the cycle collector runs."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _randn(shape, dtype, gen, device):
    import torch
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _check_rmsnorm(device, rows, D, dtype_name, seed=0, offset=0):
    """K3 against its plain version; ``offset`` elements into its buffer,
    the input starts off 16-byte alignment and takes the one-element
    path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel, ops, ref
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = _randn((rows * D + offset,), dt, gen, device)[offset:].view(rows, D)
    s = _randn((D,), torch.float32, gen, device)
    s_lib = s.to(dt)
    plan = kernel.launch_plan(D, x.element_size(), x.data_ptr() % 16 == 0,
                              rows)
    tag = (f"[kernel:rmsnorm rows={rows} D={D} {dtype_name}"
           f"{' offset=%d' % offset if offset else ''} {tuple(plan)}]")
    err = _hold(tag, kernel.rmsnorm_kernel(x, s, eps=1e-5),
                ref.rmsnorm_ref(x, s, 1e-5), dtype_name)
    flops, n_bytes = ops.cost(rows, D, x.element_size(), s.element_size())
    t = _timed(tag, lambda: kernel.rmsnorm_kernel(x, s, eps=1e-5),
               lambda: ref.rmsnorm_ref(x, s, 1e-5),
               lambda: F.rms_norm(x, (D,), s_lib, 1e-5),
               n_bytes=n_bytes, flops=flops, flops_peak=PEAK_F32_FLOPS)
    return dict(t, max_abs_err=err)


def _check_flash(device, B, Sq, Skv, H, K, hd, dtype_name, causal, seed=0):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = _randn((B, Sq, H, hd), dt, gen, device)
    k = _randn((B, Skv, K, hd), dt, gen, device)
    v = _randn((B, Skv, K, hd), dt, gen, device)
    G = H // K
    qf = (q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)
          .reshape(B * K * G, Sq, hd).contiguous())
    kf = k.permute(0, 2, 1, 3).reshape(B * K, Skv, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * K, Skv, hd).contiguous()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    tag = (f"[kernel:flash_attention B={B} Sq={Sq} Skv={Skv} H={H} K={K} "
           f"hd={hd} {dtype_name} causal={causal}]")
    want = (ref.attention_ref(qf, kf, vf, causal=causal)
            .reshape(B, K, G, Sq, hd).permute(0, 3, 1, 2, 4)
            .reshape(B, Sq, H, hd))
    err = _hold(tag, kernel.flash_attention_kernel(q, k, v, causal=causal),
                want, dtype_name)
    flops, n_bytes = ops.cost(B, Sq, Skv, H, K, hd, q.element_size(),
                              causal)
    t = _timed(tag, lambda: kernel.flash_attention_kernel(q, k, v,
                                                          causal=causal),
               lambda: ref.attention_ref(qf, kf, vf, causal=causal),
               lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=True),
               n_bytes=n_bytes, flops=flops,
               flops_peak=(PEAK_BF16_FLOPS if dtype_name == "bfloat16"
                           else PEAK_F32_FLOPS))
    return dict(t, max_abs_err=err)


def _check_decode(device, B, H, K, hd, Smax, lengths, dtype_name, seed=0,
                  bf16_scores=False):
    """Caches laid out (B, K, Smax, hd) and passed as the transposed view
    the engine passes; per-row ``lengths`` (B,); ``bf16_scores``: the
    launch option that rounds each q.k to bfloat16 before the scale, with
    q scaled by ``BF16_SCORES_Q_SCALE``: held to the plain version's
    ``f32_scores=False`` and kept apart from its float32 scores."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = _randn((B, H, hd), dt, gen, device)
    if bf16_scores:
        q = (q.float() * BF16_SCORES_Q_SCALE).to(dt)
    kc = _randn((B, K, Smax, hd), dt, gen, device)
    vc = _randn((B, K, Smax, hd), dt, gen, device)
    lengths = torch.as_tensor(lengths, device=device)
    rows = lengths.repeat_interleave(K).to(torch.int32)
    G = H // K
    q4 = q.reshape(B, H, 1, hd)
    mask = (torch.arange(Smax, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    tag = (f"[kernel:decode_attention B={B} H={H} K={K} hd={hd} Smax={Smax} "
           f"{dtype_name} lengths={lengths.tolist()[:8]}"
           f"{' bf16_scores' if bf16_scores else ''}]")

    def launch():
        return kernel.decode_attention_kernel(q, kc.transpose(1, 2),
                                              vc.transpose(1, 2), rows,
                                              bf16_scores=bf16_scores)

    def plain(f32_scores=not bf16_scores):
        return ref.decode_attention_ref(q.reshape(B * K, G, hd),
                                        kc.reshape(B * K, Smax, hd),
                                        vc.reshape(B * K, Smax, hd), rows,
                                        f32_scores=f32_scores)

    out = launch()
    err = _hold(tag, out, plain().reshape(B, H, hd), dtype_name)
    if bf16_scores:
        _apart(tag, out, plain(True).reshape(B, H, hd), dtype_name)
    if not torch.equal(out, launch()):
        raise AssertionError(f"{tag}: two launches differ (the split merge "
                             "must not depend on the blocks' order)")
    flops, n_bytes = ops.cost(B, H, K, hd, int(rows.sum()), q.element_size())
    t = _timed(tag, launch, plain,
               lambda: F.scaled_dot_product_attention(
                   q4, kc, vc, attn_mask=mask, enable_gqa=True),
               n_bytes=n_bytes, flops=flops, flops_peak=PEAK_F32_FLOPS)
    return dict(t, max_abs_err=err)


MODEL_KERNELS = {
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:23"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:69"),
    "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/"
                         "decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:63"),
    "moe_gmm": ("src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
                "src/repro/kernels/moe_gmm/kernel.py:41"),
    "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:63"),
}
# the model kernels each family's layers run
FAMILY_KERNELS = {
    "dense": ("rmsnorm", "flash_attention", "decode_attention"),
    "moe": ("rmsnorm", "flash_attention", "decode_attention", "moe_gmm"),
    "ssm": ("rmsnorm", "ssd_scan"),
    "hybrid": ("rmsnorm", "flash_attention", "decode_attention", "moe_gmm",
               "ssd_scan"),
}


def _kernel_entry(name, r, path=None):
    """One kernel's entry of the kernels line (launches filled later),
    named ``name:path`` for a shape of another path than the first."""
    return {"name": name if path is None else f"{name}:{path}",
            "route": "cuda", "source": MODEL_KERNELS[name][0],
            "replaces": MODEL_KERNELS[name][1], "launches": 0,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def phase_model_kernels(device, parent=None):
    """K3-K5 against their plain versions: the serve path's own shapes
    (the kernels-line entries) and the full-width Llama-3-8B shapes; K3 at
    every D of the card tests, rows not a multiple of a block's and an
    input one element off 16-byte alignment; K5's bfloat16-scores option,
    both modes, timed; K3's sweep beside the parent's kernel when
    ``parent`` names its checkout."""
    import numpy as np
    import torch
    main = {
        # one decode-step row of d_model 4,096, bf16
        "rmsnorm": _check_rmsnorm(device, 1, 4096, "bfloat16"),
        # a 24-token prefix prefill of Llama-3-8B's heads
        "flash_attention": _check_flash(device, 1, 24, 24, 32, 8, 128,
                                        "bfloat16", True),
        # one decode step over a slot's 192-position caches
        "decode_attention": _check_decode(device, 1, 32, 8, 128, 192, [100],
                                          "bfloat16"),
    }
    for dt in ("bfloat16", "float32"):
        _check_rmsnorm(device, 4096, 4096, dt)
        _check_rmsnorm(device, 4097, 4096, dt)
    _check_rmsnorm(device, 4096 * 32, 128, "bfloat16")
    _check_rmsnorm(device, 24 * 32, 128, "bfloat16")
    for dt in ("bfloat16", "float32"):
        for D in (64, 100, 2048, 4095, 16384):
            _check_rmsnorm(device, 37, D, dt)
        _check_rmsnorm(device, 33, 4096, dt, offset=1)
        _check_rmsnorm(device, 4096, 4096, dt, offset=1)
    _versus_parent("rmsnorm", {}, parent)
    torch.cuda.synchronize()
    for dt in ("float32", "bfloat16"):
        for causal in (True, False):
            for shape in ((1, 128, 128, 4, 4, 32), (2, 256, 256, 8, 2, 64),
                          (1, 64, 256, 4, 1, 128), (1, 23, 23, 8, 2, 128)):
                _check_flash(device, *shape, dt, causal)
    _check_flash(device, 1, 8, 8, 32, 8, 128, "bfloat16", True)
    _check_flash(device, 1, 2048, 2048, 32, 8, 128, "bfloat16", True)
    # qwen2-7b's G = 7 at a ragged S, and Whisper's 1,500-frame encoder
    # (G = 1, hd 64, not causal)
    _check_flash(device, 1, 300, 300, 28, 4, 128, "bfloat16", True)
    _check_flash(device, 1, 1500, 1500, 20, 20, 64, "bfloat16", False)
    rng = np.random.default_rng(13)
    long_lengths = rng.integers(1, 8193, 8).tolist()
    for dt in ("bfloat16", "float32"):
        _check_decode(device, 1, 32, 8, 128, 192, [100], dt)
        _check_decode(device, 8, 32, 8, 128, 8192, long_lengths, dt)
        # one long row over 16 splits; lengths inside the first split, on
        # its end and one past it
        _check_decode(device, 1, 32, 8, 128, 8192, [8192], dt)
        _check_decode(device, 4, 32, 8, 128, 2048, [5, 512, 513, 2048], dt)
    # the bfloat16-scores option (decode_f32_scores=False): the engine's
    # shape, 8 long rows, and the partial mode at phase 37's shape
    _check_decode(device, 1, 32, 8, 128, 192, [100], "bfloat16",
                  bf16_scores=True)
    _check_decode(device, 8, 32, 8, 128, 8192, long_lengths, "bfloat16",
                  bf16_scores=True)
    _check_decode_partial(device, 2, 32, 8, 128, 1024, [1024, 1023, 0, 1],
                          "bfloat16", bf16_scores=True)
    return [_kernel_entry(name, r) for name, r in main.items()]


def _teacher_forced(model, prompt, forced, **side):
    """Prefill ``prompt`` (1, S) (with the frames or patch embeddings
    ``side`` of an encoder-decoder or VLM), then decode each of ``forced``
    (1, n): the logits of every step, as float32 on the CPU.  The self
    caches grow to S + n positions (behind the patches of a VLM); the
    others, the encoder-decoder's cross caches ``xk``/``xv`` among them,
    are copied whole."""
    import torch
    n = forced.shape[1]
    caches, logits = model.prefill(prompt, **side)
    S = caches["k"].shape[3] if "k" in caches else prompt.shape[1]
    out = [logits.float().cpu()]
    big = model.new_caches(1, S + n)
    for name, c in caches.items():
        if name in ("k", "v"):
            big[name][:, :, :, :S] = c
        else:
            big[name].copy_(c)
    for t in range(n):
        big, logits = model.decode(big, forced[:, t:t + 1], S + t)
        out.append(logits.float().cpu())
    return torch.cat(out, dim=1)


def phase_full_width(device):
    """Llama-3-8B widths at 2 of its 32 layers: the card (K3-K5) against
    the CPU (the plain versions) from the same weights."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import build_model
    cfg = get_config("llama3-8b").replace(num_layers=2)
    t0 = time.perf_counter()
    card = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(1))
    cpu = build_model(cfg, device="cpu").load_params(
        {n: p.cpu() for n, p in card.params().items()})
    log(f"[full_width] {cfg.name} layers=2 d_model={cfg.d_model} "
        f"vocab={cfg.vocab_size} {cfg.dtype}: weights "
        f"{sum(p.numel() * p.element_size() for p in card.parameters())} "
        f"bytes, built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(1, cfg.vocab_size, (1, 24), generator=gen)
    forced = torch.randint(1, cfg.vocab_size, (1, 8), generator=gen)
    reset_launches()
    a = _teacher_forced(card, prompt, forced)
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    b = _teacher_forced(cpu, prompt, forced)
    log(f"[full_width] cpu run {time.perf_counter() - t0:.1f} s; card "
        f"launches {launches}")
    for name in ("rmsnorm", "flash_attention", "decode_attention"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"full-width check did not launch {name}")
    err = _hold("[full_width] logits (prefill + 8 decode steps)", a, b,
                "bfloat16", tol=MODEL_BF16_TOL)
    agree = (a.argmax(-1) == b.argmax(-1)).sum().item()
    log(f"[full_width] max_abs_err={err} greedy tokens agree at {agree} of "
        f"{a.shape[1]} steps; logits max |x| {float(b.abs().max())}")
    del card, cpu
    _free()


def _trace_llm_requests(n_apps, window, seed):
    """The LLM requests ``serve`` submits for its trace (fixed by the
    trace, not the wall clock)."""
    from repro_torch.apps.suite import SUITE
    from repro_torch.apps.workload import make_workload
    from repro_torch.launch import serve
    insts = make_workload(n_apps, window, seed=seed, t_in=serve.T_IN,
                          t_out=serve.T_OUT)
    return sum(int(obs["par"]) for inst in insts
               for unit, obs in inst.trajectory
               if SUITE[inst.app_name].units[unit].backend.kind == "llm")


def _profile_decode(tag, model, caches, pos, step_ms):
    """One decode step under torch.profiler: device busy against the
    profiled wall and against ``step_ms`` (the unprofiled median step), and
    the shares of matrix products and of each model kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    tok = torch.tensor([[7]], device=model.device)
    for _ in range(PROFILER_SESSIONS):   # a session may record no device work
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.decode(caches, tok, pos)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        evs = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
        if evs:
            break
    if not evs:
        log(f"[{tag}:decode_profile] not measured: the profiler saw no device "
            f"work in {PROFILER_SESSIONS} sessions")
        return
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    groups = {"matmul": ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                         "splitK", "matmul"),
              "rmsnorm": ("rmsnorm_kernel",), "decode_attention":
              ("decode_attention_kernel",),
              "moe_gmm": ("moe_gmm_kernel", "moe_gmm_tc")}
    share = {g: sum(e.self_device_time_total for e in evs
                    if any(k in e.key for k in keys)) / 1e3
             for g, keys in groups.items()}
    log(f"[{tag}:decode_profile] wall={wall:.3f} ms (profiled) device_busy="
        f"{busy:.3f} ms ({100 * busy / wall:.1f} % of the profiled step, "
        f"{100 * busy / step_ms:.1f} % of the {step_ms:.3f} ms median step) "
        f"device_ops="
        f"{sum(e.count for e in evs)} " + " ".join(
            f"{g}={v:.3f} ms ({100 * v / busy:.1f} % of busy)"
            for g, v in share.items()))
    for e in sorted(evs, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        log(f"[{tag}:decode_profile]   {e.key[:70]:70s} device="
            f"{e.self_device_time_total / 1e3:.4f} ms calls={e.count}")
    host = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CPU")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    log(f"[{tag}:decode_profile] host ops (profiled, self CPU time): "
        f"{sum(e.count for e in host)} ops, "
        f"{sum(e.self_cpu_time_total for e in host) / 1e3:.3f} ms; top: "
        + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in host[:8]))


# parameters a decode step does not read: the encoder and its final norm,
# the VLM projector (prefill only) and the cross-attention's key and value
# projections (their products are the cross caches)
UNREAD_IN_DECODE = ("encoder.", "enc_final_norm.", "projector")
UNREAD_SUFFIXES = (".cross_attn.wk", ".cross_attn.wv")


def _step_bytes(model, caches):
    """Bytes one decode step must move: every weight it reads, once (the
    embedding table too where the unembedding is tied to it, else one row
    of it; one row of learned positions; not ``UNREAD_IN_DECODE``), each
    Mamba layer's state and conv windows read and written, and the
    encoder-decoder's cross caches read (``caches``: the step's; the
    self-attention caches are not counted)."""
    n_bytes = 0
    for name, p in model.named_parameters():
        if name.startswith(UNREAD_IN_DECODE) or name.endswith(
                UNREAD_SUFFIXES):
            continue
        one_row = name == "pos_emb" or (name == "embed"
                                        and model.lm_head is not None)
        if one_row:
            n_bytes += p.shape[1] * p.element_size()
        else:
            n_bytes += p.numel() * p.element_size()
    for n, t in caches.items():
        if n in ("xk", "xv"):           # the cross caches, read
            n_bytes += t.numel() * t.element_size()
        elif n not in ("k", "v"):       # Mamba state, read and written
            n_bytes += 2 * t.numel() * t.element_size()
    return n_bytes


def phase_serve(device, arch):
    """A main path: serve on a full-width ``arch`` (random weights drawn on
    the card), counters reset and read around it; then one batch-1 decode
    step timed and profiled."""
    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    cfg = get_config(arch)
    tag = "serve" if cfg.family == "dense" else f"serve_{cfg.family}"
    expected = _trace_llm_requests(10, 5.0, 0)
    _free()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    run = serve.run(["--apps", "10"], cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    eng, model = run.engine, run.model
    done = eng.done
    tokens = sum(len(r.output) for r in done)
    hits = sum(1 for r in done if r.prefix_hit)
    with_prefix = sum(1 for r in done if r.prefix_id)
    ttft = [r.ttft for r in done if r.ttft]
    log(f"[{tag}] {cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
        f"{cfg.dtype} params={sum(p.numel() for p in model.parameters())}: "
        f"apps={run.n_apps} requests_served={len(done)} of {expected} "
        f"(distinct ids {len({r.req_id for r in done})}) "
        f"tokens_generated={tokens} engine_steps={eng.steps} "
        f"prefix_hits={hits}/{with_prefix} lora_merges={eng.lora.merges} "
        f"lora_hits={eng.lora.hits} lora_misses={eng.lora.misses} "
        f"mean_ttft={1e3 * float(np.mean(ttft)):.3f} ms "
        f"init={run.init_s:.3f} s wall={wall:.1f} s "
        f"max_memory_allocated={peak} (allocated before: {before}) "
        f"refresh_mode={run.sched.mode} launches={launches}")
    if len(done) != expected:
        raise AssertionError(f"{tag} served {len(done)} of the trace's "
                             f"{expected} LLM requests")
    bad = [r.req_id for r in done
           if len(r.output) != r.max_new_tokens
           or not all(0 <= t < cfg.vocab_size for t in r.output)]
    if bad:
        raise AssertionError(f"{tag}: requests with wrong outputs: {bad[:5]}")
    missing = [k for k in FAMILY_KERNELS[cfg.family]
               if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{tag} did not launch {missing}: {launches}")
    if run.sched.mode != "composed":
        raise AssertionError(f"{tag}: the scheduler runs {run.sched.mode!r},"
                             " not the reference's bare default 'composed'")
    # one decode step at batch 1 of a slot 100 positions in
    prompt = torch.randint(1, cfg.vocab_size, (1, 100),
                           generator=torch.Generator().manual_seed(4))
    caches, _ = model.prefill(prompt)
    caches = eng._pad_caches(caches, 100)
    steps = []
    tok = torch.tensor([[11]], device=model.device)
    for i in range(25):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.decode(caches, tok, 100 + i)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t1) * 1e3)
    w = _step_bytes(model, caches)
    median = statistics.median(steps[5:])
    log(f"[{tag}:decode] ms per decode step median={median:.3f} "
        f"min={min(steps[5:]):.3f} "
        f"(batch 1, positions 105..124; weights and state moved {w} bytes, "
        f"floor "
        f"{1e3 * w / PEAK_BYTES_S:.3f} ms at {PEAK_BYTES_S:.3g} B/s)")
    _profile_decode(tag, model, caches, 125, median)
    del run, eng, model, caches
    _free()
    return launches


def _engine_script(eng, Request):
    """Requests through ``eng`` covering a warm prefix, a cold prefix hit by
    a second request in the same step, priority admission and LoRA pool
    eviction; returns what must match between devices."""
    eng.prewarm_prefix("p1")
    eng.submit(Request("w", prompt=[1, 2, 3], max_new_tokens=6,
                       prefix_id="p1"))
    eng.submit(Request("c", prompt=[5, 6], max_new_tokens=4,
                       prefix_id="p2", app_id="mid"))
    eng.submit(Request("d", prompt=[9], max_new_tokens=5, prefix_id="p2",
                       app_id="hi"))
    ranks = {"": 1.0, "mid": 0.5, "hi": 0.0}
    eng.run(rank_fn=lambda r: ranks[r.app_id])
    for i, lid in enumerate(["l0", "l1", "l2", "l0", "", "l2"]):
        eng.submit(Request(f"r{i}", prompt=[7, i + 1], max_new_tokens=3,
                           lora_id=lid, prefix_id="p2" if i % 2 else ""))
        eng.run()
    return ([(r.req_id, r.output, r.prefix_hit) for r in eng.done],
            (eng.lora.hits, eng.lora.misses, eng.lora.merges),
            (eng.prefix.hits, eng.prefix.misses))


def phase_engine_reference(device, arch):
    """A tiny float32 ``arch`` through the engine on the card and on the
    CPU from the same weights and adapters: the same tokens, order, prefix
    flags and LoRA counters."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import InferenceEngine, Request
    from repro_torch.serving.lora import LoraAdapter, make_random_adapter
    from repro_torch.testing import tiny_config
    cfg = tiny_config(arch, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = build_model(cfg, device=device).load_params(cpu.params())
    adapters = [make_random_adapter(f"l{i}", cpu.params(), seed=i)
                for i in range(3)]
    out = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        eng = InferenceEngine(model, max_slots=2, max_seq=96,
                              lora_capacity=2, prefix_prompts={
                                  "p1": list(range(10, 30)),
                                  "p2": list(range(40, 70))})
        for a in adapters:
            eng.lora.register(LoraAdapter(a.lora_id, a.rank, {
                n: (x.to(model.device), y.to(model.device))
                for n, (x, y) in a.deltas.items()}, a.scale))
        reset_launches()
        out[dev] = _engine_script(eng, Request)
        if dev == "cuda":
            launches = dict(LAUNCHES)
    same = out["cuda"] == out["cpu"]
    log(f"[engine_reference:{arch}] layers={cfg.num_layers} "
        f"requests={len(out['cpu'][0])} "
        f"order={[r[0] for r in out['cpu'][0]]} lora={out['cpu'][1]} "
        f"prefix={out['cpu'][2]} identical={same} card launches={launches}")
    missing = [k for k in FAMILY_KERNELS[cfg.family]
               if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{arch} engine on cuda did not launch "
                             f"{missing}: {launches}")
    if not same:
        raise AssertionError(f"{arch} engine on cuda differs from the CPU: "
                             f"{out['cuda']} vs {out['cpu']}")

# --------------------------------------------------------------------------
# the MoE family: K6, the full-width MoE check (the MoE serve path is
# phase_serve on qwen2-moe-a2.7b)


def _check_moe_gmm(device, E, C, D, N, dtype_name, seed=0):
    """K6 against its plain version at one shape: x (E, C, D) normal, w
    (E, D, N) at the experts' init scale 1/sqrt(D); timed beside its bound,
    the plain version and ``torch.bmm``."""
    import torch
    from repro_torch.kernels.moe_gmm import kernel, ops, ref
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = _randn((E, C, D), dt, gen, device)
    w = (torch.randn((E, D, N), generator=gen, device=device)
         * D ** -0.5).to(dt)
    tag = f"[kernel:moe_gmm E={E} C={C} D={D} N={N} {dtype_name}]"
    err = _hold(tag, kernel.moe_gmm_kernel(x, w), ref.moe_gmm_ref(x, w),
                dtype_name, tol=GMM_TOL[dtype_name])
    flops, n_bytes = ops.cost(E, C, D, N, x.element_size())
    t = _timed(tag, lambda: kernel.moe_gmm_kernel(x, w),
               lambda: ref.moe_gmm_ref(x, w), lambda: torch.bmm(x, w),
               n_bytes=n_bytes, flops=flops,
               flops_peak=(PEAK_BF16_FLOPS if dtype_name == "bfloat16"
                           else PEAK_F32_FLOPS))
    return dict(t, max_abs_err=err)


# (E, C, D, N): Qwen1.5-MoE's decode (C = 1), short-prefill (C = 8) and
# 2,048-token prefill (C = 160) products, wi/wg then wo; Phi-3.5-MoE's;
# the reference's test sweep (tests/test_kernels.py); the tiny models'
GMM_SHAPES = ((64, 1, 2048, 1408), (64, 1, 1408, 2048), (64, 8, 2048, 1408),
              (64, 8, 1408, 2048), (64, 160, 2048, 1408),
              (64, 160, 1408, 2048), (16, 1, 4096, 6400), (16, 1, 6400, 4096),
              (16, 8, 4096, 6400), (16, 8, 6400, 4096), (4, 64, 128, 256),
              (2, 128, 256, 128), (8, 32, 64, 64), (16, 3, 64, 96),
              (16, 3, 96, 64))


def phase_moe_kernels(device):
    """K6 against its plain version at every shape of ``GMM_SHAPES`` in
    bfloat16 and float32; the kernels-line entry is the serve path's
    decode shape in bfloat16."""
    main = _check_moe_gmm(device, *GMM_SHAPES[0], "bfloat16")
    for dt in ("bfloat16", "float32"):
        for shape in GMM_SHAPES[int(dt == "bfloat16"):]:
            _check_moe_gmm(device, *shape, dt)
    return _kernel_entry("moe_gmm", main)


def phase_moe_full_width(device):
    """Qwen1.5-MoE widths at 2 of its 24 layers in float32 (a bf16
    rounding near a top-4 tie would move a token to another expert and say
    nothing about the kernels): the card (K3-K6) against the CPU (the
    plain versions) from the same weights, with the tokens whose expert
    sets differ counted per layer."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import moe as X
    from repro_torch.models.model import build_model
    cfg = get_config("qwen2-moe-a2.7b").replace(num_layers=2,
                                                 dtype="float32")
    t0 = time.perf_counter()
    card = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(1))
    cpu = build_model(cfg, device="cpu").load_params(
        {n: p.cpu() for n, p in card.params().items()})
    log(f"[moe_full_width] {cfg.name} layers=2 d_model={cfg.d_model} "
        f"experts={cfg.num_experts} top_k={cfg.top_k} vocab={cfg.vocab_size} "
        f"{cfg.dtype}: weights "
        f"{sum(p.numel() * p.element_size() for p in card.parameters())} "
        f"bytes, built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(1, cfg.vocab_size, (1, 24), generator=gen)
    forced = torch.randint(1, cfg.vocab_size, (1, 8), generator=gen)
    routes = []
    route = X.route

    def recording(p, xf, c):            # each call's expert sets, per token
        w, i = route(p, xf, c)
        routes.append(i.sort(dim=-1).values.cpu())
        return w, i

    X.route = recording
    try:
        reset_launches()
        a = _teacher_forced(card, prompt, forced)
        launches = dict(LAUNCHES)
        on_card = routes[:]
        routes.clear()
        t0 = time.perf_counter()
        b = _teacher_forced(cpu, prompt, forced)
        on_cpu = routes[:]
    finally:
        X.route = route
    log(f"[moe_full_width] cpu run {time.perf_counter() - t0:.1f} s; card "
        f"launches {launches}")
    for name in ("rmsnorm", "flash_attention", "decode_attention", "moe_gmm"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"MoE full-width check did not launch {name}")
    L = cfg.num_layers
    if len(on_card) != len(on_cpu) or len(on_card) % L:
        raise AssertionError(f"route calls differ: {len(on_card)} on the "
                             f"card, {len(on_cpu)} on the CPU")
    differ = [sum(int((on_card[j] != on_cpu[j]).any(-1).sum())
                  for j in range(layer, len(on_card), L))
              for layer in range(L)]
    tokens = sum(int(r.shape[0]) for r in on_card[::L])
    log(f"[moe_full_width] tokens whose expert sets differ, per layer: "
        f"{differ} of {tokens} each")
    err = _hold("[moe_full_width] logits (prefill + 8 decode steps)", a, b,
                "float32", tol=MODEL_F32_TOL)
    agree = (a.argmax(-1) == b.argmax(-1)).sum().item()
    log(f"[moe_full_width] max_abs_err={err} greedy tokens agree at {agree} "
        f"of {a.shape[1]} steps; logits max |x| {float(b.abs().max())}")
    del card, cpu
    _free()


# --------------------------------------------------------------------------
# the SSM family: K7, the full-width Mamba2 check (the SSM serve path is
# phase_serve on mamba2-1.3b)


def _ssd_inputs(device, B, S, H, P, N, dtype, gen):
    """The reference test's distributions (tests/test_kernels.py): x, B, C
    normal; dt uniform in [0.001, 0.1]; A in [-2, -0.5]."""
    import torch
    f32 = dict(generator=gen, device=device)
    return (_randn((B, S, H, P), dtype, gen, device),
            torch.rand((B, S, H), **f32) * 0.099 + 0.001,
            -(torch.rand((H,), **f32) * 1.5 + 0.5),
            _randn((B, S, N), dtype, gen, device),
            _randn((B, S, N), dtype, gen, device))


def _check_ssd(device, B, S, H, P, N, chunk, dtype_name, seed=0):
    """K7 against the chunked plain version at one shape: y at the dtype's
    SSD tolerance, the float32 final state at float32's in either dtype;
    timed beside its bound and the plain version.  The bound counts each
    input read and each output written once, and the FLOPs the chunked
    algorithm needs at the reference's chunk: per (batch, chunk of Lc
    positions) Lc (Lc + 1) N for the causal half of C B^T, which every head
    shares, and per (batch, head, chunk) Lc (Lc + 1) P for its product with
    x and 4 Lc N P for the state's read and update; at the bf16 tensor-core
    rate for bf16 inputs, else the f32 rate."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel, ops, ref
    dt_ = getattr(torch, dtype_name)
    gen = torch.Generator(device=device).manual_seed(seed)
    args = _ssd_inputs(device, B, S, H, P, N, dt_, gen)
    tag = (f"[kernel:ssd_scan B={B} S={S} H={H} P={P} N={N} chunk={chunk} "
           f"{dtype_name}]")
    y, final = kernel.ssd_scan_kernel(*args, chunk=chunk)
    want_y, want_final = ref.ssd_chunked(*args, chunk)
    err = max(_hold(f"{tag} y", y, want_y, dtype_name,
                    tol=SSD_TOL[dtype_name]),
              _hold(f"{tag} final_state", final, want_final, "float32",
                    tol=SSD_TOL["float32"]))
    flops, n_bytes = ops.cost(B, S, H, P, N, chunk, args[0].element_size())
    t = _timed(tag, lambda: kernel.ssd_scan_kernel(*args, chunk=chunk),
               lambda: ref.ssd_chunked(*args, chunk), None,
               n_bytes=n_bytes, flops=flops,
               flops_peak=(PEAK_BF16_FLOPS if dtype_name == "bfloat16"
                           else PEAK_F32_FLOPS))
    return dict(t, max_abs_err=err)


# (B, S, H, P, N, chunk): the reference's test sweep (tests/test_kernels.py);
# mamba2-1.3b's serve prompts, its widths at S = 2,048 and a ragged S = 300;
# Jamba's head width P = 128 at its config's chunk (the kernel takes 64)
SSD_SHAPES = ((1, 24, 64, 64, 128, 128), (1, 8, 64, 64, 128, 128),
              (1, 2048, 64, 64, 128, 128), (1, 300, 64, 64, 128, 128),
              (1, 128, 2, 32, 16, 32), (2, 256, 4, 64, 32, 64),
              (1, 64, 8, 16, 8, 64), (1, 300, 8, 128, 128, 128))


def phase_ssd_kernels(device, parent=None):
    """K7 against its plain version at every shape of ``SSD_SHAPES`` in
    bfloat16 and float32, then its sweep (:func:`ssd_sweep`), beside the
    parent's kernel when ``parent`` names its checkout; the kernels-line
    entry is the serve path's 24-token prefix prefill in bfloat16."""
    main = _check_ssd(device, *SSD_SHAPES[0], "bfloat16")
    for dt in ("bfloat16", "float32"):
        for shape in SSD_SHAPES[int(dt == "bfloat16"):]:
            _check_ssd(device, *shape, dt)
    _versus_parent("ssd", {}, parent)
    if parent is not None:
        # where the parent's chunk-sequential kernel spends its time
        for key, ms in _sweep_in(Path(parent) / "src", "ssd_split",
                                 {}).items():
            log(f"[ssd_split] parent {key}: {ms:.6f} ms")
    return _kernel_entry("ssd_scan", main)


def phase_ssm_full_width(device):
    """mamba2-1.3b widths at 2 of its 48 layers in float32: a 300-token
    prompt (two full chunks of 128 and a 44-token tail: the carried state
    and the ragged chunk, which the serve path's short prompts never
    reach) and 8 teacher-forced decode steps, the card (K3, K7) against
    the CPU (the plain versions) from the same weights."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import build_model
    cfg = get_config("mamba2-1.3b").replace(num_layers=2, dtype="float32")
    t0 = time.perf_counter()
    card = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(1))
    cpu = build_model(cfg, device="cpu").load_params(
        {n: p.cpu() for n, p in card.params().items()})
    log(f"[ssm_full_width] {cfg.name} layers=2 d_model={cfg.d_model} "
        f"heads={cfg.ssm_heads}x{cfg.ssm_head_dim} state={cfg.ssm_state} "
        f"chunk={cfg.ssm_chunk} vocab={cfg.vocab_size} {cfg.dtype}: weights "
        f"{sum(p.numel() * p.element_size() for p in card.parameters())} "
        f"bytes, built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(1, cfg.vocab_size, (1, 300), generator=gen)
    forced = torch.randint(1, cfg.vocab_size, (1, 8), generator=gen)
    reset_launches()
    a = _teacher_forced(card, prompt, forced)
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    b = _teacher_forced(cpu, prompt, forced)
    log(f"[ssm_full_width] cpu run {time.perf_counter() - t0:.1f} s; card "
        f"launches {launches}")
    for name in FAMILY_KERNELS["ssm"]:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"SSM full-width check did not launch {name}")
    err = _hold("[ssm_full_width] logits (prefill + 8 decode steps)", a, b,
                "float32", tol=MODEL_F32_TOL)
    agree = (a.argmax(-1) == b.argmax(-1)).sum().item()
    log(f"[ssm_full_width] max_abs_err={err} greedy tokens agree at {agree} "
        f"of {a.shape[1]} steps; logits max |x| "
        f"{float(b[..., :cfg.vocab_size].abs().max())} (real vocab)")
    del card, cpu
    _free()


# --------------------------------------------------------------------------
# the encoder-decoder (whisper-large-v3) and VLM (internvl2-26b) families:
# K3-K5 at their shapes, the 2-layer checks card against CPU, and their main
# paths through the model API

# the decoder's learned positions: max_target_positions of the public
# openai/whisper-large-v3 config
WHISPER_MAX_SEQ = 448


def phase_encdec_vlm_kernels(device):
    """K3-K5 at the new families' shapes against their plain versions, in
    both dtypes: Whisper's cross-attention (K4 not causal, Skv = 1,500) in
    prefill and decode (K5, every row 1,500 frames long), InternVL's causal
    prefill of 1,024 patches and 24 tokens, its decode and its d_model
    6,144.  Returns the kernels-line entries: each path's bf16 shapes."""
    entries = []
    for dt in ("bfloat16", "float32"):
        bf16 = dt == "bfloat16"
        for B in (1, 4):
            for Sq in (4, 24):
                r = _check_flash(device, B, Sq, 1500, 20, 20, 64, dt, False)
                if bf16 and (B, Sq) == (4, 4):   # the Whisper path's prompt
                    entries.append(_kernel_entry("flash_attention", r,
                                                 "whisper"))
            r = _check_decode(device, B, 20, 20, 64, 1500, [1500] * B, dt)
            if bf16 and B == 4:
                entries.append(_kernel_entry("decode_attention", r,
                                             "whisper"))
        r = _check_flash(device, 1, 1048, 1048, 48, 8, 128, dt, True)
        if bf16:
            entries.append(_kernel_entry("flash_attention", r, "internvl"))
        r = _check_decode(device, 2, 48, 8, 128, 1064, [1056, 1056], dt)
        if bf16:
            entries.append(_kernel_entry("decode_attention", r, "internvl"))
        r = _check_rmsnorm(device, 2, 6144, dt)
        if bf16:
            entries.append(_kernel_entry("rmsnorm", r, "internvl"))
        _check_rmsnorm(device, 2 * 1048, 6144, dt)
    return entries


def _side_input(cfg, batch, gen):
    """The frames (encdec) or patch embeddings (vlm) of ``batch`` requests:
    normal float32 on the CPU, as keyword arguments of ``Model.prefill``."""
    import torch
    key, rows = (("frames", cfg.enc_frames) if cfg.family == "encdec"
                 else ("patch_embeds", cfg.vision_patches))
    return {key: torch.randn((batch, rows, cfg.d_model), generator=gen)}


def _expected_launches(cfg, steps):
    """The launches a prefill and ``steps`` decode steps imply: per layer
    the norms (K3, RMSNorm only), the prefill's attention products (K4) and
    a step's attention products (K5)."""
    L = cfg.num_layers
    if cfg.family == "encdec":      # encoder; decoder self and cross
        return {"rmsnorm": 0, "flash_attention": cfg.enc_layers + 2 * L,
                "decode_attention": 2 * L * steps}
    return {"rmsnorm": (2 * L + 1) * (1 + steps), "flash_attention": L,
            "decode_attention": L * steps}


def phase_side_input_full_width(device, arch, layers):
    """``arch`` (encdec or vlm) at full width cut to ``layers`` layers (and
    encoder layers), bfloat16: its frames or patches, a 24-token prompt and
    8 teacher-forced decode steps on the card and on the CPU (timed) from
    the same weights; logits within 5e-2 and the launches the code
    implies."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import build_model
    cfg = get_config(arch).replace(num_layers=layers)
    if cfg.family == "encdec":
        cfg = cfg.replace(enc_layers=layers)
    tag = f"[{cfg.family}_full_width]"
    max_seq = WHISPER_MAX_SEQ if cfg.family == "encdec" else 0
    t0 = time.perf_counter()
    card = build_model(cfg, device=device, max_seq=max_seq).init(
        torch.Generator(device=device).manual_seed(1))
    cpu = build_model(cfg, device="cpu", max_seq=max_seq).load_params(
        {n: p.cpu() for n, p in card.params().items()})
    log(f"{tag} {cfg.name} layers={cfg.num_layers} enc_layers="
        f"{cfg.enc_layers} d_model={cfg.d_model} vocab={cfg.vocab_size} "
        f"{cfg.dtype}: weights "
        f"{sum(p.numel() * p.element_size() for p in card.parameters())} "
        f"bytes, built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(2)
    side = _side_input(cfg, 1, gen)
    prompt = torch.randint(1, cfg.vocab_size, (1, 24), generator=gen)
    forced = torch.randint(1, cfg.vocab_size, (1, 8), generator=gen)
    reset_launches()
    a = _teacher_forced(card, prompt, forced, **side)
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    b = _teacher_forced(cpu, prompt, forced, **side)
    log(f"{tag} cpu run {time.perf_counter() - t0:.1f} s; card launches "
        f"{launches}")
    want = _expected_launches(cfg, forced.shape[1])
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{tag} launches {got}, the code implies {want}")
    err = _hold(f"{tag} logits (prefill + 8 decode steps)", a, b,
                "bfloat16", tol=MODEL_BF16_TOL)
    agree = (a.argmax(-1) == b.argmax(-1)).sum().item()
    log(f"{tag} max_abs_err={err} greedy tokens agree at {agree} of "
        f"{a.shape[1]} steps; logits max |x| "
        f"{float(b[..., :cfg.vocab_size].abs().max())} (real vocab)")
    del card, cpu
    _free()


def _greedy(model, prompt, steps, side):
    """Prefill ``prompt`` (B, S) with ``side``, then ``steps`` greedy decode
    steps at batch B: (prefill seconds, decode seconds, logits of every
    step (B, 1 + steps, V) on the card, tokens (B, steps))."""
    import torch
    B, S = prompt.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches, logits = model.prefill(prompt, **side)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    S0 = caches["k"].shape[3]
    big = model.new_caches(B, S0 + steps)
    for name, c in caches.items():
        if name in ("k", "v"):
            big[name][:, :, :, :S0] = c
        else:
            big[name].copy_(c)
    del caches
    out, toks = [logits], []
    for t in range(steps):
        tok = out[-1][:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
        big, logits = model.decode(big, tok, S0 + t)
        out.append(logits)
    torch.cuda.synchronize()
    return (t1 - t0, time.perf_counter() - t1, torch.cat(out, dim=1),
            torch.cat(toks, dim=1))


def phase_side_input_path(device, arch, batch, prompt_len, steps, max_seq):
    """A main path of the encoder-decoder or VLM family: the full-depth,
    full-width ``arch`` (random bfloat16 weights drawn on the card) through
    ``Model.prefill`` and ``Model.decode``, ``batch`` requests of a
    ``prompt_len``-token prompt with their frames or patches, then
    ``steps`` greedy steps; counters reset and read around it, the launch
    counts the code implies asserted.  Then a warm prefill timed, one
    batch-1 decode step timed beside its floor and profiled.  Returns the
    path's launches."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    tag = f"{cfg.family}_path"
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, max_seq=max_seq).init(
        torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator().manual_seed(3)
    side = _side_input(cfg, batch, gen)
    prompt = torch.randint(1, cfg.vocab_size, (batch, prompt_len),
                           generator=gen)
    reset_launches()
    prefill_s, decode_s, logits, toks = _greedy(model, prompt, steps, side)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = _expected_launches(cfg, steps)
    got = {k: launches.get(k, 0) for k in want}
    real = logits[..., :cfg.vocab_size]
    log(f"[{tag}] {cfg.name} layers={cfg.num_layers} enc_layers="
        f"{cfg.enc_layers} d_model={cfg.d_model} {cfg.dtype} params="
        f"{sum(p.numel() for p in model.parameters())}: batch={batch} "
        f"prompt={prompt_len} side={tuple(next(iter(side.values())).shape)} "
        f"steps={steps} init={init_s:.3f} s prefill={1e3 * prefill_s:.3f} ms "
        f"(first call) decode={1e3 * decode_s / steps:.3f} ms a step (batch "
        f"{batch}) max_memory_allocated={peak} weights={weights} bytes "
        f"launches={launches} tokens[0]={toks[0].tolist()}")
    if got != want:
        raise AssertionError(f"[{tag}] launches {got}, the code implies "
                             f"{want}")
    if (tuple(logits.shape) != (batch, 1 + steps, logits.shape[-1])
            or not bool(torch.isfinite(real).all())):
        raise AssertionError(f"[{tag}] logits of shape {tuple(logits.shape)}"
                             " or non-finite")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"[{tag}] tokens outside the vocabulary")
    del logits, real
    # a warm prefill at the path's batch, then batch-1 decode steps
    prefill_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.prefill(prompt, **side)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t1))
    one = {k: v[:1] for k, v in side.items()}
    caches, _ = model.prefill(prompt[:1], **one)
    S0 = caches["k"].shape[3]
    big = model.new_caches(1, S0 + 32)
    for name, c in caches.items():
        if name in ("k", "v"):
            big[name][:, :, :, :S0] = c
        else:
            big[name].copy_(c)
    del caches
    tok = torch.tensor([[11]], device=model.device)
    step_ms = []
    for i in range(25):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.decode(big, tok, S0 + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    w = _step_bytes(model, big)
    median = statistics.median(step_ms[5:])
    log(f"[{tag}:prefill] ms per prefill of batch {batch} (warm) "
        f"{prefill_ms[0]:.3f}, {prefill_ms[1]:.3f}")
    log(f"[{tag}:decode] ms per decode step median={median:.3f} "
        f"min={min(step_ms[5:]):.3f} (batch 1, positions {S0 + 5}.."
        f"{S0 + 24}; weights and caches moved {w} bytes, floor "
        f"{1e3 * w / PEAK_BYTES_S:.3f} ms at {PEAK_BYTES_S:.3g} B/s)")
    _profile_decode(tag, model, big, S0 + 25, median)
    del model, big
    _free()
    return launches


# --------------------------------------------------------------------------
# training: one step of each family card against CPU, the full-width bf16
# gradient check, the training path at full width, restart on the card

TRAIN_FAMILIES = ("llama3-8b", "qwen2-moe-a2.7b", "mamba2-1.3b",
                  "jamba-1.5-large-398b", "whisper-large-v3",
                  "internvl2-26b")
TRAIN_KERNELS = ("rmsnorm", "flash_attention", "moe_gmm", "ssd_scan")
# the reference's float32 model tolerance, for one training step (loss,
# each gradient of its tensor's largest magnitude, the updated weights)
TRAIN_F32_TOL = 1e-4
# the least cosine of a bfloat16 gradient tensor on the card to the CPU's
GRAD_COSINE_MIN = 0.99


def _train_launches(cfg, passes, microbatches=1):
    """The model kernels' launches of ``microbatches`` training passes of
    ``cfg``: per pass the layers' kernels ``passes`` times (2 under remat:
    the backward recomputes each period's forward) and the final norm
    once; the plain backward launches none."""
    from repro_torch.models.transformer import layer_kinds
    if cfg.family == "encdec":          # LayerNorm; the encoder not remat
        k = {"rmsnorm": 0, "moe_gmm": 0, "ssd_scan": 0,
             "flash_attention": cfg.enc_layers
             + passes * 2 * cfg.num_layers}
    else:
        k3 = k4 = k6 = k7 = 0
        for mixer, ffn in layer_kinds(cfg):
            k3 += 1 + (ffn != "none") + (mixer == "mamba") \
                + 2 * (mixer == "attn" and cfg.qk_norm)
            k4 += mixer == "attn"
            k7 += mixer == "mamba"
            k6 += 3 * (ffn == "moe")
        k = {"rmsnorm": passes * k3 + 1, "flash_attention": passes * k4,
             "moe_gmm": passes * k6, "ssd_scan": passes * k7}
    return {n: microbatches * v for n, v in k.items()}


def _train_batch(cfg, B, S, step=0):
    """``batch_at``'s tokens (the reference's synthetic stream) with the
    family's frames or patch embeddings drawn from a seed."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, batch_at
    b = batch_at(DataConfig(vocab_size=min(cfg.vocab_size, 256), seq_len=S,
                            global_batch=B), step)
    rng = np.random.default_rng(17 + step)
    side = {"encdec": ("frames", cfg.enc_frames),
            "vlm": ("patch_embeds", cfg.vision_patches)}.get(cfg.family)
    if side:
        b[side[0]] = rng.normal(size=(B, side[1], cfg.d_model)).astype(
            np.float32)
    return b


def _loss_and_grads(model, batch):
    import torch
    params = model.trainable().params()
    loss = model.train_loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(params.items(), grads)}


def phase_train_tiny(device):
    """One float32 training step of each family's tiny config with remat,
    ``cuda`` (K3, K4, K6, K7 under autograd) against the CPU from the same
    weights: loss within 1e-4 relative, each gradient within 1e-4 of its
    tensor's largest magnitude, the weights after one ``adamw_update`` of
    the card's gradients on the card and on the CPU within 1e-4 (from each
    side's own gradients the difference is reported: Adam's first step
    moves a weight by about lr * g / |g|, so a gradient near zero whose
    last bits differ moves its weight by up to lr); the MoE tokens whose
    expert sets differ counted; the launches the code implies (the layers'
    forward twice, the final norm once, none in the plain backward).
    Returns the launches by kernel."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import moe as X
    from repro_torch.models.model import build_model
    from repro_torch.testing import tiny_config
    from repro_torch.training.optimizer import adamw_update, init_opt_state
    total = dict.fromkeys(TRAIN_KERNELS, 0)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0)
    route = X.route
    for arch in TRAIN_FAMILIES:
        cfg = tiny_config(arch, dtype="float32", remat=True)
        max_seq = 32 if cfg.family == "encdec" else 0
        cpu = build_model(cfg, device="cpu", max_seq=max_seq).init(
            torch.Generator().manual_seed(0))
        card = build_model(cfg, device=device, max_seq=max_seq).load_params(
            cpu.params())
        batch = _train_batch(cfg, 2, 16)
        own = build_model(cfg, device="cpu", max_seq=max_seq).load_params(
            cpu.params())            # the CPU's weights, its own update
        out, routes = {}, {}
        for side, model in (("card", card), ("cpu", cpu)):
            seen = routes[side] = []

            def recording(p, xf, c, _seen=seen):
                w, i = route(p, xf, c)
                _seen.append(i.sort(dim=-1).values.cpu())
                return w, i

            X.route = recording
            try:
                reset_launches()
                loss, grads = _loss_and_grads(model, batch)
                launches = {n: LAUNCHES.get(n, 0) for n in TRAIN_KERNELS}
            finally:
                X.route = route
            out[side] = (float(loss), grads, launches)
        (lc, gc, launches), (lp, gp, _) = out["card"], out["cpu"]
        for model, g in ((card, gc), (cpu, {n: t.cpu() for n, t in
                                            gc.items()}), (own, gp)):
            params = model.params()
            adamw_update(g, init_opt_state(params), params, tcfg)
        want = _train_launches(cfg, 2)
        differ = sum(int((a != b).any(-1).sum())
                     for a, b in zip(routes["card"], routes["cpu"]))
        worst_g = max(float((gc[n].cpu() - g).abs().max())
                      / max(float(g.abs().max()), 1e-30)
                      for n, g in gp.items())
        worst_p, worst_own = (
            max(float((p.detach().cpu() - ref.params()[n].detach())
                      .abs().max()) for n, p in card.params().items())
            for ref in (cpu, own))
        log(f"[train_tiny:{arch}] loss card {lc:.7f} cpu {lp:.7f}; worst "
            f"gradient error {worst_g:.3g} of its tensor's max; worst weight "
            f"after adamw_update {worst_p:.3g} (from the card's gradients; "
            f"from each side's own {worst_own:.3g} at lr "
            f"{tcfg.learning_rate}); launches {launches} (the "
            f"code implies {want}); route calls {len(routes['card'])}, "
            f"tokens whose expert sets differ {differ}")
        if abs(lc - lp) > TRAIN_F32_TOL * abs(lp):
            raise AssertionError(f"[train_tiny:{arch}] loss {lc} vs {lp}")
        if worst_g > TRAIN_F32_TOL or worst_p > TRAIN_F32_TOL:
            raise AssertionError(f"[train_tiny:{arch}] gradients or updated "
                                 "weights differ from the CPU's")
        if launches != want or len(routes["card"]) != len(routes["cpu"]):
            raise AssertionError(f"[train_tiny:{arch}] launches {launches}, "
                                 f"the code implies {want}")
        for n in TRAIN_KERNELS:
            total[n] += launches[n]
        del card, cpu, own
    _free()
    return total


def phase_train_full_width_check(device):
    """Llama-3-8B widths at 2 of its 32 layers in bfloat16 (remat as
    registered), one 64-token sequence: loss and gradients on ``cuda``
    against the CPU from the same weights; the loss within the model's
    bf16 tolerance, each gradient tensor's cosine to the CPU's at least
    ``GRAD_COSINE_MIN``."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.models.model import build_model
    cfg = get_config("llama3-8b").replace(num_layers=2)
    card = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(4))
    cpu = build_model(cfg, device="cpu").load_params(
        {n: p.cpu() for n, p in card.params().items()})
    batch = _train_batch(cfg, 1, 64)
    lc, gc = _loss_and_grads(card, batch)
    t0 = time.perf_counter()
    lp, gp = _loss_and_grads(cpu, batch)
    cpu_s = time.perf_counter() - t0
    _hold("[train_full_width] loss", lc.cpu().reshape(1), lp.reshape(1),
          "bfloat16", tol=MODEL_BF16_TOL)
    cos = {}
    for n, g in gp.items():         # in float64: tens of millions of terms
        a, b = gc[n].double().cpu().flatten(), g.double().flatten()
        den = float(a.norm() * b.norm())
        cos[n] = float(a @ b) / den if den > 0 else 1.0
    worst = min(cos, key=cos.get)
    log(f"[train_full_width] {cfg.name} layers=2 {cfg.dtype} tokens=64: "
        f"loss card {float(lc):.6f} cpu {float(lp):.6f} (cpu side "
        f"{cpu_s:.1f} s); gradient cosine card vs cpu: "
        + ", ".join(f"{n} {c:.6f}" for n, c in cos.items()))
    if cos[worst] < GRAD_COSINE_MIN:
        raise AssertionError(f"[train_full_width] gradient {worst} cosine "
                             f"{cos[worst]:.6f} < {GRAD_COSINE_MIN}")
    del card, cpu, gc, gp
    _free()


def _profile_train_step(tag, step, params, state, batch, step_ms):
    """One training step under torch.profiler: device busy against the
    profiled wall, and the device time inside the plain backward
    (``plain_vjp.<kernel>`` ranges) by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILER_SESSIONS):   # a session may record no device work
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        avg = prof.key_averages()
        # device work, not the device spans of the plain_vjp annotations
        evs = [e for e in avg if str(e.device_type).endswith("CUDA")
               and not e.key.startswith("plain_vjp.")]
        if evs:
            break
    if not evs:
        log(f"[{tag}:profile] not measured: the profiler saw no device work "
            f"in {PROFILER_SESSIONS} sessions")
        return
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    # an annotation's device span: the kernels launched inside it, in
    # order on the one stream
    plain = {e.key: e.self_device_time_total / 1e3 for e in avg
             if e.key.startswith("plain_vjp.")
             and str(e.device_type).endswith("CUDA")}
    kernels = {n: sum(e.self_device_time_total for e in evs
                      if any(k in e.key for k in keys)) / 1e3
               for n, keys in (("rmsnorm", ("rmsnorm_kernel",)),
                               ("flash_attention", ("flash_attention_tc",
                                                    "flash_attention_kernel")),
                               ("moe_gmm", ("moe_gmm_tc", "moe_gmm_kernel")),
                               ("ssd_scan", ("ssd_scan_tc_kernel",
                                             "ssd_scan_f32_kernel")))}
    matmul = sum(e.self_device_time_total for e in evs
                 if any(k in e.key for k in ("gemm", "nvjet", "xmma",
                                             "cutlass", "splitK"))) / 1e3
    log(f"[{tag}:profile] wall={wall:.3f} ms (profiled; unprofiled median "
        f"{step_ms:.3f}) device_busy={busy:.3f} ms ({100 * busy / wall:.1f} "
        f"% of the profiled step) plain backward (plain_vjp ranges) "
        f"{sum(plain.values()):.3f} ms ({100 * sum(plain.values()) / busy:.1f}"
        f" % of busy): " + ", ".join(f"{k} {v:.3f} ms"
                                     for k, v in plain.items())
        + f"; forward kernels {kernels}; matrix products {matmul:.3f} ms")
    for e in sorted(evs, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        log(f"[{tag}:profile]   {e.key[:70]:70s} device="
            f"{e.self_device_time_total / 1e3:.4f} ms calls={e.count}")


def phase_train_path(device, layers=8, steps=4, seq=2048, batch=8):
    """The training path: ``run_training`` (``repro_torch.launch.train``'s
    code) on a full-width Llama-3-8B cut to ``layers`` of its 32 layers,
    bfloat16, the registry's preset (``microbatch=8``, remat), a global
    batch of ``batch`` x ``seq`` tokens of the reference's synthetic
    stream, ``steps`` steps; counters reset and read around it, K3 and
    K4's launches asserted; losses finite; step ms, tokens/s, model FLOPs
    as a share of the bf16 peak, peak memory beside the reckoning; then
    one step profiled.  Returns the launches."""
    import torch
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.configs import PERF_PRESETS
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import run_training
    cfg = get_config("llama3-8b", **PERF_PRESETS["llama3-8b"]).replace(
        num_layers=layers)
    # launch/train.py's settings
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=10)
    dcfg = DataConfig(vocab_size=min(cfg.vocab_size, 256), seq_len=seq,
                      global_batch=batch)
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rep = run_training(cfg, tcfg, dcfg, total_steps=steps, verbose=False,
                       device=device)
    launches = {n: LAUNCHES.get(n, 0) for n in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = _train_launches(cfg, 2, cfg.microbatch * steps)
    n_params = sum(p.numel() for p in build_model(cfg,
                                                  device="meta").parameters())
    tokens = batch * seq
    step_ms = [1e3 * s for s in rep.step_s[1:]]
    med = statistics.median(step_ms)
    hd = cfg.resolved_head_dim()
    # 6 N per token, plus the attention products (PaLM's 12 L H hd S per
    # token, the full S x S, remat's recompute not counted)
    flops = tokens * (6 * n_params + 12 * cfg.num_layers * cfg.num_heads
                      * hd * seq)
    reckon = n_params * (2 + 2 + 4 + 8)
    log(f"[train_path] {cfg.name} layers={layers}/32 d_model={cfg.d_model} "
        f"d_ff={cfg.d_ff} heads={cfg.num_heads}/{cfg.num_kv_heads} vocab="
        f"{cfg.vocab_size} {cfg.dtype} params={n_params} microbatch="
        f"{cfg.microbatch} remat={cfg.remat} batch={batch}x{seq} steps="
        f"{steps}: losses {rep.losses}; step ms "
        f"{[round(s, 3) for s in step_ms]} (steps 2..{steps}) min={min(step_ms):.3f} median={med:.3f}; "
        f"tokens/s={tokens / (med / 1e3):.1f}; model FLOPs a step "
        f"{flops:.4g} = {100 * flops / (med / 1e3) / PEAK_BF16_FLOPS:.2f} % "
        f"of {PEAK_BF16_FLOPS:.3g} FLOP/s; max_memory_allocated={peak} "
        f"(reckoning {reckon}: 2 + 2 + 4 + 8 bytes a parameter); launches "
        f"{launches} (the code implies {want}); first step "
        f"{1e3 * rep.step_s[0]:.1f} ms; wall {rep.wall_s:.1f} s")
    if not all(math.isfinite(x) for x in rep.losses) or \
            len(rep.losses) != steps:
        raise AssertionError(f"[train_path] losses {rep.losses}")
    if launches != want:
        raise AssertionError(f"[train_path] launches {launches}, the code "
                             f"implies {want}")
    if peak > 75e9:
        raise AssertionError(f"[train_path] peak memory {peak} over 75 GB")
    _free()
    # one more step, profiled (same settings, fresh weights)
    model = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(dcfg.seed)).trainable()
    params = model.params()
    state = init_opt_state(params, cfg.opt_state_dtype)
    step = make_train_step(model, tcfg)
    b = batch_at(dcfg, 0)
    step(params, state, b)
    _profile_train_step("train_path", step, params, state, b, med)
    del model, params, state, step
    _free()
    return launches


def phase_train_restart(device, tmp):
    """The reference's restart contract on the card: a tiny float32 Llama
    (2 layers, d_model 32, d_ff 64) for 35 steps, checkpoints every 10,
    uninterrupted and under ``run_training_with_restarts`` with a failure
    injected at step 17: the post-restart losses equal, bit for bit; the
    card's last checkpoint restored onto the CPU and onto the card, equal
    bit for bit."""
    import torch
    from repro_torch.checkpoint.checkpointing import restore_checkpoint
    from repro_torch.config import TrainConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import build_model
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.testing import tiny_config
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import (run_training,
                                                 run_training_with_restarts)
    cfg = tiny_config("llama3-8b", num_layers=2, d_model=32, d_ff=64,
                      dtype="float32")
    dcfg = DataConfig(vocab_size=256, seq_len=32, global_batch=4)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5,
                       checkpoint_every=10)
    a = run_training(cfg, tcfg, dcfg, total_steps=35, verbose=False,
                     ckpt_dir=str(tmp / "a"), device=device)
    b = run_training_with_restarts(cfg, tcfg, dcfg, total_steps=35,
                                   ckpt_dir=str(tmp / "b"),
                                   injector=FailureInjector(17),
                                   verbose=False, device=device)
    same = a.losses[-25:] == b.losses[-25:]
    restored = []
    for d in (device, torch.device("cpu")):
        p = build_model(cfg, device=d).params()
        tree, extra = restore_checkpoint(str(tmp / "b"),
                                         (p, init_opt_state(p)))
        restored.append(tree)
    (pc, sc), (pp, sp) = restored
    bitwise = all(torch.equal(pc[n].cpu(), pp[n])
                  and torch.equal(sc.m[n].cpu(), sp.m[n])
                  and torch.equal(sc.v[n].cpu(), sp.v[n]) for n in pp)
    log(f"[train_restart] restarts={b.restarts} steps run {b.steps_run}; "
        f"post-restart losses equal bit for bit: {same} (last "
        f"{b.losses[-1]!r} vs {a.losses[-1]!r}; first {a.losses[0]:.4f}); "
        f"checkpoint step {extra['step']} restored onto cpu and cuda "
        f"bitwise equal: {bitwise} (step {int(sc.step)})")
    if b.restarts != 1 or not same or not bitwise:
        raise AssertionError("[train_restart] the restart is not bit-exact "
                             "on the card")


# --------------------------------------------------------------------------
# phases 29-31: the expert-parallel MoE on one card, the selective remat
# policies, the dry run


class _PackRecorder:
    """Records each ``ep_moe._pack_by_key`` call's ``keep`` mask and real
    keys (the second pack's last bin is padding), in call order: the first
    pack of a layer, then its second."""

    def __init__(self):
        from repro_torch.distributed import ep_moe
        self.mod, self.pack, self.calls = ep_moe, ep_moe._pack_by_key, []

    def __enter__(self):
        def recording(keys, n_bins, capacity):
            res = self.pack(keys, n_bins, capacity)
            real = res[1] < (n_bins if len(self.calls) % 2 == 0
                             else n_bins - 1)
            self.calls.append((res[3].cpu(), real.cpu()))
            return res
        self.mod._pack_by_key = recording
        return self

    def __exit__(self, *exc):
        self.mod._pack_by_key = self.pack

    def dropped(self):
        """Real copies dropped at the destinations and at the experts."""
        first = sum(int((~k & r).sum()) for k, r in self.calls[0::2])
        second = sum(int((~k & r).sum()) for k, r in self.calls[1::2])
        return first, second


def _ep_ctx(shape, device):
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import make_mesh
    return ShardCtx(make_mesh(shape, ("data", "model"), device))


def _ep_capacities(cfg, tokens, shape):
    """(Tc, C, C2, E_local) of the EP dispatch (``distributed/ep_moe.py``)
    at ``tokens`` tokens over a ``(data, model)`` mesh."""
    from repro_torch.models.layers import padded_experts
    nd, n = shape
    E = padded_experts(cfg.num_experts)
    Tc, k = tokens // (nd * n), cfg.top_k
    C = max(8, int(math.ceil(Tc * k * cfg.capacity_factor / n / 8)) * 8)
    C2 = max(8, int(math.ceil(n * C * 1.3 / (E // n) / 8)) * 8)
    return Tc, C, C2, E // n


EP_MESHES = ((1, 1), (1, 4), (2, 2))


def phase_ep_check(device):
    """Phase 29 (a): Qwen1.5-MoE widths at 2 of its 24 layers, float32,
    ``moe_impl="ep"``, a 2 x 256-token prefill under logical meshes (1, 1),
    (1, 4) and (2, 2) on the card (K3-K6) and on the CPU from the same
    weights: logits within 1e-4, the same copies kept and dropped, K6
    launched three times a layer; then EP (1, 4) against the sort path on
    the card at a capacity factor where neither drops a copy, within
    1e-4."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.distributed.sharding import use_shard_ctx
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import moe as X
    from repro_torch.models.model import build_model
    cfg = get_config("qwen2-moe-a2.7b").replace(num_layers=2,
                                                 dtype="float32",
                                                 moe_impl="ep")
    card = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(1))
    cpu = build_model(cfg, device="cpu").load_params(
        {n: p.cpu() for n, p in card.params().items()})
    tokens = torch.randint(1, cfg.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(2))
    L = cfg.num_layers
    for shape in EP_MESHES:
        out, drops, keeps = {}, {}, {}
        for side, model in (("card", card), ("cpu", cpu)):
            reset_launches()
            t0 = time.perf_counter()
            with _PackRecorder() as rec, \
                    use_shard_ctx(_ep_ctx(shape, model.device)):
                _, out[side] = model.prefill(tokens)
            if side == "card":
                torch.cuda.synchronize()
                launches = LAUNCHES.get("moe_gmm", 0)
            ms = 1e3 * (time.perf_counter() - t0)
            drops[side], keeps[side] = rec.dropped(), rec.calls
            log(f"[ep_check {shape}] {side}: prefill {ms:.1f} ms (first "
                f"call), copies dropped at the destinations / experts "
                f"{drops[side]}")
        Tc, C, C2, El = _ep_capacities(cfg, tokens.numel(), shape)
        same = len(keeps["card"]) == len(keeps["cpu"]) == 2 * L and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(keeps["card"], keeps["cpu"]))
        log(f"[ep_check {shape}] Tc={Tc} C={C} C2={C2} E_local={El}; kept "
            f"and dropped copies identical card vs cpu: {same}; K6 "
            f"launches {launches} (the code implies {3 * L})")
        _hold(f"[ep_check {shape}] logits", out["card"].cpu(), out["cpu"],
              "float32", tol=MODEL_F32_TOL)
        if not same or launches != 3 * L:
            raise AssertionError(f"[ep_check {shape}] copies kept differ or "
                                 f"K6 launched {launches} times")
    # EP against the sort path where nothing is dropped
    wide = cfg.replace(capacity_factor=8.0)
    card.cfg = wide
    counts = []
    route = X.route

    def recording(p, xf, c):
        w, i = route(p, xf, c)
        counts.append(int(torch.bincount(i.flatten()).max()))
        return w, i

    X.route = recording
    try:
        with _PackRecorder() as rec, \
                use_shard_ctx(_ep_ctx((1, 4), device)):
            _, ep = card.prefill(tokens.to(device))
        counts.clear()
        _, srt = card.prefill(tokens.to(device))     # no context: sort
    finally:
        X.route = route
    sort_cap = X.capacity(wide, tokens.numel())
    log(f"[ep_check] capacity_factor=8.0: EP (1, 4) copies dropped "
        f"{rec.dropped()}; the sort path's fullest expert {max(counts)} of "
        f"its capacity {sort_cap}")
    if rec.dropped() != (0, 0) or max(counts) > sort_cap:
        raise AssertionError("[ep_check] a copy was dropped at "
                             "capacity_factor=8.0")
    _hold("[ep_check] EP (1, 4) vs the sort path, logits", ep, srt,
          "float32", tol=MODEL_F32_TOL)
    del card, cpu
    _free()


def phase_ep_path(device):
    """Phase 29 (b): the full-depth Qwen1.5-MoE-A2.7B of ``PERF_PRESETS``
    (``moe_impl="ep"``, bfloat16, random weights drawn on the card) under
    ``make_host_mesh(4)``, (1, 4) on one card: a 4 x 512-token prefill,
    finite logits, K6's launches counted around it (3 a layer); prefill
    ms beside the sort path's on the same weights (median of 3,
    alternating); peak memory; then K6 at the EP buffer shapes against its
    plain version, timed beside its bound and ``torch.bmm``.  Returns the
    kernels-line entry of K6 at the EP shape."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.configs import PERF_PRESETS
    from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    cfg = get_config("qwen2-moe-a2.7b", **PERF_PRESETS["qwen2-moe-a2.7b"])
    _free()
    model = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(5))
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    tokens = torch.randint(1, cfg.vocab_size, (4, 512),
                           generator=torch.Generator().manual_seed(6)
                           ).to(device)
    mesh = make_host_mesh(4, device=device)
    ctx = ShardCtx(mesh)

    def prefill(ep):
        t0 = time.perf_counter()
        with use_shard_ctx(ctx if ep else None):
            _, logits = model.prefill(tokens)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), logits

    prefill(True)
    prefill(False)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _PackRecorder() as rec:
        _, ep_logits = prefill(True)
    launches = LAUNCHES.get("moe_gmm", 0)
    peak = torch.cuda.max_memory_allocated()
    times = {"ep": [], "sort": []}
    for _ in range(3):
        for which in ("ep", "sort"):
            ms, logits = prefill(which == "ep")
            times[which].append(ms)
    Tc, C, C2, El = _ep_capacities(cfg, tokens.numel(), (1, 4))
    diff = float((ep_logits.float() - logits.float()).abs().max())
    # the one-process logits phase 33 holds the process meshes to: a data
    # shard's ranks compute what the one-process body computes on that
    # shard's sequences alone over (1, n), so at (2, 2) each half of the
    # batch runs over (1, 2) (the same product shapes, bit for bit); the
    # whole batch over (2, 2) gives other product shapes (M = 2,048 rows
    # in the dense products, not 1,024), so it is only compared
    SHARED["ep_logits"] = {(1, 4): ep_logits.cpu()}
    with use_shard_ctx(_ep_ctx((1, 2), device)):
        SHARED["ep_logits"][(1, 2)] = model.prefill(tokens)[1].cpu()
        SHARED["ep_logits"][(2, 2)] = torch.cat(
            [model.prefill(tokens[h:h + 2])[1].cpu() for h in (0, 2)])
    with use_shard_ctx(_ep_ctx((2, 2), device)):
        SHARED["ep_logits_batch"] = model.prefill(tokens)[1].cpu()
    log(f"[ep_path] {cfg.name} layers={cfg.num_layers} {cfg.dtype} "
        f"weights={weights} bytes; mesh {mesh}; 4 x 512 tokens: Tc={Tc} "
        f"C={C} n*C={4 * C} E_local={El} C2={C2}; EP prefill ms "
        f"{[round(t, 3) for t in times['ep']]} median "
        f"{statistics.median(times['ep']):.3f}; sort prefill ms "
        f"{[round(t, 3) for t in times['sort']]} median "
        f"{statistics.median(times['sort']):.3f}; max_memory_allocated "
        f"(EP prefill) {peak}; K6 launches {launches} (the code implies "
        f"{3 * cfg.num_layers}); copies dropped at the destinations / "
        f"experts {rec.dropped()}; last-position logits EP vs sort max "
        f"|diff| {diff} (their dropped copies differ)")
    if not torch.isfinite(ep_logits).all() or \
            launches != 3 * cfg.num_layers:
        raise AssertionError(f"[ep_path] non-finite logits or K6 launched "
                             f"{launches} times")
    del model, ep_logits, logits
    _free()
    E = 4 * El
    main = _check_moe_gmm(device, E, C2, cfg.d_model, cfg.d_ff_expert,
                          "bfloat16")
    _check_moe_gmm(device, E, C2, cfg.d_ff_expert, cfg.d_model, "bfloat16")
    entry = _kernel_entry("moe_gmm", main, "ep")
    entry["launches"] = launches
    entry["shape"] = [E, C2, cfg.d_model, cfg.d_ff_expert]
    return entry


def phase_ep_train(device):
    """Phase 29 (c): one float32 training step of the tiny MoE (12 experts
    padded to 16) under EP (1, 4) with remat, ``cuda`` (K6 under autograd)
    against the CPU from the same weights: loss within 1e-4 relative, each
    gradient within 1e-4 of its tensor's largest magnitude, K6's launches
    as the code implies."""
    import torch
    from repro_torch.distributed.sharding import use_shard_ctx
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import build_model
    from repro_torch.testing import tiny_config
    cfg = tiny_config("qwen2-moe-a2.7b", dtype="float32", remat=True,
                      moe_impl="ep", num_experts=12)
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = build_model(cfg, device=device).load_params(cpu.params())
    batch = _train_batch(cfg, 2, 16)
    out = {}
    for side, model in (("card", card), ("cpu", cpu)):
        reset_launches()
        with use_shard_ctx(_ep_ctx((1, 4), model.device)):
            out[side] = _loss_and_grads(model, batch)
        if side == "card":
            launches = LAUNCHES.get("moe_gmm", 0)
    (lc, gc), (lp, gp) = out["card"], out["cpu"]
    worst = max(float((gc[n].cpu() - g).abs().max())
                / max(float(g.abs().max()), 1e-30) for n, g in gp.items())
    want = _train_launches(cfg, 2)["moe_gmm"]
    log(f"[ep_train] loss card {float(lc):.7f} cpu {float(lp):.7f}; worst "
        f"gradient error {worst:.3g} of its tensor's max; K6 launches "
        f"{launches} (the code implies {want})")
    if abs(float(lc) - float(lp)) > TRAIN_F32_TOL * abs(float(lp)) or \
            worst > TRAIN_F32_TOL or launches != want:
        raise AssertionError("[ep_train] the EP training step differs from "
                             "the CPU's")
    del card, cpu
    _free()


def _accumulated_grads(model, batch, n_mb):
    """``make_train_step``'s loss and gradients without its update: the
    mean over ``n_mb`` microbatches, accumulated in float32.  Also returns
    the bytes the first microbatch's forward left allocated for its
    backward (what a remat policy saves)."""
    import torch
    params = model.params()
    names = list(params)
    rows = next(iter(batch.values())).shape[0]
    per = rows // n_mb
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()}
    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    saved = None
    for i in range(n_mb):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        before = torch.cuda.memory_allocated()
        mb_loss = model.train_loss(mb)
        if saved is None:
            saved = torch.cuda.memory_allocated() - before
        grads = torch.autograd.grad(mb_loss, [params[n] for n in names])
        for n, g in zip(names, grads):
            acc[n] += g.float()
        loss = loss + mb_loss.detach()
        del grads
    for a in acc.values():
        a.div_(n_mb)
    return loss / n_mb, acc, saved


REMAT_POLICIES = ("full", "dots", "offloadable")


def phase_remat(device, layers=8, seq=2048, batch=8, reps=2):
    """Phase 30: phase 26's configuration (Llama-3-8B widths cut to
    ``layers`` layers, bfloat16, ``microbatch=8``, remat, ``batch`` x
    ``seq`` tokens) from one set of weights and one batch: a ``"full"``
    step, then ``reps`` rounds of one step under each of ``"full"``,
    ``"dots"`` and ``"offloadable"``.  Every step's loss and gradients must
    equal the first's bit for bit (within the run-to-run gap of the
    ``"full"`` steps if those differ).  Per policy: the median step ms
    (the forward and backward of the microbatches; the optimizer, which
    no policy changes, left out), the bytes one microbatch's forward
    leaves for its backward, and the peak memory above the step's
    start."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.configs import PERF_PRESETS
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models.model import build_model
    cfg = get_config("llama3-8b", **PERF_PRESETS["llama3-8b"]).replace(
        num_layers=layers)
    _free()
    model = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0)).trainable()
    b = {k: torch.as_tensor(v, device=device) for k, v in batch_at(
        DataConfig(vocab_size=min(cfg.vocab_size, 256), seq_len=seq,
                   global_batch=batch), 0).items()}
    ref = _accumulated_grads(model, b, cfg.microbatch)[:2]
    runs = {p: [] for p in REMAT_POLICIES}
    for _ in range(reps):
        for policy in REMAT_POLICIES:
            model.cfg = cfg.replace(remat_policy=policy)
            _free()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            loss, grads, saved = _accumulated_grads(model, b, cfg.microbatch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() - base
            same = bool(torch.equal(loss, ref[0])) and all(
                torch.equal(g, ref[1][n]) for n, g in grads.items())
            err = 0.0 if same else max(
                float((g - ref[1][n]).abs().max()) for n, g in grads.items())
            runs[policy].append((ms, saved, peak, same, err))
            del grads
    model.cfg = cfg
    del model, ref, b
    _free()
    gap = max(r[4] for r in runs["full"])
    for policy, rs in runs.items():
        log(f"[remat:{policy}] {cfg.name} layers={layers} {cfg.dtype} "
            f"microbatch={cfg.microbatch} batch={batch}x{seq}: step ms "
            f"{[round(r[0], 3) for r in rs]} median "
            f"{statistics.median(r[0] for r in rs):.3f}; bytes one "
            f"microbatch's forward keeps for its backward {rs[0][1]}; peak "
            f"above the step's start {max(r[2] for r in rs)}; loss and "
            f"gradients equal the first 'full' step's bit for bit: "
            f"{all(r[3] for r in rs)} (max |diff| {max(r[4] for r in rs)})")
        if max(r[4] for r in rs) > gap:
            raise AssertionError(f"[remat:{policy}] gradients differ from "
                                 f"'full' beyond its run-to-run gap {gap}")
    log(f"[remat] run-to-run gap of 'full': {gap}")


# the keys of a traced dry-run record (the reference's, but compile_s)
DRYRUN_KEYS = ("n_devices", "lower_s", "hlo_flops_per_dev",
               "hlo_bytes_per_dev", "collectives", "scanned_program",
               "memory_analysis", "params_bytes_per_dev",
               "model_flops_per_dev", "useful_flops_ratio", "extrapolated",
               "roofline")


def phase_dryrun(tmp):
    """Phase 31: ``python -m repro_torch.launch.dryrun --arch
    qwen2-moe-a2.7b --shape train_4k --mesh single --set moe_impl=ep``
    (the step traced as rank 0 of the 256-rank production mesh on
    ``meta``: host work, no device) exits 0 and writes its record, with
    every key of the reference's but ``compile_s`` and all-to-all bytes
    above 0; the record is printed and returned."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-moe-a2.7b", "--shape", "train_4k", "--mesh", "single",
         "--set", "moe_impl=ep", "--out", str(tmp)], capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(SRC)))
    log(f"[dryrun] exit {out.returncode}: {out.stdout.strip()}")
    if out.returncode != 0:
        raise AssertionError(f"[dryrun] exit {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    rec = json.loads((tmp / "single" /
                      "qwen2-moe-a2.7b__train_4k__moe_impl-ep.json")
                     .read_text())
    log(f"[dryrun] record {json.dumps(rec)}")
    missing = [k for k in DRYRUN_KEYS if k not in rec]
    if not rec.get("ok") or missing or "compile_s" in rec \
            or rec["collectives"]["all-to-all"] <= 0:
        raise AssertionError(f"[dryrun] record not ok, keys missing "
                             f"{missing} or no all-to-all bytes: {rec}")
    log(f"[dryrun] keys {sorted(rec)}; roofline {rec['roofline']}; memory "
        f"{rec['memory_analysis']}; collectives {rec['collectives']}")
    return rec


# ------------------------------------------- phases 32-35: across processes

# the process meshes of the spawned worlds (gloo, every rank on cuda:0)
PROC_MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
PROC_TICK_REPS = 4           # mesh ticks a (K1 / K2) arm: uniform, skewed


def _moe_layer(cfg, device, seed):
    """One full-width MoE layer of ``cfg`` with weights drawn on the card
    at the model's scales."""
    import torch
    from repro_torch.models import moe as X
    from repro_torch.models.layers import torch_dtype
    p = X.MoE(cfg, torch_dtype(cfg.dtype), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, t in p.named_parameters():
        std = p.init_std.get(name, 1.0)
        t.data.copy_(torch.randn(t.shape, generator=gen, device=device)
                     .mul_(std))
    return p


def _proc_ticks(device, W, n, reps=PROC_TICK_REPS, CAP=16384):
    """This rank's mesh ticks: phase 28's 16,384-slot arena held by the
    ``n`` ranks of the default group (this rank's block on its card),
    ticked from the
    same state as the single-arena delta tick on this rank (the whole
    arena), 8 % of the slots dirty, uniform then skewed (every dirty slot
    on shard 0, lane-balanced past 0.25), with K1 and with K2.  Every rank
    draws the same dirty sets.  Compares ranks, triage scalars, trigger and
    reach rows and this rank's block of the arena rows bit for bit, and
    returns the mismatches (never raising: the other ranks wait in the
    collectives), ms per tick and this rank's K1 / K2 launches per tick
    beside the launches its walk rows imply."""
    import numpy as np
    import torch
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.core.arena import QueueState
    from repro_torch.core.hermeslet import warmup_time_for
    from repro_torch.core.pdgraph import pack_graphs
    from repro_torch.core.prewarm import build_prewarm_table
    import torch.distributed as dist
    from repro_torch.core.refresh_mesh import RefreshMesh, refresh_ranks_mesh
    from repro_torch.core.refresh_pipeline import refresh_ranks_delta
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.pdgraph_walk import kernel
    kb = build_knowledge_base(n_trials=100, seed=3)
    packed = pack_graphs(kb, T_IN, T_OUT, device=device)
    tab = build_prewarm_table(kb, packed, warmup_time_for)
    rng = np.random.default_rng(4)
    gi = rng.integers(0, len(packed.names), CAP)
    rows = [(f"a{i}", int(g), int(packed.entry[g]), i, None)
            for i, g in enumerate(gi)]
    n_dirty = int(0.08 * CAP)
    out = {"fails": [], "ticks": []}
    for rik in (True, False):
        mesh = RefreshMesh(n, device=device, group=dist.group.WORLD)
        me = mesh.rank
        ref = QueueState(packed, capacity=CAP)
        mine = QueueState(packed, capacity=CAP, n_shards=n, group=mesh.group)
        for qs in (ref, mine):
            qs.admit_many(rows)
        kw = dict(n_walkers=W, prewarm_table=tab, prewarm_k=0.5,
                  with_triage=True, rank_in_kernel=rik)
        for rep in range(reps + 1):
            kind = "uniform" if rep % 2 else "skewed"
            if rep:
                pool = (np.arange(0, CAP, n) if kind == "skewed"
                        else np.arange(CAP))
                dirty = rng.choice(pool, n_dirty, replace=False)
                prog = rng.choice(CAP, n_dirty, replace=False)
                units = rng.integers(0, packed.n_units, n_dirty)
                for qs in (ref, mine):
                    for sl, u in zip(dirty, units):
                        qs.set_unit(qs.ids[sl], int(u))
                    for sl in prog:
                        qs.add_progress(qs.ids[sl], 0.25)
            walked = ref.take_dirty()
            if not np.array_equal(mine.take_dirty(), walked):
                out["fails"].append(f"rik={rik} rep {rep}: dirty sets")
            ranked = np.asarray(sorted(mine.take_rank_dirty()
                                       | set(walked.tolist())), np.int64)
            ref.take_rank_dirty()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = refresh_ranks_delta(packed, ref, 0, walked=walked, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            reset_launches()
            tick = refresh_ranks_mesh(packed, mine, 0, mesh=mesh,
                                      walked=walked, ranked=ranked,
                                      lane_balance=0.25, **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            got = LAUNCHES.get(kernel.NAME if rik else kernel.PHASE_NAME, 0)
            walks = (me < len(walked) if tick.balanced
                     else bool((walked % n == me).any()))
            occ = ref.occupied()
            bad = [nm for nm, a, b in (
                ("ranks", mine.rank[occ], want.ranks[occ]),
                ("sup", mine.sup[occ], ref.sup[occ]),
                ("opt", mine.opt[occ], ref.opt[occ]),
                ("mean", mine.mean[occ], ref.mean[occ]),
                ("trig", mine.trig[occ], ref.trig[occ]),
                ("reach", mine.reach[occ], ref.reach[occ]))
                if not np.array_equal(a, b)]
            own = occ[occ % n == me]
            loc = torch.as_tensor(own // n, device=device)
            glob = torch.as_tensor(own, device=device)
            bad += [nm for nm in ("d_probs", "d_edges", "a_hist", "a_lo",
                                  "a_span", "a_reach")
                    if not torch.equal(getattr(mine, nm)[loc],
                                       getattr(ref, nm)[glob])]
            if bad:
                out["fails"].append(f"rik={rik} rep {rep} ({kind}): {bad}")
            if rep:
                out["ticks"].append(dict(
                    kernel="K1" if rik else "K2", kind=kind,
                    balanced=bool(tick.balanced), walked=len(walked),
                    delta_ms=(t1 - t0) * 1e3, mesh_ms=(t2 - t1) * 1e3,
                    launches=got, walks=walks))
            for qs in (ref, mine):
                qs.bump_refresh(walked)
    return out


def _rank_ep(shape, ref, device=None, times=1, batch=None):
    """Phase 33 in one rank: the full-depth bfloat16 Qwen1.5-MoE-A2.7B of
    ``PERF_PRESETS`` over the process ``shape`` mesh (gloo; every rank on
    cuda:0), this rank's share drawn layer by layer; its data shard of a
    4 x 512-token prefill against the one-process logits ``ref`` (and,
    compared only, ``batch``: the whole batch's over a logical mesh of
    ``shape``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.config import get_config
    from repro_torch.configs import PERF_PRESETS
    from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models.model import build_model
    pm = init_process_mesh(shape, ("data", "model"), backend="gloo",
                           device=device)
    cfg = get_config("qwen2-moe-a2.7b", **PERF_PRESETS["qwen2-moe-a2.7b"])
    torch.cuda.reset_peak_memory_stats()
    # one rank draws at a time: the card holds every rank's share, and a
    # draw's float32 temporary (the embedding's, 1.2 GB) only once
    for r in range(dist.get_world_size()):
        if r == pm.rank:
            t0 = time.perf_counter()
            model = build_model(cfg, device=pm.device, mesh=pm).init(
                torch.Generator(device=pm.device).manual_seed(5))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
        dist.barrier()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    ctx = ShardCtx(pm)
    tokens = torch.randint(1, cfg.vocab_size, (4, 512),
                           generator=torch.Generator().manual_seed(6))
    bl = 4 // shape[0]
    d = ctx.data_shard
    mine = tokens[d * bl:(d + 1) * bl].to(pm.device)
    ms, launches, logits = [], None, None
    for i in range(times + 1):
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with use_shard_ctx(ctx):
            _, out = model.prefill(mine)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = LAUNCHES.get("moe_gmm", 0)
        logits = out.float().cpu()
    want = ref[d * bl:(d + 1) * bl].float()
    res = dict(shape=list(shape), rank=pm.rank, coords=list(pm.coords),
               layers=cfg.num_layers,
               init_s=init_s, weights=weights, prefill_ms=ms,
               k6_launches=launches,
               finite=bool(torch.isfinite(logits).all()),
               bitwise=bool(torch.equal(logits, want)),
               max_abs_err=float((logits - want).abs().max()),
               ref_max=float(want.abs().max()),
               batch_err=None if batch is None else float(
                   (logits - batch[d * bl:(d + 1) * bl].float()).abs()
                   .max()),
               peak=torch.cuda.max_memory_allocated())
    del model, out
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def _rank_sim(n, n_apps, engine, device):
    """Phase 35 in one rank: ``run_sim`` at ``mesh_shards=n`` on the first
    ``n_apps`` applications of phase 2's trace, on this rank's card."""
    import warnings

    import torch.distributed as dist
    from repro_torch.apps.suite import build_knowledge_base
    from repro_torch.core.refresh_config import RefreshConfig
    from repro_torch.kernels.pdgraph_walk import kernel
    insts = _trace(n_apps)
    kb = build_knowledge_base(n_trials=100, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cfg = _main_config(device=device, engine=engine,
                           refresh=RefreshConfig(mesh_shards=n),
                           process_group=dist.group.WORLD)
    t0 = time.perf_counter()
    res, launches, _ = _run_path(f"proc_sim:{engine}", kb, insts, cfg)
    return dict(order=list(res.completion_order),
                acts=[float(res.acts[i]) for i in res.completion_order],
                calls=res.policy_calls, wall_s=time.perf_counter() - t0,
                ms_per_call=1e3 * res.policy_time_s
                / max(res.policy_calls, 1),
                k1=launches.get(kernel.NAME, 0), completed=len(res.acts))


def _rank_world(n, refs, W, n_apps, device="cuda", batch=None):
    """Everything a rank of phase 33-35's ``n``-rank world runs (on
    ``device``: ``cuda`` is this rank's card)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"ep": [_rank_ep(shape, refs[shape], device=device,
                           batch=batch if shape[0] > 1 else None)
                  for shape in PROC_MESHES[n]]}
    if n == 4:
        dev = torch.device("cuda", 0) if device == "cuda" else \
            torch.device(device)
        out["ticks"] = _proc_ticks(dev, W, n)
        out["sim"] = {e: _rank_sim(n, n_apps, e, device)
                      for e in ("calendar", "heap")}
    return out


def phase_process_nccl(device, W):
    """Phase 32: a process group of one rank over NCCL in this process
    (``init_process_mesh`` on a file store): the EP layer at Qwen1.5-MoE's
    full width (bfloat16, 4 x 512 tokens) over the (1, 1) process mesh,
    its collectives through NCCL, bitwise to the one-process body, K6
    three times; the mesh tick over the one-rank group on phase 28's
    arena bitwise to the delta tick, with K1 and with K2, one launch a
    tick.  Returns (K6, K1, K2) launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.config import get_config
    from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import init_process_mesh, make_mesh
    from repro_torch.models import moe as X
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        pm = init_process_mesh((1, 1), ("data", "model"), device=device,
                               rank=0, world_size=1, store=dist.FileStore(
                                   str(Path(tmp) / "store"), 1))
        try:
            log(f"[proc_nccl] backend {pm.backend} device {pm.device} "
                f"mesh {pm}")
            cfg = get_config("qwen2-moe-a2.7b", dtype="bfloat16",
                             moe_impl="ep")
            p = _moe_layer(cfg, device, 7)
            x = torch.randn((4, 512, cfg.d_model), device=device,
                            generator=torch.Generator(device=device)
                            .manual_seed(8)).to(p.wi.dtype)
            with use_shard_ctx(ShardCtx(make_mesh((1, 1), ("data", "model"),
                                                  device))):
                want = X.moe_apply(p, x, cfg)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with use_shard_ctx(ShardCtx(pm)):
                got = X.moe_apply(p, x, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            k6 = LAUNCHES.get("moe_gmm", 0)
            same = bool(torch.equal(got, want))
            log(f"[proc_nccl] EP layer (1, 1) over NCCL: bitwise to the "
                f"one-process body {same}; K6 launches {k6}; {ms:.3f} ms "
                f"(first call)")
            if not same or k6 != 3:
                raise AssertionError("[proc_nccl] the EP layer over NCCL "
                                     "differs or K6 did not launch 3 times")
            del p, x, want, got
            _free()
            ticks = _proc_ticks(device, W, 1, reps=2)
        finally:
            dist.destroy_process_group()
    k1 = _check_proc_ticks("proc_nccl", [ticks])
    return k6, k1["K1"], k1["K2"]


def _check_proc_ticks(tag, per_rank):
    """Log and hold every rank's mesh ticks; returns each kernel's launches
    per rank (a list; one number for one rank)."""
    for r, t in enumerate(per_rank):
        if t["fails"]:
            raise AssertionError(f"[{tag}] rank {r}: mesh tick differs from "
                                 f"the delta tick: {t['fails'][:4]}")
    launches = {"K1": [], "K2": []}
    for r, t in enumerate(per_rank):
        for k in ("K1", "K2"):
            mine = [x for x in t["ticks"] if x["kernel"] == k]
            launches[k].append(sum(x["launches"] for x in mine))
            short = [x for x in mine if x["walks"] and x["launches"] < 1
                     or not x["walks"] and x["launches"]]
            if short:
                raise AssertionError(f"[{tag}] rank {r} {k}: launches do "
                                     f"not match its walk rows: {short}")
            if k == "K1" and any(x["launches"] > 1 for x in mine):
                raise AssertionError(f"[{tag}] rank {r}: more than one K1 "
                                     f"launch a tick")
            for kind in ("uniform", "skewed"):
                v = [x for x in mine if x["kind"] == kind]
                log(f"[{tag}] rank {r} {k} {kind}: mesh ms/tick "
                    f"{['%.3f' % x['mesh_ms'] for x in v]} delta ms/tick "
                    f"{['%.3f' % x['delta_ms'] for x in v]} launches "
                    f"{[x['launches'] for x in v]} balanced "
                    f"{[x['balanced'] for x in v]} walked "
                    f"{[x['walked'] for x in v]}")
    log(f"[{tag}] every rank's mesh ticks == the delta tick bitwise (ranks, "
        f"sup, opt, mean, trig, reach, its block's arena rows)")
    if len(per_rank) == 1:
        return {k: v[0] for k, v in launches.items()}
    return launches


def phase_processes(W, n_apps):
    """Phases 33-35: worlds of 2 and 4 processes over gloo, every rank on
    cuda:0 (NCCL refuses two ranks on one card), started as torchrun
    would start them (``launch.procs.spawn``).  33: the full-depth EP
    prefill over meshes (1, 2), (2, 2) and (1, 4) bitwise to phase 29's
    one-process logits with the same product shapes, K6 3 times a layer
    in every rank, prefill ms, peak memory a rank; 34: the 4-rank mesh
    tick on the 16,384-slot arena against the delta tick
    (``_proc_ticks``); 35:
    ``run_sim`` at ``mesh_shards=4`` on 150 applications in every rank,
    with the calendar engine and the deprecated heap engine: the same
    result on every rank, equal to phase 28's ``SimConfig()`` run.
    Returns each kernel's launches per rank."""
    from repro_torch.launch.procs import spawn
    refs = SHARED["ep_logits"]
    launches = {"moe_gmm": {}, "K1": {}, "K2": {}}
    for n in (2, 4):
        _free()
        t0 = time.perf_counter()
        world = spawn(_rank_world, n, n, refs, W, n_apps, "cuda",
                      SHARED["ep_logits_batch"], timeout_s=900.0)
        log(f"[proc] world of {n} ranks (gloo, cuda:0): "
            f"{time.perf_counter() - t0:.1f} s")
        for i, shape in enumerate(PROC_MESHES[n]):
            rs = [w["ep"][i] for w in world]
            for r in rs:
                med = statistics.median(r["prefill_ms"])
                log(f"[proc_ep {tuple(shape)}] rank {r['rank']} "
                    f"{tuple(r['coords'])}: share {r['weights']} bytes drawn "
                    f"in {r['init_s']:.2f} s; prefill ms "
                    f"{[round(t, 3) for t in r['prefill_ms']]} median "
                    f"{med:.3f}; K6 launches {r['k6_launches']}; logits "
                    f"bitwise {r['bitwise']} max_abs_err "
                    f"{r['max_abs_err']} (of |logit| up to "
                    f"{r['ref_max']:.3f}); "
                    + ("" if r["batch_err"] is None else
                       f"against the whole batch over a logical "
                       f"{tuple(shape)} mesh (other product shapes) "
                       f"max_abs_err {r['batch_err']}; ")
                    + f"peak {r['peak']}")
                if not r["finite"] or not r["bitwise"] or \
                        r["k6_launches"] != 3 * r["layers"]:
                    raise AssertionError(f"[proc_ep {shape}] rank "
                                         f"{r['rank']}: logits differ from "
                                         f"the one-process EP's or K6 "
                                         f"launched {r['k6_launches']} "
                                         f"times")
            launches["moe_gmm"][str(tuple(shape))] = \
                [r["k6_launches"] for r in rs]
        if n != 4:
            continue
        k = _check_proc_ticks("proc_tick", [w["ticks"] for w in world])
        launches["K1"]["mesh ticks, 4 ranks"] = k["K1"]
        launches["K2"]["mesh ticks, 4 ranks"] = k["K2"]
        want = SHARED["sim_default"]
        for engine in ("calendar", "heap"):
            sims = [w["sim"][engine] for w in world]
            for r, sm in enumerate(sims):
                log(f"[proc_sim {engine}] rank {r}: completed "
                    f"{sm['completed']} calls {sm['calls']} ms/call "
                    f"{sm['ms_per_call']:.3f} wall {sm['wall_s']:.1f} s "
                    f"K1 {sm['k1']}")
            same = all(sm["order"] == sims[0]["order"]
                       and sm["acts"] == sims[0]["acts"] for sm in sims)
            ref = [float(want.acts[i]) for i in want.completion_order]
            equal = sims[0]["order"] == list(want.completion_order) and \
                sims[0]["acts"] == ref
            log(f"[proc_sim {engine}] every rank the same result {same}; "
                f"equal to phase 28's SimConfig() run {equal}")
            if not same or not equal or min(sm["k1"] for sm in sims) < 1:
                raise AssertionError(f"[proc_sim {engine}] the runs differ "
                                     "or a rank launched no K1")
            launches["K1"][f"run_sim mesh_shards=4 {engine}, 4 ranks"] = \
                [sm["k1"] for sm in sims]
    return launches


# ---------------------------------------------------------------------------
# Phases 36-38: the GSPMD paths across processes (Llama-3-8B widths)

GSPMD_AXES = ("data", "model")
# 2 of 32 layers, bf16, a global batch of 4 x 2,048 tokens, 1 step (the
# (2, 2) run's, saved for phase 38; its next step's loss, from the updated
# weights, is held to one process's)
GSPMD_TRAIN = dict(layers=2, batch=4, seq=2048, steps=1, seed=31)
# phase 36's meshes and the steps timed on each: one (a second step at
# (2, 2) repeated the first's path and time)
GSPMD_TRAIN_MESHES = {(2, 2): GSPMD_TRAIN["steps"], (4, 1): 1}
GSPMD_RESTORE_MESHES = ((1, 4), (4, 1))
# 4 of 32 layers, bf16, a 2 x 512-token prompt, 8 greedy steps over (1, 4)
GSPMD_DECODE = dict(layers=4, batch=2, prompt=512, steps=8, seed=37,
                    mesh=(1, 4))
# decode tokens are compared where the one-process top-2 margin exceeds it
GSPMD_MARGIN = 5e-2
# the sharded decode's largest |logit - float32 logit| over the one-process
# bfloat16 port's (1.029 in the first card runs: 0.06398 against 0.06220)
GSPMD_F32_GAP = 1.25


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _peak(dev, reset=False):
    """Peak device memory (0 off the card); ``reset`` restarts it."""
    import torch
    if torch.device(dev).type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated()


def _gspmd_cfg(layers):
    from repro_torch.config import get_config
    return get_config("llama3-8b").replace(num_layers=layers)


def _gspmd_tcfg():
    from repro_torch.config import TrainConfig
    return TrainConfig(warmup_steps=1)


def _gspmd_batch(cfg, step):
    """``batch_at``'s synthetic stream over the whole vocabulary."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    return batch_at(DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=GSPMD_TRAIN["seq"],
                               global_batch=GSPMD_TRAIN["batch"]), step)


def _mesh_sum(t, pm):
    """``t`` summed over every axis of the process mesh ``pm``, in its own
    dtype (float64 and int64 sums; on the CPU over gloo, on the card over
    NCCL)."""
    import torch.distributed as dist
    t = t.to(pm.device if pm.backend == "nccl" else "cpu").contiguous()
    for a in pm.axis_names:
        dist.all_reduce(t, group=pm.group(a))
    return t.cpu()


def _chunks(t, n=1 << 24):
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), n):
        yield flat[i:i + n]


def _grad_cosines(grads, place, path):
    """Each gradient tensor's cosine to the one-process gradient saved at
    ``path`` (``torch.save`` of full tensors, read through a memory map):
    this rank's blocks' dot products in float64, each block counted once
    over the mesh."""
    import torch
    from repro_torch.distributed.sharding import local_block
    ref = torch.load(path, mmap=True, map_location="cpu")
    names = sorted(grads)
    stats = torch.zeros((len(names), 3), dtype=torch.float64)
    for i, n in enumerate(names):
        if not place.counted_here(n):
            continue
        want = local_block(ref[n], place.specs[n], place.mesh).to(
            grads[n].device)
        for a, b in zip(_chunks(grads[n]), _chunks(want)):
            a, b = a.double(), b.double()
            stats[i] += torch.stack([a @ b, a @ a, b @ b]).cpu()
    stats = _mesh_sum(stats, place.mesh)
    return {n: float(d / max(math.sqrt(float(x * y)), 1e-300))
            for n, (d, x, y) in zip(names, stats.tolist())}


def _fingerprints(tree, place):
    """A 64-bit fingerprint of each whole tensor of ``tree`` (parameter
    names -> this rank's blocks): the sum over its elements of their bits
    times a weight of their index in the whole tensor (int64, wrapping),
    summed over the mesh with each block counted once; equal fingerprints
    mean equal bits but for a 2^-64 chance."""
    import torch
    from repro_torch.distributed.sharding import block_slices
    names = sorted(tree)
    fp = torch.zeros(len(names), dtype=torch.int64)
    for i, n in enumerate(names):
        if not place.counted_here(n):
            continue
        t = tree[n]
        full = place.full[n]
        sl = block_slices(full, place.specs[n], place.mesh)
        bits = t.contiguous().view(torch.int16 if t.element_size() == 2
                                   else torch.int32)
        acc = torch.zeros((), dtype=torch.int64, device=t.device)
        rows = max(1, (1 << 22) // max(1, bits[0].numel()))
        for r0 in range(0, bits.shape[0], rows):
            blk = bits[r0:r0 + rows].to(torch.int64)
            idx = torch.zeros((), dtype=torch.int64, device=t.device)
            for dim, s in enumerate(sl):
                lo = s.start + (r0 if dim == 0 else 0)
                n_d = blk.shape[dim]
                ar = torch.arange(lo, lo + n_d, dtype=torch.int64,
                                  device=t.device)
                shape = [1] * blk.dim()
                shape[dim] = n_d
                idx = idx * full[dim] + ar.view(shape)
            acc += (blk * (idx % 65521 + 1)).sum()
        fp[i] = acc.cpu()
    return dict(zip(names, _mesh_sum(fp, place.mesh).tolist()))


def _draw_placed(cfg, pm, seed):
    """The dense model placed over the process mesh ``pm``, each weight
    drawn whole (the one-process model's draw) and cut to this rank's
    block; one rank draws at a time (the float32 temporaries of the
    embedding are 2.1 GB)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.model import build_model
    model = None
    for r in range(pm.size):
        if r == pm.rank:
            model = build_model(cfg, device=pm.device, mesh=pm).init(
                torch.Generator(device=pm.device).manual_seed(seed))
            _sync(pm.device)
        dist.barrier()
    return model


def _placed_train(pm, ref, batches, steps, ckpt=None):
    """Phase 36 over one process mesh: the gradients of the first batch
    (K3/K4 launches counted), their cosines to the one-process port's,
    then ``steps`` timed steps; with ``ckpt``, the state is
    fingerprinted, saved there (phase 38) and one more step taken."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import P, spec_axes
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.training.optimizer import AdamState, init_opt_state
    cfg = _gspmd_cfg(GSPMD_TRAIN["layers"])
    model = _draw_placed(cfg, pm, GSPMD_TRAIN["seed"]).trainable()
    place = model.placement
    params = model.params()
    weights = sum(p.numel() * p.element_size() for p in params.values())
    replicated = sum(p.numel() * p.element_size() for n, p in params.items()
                     if not spec_axes(place.specs[n]))
    state = init_opt_state(params, cfg.opt_state_dtype)
    step = make_train_step(model, _gspmd_tcfg())
    _peak(pm.device, reset=True)
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    g_loss, grads = step.gradients(params, batches[0])
    _sync(pm.device)
    grad_s = time.perf_counter() - t0
    launches = {n: LAUNCHES.get(n, 0) for n in ("rmsnorm",
                                                 "flash_attention")}
    cos = _grad_cosines(grads, place, ref["grads_path"])
    # step 1 is these gradients' update (its time: theirs and the
    # update's, not the cosines'), step 2 a whole step
    t0 = time.perf_counter()
    params, state, m = step.apply(params, state, g_loss, grads)
    _sync(pm.device)
    ms = [(grad_s + time.perf_counter() - t0) * 1e3]
    losses = [float(m["loss"])]
    del grads
    for k in range(1, steps):
        dist.barrier()
        _sync(pm.device)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[k])
        _sync(pm.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    out = dict(shape=list(pm.shape.values()), rank=pm.rank,
               coords=list(pm.coords), grad_loss=float(g_loss),
               launches=launches, cosines=cos, losses=losses, step_ms=ms,
               weights=weights, replicated=replicated,
               peak=_peak(pm.device))
    if ckpt is not None:
        from repro_torch.checkpoint.checkpointing import save_checkpoint
        out["fingerprints"] = {
            "params": _fingerprints(params, place),
            "m": _fingerprints(state.m, place),
            "v": _fingerprints(state.v, place)}
        t0 = time.perf_counter()
        save_checkpoint(ckpt, steps, (params, state), {"step": steps - 1},
                        mesh=pm, shardings=(place.specs, AdamState(
                            P(), place.specs, place.specs)))
        out["save_s"] = time.perf_counter() - t0
        params, state, m = step(params, state, batches[steps])
        out["next_loss"] = float(m["loss"])
    del model, params, state, step
    _free()
    return out


def _placed_restore(pm, ckpt, batch):
    """Phase 38 onto one process mesh: the (2, 2) state restored (each
    rank keeps its block under this mesh's specs), fingerprinted, then one
    more step."""
    import torch
    from repro_torch.checkpoint.checkpointing import restore_checkpoint
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamState, init_opt_state
    cfg = _gspmd_cfg(GSPMD_TRAIN["layers"])
    model = build_model(cfg, device=pm.device, mesh=pm).trainable()
    place = model.placement
    params = model.params()
    state = init_opt_state(params, cfg.opt_state_dtype)
    t0 = time.perf_counter()
    (saved, state), extra = restore_checkpoint(
        ckpt, (params, state), shardings=(place.specs, AdamState(
            P(), place.specs, place.specs)), mesh=pm)
    model.load_params(saved)
    _sync(pm.device)
    restore_s = time.perf_counter() - t0
    params = model.params()
    fp = {"params": _fingerprints(params, place),
          "m": _fingerprints(state.m, place),
          "v": _fingerprints(state.v, place)}
    step = make_train_step(model, _gspmd_tcfg())
    params, state, m = step(params, state, batch)
    out = dict(shape=list(pm.shape.values()), rank=pm.rank,
               step=int(state.step), extra=extra, fingerprints=fp,
               restore_s=restore_s, next_loss=float(m["loss"]))
    del model, params, state, saved, step
    _free()
    return out


def _placed_decode(pm, ref):
    """Phase 37 in one rank: the 4-layer model placed over (1, 4), the
    prompt prefilled into caches of prompt + steps positions (this rank's
    slice of them), then the one-process port's greedy tokens decoded
    (teacher-forced, so every step's logits are comparable); K5's partial
    mode against its plain twin on this rank's caches with empty rows."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.decode_attention import kernel as k5
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_partials
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_partials_ref
    cfg = _gspmd_cfg(GSPMD_DECODE["layers"])
    model = _draw_placed(cfg, pm, GSPMD_DECODE["seed"])
    prompt = torch.as_tensor(ref["prompt"]).to(pm.device)
    forced = torch.as_tensor(ref["tokens"]).to(pm.device)
    S, steps = prompt.shape[1], GSPMD_DECODE["steps"]
    dist.barrier()
    _sync(pm.device)
    reset_launches()
    t0 = time.perf_counter()
    caches, logits = model.prefill(prompt, max_seq=S + steps)
    _sync(pm.device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = {n: LAUNCHES.get(n, 0) for n in (
        "rmsnorm", "flash_attention", k5.NAME, k5.PARTIAL_NAME)}
    out, ms = [logits.float().cpu()], []
    reset_launches()
    for t in range(steps):
        _sync(pm.device)
        t0 = time.perf_counter()
        caches, logits = model.decode(caches, forced[:, t:t + 1], S + t)
        _sync(pm.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits.float().cpu())
    step_launches = {n: LAUNCHES.get(n, 0) for n in (
        "rmsnorm", "flash_attention", k5.NAME, k5.PARTIAL_NAME)}
    got = torch.cat(out, dim=1)
    want = torch.as_tensor(ref["logits"])
    f32_err = float((got - torch.as_tensor(ref["logits_f32"])).abs().max())
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > GSPMD_MARGIN
    same = got.argmax(-1) == want.argmax(-1)
    # K5's partial mode on this rank's layer-0 slice: rows of length 0, 1,
    # half and all of the slice
    kc, vc = caches["k"][0], caches["v"][0]
    B, K, Sl, hd = kc.shape
    q = torch.randn((B, cfg.num_heads, hd), device=pm.device,
                    generator=torch.Generator(device=pm.device)
                    .manual_seed(pm.rank)).to(kc.dtype)
    lens = torch.tensor([(0, 1, Sl // 2, Sl)[i % 4] for i in range(B * K)],
                        dtype=torch.int32, device=pm.device)
    before = LAUNCHES[k5.PARTIAL_NAME]
    o, lse = decode_attention_partials(q[:, None], kc.transpose(1, 2),
                                       vc.transpose(1, 2), lens)
    G = cfg.num_heads // K
    wo, wl = decode_attention_partials_ref(
        q.reshape(B * K, G, hd), kc.reshape(B * K, Sl, hd),
        vc.reshape(B * K, Sl, hd), lens)
    o, lse = o.reshape(B * K, G, hd), lse.reshape(B * K, G)
    empty = (lens == 0)[:, None].expand_as(lse)
    partial_ok = (bool((lse[empty] == -math.inf).all())
                  and bool((o[empty] == 0).all())
                  and bool(torch.allclose(o, wo, rtol=KERNEL_TOL["bfloat16"],
                                          atol=KERNEL_TOL["bfloat16"]))
                  and bool(torch.allclose(lse[~empty], wl[~empty],
                                          rtol=2e-5, atol=2e-5))
                  and LAUNCHES[k5.PARTIAL_NAME]
                  == before + (pm.device.type == "cuda"))
    res = dict(rank=pm.rank, prefill_ms=prefill_ms, step_ms=ms,
               prefill_launches=prefill_launches,
               step_launches=step_launches, cache_positions=Sl,
               max_abs_err=float((got - want).abs().max()),
               err_by_step=[float((got[:, i] - want[:, i]).abs().max())
                            for i in range(got.shape[1])],
               f32_err=f32_err,
               finite=bool(torch.isfinite(got).all()),
               tokens_compared=int(sure.sum()),
               tokens_same=bool(same[sure].all()),
               partial_ok=partial_ok,
               partial_err=float((o - wo).abs().max()),
               weights=sum(p.numel() * p.element_size()
                           for p in model.parameters()),
               peak=_peak(pm.device))
    del model, caches
    _free()
    return res


# ---------------------------------------------------------------------------
# Phases 36-37 for every other family, and the divisibility fallback

# Qwen1.5-MoE and Mamba2-1.3B at full width cut to 2 layers, bfloat16: a
# train step of 4 x 2,048 tokens over (2, 2), a 2 x 512-token prompt and 8
# greedy steps over (1, 4); the tiny Jamba, float32, whose plan puts
# attention, Mamba2 and MoE layers in one model: 4 x 256 tokens, a 2 x
# 64-token prompt and 4 steps.  Whisper-large-v3 at full width, 2 encoder
# and 2 decoder layers: 4 x 448 tokens with 4 x 1,500 frames, a 2 x
# 24-token prompt with 1,500 frames and 8 steps (448 learned positions);
# InternVL2-26B at full width, 2 layers: 4 x (1,024 patches + 1,024
# tokens), a 2 x (1,024 patches + 24 tokens) prompt and 8 steps.  Qwen2-7B
# at full width, 2 layers, over a (1, 3) mesh of ranks 0-2 (``mesh``),
# where its 28 heads, 4 KV heads, d_ff 18,944 and the 3,584 columns of
# its projections do not divide and are computed whole, and the
# vocabulary splits: one gradient step of 2 x 512 tokens, then a 516-token
# prompt and 4 steps over 520 cache positions, which the seq axis of 3
# does not divide (whole caches, K5's normal mode)
GSPMD_FAMILIES = {
    "qwen2-moe-a2.7b": dict(layers=2, batch=4, seq=2048, prompt=512,
                            steps=8),
    "mamba2-1.3b": dict(layers=2, batch=4, seq=2048, prompt=512, steps=8),
    "jamba-1.5-large-398b": dict(layers=None, batch=4, seq=256, prompt=64,
                                 steps=4),
    "whisper-large-v3": dict(layers=2, batch=4, seq=448, prompt=24, steps=8,
                             max_seq=WHISPER_MAX_SEQ),
    "internvl2-26b": dict(layers=2, batch=4, seq=1024, prompt=24, steps=8),
    "qwen2-7b": dict(layers=2, batch=2, seq=512, prompt=516, steps=4,
                     mesh=(1, 3), whole=("attn", "mlp")),
}
GSPMD_FAMILY_SEED = 43
# Qwen1.5-MoE's sharded decode: its largest |logit - one-process bf16
# logit| (0.0654 in sound runs on an H100: the row-parallel sums' rounding
# and 17 of 2,080 routings that differ); the control, one process with one
# expert dropped, must read above it
GSPMD_MOE_LOGIT_TOL = 0.15
GSPMD_FAMILY_TRAIN_MESH = (2, 2)
GSPMD_FAMILY_DECODE_MESH = (1, 4)
# the kernels these paths launch, by launch counter
GSPMD_FAMILY_KERNELS = ("rmsnorm", "flash_attention", "decode_attention",
                        "decode_attention_partial", "moe_gmm", "ssd_scan")


def _family_cfg(name):
    """Full width cut to the family's layers (bfloat16; an
    encoder-decoder's encoder too), or the tiny configuration
    (float32)."""
    from repro_torch.config import get_config
    from repro_torch.testing import tiny_config
    layers = GSPMD_FAMILIES[name]["layers"]
    if layers is None:
        return tiny_config(name, dtype="float32")
    cfg = get_config(name).replace(num_layers=layers)
    return cfg.replace(enc_layers=layers) if cfg.enc_layers else cfg


def _family_meshes(name):
    """(train mesh, decode mesh) of a family's phase 36 and 37 cases."""
    mesh = GSPMD_FAMILIES[name].get("mesh")
    return ((mesh, mesh) if mesh else
            (GSPMD_FAMILY_TRAIN_MESH, GSPMD_FAMILY_DECODE_MESH))


def _family_model(cfg, name, device, mesh=None):
    """The family's model (its learned positions, where it has them),
    placed over ``mesh`` if given; weights uninitialised."""
    from repro_torch.models.model import build_model
    return build_model(cfg, device=device, mesh=mesh,
                       max_seq=GSPMD_FAMILIES[name].get("max_seq", 0))


def _family_batch(cfg, name):
    """``batch_at``'s tokens, with the stub frontend's frames or patch
    embeddings of the encoder-decoder and the VLM (``side_inputs``)."""
    from repro_torch.data.pipeline import DataConfig, batch_at, side_inputs
    spec = GSPMD_FAMILIES[name]
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                      global_batch=spec["batch"])
    return {**batch_at(dcfg, 0), **side_inputs(cfg, dcfg, 0)}


def _family_prompt(cfg, name):
    """The decode's 2-row prompt and its frames or patch embeddings (the
    keyword arguments of ``prefill``), on the CPU."""
    import torch
    gen = torch.Generator().manual_seed(38)
    prompt = torch.randint(1, cfg.vocab_size,
                           (2, GSPMD_FAMILIES[name]["prompt"]), generator=gen)
    side = (_side_input(cfg, 2, gen) if cfg.family in ("encdec", "vlm")
            else {})
    return prompt, side


def _prefilled(cfg, prompt):
    """The positions a prefill of ``prompt`` fills: a VLM's patches
    first."""
    return prompt.shape[1] + (cfg.vision_patches if cfg.family == "vlm"
                              else 0)


def _family_tols(cfg):
    """(loss and logits tolerance, whether the model is float32)."""
    f32 = cfg.dtype == "float32"
    return (MODEL_F32_TOL if f32 else MODEL_BF16_TOL), f32


def _gated_norms(cfg, remat):
    """The RMSNorm kernel launches of one pass's gated norms (one a Mamba
    layer, twice under remat): a placed model over a model axis above 1
    runs them in plain PyTorch, each row's sum of squares summed over the
    axis."""
    from repro_torch.models.transformer import layer_kinds
    n = sum(m == "mamba" for m, _ in layer_kinds(cfg))
    return n * (2 if remat and cfg.remat else 1)


class _Routes:
    """Every MoE routing's expert ids (``moe.route``) while active."""

    def __enter__(self):
        from repro_torch.models import moe as X
        self.calls, self._orig = [], X.route

        def recording(p, xf, cfg):
            w, idx = self._orig(p, xf, cfg)
            self.calls.append(idx.detach().cpu())
            return w, idx
        X.route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as X
        X.route = self._orig


def _rerouted(calls, ref_calls):
    """(tokens whose top-k expert set differs from the reference's,
    tokens routed), over every routing call."""
    diff = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
               for a, b in zip(calls, ref_calls))
    return diff, sum(a.shape[0] for a in calls)


def _launch_counts():
    from repro_torch.kernels import LAUNCHES
    return {n: LAUNCHES.get(n, 0) for n in GSPMD_FAMILY_KERNELS}


def _forced_logits(model, prompt, toks, side):
    """The float32 logits of ``prompt``'s prefill (with ``side``), then of
    each of the teacher-forced ``toks`` (B, steps) decoded in turn."""
    import torch
    S, steps = _prefilled(model.cfg, prompt), toks.shape[1]
    dev = model.device
    caches, lg = model.prefill(prompt.to(dev), max_seq=S + steps, **side)
    out = [lg.float().cpu()]
    for t in range(steps):
        caches, lg = model.decode(caches, toks[:, t:t + 1].to(dev), S + t)
        out.append(lg.float().cpu())
    return torch.cat(out, 1)


def _dropped_expert(model, prompt, side, toks, step_routes, logits):
    """The control of ``GSPMD_MOE_LOGIT_TOL``: the one-process decode,
    teacher-forced as the sound run, with the expert its steps route most
    copies to dropped (its ``wo`` zeroed in every MoE layer, then put
    back): (that expert, its largest |logit - the sound run's logit|)."""
    import torch
    e = int(torch.cat([c.reshape(-1) for c in step_routes]).bincount()
            .argmax())
    wos = [layer.moe.wo for layer in model.layers
           if getattr(layer, "moe", None) is not None]
    with torch.no_grad():
        kept = [w[e].clone() for w in wos]
        for w in wos:
            w[e].zero_()
        got = _forced_logits(model, prompt, toks, side)
        for w, k in zip(wos, kept):
            w[e].copy_(k)
    return e, float((got - logits).abs().max())


def _family_reference(device, tmp, name):
    """The one-process port on the card from the weights the ranks draw:
    the train step's gradients (saved for the ranks' cosines), loss,
    launches and routing; the greedy decode, its routing and launches,
    and (bfloat16) the logits of the float32 model of the same weights,
    teacher-forced the same way; a bfloat16 MoE model's control
    (``_dropped_expert``)."""
    import torch
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import global_norm
    cfg = _family_cfg(name)
    model = _family_model(cfg, name, device).init(torch.Generator(
        device=device).manual_seed(GSPMD_FAMILY_SEED)).trainable()
    params = model.params()
    step = make_train_step(model, _gspmd_tcfg())
    batch = _family_batch(cfg, name)
    _sync(device)
    reset_launches()
    with _Routes() as routes:
        t0 = time.perf_counter()
        loss, grads = step.gradients(params, batch)
        _sync(device)
        grad_ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    path = str(tmp / f"{name}-grads.pt")
    torch.save({n: g.cpu() for n, g in grads.items()}, path)
    ref = dict(grads_path=path, grad_loss=float(loss),
               grad_norm=float(global_norm(grads)), grad_ms=grad_ms,
               launches=launches, routes=routes.calls,
               weights=sum(p.numel() * p.element_size()
                           for p in params.values()))
    del params, step, grads     # the weights stay as drawn: no update
    _free()
    steps = GSPMD_FAMILIES[name]["steps"]
    prompt, side = _family_prompt(cfg, name)
    S = _prefilled(cfg, prompt)
    reset_launches()
    with _Routes() as routes:
        _sync(device)
        t0 = time.perf_counter()
        caches, logits = model.prefill(prompt.to(device), max_seq=S + steps,
                                       **side)
        _sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = _launch_counts()
        n_prefill = len(routes.calls)
        reset_launches()
        out, toks, dms = [logits.float().cpu()], [], []
        for t in range(steps):
            tok = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(tok.cpu())
            _sync(device)
            t0 = time.perf_counter()
            caches, logits = model.decode(caches, tok, S + t)
            _sync(device)
            dms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits.float().cpu())
    step_launches = _launch_counts()
    logits = torch.cat(out, 1)
    toks = torch.cat(toks, 1)
    del caches
    logits32 = logits
    control = None
    if cfg.dtype != "float32":
        if cfg.num_experts:
            control = _dropped_expert(model, prompt, side, toks,
                                      routes.calls[n_prefill:], logits)
        f32 = _family_model(cfg.replace(dtype="float32"), name, device)
        f32.load_params({n: p.float() for n, p in model.params().items()})
        del model
        _free()
        logits32 = _forced_logits(f32, prompt, toks, side)
        model = f32
    ref.update(prompt=prompt.numpy(), side=side, tokens=toks.numpy(),
               logits=logits.numpy(), logits_f32=logits32.numpy(),
               prefill_ms=prefill_ms, decode_ms=dms,
               prefill_launches=prefill_launches,
               step_launches=step_launches, decode_routes=routes.calls,
               control=control,
               bf16_err=float((logits - logits32).abs().max()),
               logits_max=float(logits[..., :cfg.vocab_size].abs().max()))
    del model
    _free()
    return ref


def _barrier(pm):
    """A barrier over the ranks of the process mesh ``pm`` (which may be
    fewer than the world's): over each axis's group in turn."""
    import torch.distributed as dist
    for a in pm.axis_names:
        dist.barrier(group=pm.group(a))


def _placed_bytes(place, params):
    """(this rank's bytes, the bytes ``named_shardings`` gives it, the
    bytes of its blocks of tensors split over every axis, the whole of
    those tensors' bytes)."""
    import numpy as np
    from repro_torch.distributed.sharding import block_index
    mine = want = split = whole_split = 0
    for n, p in params.items():
        b = p.numel() * p.element_size()
        whole = int(np.prod(place.full[n])) * p.element_size()
        blocks = int(np.prod([block_index(e, place.mesh)[1]
                              for e in place.specs[n]]))
        mine += b
        want += whole // blocks
        if blocks == place.mesh.size:
            split += b
            whole_split += whole
    return mine, want, split, whole_split


def _draw_family(cfg, name, pm):
    """The model placed over the process mesh ``pm``, each weight drawn
    whole (the one-process model's draw) and cut to this rank's block,
    every rank at once (a draw's largest float32 temporary, Qwen2-7B's
    embedding, is 2.2 GB)."""
    import torch
    model = _family_model(cfg, name, pm.device, pm).init(
        torch.Generator(device=pm.device).manual_seed(GSPMD_FAMILY_SEED))
    _sync(pm.device)
    _barrier(pm)
    return model


def _fallbacks(model):
    """The layers a placed model computes whole (``layers.fallback``) and
    whether its vocabulary is split over ``model``."""
    from repro_torch.models import layers as L
    ctx = model.shard_ctx
    n = ctx.mesh.shape[ctx.model_axis] if ctx.model_axis else 1
    whole = sorted(k for k, v in L.fallback(model.cfg, n).items() if v)
    return whole, model.placement.specs["embed"][0] is not None


def _family_train(pm, ref, name):
    """Phase 36 for one family in one rank: the gradients of the batch
    (launches and routing recorded), their cosines to the one-process
    port's, then the update; the rank's bytes beside its blocks'."""
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.training.optimizer import init_opt_state
    cfg = _family_cfg(name)
    model = _draw_family(cfg, name, pm).trainable()
    place = model.placement
    params = model.params()
    mine, want, split, whole_split = _placed_bytes(place, params)
    step = make_train_step(model, _gspmd_tcfg())
    batch = _family_batch(cfg, name)
    _peak(pm.device, reset=True)
    _barrier(pm)
    _sync(pm.device)
    reset_launches()
    with _Routes() as routes:
        t0 = time.perf_counter()
        loss, grads = step.gradients(params, batch)
        _sync(pm.device)
        grad_ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    cos = _grad_cosines(grads, place, ref["grads_path"])
    state = init_opt_state(params, cfg.opt_state_dtype)
    params, state, m = step.apply(params, state, loss, grads)
    out = dict(rank=pm.rank, coords=list(pm.coords), grad_loss=float(loss),
               grad_norm=float(m["grad_norm"]), grad_ms=grad_ms,
               launches=launches, size=pm.size, fallbacks=_fallbacks(model),
               cosines=cos, weights=mine, expected=want, split=split,
               whole_split=whole_split,
               rerouted=_rerouted(routes.calls, ref["routes"]),
               peak=_peak(pm.device))
    del model, params, state, step, grads
    _free()
    return out


# phase 36's EP preset: Qwen1.5-MoE under PERF_PRESETS (moe_impl="ep",
# remat off) at full width, 2 layers, one step of 4 x 1,024 tokens through
# run_training(mesh=) over (2, 2); two microbatches of 2 rows (the preset's
# 16 need 16 rows a data shard)
GSPMD_EP_PRESET = dict(arch="qwen2-moe-a2.7b", layers=2, batch=4, seq=1024,
                       microbatch=2, seed=47)


def _ep_preset():
    """(model config, train config, data config) of phase 36's EP
    preset."""
    from repro_torch.config import get_config
    from repro_torch.configs import PERF_PRESETS
    from repro_torch.data.pipeline import DataConfig
    spec = GSPMD_EP_PRESET
    cfg = get_config(spec["arch"], **PERF_PRESETS[spec["arch"]]).replace(
        num_layers=spec["layers"], microbatch=spec["microbatch"])
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                      global_batch=spec["batch"], seed=spec["seed"])
    return cfg, _gspmd_tcfg(), dcfg


def _ep_preset_reference(device, tmp):
    """The one-process port on the card from the weights ``run_training``
    draws (its data seed): the first step's loss and gradients (saved for
    the ranks' cosines) and launches, its EP body over a logical mesh of
    the ranks' shape (every position's tokens, capacities and drops as
    the ranks'; without a model axis it would take the sort dispatch,
    whose global capacity drops other copies)."""
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    cfg, tcfg, dcfg = _ep_preset()
    model = build_model(cfg, device=device).init(torch.Generator(
        device=device).manual_seed(dcfg.seed)).trainable()
    reset_launches()
    mesh = make_mesh(GSPMD_FAMILY_TRAIN_MESH, GSPMD_AXES, device)
    with use_shard_ctx(ShardCtx(mesh)):
        loss, grads = make_train_step(model, tcfg).gradients(
            model.params(), batch_at(dcfg, 0))
    _sync(device)
    path = str(tmp / "ep-preset-grads.pt")
    torch.save({n: g.cpu() for n, g in grads.items()}, path)
    ref = dict(grads_path=path, loss=float(loss), launches=_launch_counts())
    del model, grads
    _free()
    return ref


def _ep_preset_train(pm, eref):
    """Phase 36's EP preset in one rank: one step of ``run_training`` over
    the process mesh ``pm`` (its loss and launches: K6 on the rank's
    placed experts), then the same model's gradients of the same batch by
    hand, their cosines to the one-process port's."""
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.training.train_loop import run_training
    cfg, tcfg, dcfg = _ep_preset()
    _barrier(pm)
    reset_launches()
    t0 = time.perf_counter()
    rep = run_training(cfg, tcfg, dcfg, total_steps=1, device=pm.device,
                       mesh=pm, verbose=False)
    _sync(pm.device)
    run_s = time.perf_counter() - t0
    launches = _launch_counts()
    _free()
    model = build_model(cfg, device=pm.device, mesh=pm,
                        expert_share=False).init(torch.Generator(
                            device=pm.device).manual_seed(dcfg.seed))
    model.trainable()
    _barrier(pm)
    loss, grads = make_train_step(model, tcfg).gradients(model.params(),
                                                         batch_at(dcfg, 0))
    cos = _grad_cosines(grads, model.placement, eref["grads_path"])
    out = dict(rank=pm.rank, coords=list(pm.coords), loss=rep.losses[0],
               grad_loss=float(loss), cosines=cos, launches=launches,
               run_s=run_s, experts=int(model.layers[0].moe.wi.shape[0]))
    del model, grads
    _free()
    return out


def _check_ep_preset(world, eref, launches):
    """Phase 36's EP preset: each rank's ``run_training`` loss within 5e-2
    of the one-process port's, its gradients' cosines at least 0.99, and
    K6 launched on every rank (6 a microbatch: three products in each of
    the 2 layers); adds the launches to ``launches``."""
    cfg, _, _ = _ep_preset()
    want_k6 = 3 * cfg.num_layers * cfg.microbatch
    for w in world:
        r = w["ep_preset"]
        worst = min(r["cosines"], key=r["cosines"].get)
        log(f"[gspmd_ep_preset (2, 2)] rank {r['rank']} {tuple(r['coords'])}"
            f": run_training loss {r['loss']:.6f} (the gradients' "
            f"{r['grad_loss']:.6f}; one process {eref['loss']:.6f}); worst "
            f"cosine {worst} {r['cosines'][worst]:.6f}; experts held "
            f"{r['experts']}; launches {r['launches']} (one process "
            f"{eref['launches']}); run_training step {r['run_s']:.1f} s "
            f"(gloo host copies)")
        if (abs(r["loss"] - eref["loss"]) > MODEL_BF16_TOL
                or r["cosines"][worst] < GRAD_COSINE_MIN
                or r["launches"]["moe_gmm"] != want_k6):
            raise AssertionError(f"[gspmd_ep_preset] rank {r['rank']} "
                                 f"differs from the one-process port or K6 "
                                 f"did not launch")
    launches["moe_gmm"]["GSPMD EP preset run_training step (2, 2), gloo, "
                        "per rank"] = [w["ep_preset"]["launches"]["moe_gmm"]
                                       for w in world]


def _family_decode(pm, ref, name):
    """Phase 37 for one family in one rank: the model placed over ``pm``,
    the prompt prefilled into caches of prompt + steps positions (this
    rank's blocks of them), then the one-process port's greedy tokens
    decoded (teacher-forced, so every step's logits are comparable)."""
    import torch
    from repro_torch.distributed.sharding import block_shape
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.steps import cache_shardings
    cfg = _family_cfg(name)
    model = _draw_family(cfg, name, pm)
    prompt = torch.as_tensor(ref["prompt"]).to(pm.device)
    forced = torch.as_tensor(ref["tokens"]).to(pm.device)
    S, steps = _prefilled(cfg, prompt), forced.shape[1]
    _peak(pm.device, reset=True)
    _barrier(pm)
    _sync(pm.device)
    reset_launches()
    ms = []
    with _Routes() as routes:
        t0 = time.perf_counter()
        caches, logits = model.prefill(prompt, max_seq=S + steps,
                                       **ref["side"])
        _sync(pm.device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = _launch_counts()
        reset_launches()
        out = [logits.float().cpu()]
        for t in range(steps):
            _sync(pm.device)
            t0 = time.perf_counter()
            caches, logits = model.decode(caches, forced[:, t:t + 1], S + t)
            _sync(pm.device)
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits.float().cpu())
    step_launches = _launch_counts()
    got = torch.cat(out, dim=1)
    want = torch.as_tensor(ref["logits"])
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > GSPMD_MARGIN
    same = got.argmax(-1) == want.argmax(-1)
    full = model.cache_spec(prompt.shape[0], S + steps)
    specs = cache_shardings(model.shard_ctx, full,
                            seq_axes=model.shard_ctx.seq_axes)
    res = dict(rank=pm.rank, prefill_ms=prefill_ms, step_ms=ms,
               seq_split=caches.seq_split,
               prefill_launches=prefill_launches,
               step_launches=step_launches,
               caches={k: tuple(c.shape) for k, c in caches.items()},
               caches_ok=all(tuple(c.shape) == block_shape(
                   full[k].shape, specs[k], pm) for k, c in caches.items()),
               max_abs_err=float((got - want).abs().max()),
               f32_err=float((got - torch.as_tensor(ref["logits_f32"]))
                             .abs().max()),
               finite=bool(torch.isfinite(got).all()),
               tokens_compared=int(sure.sum()),
               tokens_same=bool(same[sure].all()),
               rerouted=_rerouted(routes.calls, ref["decode_routes"]),
               weights=sum(p.numel() * p.element_size()
                           for p in model.parameters()),
               peak=_peak(pm.device))
    del model, caches
    _free()
    return res


def _family_nccl(device, pm, ref, name):
    """One family at (1, 1) over NCCL in this process: the gradients'
    loss, cosines and launches, and the teacher-forced decode's logits,
    against the one-process port."""
    import torch
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import layer_kinds
    cfg = _family_cfg(name)
    t0 = time.perf_counter()
    model = _family_model(cfg, name, device, pm).init(torch.Generator(
        device=device).manual_seed(GSPMD_FAMILY_SEED)).trainable()
    step = make_train_step(model, _gspmd_tcfg())
    reset_launches()
    loss, grads = step.gradients(model.params(), _family_batch(cfg, name))
    launches = _launch_counts()
    cos = _grad_cosines(grads, model.placement, ref["grads_path"])
    del grads, step             # the weights stay as drawn: no update
    _free()
    prompt = torch.as_tensor(ref["prompt"]).to(device)
    forced = torch.as_tensor(ref["tokens"]).to(device)
    S, steps = _prefilled(cfg, prompt), forced.shape[1]
    caches, logits = model.prefill(prompt, max_seq=S + steps, **ref["side"])
    reset_launches()
    out = [logits.float().cpu()]
    for t in range(steps):
        caches, logits = model.decode(caches, forced[:, t:t + 1], S + t)
        out.append(logits.float().cpu())
    step_launches = _launch_counts()
    err = float((torch.cat(out, 1) - torch.as_tensor(ref["logits"]))
                .abs().max())
    del model, caches
    _free()
    worst = min(cos, key=cos.get)
    tol, _ = _family_tols(cfg)
    log(f"[gspmd_nccl {name}] (1, 1) over {pm.backend}: gradients' loss "
        f"{float(loss):.6f} (one process {ref['grad_loss']:.6f}); worst "
        f"gradient cosine {worst} {cos[worst]:.6f}; launches {launches} "
        f"(one process {ref['launches']}); decode logits max_abs_err "
        f"{err} (tolerance {tol}); {steps} steps' launches {step_launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    n_attn = sum(m == "attn" for m, _ in layer_kinds(cfg))
    card = device.type == "cuda"
    if (abs(float(loss) - ref["grad_loss"]) > tol
            or cos[worst] < GRAD_COSINE_MIN or launches != ref["launches"]
            or err > tol or step_launches["decode_attention_partial"]
            != n_attn * steps * card):
        raise AssertionError(f"[gspmd_nccl {name}] the (1, 1) step or "
                             "decode differs from the one-process port")
    return {"train": launches, "decode": step_launches,
            "s": time.perf_counter() - t0}


def _rank_gspmd(ref):
    """Everything a rank of phases 36-38's 4-rank world runs (gloo, every
    rank on cuda:0)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_mesh, process_submesh
    torch.backends.cuda.matmul.allow_tf32 = False
    device = ref["device"]
    cfg = _gspmd_cfg(GSPMD_TRAIN["layers"])
    batches = [_gspmd_batch(cfg, k) for k in range(GSPMD_TRAIN["steps"] + 1)]
    out = {"train": [], "restore": []}
    t0 = time.perf_counter()
    for shape, steps in GSPMD_TRAIN_MESHES.items():
        pm = init_process_mesh(shape, GSPMD_AXES, backend="gloo",
                               device=device)
        out["train"].append(_placed_train(
            pm, ref, batches, steps,
            ref["ckpt"] if shape == (2, 2) else None))
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for shape in GSPMD_RESTORE_MESHES:
        pm = init_process_mesh(shape, GSPMD_AXES, backend="gloo",
                               device=device)
        out["restore"].append(_placed_restore(
            pm, ref["ckpt"], batches[GSPMD_TRAIN["steps"]]))
    out["restore_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pm = init_process_mesh(GSPMD_DECODE["mesh"], GSPMD_AXES, backend="gloo",
                           device=device)
    out["decode"] = _placed_decode(pm, ref)
    out["decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = init_process_mesh(GSPMD_FAMILY_TRAIN_MESH, GSPMD_AXES,
                              backend="gloo", device=device)
    decode = init_process_mesh(GSPMD_FAMILY_DECODE_MESH, GSPMD_AXES,
                               backend="gloo", device=device)
    meshes = {GSPMD_FAMILY_TRAIN_MESH: train,
              GSPMD_FAMILY_DECODE_MESH: decode,
              # ranks 0-2; rank 3 outside it
              (1, 3): process_submesh((1, 3), GSPMD_AXES, [[0, 1, 2]],
                                      train.device)}
    out["families"] = {}
    for name in GSPMD_FAMILIES:
        fref = ref["families"][name]
        train, decode = (meshes[m] for m in _family_meshes(name))
        if train is None:       # not a rank of this family's mesh
            continue
        t1 = time.perf_counter()
        fam = out["families"][name] = {"train": _family_train(train, fref,
                                                              name)}
        t2 = time.perf_counter()
        fam["decode"] = _family_decode(decode, fref, name)
        fam["s"] = (t2 - t1, time.perf_counter() - t2)
    out["families_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ep_preset"] = _ep_preset_train(meshes[GSPMD_FAMILY_TRAIN_MESH],
                                        ref["ep_preset"])
    out["ep_preset_s"] = time.perf_counter() - t0
    dist.barrier()
    return out


def _gspmd_reference(device, tmp):
    """The one-process port on the card from the weights the ranks draw:
    phase 36's gradients (saved for the ranks' cosines), its timed steps;
    phase 37's greedy decode."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import init_opt_state
    cfg = _gspmd_cfg(GSPMD_TRAIN["layers"])
    model = build_model(cfg, device=device).init(torch.Generator(
        device=device).manual_seed(GSPMD_TRAIN["seed"])).trainable()
    params = model.params()
    state = init_opt_state(params, cfg.opt_state_dtype)
    step = make_train_step(model, _gspmd_tcfg())
    batches = [_gspmd_batch(cfg, k) for k in range(GSPMD_TRAIN["steps"] + 1)]
    _peak(device, reset=True)
    reset_launches()
    t0 = time.perf_counter()
    g_loss, grads = step.gradients(params, batches[0])
    _sync(device)
    grad_s = time.perf_counter() - t0
    launches = {n: LAUNCHES.get(n, 0) for n in ("rmsnorm",
                                                 "flash_attention")}
    path = str(tmp / "grads.pt")
    torch.save({n: g.cpu() for n, g in grads.items()}, path)
    t0 = time.perf_counter()
    params, state, m = step.apply(params, state, g_loss, grads)
    _sync(device)
    ms = [(grad_s + time.perf_counter() - t0) * 1e3]
    losses = [float(m["loss"])]
    del grads
    for k in range(1, GSPMD_TRAIN["steps"] + 1):
        _sync(device)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[k])
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    ref = dict(grads_path=path, grad_loss=float(g_loss), losses=losses,
               step_ms=ms, launches=launches,
               weights=sum(p.numel() * p.element_size()
                           for p in params.values()),
               peak=_peak(device),
               ckpt=str(tmp / "ckpt"))
    del model, params, state, step
    _free()
    cfg = _gspmd_cfg(GSPMD_DECODE["layers"])
    model = build_model(cfg, device=device).init(torch.Generator(
        device=device).manual_seed(GSPMD_DECODE["seed"]))
    B, S, steps = (GSPMD_DECODE["batch"], GSPMD_DECODE["prompt"],
                   GSPMD_DECODE["steps"])
    prompt = torch.randint(1, cfg.vocab_size, (B, S), generator=torch
                           .Generator().manual_seed(38))
    _sync(device)
    t0 = time.perf_counter()
    caches, logits = model.prefill(prompt.to(device), max_seq=S + steps)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out, toks, dms = [logits.float().cpu()], [], []
    for t in range(steps):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        toks.append(tok.cpu())
        _sync(device)
        t0 = time.perf_counter()
        caches, logits = model.decode(caches, tok, S + t)
        _sync(device)
        dms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits.float().cpu())
    logits = torch.cat(out, 1)
    toks = torch.cat(toks, 1)
    # the float32 model of the same (bfloat16) weights, teacher-forced the
    # same way: how far the one-process bfloat16 port's own roundings take
    # its logits
    f32 = build_model(cfg.replace(dtype="float32"), device=device)
    f32.load_params({n: p.float() for n, p in model.params().items()})
    del model, caches
    _free()
    caches, lg = f32.prefill(prompt.to(device), max_seq=S + steps)
    out32 = [lg.float().cpu()]
    for t in range(steps):
        caches, lg = f32.decode(caches, toks[:, t:t + 1].to(device), S + t)
        out32.append(lg.float().cpu())
    logits32 = torch.cat(out32, 1)
    ref.update(prompt=prompt.numpy(), tokens=toks.numpy(),
               logits=logits.numpy(), logits_f32=logits32.numpy(),
               prefill_ms=prefill_ms, decode_ms=dms,
               logits_max=float(logits.abs().max()),
               bf16_err=float((logits - logits32).abs().max()))
    del f32, caches
    _free()
    ref["families"] = {}
    for name in GSPMD_FAMILIES:
        t0 = time.perf_counter()
        ref["families"][name] = _family_reference(device, tmp, name)
        ref["families"][name]["ref_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref["ep_preset"] = _ep_preset_reference(device, tmp)
    ref["ep_preset"]["ref_s"] = time.perf_counter() - t0
    return ref


def phase_gspmd_nccl(device, ref):
    """Phases 36 and 37 at one rank over NCCL in this process (``(1, 1)``:
    every block the whole tensor, the same code with real NCCL calls):
    the gradients' cosines and loss, and the decode logits, against the
    one-process port."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        pm = init_process_mesh((1, 1), GSPMD_AXES, device=device, rank=0,
                               world_size=1, store=dist.FileStore(
                                   str(Path(tmp) / "store"), 1))
        try:
            cfg = _gspmd_cfg(GSPMD_TRAIN["layers"])
            model = build_model(cfg, device=device, mesh=pm).init(
                torch.Generator(device=device).manual_seed(
                    GSPMD_TRAIN["seed"])).trainable()
            step = make_train_step(model, _gspmd_tcfg())
            reset_launches()
            loss, grads = step.gradients(model.params(),
                                         _gspmd_batch(cfg, 0))
            launches = {n: LAUNCHES.get(n, 0) for n in ("rmsnorm",
                                                         "flash_attention")}
            cos = _grad_cosines(grads, model.placement, ref["grads_path"])
            del model, grads, step
            _free()
            worst = min(cos, key=cos.get)
            log(f"[gspmd_nccl] train step at (1, 1) over {pm.backend}: loss "
                f"{float(loss):.6f} (one process {ref['grad_loss']:.6f}); "
                f"worst gradient cosine {worst} {cos[worst]:.6f}; launches "
                f"{launches} (one process {ref['launches']})")
            if abs(float(loss) - ref["grad_loss"]) > MODEL_BF16_TOL or \
                    cos[worst] < GRAD_COSINE_MIN or \
                    launches != ref["launches"]:
                raise AssertionError("[gspmd_nccl] the (1, 1) train step "
                                     "differs from the one-process port")
            cfg = _gspmd_cfg(GSPMD_DECODE["layers"])
            model = build_model(cfg, device=device, mesh=pm).init(
                torch.Generator(device=device).manual_seed(
                    GSPMD_DECODE["seed"]))
            prompt = torch.as_tensor(ref["prompt"]).to(device)
            forced = torch.as_tensor(ref["tokens"]).to(device)
            S = prompt.shape[1]
            reset_launches()
            caches, logits = model.prefill(prompt,
                                           max_seq=S + forced.shape[1])
            out = [logits.float().cpu()]
            for t in range(forced.shape[1]):
                caches, logits = model.decode(caches, forced[:, t:t + 1],
                                              S + t)
                out.append(logits.float().cpu())
            k5p = LAUNCHES.get("decode_attention_partial", 0)
            err = float((torch.cat(out, 1) - torch.as_tensor(ref["logits"]))
                        .abs().max())
            del model, caches
            _free()
            log(f"[gspmd_nccl] decode at (1, 1) over {pm.backend}: logits "
                f"max_abs_err {err} against the one-process port; K5 "
                f"partial launches {k5p}")
            want = cfg.num_layers * forced.shape[1] * (device.type == "cuda")
            if err > MODEL_BF16_TOL or k5p != want:
                raise AssertionError("[gspmd_nccl] the (1, 1) decode differs "
                                     "or K5's partial mode did not launch")
            families = {name: _family_nccl(device, pm, ref["families"][name],
                                           name)
                        for name in GSPMD_FAMILIES}
        finally:
            dist.destroy_process_group()
    return {"train": launches, "decode_partial": k5p, "families": families}


def _check_decode_partial(device, B, H, K, hd, Sl, lengths, dtype_name,
                          bf16_scores=False):
    """K5's partial mode at the sequence-sharded decode's shape (a rank's
    slice of ``Sl`` positions, rows of the given lengths, 0 included)
    against its plain twin, timed beside its bound, its plain version and
    the library call that returns the output and the log-sum-exp:
    ``_scaled_dot_product_efficient_attention`` over the KV heads expanded
    to every query head, the lengths as an additive mask (its output in
    the model dtype, where K5's partial is float32).  ``bf16_scores``: the
    launch option that rounds each q.k to bfloat16 first, against the
    plain version's ``f32_scores=False`` and kept apart from its float32
    scores, q scaled by ``BF16_SCORES_Q_SCALE`` (the library call's scores
    stay float32: its log-sum-exp is only printed)."""
    import torch
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=device).manual_seed(41)
    q = _randn((B, H, hd), dt, gen, device)
    if bf16_scores:
        q = (q.float() * BF16_SCORES_Q_SCALE).to(dt)
    kc = _randn((B, K, Sl, hd), dt, gen, device)
    vc = _randn((B, K, Sl, hd), dt, gen, device)
    rows = torch.tensor([lengths[i % len(lengths)] for i in range(B * K)],
                        dtype=torch.int32, device=device)
    G = H // K
    tag = (f"[kernel:decode_attention:partial B={B} H={H} K={K} hd={hd} "
           f"Sl={Sl} {dtype_name} lengths={lengths}"
           f"{' bf16_scores' if bf16_scores else ''}]")

    def launch():
        return kernel.decode_attention_kernel(q, kc.transpose(1, 2),
                                              vc.transpose(1, 2), rows,
                                              partial=True,
                                              bf16_scores=bf16_scores)

    def plain(f32_scores=not bf16_scores):
        return ref.decode_attention_partials_ref(
            q.reshape(B * K, G, hd), kc.reshape(B * K, Sl, hd),
            vc.reshape(B * K, Sl, hd), rows, f32_scores=f32_scores)

    # the library call's operands: every query head's K/V, and the mask as
    # a bias whose rows start 16-element aligned, as its kernel asks
    ke = kc.repeat_interleave(G, dim=1)
    ve = vc.repeat_interleave(G, dim=1)
    pad = -(-Sl // 16) * 16
    bias = torch.zeros((B, H, 1, pad), dtype=dt, device=device)[..., :Sl]
    live = (torch.arange(Sl, device=device)
            < rows.reshape(B, K).repeat_interleave(G, dim=1)[..., None])
    bias[:, :, 0] = torch.where(live, 0.0, -math.inf).to(dt)

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q[:, :, None], ke, ve, bias, True)

    o, lse = launch()
    wo, wl = plain()
    o, lse = o.reshape(B * K, G, hd), lse.reshape(B * K, G)
    empty = (rows == 0)[:, None].expand_as(lse)
    if not (bool((lse[empty] == -math.inf).all())
            and bool((o[empty] == 0).all())):
        raise AssertionError(f"{tag}: a row of length 0 is not (0, -inf)")
    err = _hold(tag + " o", o, wo, dtype_name)
    _hold(tag + " lse", lse[~empty], wl[~empty], "float32")
    if bf16_scores:
        _apart(tag + " o", o, plain(True)[0], dtype_name)
    lo, ll = library()[:2]
    lo, ll = lo.float().reshape(B * K, G, hd), ll[..., 0].reshape(B * K, G)
    log(f"{tag} library call vs the kernel on rows with positions: o "
        f"{float((lo - o)[~empty].abs().max())} lse "
        f"{float((ll - lse)[~empty].abs().max())}")
    flops, n_bytes = ops.cost(B, H, K, hd, int(rows.sum()), q.element_size(),
                              partial=True)
    t = _timed(tag, launch, plain, library, n_bytes=n_bytes, flops=flops,
               flops_peak=PEAK_F32_FLOPS)
    return dict(t, max_abs_err=err)


def _check_gspmd_families(world, ref, nccl, launches, card):
    """Phases 36 and 37 for every family but the dense one (and for
    Qwen2-7B over (1, 3), the divisibility fallback): each rank's
    train step at ``GSPMD_FAMILY_TRAIN_MESH`` and decode at
    ``GSPMD_FAMILY_DECODE_MESH`` (or the family's ``mesh``) held to the
    one-process port (bfloat16:
    loss within 5e-2, gradient cosines at least 0.99, the decode's
    largest |logit - float32 logit| at most ``GSPMD_F32_GAP`` times the
    one-process port's, tokens identical where the top-2 margin exceeds
    5e-2, and an MoE model's largest |logit - one-process logit| at most
    ``GSPMD_MOE_LOGIT_TOL``, which its control must exceed; float32: loss
    and logits within 1e-4), each rank's weights and
    caches its blocks under ``named_shardings`` and ``cache_shardings``,
    and each kernel's launches a rank; Qwen2-7B's layers computed whole
    but its vocabulary split; adds those launches to ``launches`` and
    returns K5's partial-mode launches."""
    from repro_torch.models.transformer import layer_kinds
    partial = {}
    for n in ("decode_attention", "moe_gmm", "ssd_scan"):
        launches[n] = {}
    log(f"[gspmd_families] world {world[0]['families_s']:.1f} s: " + ", ".join(
        f"{name} train {world[0]['families'][name]['s'][0]:.1f} s, decode "
        f"{world[0]['families'][name]['s'][1]:.1f} s"
        for name in GSPMD_FAMILIES))
    for name in GSPMD_FAMILIES:     # each family's seconds, every part
        parts = (ref["families"][name]["ref_s"], nccl["families"][name]["s"],
                 *world[0]["families"][name]["s"])
        log(f"[gspmd_family_s {name}] one process {parts[0]:.1f} s, (1, 1) "
            f"over NCCL {parts[1]:.1f} s, the world's train {parts[2]:.1f} "
            f"s and decode {parts[3]:.1f} s: {sum(parts):.1f} s")
    for name, spec in GSPMD_FAMILIES.items():
        fref = ref["families"][name]
        cfg = _family_cfg(name)
        tol, f32 = _family_tols(cfg)
        n_attn = sum(m == "attn" for m, _ in layer_kinds(cfg))
        train_mesh, decode_mesh = _family_meshes(name)
        ranks = [w for w in world if name in w["families"]]
        split = train_mesh[1] > 1
        want = dict(fref["launches"])
        want["rmsnorm"] -= _gated_norms(cfg, True) * split * card
        log(f"[gspmd_ref {name}] one process: gradients {fref['grad_ms']:.3f}"
            f" ms, loss {fref['grad_loss']:.6f}, launches "
            f"{fref['launches']}; prefill {fref['prefill_ms']:.3f} ms, "
            f"decode ms {[round(x, 3) for x in fref['decode_ms']]}, "
            f"launches {fref['prefill_launches']} then "
            f"{fref['step_launches']}; |logit - float32 logit| "
            f"{fref['bf16_err']}; {fref['ref_s']:.1f} s")
        for w in ranks:
            r = w["families"][name]["train"]
            worst = min(r["cosines"], key=r["cosines"].get)
            log(f"[gspmd_train {name} {train_mesh}] rank "
                f"{r['rank']} {tuple(r['coords'])}: gradients' loss "
                f"{r['grad_loss']:.6f} (one process {fref['grad_loss']:.6f})"
                f", the update's gradient norm {r['grad_norm']:.6f} (one "
                f"process {fref['grad_norm']:.6f}); worst cosine {worst} "
                f"{r['cosines'][worst]:.6f}; gradients "
                f"{r['grad_ms']:.3f} ms (one process {fref['grad_ms']:.3f};"
                f" gloo host copies); weights {r['weights']} bytes "
                f"(named_shardings' blocks {r['expected']}), "
                f"{r['weights'] / fref['weights']:.6f} of the whole, its "
                f"blocks of the tensors split over both axes "
                f"{r['split']} of {r['whole_split']}; layers computed whole "
                f"{r['fallbacks'][0]}, vocabulary split {r['fallbacks'][1]};"
                f" tokens rerouted "
                f"{r['rerouted'][0]} of {r['rerouted'][1]}; launches "
                f"{r['launches']} (want {want}); peak {r['peak']}")
            # the layers the family's mesh computes whole; the vocabulary
            # splits everywhere
            fallback = (list(spec.get("whole", ())), True)
            if (abs(r["grad_loss"] - fref["grad_loss"]) > tol
                    or r["cosines"][worst] < GRAD_COSINE_MIN
                    or r["weights"] != r["expected"]
                    or r["size"] * r["split"] != r["whole_split"]
                    or tuple(r["fallbacks"]) != fallback
                    or r["launches"] != want):
                raise AssertionError(f"[gspmd_train {name}] rank "
                                     f"{r['rank']} differs from the "
                                     f"one-process port")
        for n in launches:
            launches[n][f"GSPMD {name} train step gradients "
                        f"{train_mesh}, gloo, per rank"] = [
                w["families"][name]["train"]["launches"][n] for w in ranks]
        steps = spec["steps"]
        f32_tol = tol if f32 else GSPMD_F32_GAP * fref["bf16_err"]
        port_tol = math.inf
        if fref["control"] is not None:
            port_tol = GSPMD_MOE_LOGIT_TOL
            expert, control = fref["control"]
            log(f"[gspmd_ref {name}] control: one process with expert "
                f"{expert} dropped in every MoE layer: |logit - one-process "
                f"logit| {control} (the sharded decode's limit {port_tol})")
            if control <= port_tol:
                raise AssertionError(f"[gspmd_ref {name}] the decode's limit "
                                     f"does not see one expert dropped")
        split = decode_mesh[1] > 1
        # the self caches' positions split over the model axis, or whole
        seq_split = (_prefilled(cfg, fref["prompt"]) + steps) % \
            decode_mesh[1] == 0
        want_prefill = dict(fref["prefill_launches"])
        want_prefill["rmsnorm"] -= _gated_norms(cfg, False) * split * card
        want_steps = dict(fref["step_launches"])
        want_steps["rmsnorm"] -= (_gated_norms(cfg, False) * steps * split
                                  * card)
        # the self-attention's steps: K5's partial mode over split caches
        # (the cross-attention's stay in its normal mode)
        self_steps = n_attn * steps * card * seq_split
        want_steps["decode_attention_partial"] = self_steps
        want_steps["decode_attention"] -= self_steps
        for w in ranks:
            r = w["families"][name]["decode"]
            log(f"[gspmd_decode {name} {decode_mesh}] rank "
                f"{r['rank']}: caches {r['caches']}, positions split "
                f"{r['seq_split']} (cache_shardings' "
                f"blocks {r['caches_ok']}); prefill {r['prefill_ms']:.3f} ms"
                f" (one process {fref['prefill_ms']:.3f}); decode ms a step "
                f"{[round(x, 3) for x in r['step_ms']]} (one process "
                f"{[round(x, 3) for x in fref['decode_ms']]}; gloo host "
                f"copies); logits max_abs_err {r['max_abs_err']} (held to "
                f"{port_tol}; |logit| up to {fref['logits_max']:.3f}); to the "
                f"float32 model "
                f"{r['f32_err']} (held to {f32_tol}); tokens same where the "
                f"margin > {GSPMD_MARGIN} ({r['tokens_compared']} of "
                f"{2 * (steps + 1)}) {r['tokens_same']}; tokens rerouted "
                f"{r['rerouted'][0]} of {r['rerouted'][1]}; launches prefill "
                f"{r['prefill_launches']} (want {want_prefill}), {steps} "
                f"steps {r['step_launches']} (want {want_steps}); peak "
                f"{r['peak']}")
            bad = (r["f32_err"] > f32_tol or not r["tokens_same"]
                   or r["max_abs_err"] > port_tol)
            if (bad or not r["finite"] or not r["caches_ok"]
                    or r["seq_split"] != seq_split
                    or r["step_launches"] != want_steps
                    or r["prefill_launches"] != want_prefill):
                raise AssertionError(f"[gspmd_decode {name}] rank "
                                     f"{r['rank']} differs from the "
                                     f"one-process port or its launches "
                                     f"are off")
        for n in launches:
            launches[n][f"GSPMD {name} decode {decode_mesh}, "
                        f"prefill and {steps} steps, gloo, per rank"] = [
                w["families"][name]["decode"]["prefill_launches"][n]
                + w["families"][name]["decode"]["step_launches"][n]
                for w in ranks]
        partial[f"GSPMD {name} decode {decode_mesh}, {steps} "
                f"steps, gloo, per rank"] = [
            w["families"][name]["decode"]["step_launches"][
                "decode_attention_partial"] for w in ranks]
        fam = nccl["families"][name]
        for n in launches:
            launches[n][f"GSPMD {name} train step gradients (1, 1), "
                        f"NCCL"] = fam["train"][n]
        partial[f"GSPMD {name} decode (1, 1), {steps} steps, NCCL"] = \
            fam["decode"]["decode_attention_partial"]
    return partial


def phase_gspmd(device, tmp, settle=None):
    """Phases 36-38: the GSPMD paths across processes (dense Llama-3-8B
    widths, bfloat16), each rank of a 4-rank gloo world on cuda:0 held to
    the one-process port on the card from the same weights (each rank
    drawing every weight whole and keeping its block), and the same code
    at (1, 1) over NCCL here.  36: the FSDP and tensor-parallel train step
    (2 layers, 4 x 2,048 tokens; 1 step over (2, 2) and over (4, 1)): loss
    within 5e-2, and the (2, 2) run's next loss, from its updated weights,
    within 5e-2 of one process's, each gradient's cosine at least 0.99, each rank's weights
    a quarter of the whole (but for the replicated norm scales), step ms,
    peak memory and K3/K4 launches a rank; 37: the sequence-sharded
    decode (4 layers, 2 x 512-token prompt, 8 greedy steps) over (1, 4):
    its largest |logit - float32 logit| at most ``GSPMD_F32_GAP`` times
    the one-process bfloat16 port's (its distance to that port printed),
    tokens identical where the one-process top-2 margin exceeds 5e-2, K5's
    partial mode against its plain twin on each rank (rows of length 0
    included), decode ms a step, K5 launches a rank;
    38: the (2, 2) train state after 1 step saved (gathered whole, rank 0
    writes), restored onto (1, 4) and (4, 1): parameters and moments
    bitwise (fingerprints of every whole tensor), one more step's loss
    within 5e-2 of the unbroken (2, 2) run's.  Times are those of gloo's
    host copies between 4 processes on one card, not NCCL's.  ``settle``,
    if given, is called before K5's partial mode is timed (it waits for
    the processes running beside this phase).  Returns the K5
    partial-mode kernel entry and the launches."""
    import torch
    from repro_torch.launch.procs import spawn
    t0 = time.perf_counter()
    ref = _gspmd_reference(device, tmp)
    ref["device"] = device.type
    ref_s = time.perf_counter() - t0
    log(f"[gspmd_ref] one process on the card: train step (2 layers, 4 x "
        f"2,048 tokens) ms {[round(x, 3) for x in ref['step_ms']]}, losses "
        f"{ref['losses']}, launches {ref['launches']}, weights "
        f"{ref['weights']} bytes, peak {ref['peak']}; decode (4 layers, "
        f"2 x 512 prompt) prefill {ref['prefill_ms']:.3f} ms, step ms "
        f"{[round(x, 3) for x in ref['decode_ms']]}; {ref_s:.1f} s")
    t0 = time.perf_counter()
    nccl = phase_gspmd_nccl(device, ref)
    log(f"[gspmd_nccl] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    world = spawn(_rank_gspmd, 4, ref, timeout_s=900.0)
    log(f"[gspmd] world of 4 ranks (gloo, cuda:0): "
        f"{time.perf_counter() - t0:.1f} s (train "
        f"{world[0]['train_s']:.1f} s, restore {world[0]['restore_s']:.1f} "
        f"s, decode {world[0]['decode_s']:.1f} s)")
    launches = {"rmsnorm": {}, "flash_attention": {}}
    # 36: the train step
    for i, shape in enumerate(GSPMD_TRAIN_MESHES):
        rs = [w["train"][i] for w in world]
        for r in rs:
            worst = min(r["cosines"], key=r["cosines"].get)
            log(f"[gspmd_train {shape}] rank {r['rank']} {tuple(r['coords'])}"
                f": gradients' loss {r['grad_loss']:.6f} (one process "
                f"{ref['grad_loss']:.6f}); worst cosine {worst} "
                f"{r['cosines'][worst]:.6f}; losses {r['losses']} (one "
                f"process {ref['losses'][:len(r['losses'])]}); step ms "
                f"{[round(x, 3) for x in r['step_ms']]} (one process "
                f"{[round(x, 3) for x in ref['step_ms'][:len(r['step_ms'])]]}"
                f"; gloo host "
                f"copies); weights {r['weights']} bytes = "
                f"{r['weights'] / ref['weights']:.6f} of the whole "
                f"({r['replicated']} bytes of replicated norm scales); peak "
                f"{r['peak']}; launches {r['launches']}")
            # the loss after the last timed step's update: the (2, 2) run's
            # next step (phase 38's) against the one-process port's
            nxt = r.get("next_loss")
            if nxt is not None:
                log(f"[gspmd_train {shape}] rank {r['rank']}: the next "
                    f"step's loss {nxt:.6f} (one process "
                    f"{ref['losses'][GSPMD_TRAIN['steps']]:.6f})")
            bad = (abs(r["grad_loss"] - ref["grad_loss"]) > MODEL_BF16_TOL
                   or any(abs(a - b) > MODEL_BF16_TOL for a, b in
                          zip(r["losses"], ref["losses"]))
                   or (nxt is not None and abs(
                       nxt - ref["losses"][GSPMD_TRAIN["steps"]])
                       > MODEL_BF16_TOL)
                   or r["cosines"][worst] < GRAD_COSINE_MIN
                   or r["launches"] != ref["launches"]
                   or 4 * (r["weights"] - r["replicated"])
                   != ref["weights"] - r["replicated"])
            if bad:
                raise AssertionError(f"[gspmd_train {shape}] rank "
                                     f"{r['rank']} differs from the "
                                     f"one-process port")
        for n in launches:
            launches[n][f"GSPMD train step gradients {shape}, gloo, per "
                        f"rank"] = [r["launches"][n] for r in rs]
    # 38: the elastic restart
    saved = world[0]["train"][0]
    log(f"[gspmd_restore] (2, 2) state saved in {saved['save_s']:.1f} s; "
        f"the unbroken (2, 2) run's next loss {saved['next_loss']:.6f}")
    for i, shape in enumerate(GSPMD_RESTORE_MESHES):
        for w in world:
            r = w["restore"][i]
            same = r["fingerprints"] == saved["fingerprints"]
            log(f"[gspmd_restore {shape}] rank {r['rank']}: restored step "
                f"{r['step']} {r['extra']} in {r['restore_s']:.1f} s; "
                f"parameters and moments bitwise (fingerprints) {same}; "
                f"next loss {r['next_loss']:.6f}")
            if not same or abs(r["next_loss"] - saved["next_loss"]) > \
                    MODEL_BF16_TOL:
                raise AssertionError(f"[gspmd_restore {shape}] rank "
                                     f"{r['rank']}: the restored state or "
                                     f"its next step differs")
    # 37: the sequence-sharded decode
    steps = GSPMD_DECODE["steps"]
    layers = GSPMD_DECODE["layers"]
    card = device.type == "cuda"        # no kernel launches off the card
    # the sharded decode sums each row-parallel product's partials in
    # another order than the one-process product, so its bfloat16
    # roundings differ (its distance to the one-process port is printed):
    # it is held as close to the float32 model of the same weights as the
    # one-process bfloat16 port is, within GSPMD_F32_GAP times
    f32_tol = GSPMD_F32_GAP * ref["bf16_err"]
    log(f"[gspmd_decode] max |logit - float32 logit| held to {f32_tol} "
        f"({GSPMD_F32_GAP} x the one-process bf16 port's "
        f"{ref['bf16_err']})")
    for w in world:
        r = w["decode"]
        log(f"[gspmd_decode (1, 4)] rank {r['rank']}: {r['cache_positions']}"
            f" cache positions; prefill {r['prefill_ms']:.3f} ms (one "
            f"process {ref['prefill_ms']:.3f}); decode ms a step "
            f"{[round(x, 3) for x in r['step_ms']]} (one process "
            f"{[round(x, 3) for x in ref['decode_ms']]}; gloo host copies); "
            f"logits max_abs_err {r['max_abs_err']} (prefill, then each "
            f"step: {['%.4f' % e for e in r['err_by_step']]}; |logit| up to "
            f"{ref['logits_max']:.3f}); to the float32 model {r['f32_err']} "
            f"(the one-process bfloat16 port's {ref['bf16_err']}); tokens "
            f"same where the "
            f"margin > {GSPMD_MARGIN} ({r['tokens_compared']} of "
            f"{GSPMD_DECODE['batch'] * (steps + 1)}) {r['tokens_same']}; "
            f"K5 partial mode vs its plain twin {r['partial_ok']} (err "
            f"{r['partial_err']}); launches prefill {r['prefill_launches']}, "
            f"{steps} steps {r['step_launches']}; weights {r['weights']}; "
            f"peak {r['peak']}")
        sl = r["step_launches"]
        if (not r["finite"] or r["f32_err"] > f32_tol
                or not r["tokens_same"] or not r["partial_ok"]
                or sl["decode_attention_partial"] != layers * steps * card
                or sl["decode_attention"] != 0
                or r["prefill_launches"]["flash_attention"] != layers * card):
            raise AssertionError(f"[gspmd_decode] rank {r['rank']} differs "
                                 f"from the one-process port or its "
                                 f"launches are off")
    partial_launches = _check_gspmd_families(world, ref, nccl, launches,
                                             card)
    log(f"[gspmd_ep_preset] one process {ref['ep_preset']['ref_s']:.1f} s, "
        f"the world's {world[0]['ep_preset_s']:.1f} s")
    _check_ep_preset(world, ref["ep_preset"], launches)
    cfg = _gspmd_cfg(layers)
    Sl = world[0]["decode"]["cache_positions"]
    if settle is not None:
        settle()
    entry = _kernel_entry("decode_attention", _check_decode_partial(
        device, GSPMD_DECODE["batch"], cfg.num_heads, cfg.num_kv_heads,
        cfg.resolved_head_dim(), Sl, [Sl, Sl - 1, 0, 1], "bfloat16"),
        path="partial")
    entry["launches"] = world[0]["decode"]["step_launches"][
        "decode_attention_partial"]
    entry["process_launches"] = {
        f"sequence-sharded decode (1, 4), {steps} steps, gloo, per rank":
            [w["decode"]["step_launches"]["decode_attention_partial"]
             for w in world],
        f"sequence-sharded decode (1, 1), {steps} steps, NCCL":
            nccl["decode_partial"], **partial_launches}
    for n in nccl["train"]:
        launches[n]["GSPMD train step gradients (1, 1), NCCL"] = \
            nccl["train"][n]
    return entry, launches


# each phase's own seconds (host clock), in the order run
PHASE_S = {}


def _background_child(name, fn, args, send):
    """A background phase's process: ``fn(*args)``, its seconds printed;
    sends (ok, result or traceback, seconds)."""
    try:
        import torch
        # the simulators' CPU work is single-threaded Python: fewer intra-op
        # threads, and a lower priority, leave the cores to the phases on
        # the critical path beside it
        torch.set_num_threads(2)
        os.nice(5)
        t0 = time.perf_counter()
        val = fn(*args)
        sec = time.perf_counter() - t0
        log(f"[phase {name}] {sec:.1f} s (a process of its own)")
        send.send((True, val, sec))
    except BaseException:
        send.send((False, traceback.format_exc(), 0.0))
    finally:
        send.close()


class _Background:
    """Phases run each in a process of its own (spawned: its own CUDA
    context and launch counters) while this process runs others.
    ``join`` waits for every one, records its seconds in ``PHASE_S`` and
    returns the results by name, raising if any failed; leaving the
    ``with`` block stops every process still running."""

    def __init__(self):
        self.ctx = mp.get_context("spawn")
        self.jobs = {}
        self.done = {}

    def start(self, name, fn, *args):
        recv, send = self.ctx.Pipe(duplex=False)
        proc = self.ctx.Process(target=_background_child,
                                args=(name, fn, args, send))
        proc.start()
        send.close()
        self.jobs[name] = (proc, recv)

    def join(self):
        failed = []
        for name, (proc, recv) in list(self.jobs.items()):
            try:
                ok, val, sec = recv.recv()
            except EOFError:
                ok, val, sec = False, "exited without a result", 0.0
            proc.join()
            recv.close()
            del self.jobs[name]
            if not ok:
                failed.append(f"{name} (exit code {proc.exitcode}):\n{val}")
                continue
            PHASE_S[name] = sec
            self.done[name] = val
        if failed:
            raise RuntimeError("background phases failed:\n"
                               + "\n".join(failed))
        return self.done

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for proc, recv in self.jobs.values():
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10.0)
            if proc.is_alive():
                proc.kill()
                proc.join()
            recv.close()
        self.jobs.clear()


@contextlib.contextmanager
def _phase(name):
    """Time the block as phase ``name`` and print its seconds."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_S[name] = time.perf_counter() - t0
        log(f"[phase {name}] {PHASE_S[name]:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sim-apps", type=int, default=1400,
                    help="applications in the main and composed paths' "
                         "trace (at most 2100)")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: the K1, K2, K3 "
                         "and K7 sweeps then also time its kernels, in the "
                         "order parent, this tree, this tree, parent, and "
                         "K7's stage split cuts its SSD source")
    ap.add_argument("--sweep", choices=sorted(SWEEPS), default=None,
                    help="only print one sweep's times as a JSON line (the "
                         "package under --src)")
    ap.add_argument("--only", choices=("gspmd",), default=None,
                    help="build the kernels and run phases 36-38 only (the "
                         "kernels line then lists K5's partial mode only)")
    ap.add_argument("--src", default=str(SRC), help=argparse.SUPPRESS)
    ap.add_argument("--spec", default="{}", help=argparse.SUPPRESS)
    args = ap.parse_args()
    src = Path(args.src)
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {src / 'repro_torch'} not found — run this from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    dev = torch.device("cuda")
    if args.sweep is not None:
        print(json.dumps(SWEEPS[args.sweep](dev, **json.loads(args.spec))))
        return 0
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with _phase("1 build"):
        phase_build()
    if args.only == "gspmd":
        torch.backends.cuda.matmul.allow_tf32 = False
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, \
                _phase("36-38 gspmd"):
            kernels = [phase_gspmd(dev, Path(tmp))[0]]
        return _finish(kernels, t0)
    # phases 2-4, 7 and 28's run_sim (simulator traces, host-bound) and
    # phase 31's dry run (a trace on meta) each in a process of its own
    # beside phases 36-38 (gloo's host copies); every phase after them runs
    # alone on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (ROOT / "build").mkdir(exist_ok=True)
    dry_tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    with _Background() as bg, dry_tmp:
        bg.start("31 dry run", phase_dryrun, Path(dry_tmp.name))
        bg.start("2 main path", phase_main_path, dev, args.sim_apps)
        bg.start("3 composed path", phase_composed_path, dev, args.sim_apps)
        bg.start("4 posterior path", phase_posterior_path, dev)
        bg.start("7 reference and threefry", phase_reference_and_threefry)
        bg.start("28 mesh run_sim", phase_mesh_sim,
                 min(MESH_SIM_APPS, args.sim_apps))
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, \
                _phase("36-38 gspmd"):
            partial, gspmd = phase_gspmd(dev, Path(tmp), settle=bg.join)
        done = bg.join()
    log(f"[background] phases 2, 3, 4, 7, 28's run_sim and 31 beside 36-38: "
        f"{time.perf_counter() - t0 - PHASE_S['1 build']:.1f} s")
    main_res, launches, W, ov_width, rows = done["2 main path"]
    launches_composed, phase_apps, composed_res = done["3 composed path"]
    _same_schedule("composed_path vs main_path", main_res, composed_res, 0.0)
    launches_posterior = done["4 posterior path"]
    mesh_k1, SHARED["sim_default"] = done["28 mesh run_sim"]
    with _phase("5 walk kernels"):
        kernels = phase_kernels(dev, W, ov_width, rows, phase_apps,
                                args.parent)
    # each kernel's launches on its own path
    from repro_torch.kernels.pdgraph_walk import kernel
    path = {kernel.NAME: launches, kernel.PHASE_NAME: launches_composed,
            kernel.POSTERIOR_NAME: launches_posterior}
    for k in kernels:
        k["launches"] = path[k["name"]][k["name"]]
    with _phase("6 delta ticks"):
        phase_delta_tick(dev, W)
    with _phase("8 model kernels"):
        model_kernels = phase_model_kernels(dev, args.parent)
    with _phase("9 full width"):
        phase_full_width(dev)
    with _phase("10 serve"):
        launches_serve = phase_serve(dev, "llama3-8b")
    for k in model_kernels:
        k["launches"] = launches_serve[k["name"]]
    kernels += model_kernels
    with _phase("11 engine"):
        phase_engine_reference(dev, "llama3-8b")
    with _phase("12 K6"):
        moe_kernel = phase_moe_kernels(dev)
    with _phase("13 MoE full width"):
        phase_moe_full_width(dev)
    with _phase("14 MoE serve"):
        moe_kernel["launches"] = phase_serve(dev, "qwen2-moe-a2.7b")[
            "moe_gmm"]
    kernels.append(moe_kernel)
    with _phase("15 MoE engine"):
        phase_engine_reference(dev, "qwen2-moe-a2.7b")
    with _phase("16 K7"):
        ssd_kernel = phase_ssd_kernels(dev, args.parent)
    with _phase("17 SSM full width"):
        phase_ssm_full_width(dev)
    with _phase("18 SSM serve"):
        ssd_kernel["launches"] = phase_serve(dev, "mamba2-1.3b")["ssd_scan"]
    kernels.append(ssd_kernel)
    with _phase("19 SSM and hybrid engines"):
        phase_engine_reference(dev, "mamba2-1.3b")
        phase_engine_reference(dev, "jamba-1.5-large-398b")
    with _phase("20 encdec and VLM kernels"):
        side_kernels = phase_encdec_vlm_kernels(dev)
    with _phase("21-22 encdec and VLM full width"):
        phase_side_input_full_width(dev, "whisper-large-v3", 2)
        phase_side_input_full_width(dev, "internvl2-26b", 2)
    with _phase("23 encdec and VLM paths"):
        path = {"whisper": phase_side_input_path(
                    dev, "whisper-large-v3", 4, 4, 32, WHISPER_MAX_SEQ),
                "internvl": phase_side_input_path(
                    dev, "internvl2-26b", 2, 24, 16, 0)}
    for k in side_kernels:
        name, which = k["name"].split(":")
        k["launches"] = path[which][name]
    kernels += side_kernels
    with _phase("24 train tiny"):
        train_tiny = phase_train_tiny(dev)
    with _phase("25 train full width"):
        phase_train_full_width_check(dev)
    with _phase("26 train path"):
        train_path = phase_train_path(dev)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, \
            _phase("27 restart"):
        phase_train_restart(dev, Path(tmp))
    # K1's and K2's launches on the mesh path beside their own paths'
    with _phase("28 mesh"):
        mesh_k2 = phase_mesh(dev, W, ov_width)
    for k in kernels:
        if k["name"] == kernel.NAME:
            k["mesh_launches"] = mesh_k1
            k["mesh_path"] = (f"run_sim at mesh_shards=8, "
                              f"{min(MESH_SIM_APPS, args.sim_apps)} apps")
        elif k["name"] == kernel.PHASE_NAME:
            k["mesh_launches"] = mesh_k2
            k["mesh_path"] = "6 mesh ticks at 8 shards, 16,384 slots"
    with _phase("29 EP"):
        phase_ep_check(dev)
        kernels.append(phase_ep_path(dev))
        phase_ep_train(dev)
    with _phase("30 remat"):
        phase_remat(dev)
    # across processes: NCCL at one rank here, then gloo worlds on cuda:0
    with _phase("32 process NCCL"):
        nccl = phase_process_nccl(dev, W)
    with _phase("33-35 processes"):
        proc = phase_processes(W, min(MESH_SIM_APPS, args.sim_apps))
    # the GSPMD paths' K5 partial mode (phases 36-38, run first)
    kernels.append(partial)
    for k in kernels:
        if k["name"] == kernel.NAME:
            k["process_launches"] = {"mesh ticks, NCCL, 1 rank": nccl[1],
                                     **proc["K1"]}
        elif k["name"] == kernel.PHASE_NAME:
            k["process_launches"] = {"mesh ticks, NCCL, 1 rank": nccl[2],
                                     **proc["K2"]}
        elif k["name"] == "moe_gmm:ep":
            k["process_launches"] = {
                "EP layer (1, 1), NCCL, 1 rank": nccl[0],
                **{f"EP prefill {shape}, gloo, per rank": v
                   for shape, v in proc["moe_gmm"].items()}}
    for k in kernels:
        if k["name"] in gspmd:
            k["process_launches"] = gspmd[k["name"]]
    # each model kernel's launches on the train path beside its own path's:
    # K3 and K4 on phase 26's Llama-3-8B, K6 and K7 on phase 24's families
    for k in kernels:
        if k["name"] in ("rmsnorm", "flash_attention"):
            k["train_launches"] = train_path[k["name"]]
            k["train_path"] = "llama3-8b training, 8 layers, 4 steps"
        elif k["name"] in ("moe_gmm", "ssd_scan"):
            k["train_launches"] = train_tiny[k["name"]]
            k["train_path"] = "one training step of each tiny family"
    return _finish(kernels, t0)


def _finish(kernels, t0) -> int:
    """The kernels line, the card's name and power limit, and the last
    line."""
    import torch
    log(f"[phases] {json.dumps({k: round(v, 1) for k, v in PHASE_S.items()})}")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
