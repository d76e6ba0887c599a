#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,kernels --out DIR

Phases, one report line each (details go to ``<out>/chip_smoke.json``,
default ``build/chip_smoke/``):

1. ``build``    -- compile every CUDA kernel of the served paths from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once) and print
   the card's name and power limit.
2. ``kernels``  -- hold ``kraken_gemm`` and ``paged_decode_attention``
   against their plain PyTorch versions on the card at the yi-6b main-path
   shapes, in bfloat16 and float32, and time them (CUDA events) beside the
   plain version, one library call and the bound; ``kraken_gemm`` also at
   the edge cases of ``repro_torch/core/gemm_cases.py`` (M 1, a split at
   decode, M 65, K 27 and 363 and N 123, which TMA refuses, a ragged K) and
   every epilogue at ragged shapes (and llama-3.2-vision-11b's cross K/V
   projection of 1601 patches, musicgen-large's bias + gelu MLP); the
   decode-step GEMMs of rwkv6-3b, zamba2-1.2b, llama-3.2-vision-11b and
   musicgen-large are timed too.  Each GEMM runs twice and must give the
   same bits; its plan, TFLOP/s, GB/s and ratios to ``torch.matmul`` and
   the bound are logged, and every case is checked before a miss fails the
   phase with the largest atol it needs.  ``paged_decode_attention`` runs
   every ``PAGED_CASES`` entry of ``repro_torch/core/attention_cases.py``
   (yi-6b, its int8 pools and mixtral at 1, 4 and 64 slots, zamba2's
   shared block, which is musicgen-large's geometry, and
   llama-3.2-vision-11b at 4 and 64; a ring wrap, a
   window, dead slots, sentinels mid-table, shapes TMA refuses) in each of
   its pool dtypes: within ``ATTN_TOL``, dead slots exactly zero, two calls
   bit-identical and the same bits with Inf and NaN in every dead entry and
   the trash page; its plan and the largest atol needed are logged, and the
   serve shapes are timed event-timed and device-only (CUDA-graph replay).
3. ``moe_kernels`` -- the same for ``grouped_moe_gemm`` at the mixtral and
   llama4 expert shapes of ``repro_torch/core/moe_cases.py``, decode and
   mixed-step capacities, bfloat16, float32 and int8 (exact), with skewed,
   empty, past-capacity and all-empty sizes and garbage in the dead rows,
   and in bf16 at its edge cases (a split of d, two m tiles, negative
   sizes, Inf in the dead rows, the tile route); rows past the sizes
   exactly zero, two calls bit-identical, the plan logged, every case
   checked before a miss fails the phase with the largest atol it needs;
   timed event-timed and device-only beside ``torch.bmm``, and summed per
   mixtral decode and mixed step against the bound; then the two other
   kernels at the mixtral path's shapes.
4. ``serve``    -- serve full-width, full-depth yi-6b (bf16, seeded random
   weights) through ``repro_torch``'s PagedEngine: 4 slots, page 16,
   max_len 512, chunk 64, 8 requests of 17-300 prompt tokens, 16 new tokens,
   twice through one engine; every kernel of the path must have launched.
   Then the serving state protocol's whole-prompt scatter: the first 4
   prompts prefilled whole into ``init_caches(4, 138,
   clamp_window=False)`` and written by ``StateTree.scatter_prefill`` into
   fresh pools of the engine's geometry, against the same prompts through
   the chunked mixed step into other fresh pools: every live entry at the
   same position, K/V within ``E2E_TOL`` of the largest, one decode step
   from each within ``E2E_TOL`` (32 ``paged_decode_attention`` launches
   each).
   ``serve_features`` -- the serving features on the serve phase's weights
   (their first 8 layers, to keep the whole script near 780 s) and engine
   geometry, one fresh engine per workload: a 128-token prefix
   shared by 8 requests with the prefix cache (hit rate above 0); 6
   class-1 requests and, 8 steps later, 2 class-0 ones with preemption (at
   least one); prompts repeating a 32-token segment with ``--speculate 4``
   (the n-gram drafter; decode rides the mixed program, so the paged
   kernel does not launch); the serve workload under a seeded fault plan
   with the watchdog (its at-drain sweep green); the serve workload sampled
   at T 0.8, twice from one seed (the same tokens).  Each serves every
   request the faults did not fail, leaks no page, adds no signature on a
   warm second pass and launches ``kraken_gemm`` and
   ``paged_decode_attention`` exactly as its steps require; tok/s,
   preemptions, hit and accept rates are reported, and token identity with
   the feature-off engine in bf16.  Then the gate: the four feature
   workloads in float32, yi-6b at full width cut to 4 layers and
   zamba2-1.2b at full width and depth, token-identical to the feature-off
   engine.
5. ``e2e``      -- one mixed step's and one decode step's logits through the
   kernels and again through the plain versions, on the card.
6. ``profile``  -- ``torch.profiler`` over one more pass of the serve
   phase's warm engine: device time by kernel and the device's busy share
   (and, with ``moe_serve``, over one more warm mixtral pass; with
   ``swa_forward``, over one more gemma3-12b forward).
   ``tune`` -- the tile tuner, ``serve --autotune --tile-cache`` on the
   card (``launch.serve.warm_tile_cache``): yi-6b's 10 ``kraken_gemm``
   cells and its ``paged_decode_attention`` geometry tuned into a fresh
   cache file, every timed candidate first held against the plain version
   within its kernel's tolerance (a fast but wrong plan fails the phase),
   each cell's planner pick, winner and both device times printed; a
   second warm-up from the file must print ``11/11 cells hit — fully
   warm``.  Then ``grouped_moe_gemm`` at mixtral-8x22b's two cell widths,
   ``kraken_conv2d_direct``'s (BN, split) at VGG-16's conv layers at batch
   1 and 32, and the decode cells of rwkv6-3b and musicgen-large (with
   the G = 1 paged geometry), all on random operands.  Last, the serve
   phase's weights served in mode ``cached``: every logit finite, zero new
   signatures warm, every launch on its cached winner (the plans
   ``_launch_plan`` saw); tok/s and bf16 token agreement with the serve
   phase's model-plan engine reported.
7. ``moe_serve`` -- release yi-6b, then serve mixtral-8x22b at full width
   and 8 of its 56 layers (20.4 B parameters, bf16) with the same engine
   and traffic; every MoE layer's expert FFN must go through
   ``grouped_moe_gemm``, three launches per layer per step.  Then
   ``repro_torch.examples.long_context``'s ``run`` on those weights: batch
   2, a 32-entry cache, 64 decode steps past it; every logit finite, the
   allocated bytes the same after the last step as after the first, 33
   ``kraken_gemm`` and 24 ``grouped_moe_gemm`` launches a step.
8. ``moe_e2e``  -- every MoE layer of one mixed and one decode step fed the
   same input through the kernel block and the plain block (one of them
   under ``torch.cuda.set_sync_debug_mode("error")``), then the whole
   model's logits, kernels against plain versions, with the routing
   choices that differ counted.
9. ``dense_kernels`` -- ``decode_attention`` against its plain version at
   the yi-6b decode shape (32/4 heads of 128, 4 slots, a 512-slot dense
   cache), bfloat16, float32 and int8: per-slot positions with a wrapped
   ring, shared positions, a window, a ragged S and an all-empty row (exact
   zeros); then int8 at ``dense_serve``'s shape (one slot, each prompt's
   middle decode position).  Each case runs twice and must give the same
   bits; its plan (splits, blocks) is logged.  Timed, event-timed and
   device-only (CUDA-graph replay), beside the plain version, one
   ``F.scaled_dot_product_attention`` on the bf16 cache and the bound.
10. ``dense_serve`` -- full-width, full-depth yi-6b with int8 KV (bf16,
   the serve phase's weights): the serve workload's 8 requests one by one
   through ``init_caches``, ``prefill`` and ``decode_step`` (32
   ``decode_attention`` launches per decode step), then through an int8
   ``PagedEngine`` (int8 pools, ``paged_decode_attention``); tok/s of both.
11. ``dense_e2e`` -- one int8 dense decode step's logits at full width,
   kernels against plain versions; then, in float32 at 2 layers, the int8
   engine (whole-prompt prefill) token-identical to the int8 dense
   sequential path.
12. ``swa_kernels`` -- ``swa_attention`` against its plain version at
   gemma3-12b's local-layer shape (16/8 heads of 240, S 4096, window 1024)
   and mixtral's (48/8 heads of 128, S 2048 under its 4096 window), in
   bfloat16 and float32, plus edge windows (1, 16, 100), a ragged S with
   a head dim that is no multiple of 16, and in bfloat16 every head-dim
   class (D 40, 64, 128, 240) under windows 1, 16, 100, 1024 and 4096.
   Each case's plan is logged; timed, event-timed and device-only, beside
   the plain version, one ``F.scaled_dot_product_attention`` with a boolean
   band mask and the bound.  Then the backward, ``swa_attention_bwd``, on
   the forward kernel's own output and lse at every ``SWA_BWD_CASES`` entry
   (gemma3-12b's local layer at B 2, mixtral's at S 8192 past its window,
   windows 1, 16, 100 and past S, a ragged S, D 40, 64, 128 and 240), in
   bfloat16 and float32: dq, dk and dv against the plain backward within
   ``SWA_BWD_TOL``, the plain backward against autograd through the plain
   forward, two calls with the same bits, the forward's output with the same
   bits with and without the lse and its lse against the plain one; the two
   train shapes in bf16 timed beside the plain backward, SDPA's backward and
   the bound.
13. ``swa_forward`` -- release every earlier model, then gemma3-12b's
   cache-less forward at full width and all 48 layers (11.6 B parameters,
   bf16, seeded random weights) on 4096 random tokens: ``Model.forward``
   and ``Model.loss`` timed warm, exactly 40 ``swa_attention`` and 337
   ``kraken_gemm`` launches per forward; its logits against the same
   forward with only ``swa_attention`` swapped for its plain version, and
   its last row against ``Model.prefill`` into a dense cache (which runs the
   local layers through the chunked attention instead); then one period
   (6 layers) in float32, kernel against plain.
14. ``conv_kernels`` -- ``kraken_conv2d_direct`` against its plain version
   at every distinct conv geometry of AlexNet, VGG-16 and ResNet-50 (per
   group; 5 + 9 + 20), at batch 1 in bfloat16 and float32 and at batch 32
   in bfloat16, plus edge cases (R 1, 3 and 16, C_i 3 packed at K 3 / S 1
   and K 11 / S 4, a ragged C_i chunk that TMA cannot take (C_i 100) and
   C_o tile, an odd C_i (35) that TMA cannot take either, a stride that
   leaves rows over, odd OH at N > 1, asymmetric padding, bf16 in and f32
   out, a split over C_i at batch 1, 7 x 7 maps at N 3) and an Inf in the
   input (packed and not), which must reach exactly the outputs whose
   window holds it.  Each case runs twice and must give the same bits;
   its plan (tile, ring stages, split, shared memory, blocks) is logged.  Timed
   beside the plain version, one cuDNN ``F.conv2d`` (channels_last, TF32
   off) and the bound, with the TFLOP/s on in-bounds taps and the ratio to
   cuDNN.
15. ``conv_nets`` -- each network's conv layers in order, one layer at a
   time as in the paper's Table V, at batch 1 and 32 in bfloat16: through
   the direct kernel (exactly 8 / 13 / 53 launches per frame), through the
   im2col route (``kraken_gemm``, as many launches) and through cuDNN;
   frames per second of each route, both kernel routes against the plain
   version, the peak allocation, and a ``torch.profiler`` trace of VGG-16
   frames at each batch.

``examples`` -- ``repro_torch.examples`` through their entry points on
   small models: ``kraken_paper``'s printed lines as on the CPU;
   ``quickstart`` (smoke yi-6b: losses finite and falling, 9 tokens,
   ``kraken_gemm`` launched as counted); ``serve_lm --repeat 2`` for yi-6b,
   mixtral-8x22b, rwkv6-3b and zamba2-1.2b (every request served, no new
   signature warm, ``paged_decode_attention`` and ``grouped_moe_gemm``
   exactly where the arch needs them); ``long_context`` at JAX's smoke
   sizes; ``train_lm``'s 300 steps of yi-100m (float32, batch 8 x 256):
   every loss and grad norm finite, no restart, checkpoints 100/200/300,
   the last logged loss 1 nat under the first, 267 ``kraken_gemm`` a step;
   then ``kraken_gemm``'s float32 route at train_lm's cells (the forward
   and both backward products) against the plain version, timed.
16. ``recurrence`` -- one full-width float32 layer of each recurrent
   mixer (rwkv6-3b's RWKV6 time mix, zamba2-1.2b's Mamba2 block, seeded
   weights with the reference's init scaling) over 300 tokens, rows of 300
   and 217: the chunked mix finite and within ``RECUR_TOL`` of max |want|
   of a token-by-token loop of the same layer's step, outputs and final
   states; both timed.
17. ``rwkv_serve`` -- release the earlier models, then serve rwkv6-3b at
   full width and depth (32 layers, bf16, seeded weights) with the serve
   phase's engine and traffic: every logit finite, zero new signatures
   when warm, exactly 289 ``kraken_gemm`` launches a step (the channel
   mix's ReLU in its epilogue); then the 8 requests one at a time through
   ``init_caches`` / ``prefill`` / ``decode_step``, counting the requests
   token-identical to the engine's (reported); then the long_context
   example's ``run`` at full width as ``moe_serve`` runs it (289
   ``kraken_gemm`` a step).  With ``profile``, a traced warm pass (the
   device activity alone) whose ``recurrence`` group holds the kernels
   that ran between the ranges' marker kernels (``range_markers``).
18. ``rwkv_e2e`` -- one mixed and one decode step of rwkv6-3b, kernels
   against plain versions: in bf16 on the served weights (reported: the
   model at this init amplifies a last-ulp difference, see
   ``recurrent_e2e``) and in float32 at full depth, within ``E2E_TOL``;
   in bf16 every recurrent layer of both steps at shared inputs, kernels
   against plain versions, within ``RECUR_LAYER_TOL`` (and a planted fault
   in one layer must fail that gate), and the whole-model gap again with a
   seeded nonzero RWKV bonus (reported); then in float32 at 2 layers the
   engine token-identical to the sequential path on the serve workload's 8
   requests.
19. ``zamba_serve``, ``zamba_e2e`` -- the same for zamba2-1.2b (38 Mamba2
   layers and 6 calls of the weight-shared attention block): 119
   ``kraken_gemm`` launches a step and 6 ``paged_decode_attention``
   launches a decode step (32/32 heads of 64); its float32 engine check
   runs 7 layers (one period and the shared block, one tail layer).
20. ``vlm_serve`` -- release the earlier models, then serve
   llama-3.2-vision-11b at full width and depth (40 layers, 8 of them
   cross attention; 9.78 B parameters, bf16, seeded weights) with the
   serve phase's engine and traffic, text-only as the reference's engine
   serves: every logit finite, zero new signatures when warm, exactly 265
   ``kraken_gemm`` launches a step and 32 ``paged_decode_attention``
   launches a decode step, and every cross row still exactly zero; then
   the first 2 requests one at a time through ``init_caches`` /
   ``prefill`` / ``decode_step`` with seeded image patches [1, 1601, 4096]
   (the cross rows filled, each prefill's 8 cross K/V projections counted)
   and again without: tok/s of both, and the patches must move the first
   token's logits.  With ``profile``, a traced warm engine pass.
21. ``vlm_e2e`` -- bf16 on the served weights, kernels against plain
   versions within ``E2E_TOL``: one mixed and one decode step, and one
   prefill with the patches; then in float32 at 5 layers (one period, its
   cross layer included) the engine token-identical to the sequential
   path on the serve workload's 8 requests.
22. ``audio_serve``, ``audio_e2e`` -- the same for musicgen-large (48
   layers, d 2048, 32/32 heads of 64, LayerNorm, sinusoidal positions, the
   gelu MLP with biases in ``kraken_gemm``'s epilogue; 2.43 B parameters):
   289 ``kraken_gemm`` launches a step, 48 ``paged_decode_attention`` a
   decode step; on the dense path seeded audio frames [1, S, 2048] are
   added in the prefill and [1, 1, 2048] at each decode step; its float32
   gate runs 2 layers.
23. ``train`` -- release every earlier model, then the gradient of
   ``kraken_matmul`` (``ops.KrakenMatmul``: its forward and both backward
   products on ``kraken_gemm``) at yi-6b's training cells (M 1024: q/o,
   k/v, the silu gate, up, down, the unembed), musicgen-large's bias +
   gelu and rwkv6-3b's relu widths and a ragged M 65 / K 27 / N 123 with
   every epilogue, in bfloat16 and float32: the output, dA, dB and dbias
   against autograd through ``ref.matmul`` within ``GEMM_TOL`` at unit
   scale, a second forward and backward with the same bits, the launches counted; at M 1024
   in bf16 the two backward products timed event-timed and device-only
   beside ``torch.matmul`` and the bound, the operand transposes and the
   z relaunch apart.  Then full-width, full-depth yi-6b (bf16 parameters,
   fp32 AdamW moments) takes 3 steps of batch 8 x seq 128 from
   ``SyntheticLM`` through ``launch/steps.make_train_step`` (remat
   ``"full"``): every loss and grad norm finite, exactly
   ``train_launches()`` (931) ``kraken_gemm`` launches a step and nothing
   else, the step time and the peak allocation (which must leave 4 GB
   free); one more step traced (device time by kernel group, AdamW's
   kernels apart).  Then one step's gradients at full width and 2 layers,
   kernels (remat "none" and "full") against plain versions: each leaf
   within 1e-4 relative L2 in float32 (gated; bf16 reported).  Last, ``python -m repro_torch.launch.train
   --arch yi-6b --smoke`` on the card: 12 steps with a failure injected at
   step 8 (restored from step 5), then a second invocation resuming from
   step 12; its checkpoint is kept for ``mesh``.
    ``swa_train`` -- release every earlier model, then gemma3-12b at
   full width and one period (5 local + 1 global layer, 2.33 B parameters,
   bf16, fp32 AdamW moments) takes 3 steps of batch 2 x seq 4096 from
   ``SyntheticLM`` through ``make_train_step`` (remat ``"full"``): every
   loss and grad norm finite, exactly 177 ``kraken_gemm``, 10
   ``swa_attention`` (5 and 5 recomputed) and 5 ``swa_attention_bwd``
   launches a step, the step time and the peak (4 GB left free); one more
   step traced.  The float32 gate: that period's gradients at batch 1 x
   seq 2048, kernels (remat "none" and "full") against plain versions,
   each leaf within 1e-4 relative L2.  mixtral-8x22b at full width and one
   layer (2.9 B) takes 2 steps of batch 1 x seq 8192, past its 4096
   window: finite, 19 ``kraken_gemm``, 2 + 1 swa launches and no
   ``grouped_moe_gemm`` (the einsum experts under grad).  Last,
   ``launch/train.py --arch gemma3-12b --smoke`` (seq 128, window 8) for 6
   steps and again resuming from step 6.
24. ``mesh`` -- a real one-rank NCCL group and a ``(1, 1)`` ``DeviceMesh``
   on the card.  Full-width bf16 yi-6b (the serve phase's init and seed):
   a prefill of 4 x 64 tokens and 4 decode steps through
   ``make_prefill_step`` / ``make_decode_step``, unsharded and with the
   parameters, caches and inputs as DTensors under ``RULES_SINGLE_POD``:
   the logits bit for bit, ``kraken_gemm`` launched on the local shards
   (through ``dense_gemm``'s sharding rule) as many times as the steps
   need; the unsharded warm decode step timed.  Two train steps at yi-6b's
   width and 2 layers, unsharded and under the mesh with ZeRO-1 moments:
   losses and parameters bit for bit, the same launches.
   ``allreduce_compressed`` over NCCL equals the local compress and
   decompress; the train phase's checkpoint (written through the launcher
   when ``train`` did not run) restores onto the mesh equal.
25. ``roofline`` -- ``repro_torch.launch.dryrun`` walks the yi-6b decode
   step of ``mesh`` and the full-width train step of ``train`` on a fake
   ``(1, 1)`` mesh (the plain versions; every GEMM counted as one
   ``dense_gemm``); beside their measured times: t_compute, t_memory, the
   bound, its share and MFU against ``PEAK_BF16``, with the card's name
   and power limit.  Reported, but a share of the bound above 1.05 fails.
26. ``dryrun`` -- ``repro_torch.launch.dryrun`` on yi-6b ``train_4k`` and
   ``decode_32k`` over 16x16 and mixtral-8x22b ``train_4k`` over 2x16x16
   (the train cells cut to ``DRYRUN_TRAIN_LAYERS`` layers), three
   processes at once on the host's CPU (started with ``roofline``'s two
   when both phases run), each with a fake process group of 256 or 512
   ranks: per-device bytes, collectives, the bottleneck and the roofline
   fraction; a ``"status": "fail"`` fails the phase.

Phases run in the order ``build, kernels, moe_kernels, dense_kernels,
swa_kernels, conv_kernels, examples, recurrence, serve, serve_features, e2e,
profile, tune, dense_serve, dense_e2e, moe_serve, moe_e2e, swa_forward,
conv_nets, rwkv_serve, rwkv_e2e, zamba_serve, zamba_e2e, vlm_serve,
vlm_e2e, audio_serve, audio_e2e, train, swa_train, mesh, roofline,
dryrun``.

The line before the last is the kernels' JSON record; the last line is the
device record.  Any failure raises and the exit code is not 0; without a
CUDA device the script exits 2 before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (dense): bf16 tensor cores, fp32 outside
# them, int8, and HBM3 bandwidth; their one home is the port's roofline
from repro_torch.roofline.analysis import (  # noqa: E402
    PEAK_BF16, PEAK_BYTES, PEAK_FP32, PEAK_INT8)

# yi-6b main-path widths: d_model 4096, 32 heads / 4 KV heads of 128,
# d_ff 11008, vocab 64000; serving at 4 slots x chunk 64
HEADS, KV_HEADS, HEAD_DIM, LAYERS = 32, 4, 128, 32
SLOTS, CHUNK, PAGE, MAX_LEN = 4, 64, 16, 512
# the serve workload: 8 prompts of 17..300 tokens, 16 new tokens each
SERVE_LENS = [round(17 + i * (300 - 17) / 7) for i in range(8)]
SERVE_NEW = 16
# kraken_gemm's shapes (yi-6b's GEMMS, mixtral's MIXTRAL_GEMMS, gemma3's
# GEMMA_GEMMS and the edge cases) are repro_torch.core.gemm_cases's: the CPU
# tests plan the same cases.
# mixtral-8x22b served at full width and MOE_LAYERS of its 56 layers;
# grouped_moe_gemm's cases (MOE_CASES, MIXED_USES, MOE_EDGE) are
# repro_torch.core.moe_cases's: the card tests and the CPU plan tests read
# the same.  GEMM_TOL, kraken_gemm's and grouped_moe_gemm's tolerance, is
# repro_torch.core.gemm_cases's.
MOE_LAYERS = 8
# paged_decode_attention's, decode_attention's and swa_attention's cases
# and tolerances (PAGED_CASES, ATTN_TOL, DECODE_TOL, SWA_TOL, SWA_ROW_KEYS)
# are repro_torch.core.attention_cases's: the card tests hold the kernels to
# the same, and the CPU tests plan the same cases.  The mixtral path's
# paged_decode_attention case is its "mixtral 4 slots" (48/8 heads of 128
# under the 4096 window).
MIXTRAL_PAGED = "mixtral 4 slots"
E2E_TOL = 0.05   # max |kernel - plain| <= E2E_TOL * max |plain| on bf16 logits
# gemma3-12b (``GEMMA3_12B``): 48 layers = 8 periods of 5 local (window
# 1024) + 1 global; 16/8 heads of 240; the forward's sequence length
SWA_SEQ = 4096
GEMMA_LAYERS, GEMMA_LOCAL, GEMMA_PERIOD = 48, 40, 6
# the float32 one-period forward, kernel against plain: both run the same
# float32 kraken_gemm, so only the attention's sum order differs (~1e-6)
F32_E2E_TOL = 1e-4
# the conv path: the networks, batches, R, edge cases and geometries are
# repro_torch.core.conv_cases's (the CPU tests plan the same cases).
# kraken_conv2d_direct launches per frame: AlexNet's grouped layers run one
# call per group, ResNet-50's repeated blocks one per repeat
CONV_FRAME_LAUNCHES = {"alexnet": 8, "vgg16": 13, "resnet50": 53}
# profiler sessions conv_trace may take to get a whole trace of its frames
CONV_TRACE_ATTEMPTS = 3
# CONV_TOL, kraken_conv2d_direct's and the im2col route's tolerance against
# ref.conv2d, is repro_torch.core.conv_cases's (the tile tuner holds every
# conv candidate to it too)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after one warm-up call)."""
    import torch
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


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Mean device time of one call of ``fn``: ``calls`` consecutive calls
    captured in one CUDA graph and replayed ``replays`` times (CUDA events),
    so the host's cost of a call is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def rotating(make, nbytes: int, budget: int = 160 << 20, most: int = 32):
    """Enough copies of an operand (at most ``most``) that cycling through
    them exceeds the 50 MB L2, as a decode step's distinct layer weights
    do."""
    n = max(1, min(most, -(-budget // max(1, nbytes))))
    return [make() for _ in range(n)]


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def assert_close(name, got, want, atol, rtol) -> float:
    import torch
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    if (err > lim).any():
        raise AssertionError(
            f"{name}: max |err| {err.max().item():.3e} exceeds "
            f"atol={atol} rtol={rtol}")
    return float(err.max().item())


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def ptxas_by_function(log_text: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {function: [its register and spill
    lines]}."""
    out, fn = {}, None
    for ln in log_text.splitlines():
        if "Function properties for " in ln:
            fn = ln.split("Function properties for ", 1)[1].strip()
        elif "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else fn
        if fn and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.strip())
    return out


def phase_build(rec: dict, state: dict) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build(["kraken_gemm", "paged_attention",
                           "grouped_moe_gemm", "decode_attention",
                           "swa_attention", "swa_attention_bwd",
                           "kraken_conv"], force=True)
    secs = time.perf_counter() - t0
    for name, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        rec.setdefault("build", {})[name] = {"seconds": r["seconds"],
                                             "ptxas": regs}
        for ln in regs:
            log(f"  ptxas {name}: {ln}")
    # the bf16 conv kernel's accumulators live in registers: a spill fails
    # the build; whether ptxas serialised its wgmma (C7520) is logged
    conv = ptxas_by_function(report["kraken_conv"]["log"])
    wgmma = {fn: lines for fn, lines in conv.items()
             if "kraken_conv_kernel" in fn}
    if len(wgmma) != 4 or any(" 0 bytes spill stores" not in " ".join(v)
                              for v in wgmma.values()):
        raise AssertionError(f"kraken_conv_kernel variants: {wgmma}")
    serial = "C7520" in report["kraken_conv"]["log"]
    rec["build"]["kraken_conv"]["wgmma_serialised"] = serial
    # kraken_gemm's six bf16 variants: no spill, no serialised wgmma; the
    # two-consumer (BM 128) ones hand registers over with setmaxnreg, which
    # needs the kernel at its launch-bound count, 168 a thread at 384
    gemm = {fn: lines for fn, lines in
            ptxas_by_function(report["kraken_gemm"]["log"]).items()
            if "kraken_gemm_wgmma" in fn}
    if len(gemm) != 6 or any(" 0 bytes spill stores" not in " ".join(v)
                             for v in gemm.values()):
        raise AssertionError(f"kraken_gemm_wgmma variants: {gemm}")
    for fn, lines in gemm.items():
        if "ILi128E" in fn and "Used 168 registers" not in " ".join(lines):
            raise AssertionError(f"{fn}: setmaxnreg needs 168 registers at "
                                 f"entry: {lines}")
    # its float32 kernel: two blocks an SM (128 registers), no spill
    fma = {fn: lines for fn, lines in
           ptxas_by_function(report["kraken_gemm"]["log"]).items()
           if "kraken_gemm_fma" in fn}
    if len(fma) != 1 or any(" 0 bytes spill stores" not in " ".join(v)
                            for v in fma.values()):
        raise AssertionError(f"kraken_gemm_fma: {fma}")
    rec["build"]["kraken_gemm"]["fma"] = fma
    gemm_serial = [ln for ln in report["kraken_gemm"]["log"].splitlines()
                   if "C7520" in ln]
    if gemm_serial:
        raise AssertionError(f"ptxas serialised kraken_gemm's wgmma: "
                             f"{gemm_serial}")
    # swa_attention's three bf16 variants (D in 1, 2 or 4 boxes of 64) hand
    # registers over with setmaxnreg too: 168 at entry, no spill, wgmma not
    # serialised; decode_attention's split and combine kernels spill nothing
    swa = ptxas_by_function(report["swa_attention"]["log"])
    swa_wg = {fn: lines for fn, lines in swa.items() if "swa_wgmma" in fn}
    if len(swa_wg) != 3 or any(
            " 0 bytes spill stores" not in " ".join(v)
            or "Used 168 registers" not in " ".join(v)
            for v in swa_wg.values()):
        raise AssertionError(f"swa_wgmma variants: {swa_wg}")
    swa_serial = [ln for ln in report["swa_attention"]["log"].splitlines()
                  if "C7520" in ln]
    if swa_serial:
        raise AssertionError(f"ptxas serialised swa_attention's wgmma: "
                             f"{swa_serial}")
    # grouped_moe_gemm's two wgmma tiles and the split's sum: no spill; the
    # two-consumer (BM 128) tile hands registers over with setmaxnreg, so
    # 168 registers at entry; whether ptxas serialised wgmma is logged
    moe_log = report["grouped_moe_gemm"]["log"]
    moe = {fn: lines for fn, lines in ptxas_by_function(moe_log).items()
           if "grouped_moe_gemm_wgmma" in fn or "grouped_moe_gemm_sum" in fn}
    moe_wg = {fn: lines for fn, lines in moe.items() if "wgmma" in fn}
    if len(moe_wg) != 2 or len(moe) != 3 or any(
            " 0 bytes spill stores" not in " ".join(v) for v in moe.values()):
        raise AssertionError(f"grouped_moe_gemm kernels: {moe}")
    for fn, lines in moe_wg.items():
        if "ILi128E" in fn and "Used 168 registers" not in " ".join(lines):
            raise AssertionError(f"{fn}: setmaxnreg needs 168 registers at "
                                 f"entry: {lines}")
    moe_serial = [ln for ln in moe_log.splitlines() if "C7520" in ln]
    rec["build"]["grouped_moe_gemm"]["wgmma_serialised"] = moe_serial
    for ln in moe_serial:
        log(f"  ptxas grouped_moe_gemm C7520: {ln.strip()}")
    # swa_attention_bwd's six kernels (the delta pass in f32 and bf16, the
    # f32 FMA grid, the bf16 wgmma grid at DP 64, 128 and 256, which hold
    # their dq or dk/dv accumulators in registers): no spill; the wgmma
    # variants hand registers over with setmaxnreg (168 at entry) and their
    # wgmma is not serialised
    bwd_log = report["swa_attention_bwd"]["log"]
    bwd = ptxas_by_function(bwd_log)
    rec["build"]["swa_attention_bwd"]["kernels"] = bwd
    bwd_wg = {fn: v for fn, v in bwd.items() if "swa_bwd_wgmma" in fn}
    if len(bwd) != 6 or len(bwd_wg) != 3 or any(
            " 0 bytes spill stores" not in " ".join(v) for v in bwd.values()
    ) or any("Used 168 registers" not in " ".join(v)
             for v in bwd_wg.values()):
        raise AssertionError(f"swa_attention_bwd kernels: {bwd}")
    bwd_serial = [ln for ln in bwd_log.splitlines() if "C7520" in ln]
    if bwd_serial:
        raise AssertionError(f"ptxas serialised swa_attention_bwd's wgmma: "
                             f"{bwd_serial}")
    dec = ptxas_by_function(report["decode_attention"]["log"])
    if len(dec) != 10 or any(" 0 bytes spill stores" not in " ".join(v)
                             for v in dec.values()):
        raise AssertionError(f"decode_attention kernels: {dec}")
    # paged_decode_attention's eight split variants (four dtype pairs x the
    # tma and ldg routes): the two the engines serve (tma over bf16 pools,
    # and bf16 q over int8 pools) spill nothing
    paged = {fn: lines for fn, lines in
             ptxas_by_function(report["paged_attention"]["log"]).items()
             if "paged_decode_attention_split" in fn}
    paged_tma = {fn: lines for fn, lines in paged.items()
                 if "13__nv_bfloat16S1_Lb1EE" in fn
                 or "13__nv_bfloat16aLb1EE" in fn}
    for fn, lines in paged.items():
        args = fn.split("paged_decode_attention_split", 1)[1].split("EEv")[0]
        log(f"  ptxas paged_attention split{args}: {' | '.join(lines)}")
    if len(paged) != 8 or len(paged_tma) != 2 or any(
            " 0 bytes spill stores" not in " ".join(v)
            for v in paged_tma.values()):
        raise AssertionError(f"paged_decode_attention_split variants: "
                             f"{paged}")
    log(f"build: {len(report)} kernels in {secs:.1f} s (parallel nvcc); "
        f"kraken_conv_kernel's 4 variants (bf16 in) spill nothing; wgmma "
        f"{'SERIALISED by ptxas (C7520)' if serial else 'not serialised'}; "
        "kraken_gemm_wgmma's 6 variants spill nothing, wgmma not "
        "serialised; kraken_gemm_fma spills nothing; swa_wgmma's 3 variants "
        "at 168 registers, no spill, wgmma not serialised; "
        "swa_attention_bwd's 6 kernels spill nothing, swa_bwd_wgmma's 3 at "
        "168 registers, wgmma not serialised; decode_attention's 10 kernels spill nothing; "
        "paged_decode_attention's 2 served tma variants spill nothing; "
        "grouped_moe_gemm's 2 wgmma tiles and its sum spill nothing, the "
        "128 x 128 one at 168 registers, wgmma "
        f"{'SERIALISED by ptxas (C7520)' if moe_serial else 'not serialised'}")
    rec["card"] = card_line()
    log(f"card: {rec['card']}")


# ---------------------------------------------------------------------------
# phase 2: kernel parity + timing
# ---------------------------------------------------------------------------

def gemm_case(torch, kg, ref, m, k, n, act, dtype, *, bias=False,
              timed=True, seed=0, iters=(20, 5, 20)):
    """One ``kraken_gemm`` against ``ref.matmul`` under ``GEMM_TOL``, run
    twice (the two outputs must have the same bits); when ``timed``, the
    kernel's, the plain version's and ``torch.matmul``'s time over
    ``iters`` calls each.  A miss does not raise: the row says ``ok``
    False and the least atol it needs (``check_gemm_rows`` raises)."""
    from repro_torch.core.gemm_cases import GEMM_TOL
    g = torch.Generator(device="cuda").manual_seed(seed)
    isz = torch.tensor([], dtype=dtype).element_size()
    a = torch.randn((m, k), generator=g, device="cuda").to(dtype)

    def make_b():
        return (torch.randn((k, n), generator=g, device="cuda")
                / math.sqrt(k)).to(dtype)

    bs = rotating(make_b, k * n * isz) if timed else [make_b()]
    bv = (torch.randn((n,), generator=g, device="cuda").to(dtype)
          if bias else None)
    got = kg.kraken_gemm(a, bs[0], bias=bv, activation=act)
    again = kg.kraken_gemm(a, bs[0], bias=bv, activation=act)
    want = ref.matmul(a, bs[0], bias=bv, activation=act)
    torch.cuda.synchronize()
    dt = str(dtype).split(".")[-1]
    atol, rtol = GEMM_TOL[dt]
    err = (got.float() - want.float()).abs()
    finite = bool(torch.isfinite(got.float()).all())
    need = (float((err - rtol * want.float().abs()).max().clamp_min(0))
            if finite else math.inf)
    same = torch.equal(got.view(torch.int16) if isz == 2 else got,
                       again.view(torch.int16) if isz == 2 else again)
    q = kg.plan(m, k, n, dtype=dtype, a_align=kg.alignment(a),
                b_align=kg.alignment(bs[0]))
    row = {"m": m, "k": k, "n": n, "act": act, "bias": bias, "dtype": dt,
           "max_abs_err": float(err.max()) if finite else math.inf,
           "atol_needed": need, "same_bits": same,
           "ok": finite and need <= atol and same, "plan": q,
           "plan_text": kg.describe(q)}
    del got, again, want, err
    if timed:
        it = [0]

        def cycle(fn):
            def run():
                it[0] = (it[0] + 1) % len(bs)
                return fn(bs[it[0]])
            return run
        row["ms"] = time_ms(cycle(lambda b: kg.kraken_gemm(
            a, b, bias=bv, activation=act)), iters[0])
        row["plain_ms"] = time_ms(cycle(lambda b: ref.matmul(
            a, b, bias=bv, activation=act)), iters[1])
        row["library_ms"] = time_ms(cycle(lambda b: torch.matmul(a, b)),
                                    iters[2])
        # device time alone, each of the rotating weights once per replay
        row["device_ms"] = graph_ms(cycle(lambda b: kg.kraken_gemm(
            a, b, bias=bv, activation=act)), len(bs))
        row["device_library_ms"] = graph_ms(
            cycle(lambda b: torch.matmul(a, b)), len(bs))
        nbytes = (m * k + k * n + m * n) * isz + (n * isz if bias else 0)
        flops = 2.0 * m * n * k
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, peak)
        row["tflop_s"] = flops / row["ms"] / 1e9
        row["gb_s"] = nbytes / row["ms"] / 1e6
        row["x_matmul"] = row["ms"] / row["library_ms"]
        row["x_bound"] = row["ms"] / row["bound_ms"]
    return row


def gemm_line(label: str, r: dict) -> str:
    """One log line of a ``gemm_case`` row: error, plan and, when timed,
    time beside the plain version, torch.matmul and the bound."""
    out = (f"  {label} M={r['m']:<5d} K={r['k']:<5d} N={r['n']:<6d} "
           f"{r['dtype']:8s} err={r['max_abs_err']:.2e} "
           f"atol_needed={r['atol_needed']:.2e}"
           f"{'' if r['same_bits'] else ' BITS DIFFER'} [{r['plan_text']}]")
    if "ms" in r:
        out += (f" ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
                f"matmul={r['library_ms']:.4f} bound={r['bound_ms']:.4f} "
                f"{r['tflop_s']:.1f} TFLOP/s {r['gb_s']:.0f} GB/s "
                f"x_matmul={r['x_matmul']:.2f} x_bound={r['x_bound']:.2f}; "
                f"device (graph) {r['device_ms']:.4f} matmul "
                f"{r['device_library_ms']:.4f}")
    return out


def check_gemm_rows(label: str, rows: list) -> None:
    """Raise, after every case has run, if any ``gemm_case`` row missed
    ``GEMM_TOL`` or gave other bits on its second run."""
    bad = [r for r in rows if not r["ok"]]
    if bad:
        need = max(r["atol_needed"] for r in bad)
        raise AssertionError(
            f"{label}: kraken_gemm fails {len(bad)} of {len(rows)} cases "
            f"(largest atol needed {need:.3e}): "
            + "; ".join(f"{r['m']}x{r['k']}x{r['n']} {r['dtype']} "
                        f"{r['act']} bias={r['bias']} need "
                        f"{r['atol_needed']:.2e} same_bits={r['same_bits']}"
                        for r in bad[:12]))


def paged_case(torch, pa, ref, case, dtype: str, *, seed=0):
    """One ``PAGED_CASES`` entry with pools of ``dtype`` against
    ``ref.paged_decode_attention`` under ``ATTN_TOL``: the dead slots exact
    zeros, two calls bit-identical, and the same bits again with Inf in K
    and NaN in V (int8: in their scales) at every entry no slot attends to,
    the unreferenced pages and the trash page.  When the case is timed, the
    kernel's and the plain version's time event-timed (host included) and
    the kernel's device-only (``graph_ms``), and the bound from this run's
    live pages.  A miss does not raise: the row says ``ok`` False and the
    least atol it needs (``check_paged``)."""
    from repro_torch.core.attention_cases import ATTN_TOL, paged_pool
    name, b, h, kvh, d, ps, mp, _, window, q_pos, dead, _, timed, _ = case
    quant = dtype == "int8"
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    kvdt = torch.int8 if quant else qdt

    def on_card(x):
        n = x["n_pages"]
        put = lambda a: torch.from_numpy(a).to("cuda")  # noqa: E731
        sc = {key: put(x[key])[:n] if quant else None
              for key in ("k_scale", "v_scale")}
        return (put(x["q"]).to(qdt), put(x["k"]).to(kvdt)[:n],
                put(x["v"]).to(kvdt)[:n],
                dict(pos_pages=put(x["pos"])[:n], page_table=put(x["table"]),
                     q_pos=put(x["q_pos"]), window=window, **sc))

    x = paged_pool(case, dtype, seed)
    q, k, v, kw = on_card(x)
    got = pa.paged_decode_attention(q, k, v, **kw)
    again = pa.paged_decode_attention(q, k, v, **kw)
    want = ref.paged_decode_attention(q, k, v, **kw)
    y = on_card(paged_pool(case, dtype, seed, nonfinite=True))
    inf = pa.paged_decode_attention(y[0], y[1], y[2], **y[3])
    torch.cuda.synchronize()
    del y
    atol, rtol = ATTN_TOL[str(qdt).split(".")[-1]]
    err = (got.float() - want.float()).abs()
    finite = bool(torch.isfinite(got.float()).all())
    need = (float((err - rtol * want.float().abs()).max().clamp_min(0))
            if finite else math.inf)
    bits = lambda t: t.view(torch.uint8)  # noqa: E731
    same = torch.equal(bits(got), bits(again))
    inf_same = torch.equal(bits(got), bits(inf))
    dead_zero = all(got[i].abs().max().item() == 0.0 for i in dead)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = pa.plan(b, h, kvh, d, ps, mp, kvdt, sms=sms)
    row = {"name": name, "dtype": dtype, "b": b, "window": window,
           "max_abs_err": float(err.max()) if finite else math.inf,
           "atol_needed": need, "same_bits": same,
           "inf_dead_same_bits": inf_same, "dead_slots_zero": dead_zero,
           "ok": finite and need <= atol and same and inf_same and dead_zero,
           "plan": plan, "plan_text": pa.describe(plan), "ms": None,
           "device_ms": None, "plain_ms": None, "library_ms": None,
           "bound_ms": None, "bound_by": None}
    del got, again, want, inf, err
    if not timed:
        return row

    def kernel():
        return pa.paged_decode_attention(q, k, v, **kw)

    row["ms"] = time_ms(kernel, 50)
    row["device_ms"] = graph_ms(kernel, 20)
    row["plain_ms"] = time_ms(lambda: ref.paged_decode_attention(
        q, k, v, **kw), 10)
    # the bound counts what these inputs need: q and out, the table and
    # q_pos, the position rows of the reached pages, and K/V (+ scales) only
    # of pages with an entry that survives the mask
    n_pages, live = x["n_pages"], x["live"]
    nbytes = 2 * b * h * d * q.element_size() + b * mp * 4 + b * 4
    n_live = 0
    for i in range(b):
        for j in range(mp):
            page = int(x["table"][i, j])
            if page >= n_pages or j * ps > q_pos[i]:
                continue
            nbytes += ps * 4
            if live[page].any():
                nbytes += 2 * kvh * ps * (d * k.element_size()
                                          + (4 if quant else 0))
                n_live += int(live[page].sum())
    peak = PEAK_BF16 if dtype == "bfloat16" else PEAK_FP32
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 4.0 * h * d * n_live,
                                                peak)
    row["live_entries"] = n_live
    return row


def paged_line(r: dict) -> str:
    """One log line of a ``paged_case`` row."""
    out = (f"  paged_attention {r['name'][:34]:34s} {r['dtype']:8s} err="
           f"{r['max_abs_err']:.2e} atol_needed={r['atol_needed']:.2e}"
           f"{'' if r['same_bits'] else ' BITS DIFFER'}"
           f"{'' if r['inf_dead_same_bits'] else ' INF IN DEAD DATA MOVES IT'}"
           f"{'' if r['dead_slots_zero'] else ' DEAD SLOT NOT ZERO'}"
           f" [{r['plan_text']}]")
    if r["ms"] is not None:
        out += (f" ms={r['ms']:.4f} device={r['device_ms']:.4f} "
                f"plain={r['plain_ms']:.4f} bound={r['bound_ms']:.5f}")
    return out


def check_paged(label: str, rows: list) -> None:
    """Raise, after every case has run, if any ``paged_case`` row missed
    ``ATTN_TOL``, gave other bits on its second run or with Inf in its dead
    data, or a dead slot that is not exact zeros."""
    bad = [r for r in rows if not r["ok"]]
    if bad:
        need = max(r["atol_needed"] for r in bad)
        raise AssertionError(
            f"{label}: paged_decode_attention fails {len(bad)} of {len(rows)} "
            f"cases (largest atol needed {need:.3e}): "
            + "; ".join(f"{r['name']} {r['dtype']} need {r['atol_needed']:.2e}"
                        f" same_bits={r['same_bits']} inf_dead_same_bits="
                        f"{r['inf_dead_same_bits']} dead_slots_zero="
                        f"{r['dead_slots_zero']}" for r in bad[:12]))


def phase_kernels(rec: dict, state: dict) -> None:
    import torch
    from repro_torch.core.gemm_cases import GEMM_EDGE, GEMMS, RAGGED
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for m in (SLOTS, SLOTS * CHUNK):
            for name, k, n, act, _ in GEMMS:
                r = gemm_case(torch, kg, ref, m, k, n, act, dtype)
                r["name"] = name
                rows.append(r)
                log(gemm_line(f"gemm {name:8s}", r))
    for m in (SLOTS, SLOTS * CHUNK):
        step = {key: sum(r[key] * c for r, (_, _, _, _, c) in zip(
            [r for r in rows if r["m"] == m and r["dtype"] == "bfloat16"],
            GEMMS)) for key in ("ms", "library_ms", "bound_ms", "device_ms",
                                "device_library_ms")}
        rec.setdefault("gemm_steps", {})[str(m)] = step
        log(f"kernels: yi-6b {'decode' if m == SLOTS else 'mixed'} step "
            f"(M {m}) bf16 kraken_gemm {step['ms']:.2f} ms, torch.matmul "
            f"{step['library_ms']:.2f}, bound {step['bound_ms']:.2f} "
            f"(x_matmul {step['ms'] / step['library_ms']:.2f}, x_bound "
            f"{step['ms'] / step['bound_ms']:.2f}); device (graph) "
            f"{step['device_ms']:.2f} ms, torch.matmul "
            f"{step['device_library_ms']:.2f}")
    # the other archs' decode-step GEMMs (M = 4 slots, bf16; musicgen's
    # MLP with its biases), summed per decode step as yi-6b's are
    from repro_torch.core.gemm_cases import (MUSICGEN_GEMMS, RWKV_GEMMS,
                                             VLM_GEMMS, ZAMBA_GEMMS)
    for arch, table in (("rwkv6-3b", RWKV_GEMMS),
                        ("zamba2-1.2b", ZAMBA_GEMMS),
                        ("llama-3.2-vision-11b", VLM_GEMMS),
                        ("musicgen-large", MUSICGEN_GEMMS)):
        arows = []
        for name, k, n, act, *bias, calls in table:
            r = gemm_case(torch, kg, ref, SLOTS, k, n, act, torch.bfloat16,
                          bias=any(bias), seed=len(rows))
            r["name"] = f"{arch.split('-')[0]} {name}"
            r["calls_per_decode_step"] = calls
            arows.append(r)
            log(gemm_line(f"gemm {r['name'][:16]:16s}", r))
        rows += arows
        step = {key: sum(r[key] * r["calls_per_decode_step"] for r in arows)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "device_ms", "device_library_ms")}
        rec["gemm_steps"][f"{arch} decode"] = step
        log(f"kernels: {arch} decode step (M {SLOTS}) bf16 kraken_gemm "
            f"{step['ms']:.2f} ms ({sum(r['calls_per_decode_step'] for r in arows)} "
            f"calls), torch.matmul {step['library_ms']:.2f}, bound "
            f"{step['bound_ms']:.2f}; device (graph) {step['device_ms']:.2f} "
            f"ms, torch.matmul {step['device_library_ms']:.2f}")
    # the plan's corners (one row, a split at decode, a second row tile, A
    # and B that TMA refuses, a ragged K, the recurrent archs' new shapes)
    # and every epilogue, with and without bias, at ragged shapes
    for name, m, k, n, act, bias in GEMM_EDGE:
        for dtype in (torch.bfloat16, torch.float32):
            r = gemm_case(torch, kg, ref, m, k, n, act, dtype, bias=bias,
                          timed=False, seed=len(rows))
            r["name"] = name
            rows.append(r)
            log(gemm_line(f"edge {name[:30]:30s}", r))
    for (m, k, n) in RAGGED:
        for act in (None, "relu", "silu", "gelu"):
            for bias in (False, True):
                for dtype in (torch.bfloat16, torch.float32):
                    r = gemm_case(torch, kg, ref, m, k, n, act, dtype,
                                  bias=bias, timed=False, seed=3)
                    r["name"] = "ragged"
                    rows.append(r)
    rec["gemm"] = rows
    check_gemm_rows("kernels", rows)
    log(f"kernels: kraken_gemm matches plain in {len(rows)} cases, each "
        f"bit-identical over two runs ({sum(r['plan']['split'] > 1 for r in rows)} "
        f"split over K, {sum(r['plan']['fill_a'] or r['plan']['fill_b'] for r in rows if r['dtype'] == 'bfloat16')} "
        "bf16 with an operand TMA refuses), largest atol needed bf16 "
        f"{max(r['atol_needed'] for r in rows if r['dtype'] == 'bfloat16'):.2e} "
        f"f32 {max(r['atol_needed'] for r in rows if r['dtype'] == 'float32'):.2e}")
    from repro_torch.core.attention_cases import PAGED_CASES
    arows = []
    for case in PAGED_CASES:
        for dtype in case[7]:
            r = paged_case(torch, pa, ref, case, dtype, seed=len(arows))
            arows.append(r)
            log(paged_line(r))
            torch.cuda.empty_cache()
    rec["attention"] = arows
    check_paged("kernels", arows)
    main = next(r for r in arows
                if r["name"] == "yi-6b 4 slots" and r["dtype"] == "bfloat16")
    log(f"kernels: paged_decode_attention matches plain in {len(arows)} "
        "cases, each bit-identical over two runs and with Inf in its dead "
        f"data ({sum(not r['plan']['tma'] for r in arows)} on the ldg route), "
        "largest atol needed bf16 "
        f"{max(r['atol_needed'] for r in arows if r['dtype'] != 'float32'):.2e}"
        f" f32 {max(r['atol_needed'] for r in arows if r['dtype'] == 'float32'):.2e}"
        f"; yi-6b 4 slots bf16 [{main['plan_text']}] {main['ms']:.4f} ms a "
        f"call event-timed, {main['device_ms']:.4f} device-only, plain "
        f"{main['plain_ms']:.4f}, bound {main['bound_ms']:.5f}")


def moe_case(torch, mg, ref, *, e, c, d, f, sizes, dtype, seed=0, fill=99.0,
             timed=True):
    """One grouped GEMM against ``ref.grouped_moe_gemm``, with ``fill``
    (garbage or Inf) in the dead capacity rows: int8 exact, bf16 and f32
    within ``GEMM_TOL``, rows past the sizes exactly zero, two calls
    bit-identical.  When ``timed``, the kernel's, the plain version's and
    one ``torch.bmm``'s time, event-timed and (kernel and ``torch.bmm``)
    device-only by CUDA-graph replay.  Every live call reads more than the
    50 MB L2 of expert weights, so repeated calls find it cold, as a serving
    step does.  A miss does not raise: the row says ``ok`` False and the
    least atol it needs (``check_moe_rows`` raises)."""
    from repro_torch.core.gemm_cases import GEMM_TOL
    g = torch.Generator(device="cuda").manual_seed(seed)
    integer = dtype == torch.int8
    w = torch.empty((e, d, f), dtype=dtype, device="cuda")
    for i in range(e):           # one expert at a time: no fp32 bank copy
        if integer:
            w[i] = torch.randint(-128, 128, (d, f), generator=g,
                                 device="cuda", dtype=torch.int8)
        else:
            w[i] = torch.randn((d, f), generator=g, device="cuda") \
                / math.sqrt(max(d, 1))
    if integer:
        xs = torch.randint(-128, 128, (e, c, d), generator=g, device="cuda",
                           dtype=torch.int8)
    else:
        xs = torch.randn((e, c, d), generator=g, device="cuda").to(dtype)
    sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    live = (torch.arange(c, device="cuda")[None, :]
            < sz.clamp(0, c)[:, None])[..., None]
    # garbage in the dead capacity rows: the kernel must mask, not rely on
    # zeros there
    xs = torch.where(live, xs, torch.full_like(xs, fill))
    got = mg.grouped_moe_gemm(xs, w, sz)
    again = mg.grouped_moe_gemm(xs, w, sz)
    want = ref.grouped_moe_gemm(xs, w, sz)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    dead_zero = not bool(got.masked_fill(live, 0).any())
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    same = torch.equal(got.view(bits), again.view(bits))
    if integer:
        exact = got.dtype == torch.int32 and torch.equal(got, want)
        err = 0.0 if exact else math.inf
        need = err
        fits = exact
    else:
        atol, rtol = GEMM_TOL[name]
        diff = (got.float() - want.float()).abs()
        finite = bool(torch.isfinite(got.float()).all())
        err = float(diff.max()) if finite and diff.numel() else (
            0.0 if finite else math.inf)
        need = (float((diff - rtol * want.float().abs()).max().clamp_min(0))
                if finite and diff.numel() else err)
        fits = finite and need <= atol
    q = mg.plan(e, c, d, f, dtype)
    row = {"e": e, "c": c, "d": d, "f": f, "dtype": name,
           "sizes": [int(x) for x in sizes], "fill": fill,
           "max_abs_err": err, "atol_needed": need,
           "dead_rows_zero": dead_zero, "same_bits": same,
           "ok": fits and dead_zero and same,
           "plan": q, "plan_text": mg.describe(q, sizes)}
    del got, again, want
    if timed:
        row["ms"] = time_ms(lambda: mg.grouped_moe_gemm(xs, w, sz), 10)
        row["plain_ms"] = time_ms(lambda: ref.grouped_moe_gemm(xs, w, sz), 3)
        row["device_ms"] = graph_ms(lambda: mg.grouped_moe_gemm(xs, w, sz),
                                    10)
        row["library_ms"] = row["device_library_ms"] = None
        if not integer:
            xm = torch.where(live, xs, torch.zeros_like(xs))
            row["library_ms"] = time_ms(lambda: torch.bmm(xm, w), 10)
            row["device_library_ms"] = graph_ms(lambda: torch.bmm(xm, w), 10)
        # the bound counts what these sizes need: the active experts'
        # weights, the live rows, the size table and the whole output,
        # which is written
        rows = [min(max(int(x), 0), c) for x in sizes]
        active = sum(1 for r in rows if r)
        isz = w.element_size()
        osz = 4 if integer else isz
        nbytes = (active * d * f + sum(rows) * d) * isz + e * 4 \
            + e * c * f * osz
        peak = {torch.bfloat16: PEAK_BF16, torch.float32: PEAK_FP32,
                torch.int8: PEAK_INT8}[dtype]
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2.0 * sum(rows) * d * f, peak)
        row["active_experts"] = active
        row["weights_tb_s"] = active * d * f * isz / (row["ms"] * 1e-3) / 1e12
        row["device_weights_tb_s"] = (active * d * f * isz
                                      / (row["device_ms"] * 1e-3) / 1e12)
    return row


def moe_line(r: dict) -> str:
    """One log line of a ``moe_case`` row: error, plan and, when timed, the
    kernel beside the plain version, torch.bmm and the bound."""
    out = (f"  moe {r['name'][:44]:44s} {r['dtype']:8s} "
           f"err={r['max_abs_err']:.2e} atol_needed={r['atol_needed']:.2e}"
           f"{'' if r['dead_rows_zero'] else ' DEAD ROWS NOT ZERO'}"
           f"{'' if r['same_bits'] else ' BITS DIFFER'} [{r['plan_text']}]")
    if "ms" in r:
        lib = ("-" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} (device {r['device_library_ms']:.4f})")
        out += (f" ms={r['ms']:.4f} device={r['device_ms']:.4f} "
                f"plain={r['plain_ms']:.4f} bmm={lib} "
                f"bound={r['bound_ms']:.4f} active={r['active_experts']} "
                f"({r['weights_tb_s']:.2f} TB/s, device "
                f"{r['device_weights_tb_s']:.2f})")
    return out


def check_moe_rows(label: str, rows: list) -> None:
    """Raise, after every case has run, if any ``moe_case`` row missed its
    tolerance, left a dead row non-zero or gave other bits on its second
    run."""
    bad = [r for r in rows if not r["ok"]]
    if bad:
        need = max(r["atol_needed"] for r in bad)
        raise AssertionError(
            f"{label}: grouped_moe_gemm fails {len(bad)} of {len(rows)} cases "
            f"(largest atol needed {need:.3e}): "
            + "; ".join(f"{r['name']} {r['dtype']} need "
                        f"{r['atol_needed']:.2e} dead_rows_zero="
                        f"{r['dead_rows_zero']} same_bits={r['same_bits']}"
                        for r in bad[:12]))


def empty_sum_cost(torch, mg, calls: int = 100, turns: int = 5) -> dict:
    """What a plan that may split d costs a call that takes no split: at
    mixtral's decode sizes (6 of 8 experts live) the kernel fills the grid
    unsplit, yet the call allocates the partials and launches the sum,
    which returns at once.  Per decode shape, the host time of a call
    (``calls`` back to back, no synchronize, median of ``turns``) and its
    device time (``graph_ms``) on the planned split against the same plan
    with split 1 (no sum launch), in turns; both give the same output."""
    from repro_torch.core.moe_cases import MOE_CASES
    out = {}
    for name, e, c, d, f, sizes, uses in MOE_CASES:
        if not uses:
            continue
        w = torch.randn((e, d, f), device="cuda", dtype=torch.bfloat16)
        xs = torch.randn((e, c, d), device="cuda", dtype=torch.bfloat16)
        sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        q = mg.plan(e, c, d, f)
        plans = {"planned": (q, mg.plan_array(q)),
                 "split 1": ({**q, "split": 1},
                             mg.plan_array({**q, "split": 1}))}
        if not torch.equal(mg.run_plan(xs, w, sz, *plans["planned"]),
                           mg.run_plan(xs, w, sz, *plans["split 1"])):
            raise AssertionError(f"{name}: the split-1 plan differs")
        host = {k: [] for k in plans}
        for _ in range(turns):
            for k, (pq, fields) in plans.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    mg.run_plan(xs, w, sz, pq, fields)
                host[k].append((time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize()
        r = {"most_split": q["split"],
             "split_taken": mg.live_split(q, mg.live_tiles(q, sizes))}
        for k, (pq, fields) in plans.items():
            r[f"host_us {k}"] = sorted(host[k])[turns // 2]
            r[f"device_us {k}"] = 1e3 * graph_ms(
                lambda pq=pq, fields=fields: mg.run_plan(xs, w, sz, pq,
                                                         fields), 10)
        out[name] = r
        log(f"moe_kernels: {name}: a plan that may split {q['split']} ways "
            f"(split taken {r['split_taken']}): host "
            f"{r['host_us planned']:.1f} us a call against "
            f"{r['host_us split 1']:.1f} with split 1 (no sum); device "
            f"{r['device_us planned']:.1f} us against "
            f"{r['device_us split 1']:.1f}")
        del w, xs
        torch.cuda.empty_cache()
    return out


def phase_moe_kernels(rec: dict, state: dict) -> None:
    import torch
    from repro_torch.core.moe_cases import (MIXED_USES, MOE_CASES, MOE_EDGE,
                                            moe_sizes)
    from repro_torch.kernels import kraken_moe_gemm as mg
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for name, e, c, d, f, spec, uses in MOE_CASES:
        sizes = moe_sizes(spec, e, seed=0)
        for dtype in (torch.bfloat16, torch.float32, torch.int8):
            r = moe_case(torch, mg, ref, e=e, c=c, d=d, f=f, sizes=sizes,
                         dtype=dtype, seed=len(rows))
            r["name"], r["uses_per_layer"] = name, uses
            rows.append(r)
            torch.cuda.empty_cache()
            log(moe_line(r))
    for name, e, c, d, f, sizes, fill in MOE_EDGE:
        r = moe_case(torch, mg, ref, e=e, c=c, d=d, f=f, sizes=sizes,
                     dtype=torch.bfloat16, seed=len(rows), fill=fill,
                     timed=False)
        r["name"], r["uses_per_layer"] = name, 0
        rows.append(r)
        torch.cuda.empty_cache()
        log(moe_line(r))
    rec["moe_gemm"] = rows
    check_moe_rows("moe_kernels", rows)
    log(f"moe_kernels: grouped_moe_gemm matches plain in {len(rows)} cases "
        "(int8 exact; skewed, empty, past-capacity, negative and all-empty "
        "sizes; garbage and Inf in dead rows exactly zero; each bit-identical "
        "over two runs), largest atol needed bf16 "
        f"{max(r['atol_needed'] for r in rows if r['dtype'] == 'bfloat16'):.2e} "
        f"f32 {max(r['atol_needed'] for r in rows if r['dtype'] == 'float32'):.2e}")
    # one mixtral decode step (C 1) and one [4, 64] mixed step (C 80) at
    # MOE_LAYERS layers: gate, up and down per layer
    steps = {}
    for step, uses in (("decode", {n: u for n, *_, u in MOE_CASES if u}),
                       ("mixed", MIXED_USES)):
        sel = [r for r in rows if r["dtype"] == "bfloat16"
               and r["name"] in uses and "ms" in r]
        steps[step] = {key: MOE_LAYERS * sum(r[key] * uses[r["name"]]
                                             for r in sel)
                       for key in ("ms", "device_ms", "plain_ms",
                                   "library_ms", "device_library_ms",
                                   "bound_ms")}
        t = steps[step]
        log(f"moe_kernels: mixtral {step} step ({MOE_LAYERS} layers) bf16 "
            f"grouped_moe_gemm {t['ms']:.2f} ms event-timed, "
            f"{t['device_ms']:.2f} device-only; torch.bmm "
            f"{t['library_ms']:.2f} / {t['device_library_ms']:.2f}; bound "
            f"{t['bound_ms']:.2f} (x_bmm {t['ms'] / t['library_ms']:.2f}, "
            f"device {t['device_ms'] / t['device_library_ms']:.2f}; x_bound "
            f"{t['device_ms'] / t['bound_ms']:.2f} device)")
    rec["moe_steps"] = steps
    rec["moe_empty_sum"] = empty_sum_cost(torch, mg)

    # the mixtral path's kraken_gemm and paged_decode_attention shapes
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.core.gemm_cases import MIXTRAL_GEMMS
    path = []
    for m in (SLOTS, SLOTS * CHUNK):
        for name, k, n, _ in MIXTRAL_GEMMS:
            r = gemm_case(torch, kg, ref, m, k, n, None, torch.bfloat16)
            r["name"] = name
            path.append(r)
            log(gemm_line(f"mixtral gemm {name:8s}", r))
    check_gemm_rows("moe_kernels", path)
    from repro_torch.core.attention_cases import PAGED_CASES
    att = paged_case(torch, pa, ref, next(c for c in PAGED_CASES
                                          if c[0] == MIXTRAL_PAGED),
                     "bfloat16")
    log(paged_line(att))
    check_paged("moe_kernels", [att])
    dec = sum(r["ms"] * c for r, (_, _, _, c) in zip(path, MIXTRAL_GEMMS))
    log(f"moe_kernels: the mixtral path's kraken_gemm and "
        f"paged_decode_attention shapes match plain; kraken_gemm "
        f"{dec:.2f} ms per mixtral decode step ({MOE_LAYERS} layers)")
    rec["moe_path"] = {"gemm": path, "attention": att,
                       "kraken_gemm_ms_per_decode_step": dec}


def _yi6b(kernels=None):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    return Model(get_arch("yi-6b"), kernels=kernels)   # bf16, full width


def serve_passes(eng, label: str, reps: int = 2) -> list[dict]:
    """The serve workload ``reps`` times through ``eng``: each pass's wall
    time, tok/s, TTFT, steps and new program signatures.  Every request
    must be served in full, and the last pass (warm) may add no program
    signature."""
    import numpy as np
    import torch
    vocab = eng.model.cfg.vocab_size
    rng = np.random.default_rng(0)
    passes = []
    for rep in range(reps):
        before = (eng._prefill.retraces, eng._decode.retraces,
                  eng._reset.retraces)
        reqs = [eng.submit(rng.integers(0, vocab, (n,)), SERVE_NEW)
                for n in SERVE_LENS]
        calls0 = (eng._prefill.calls, eng._decode.calls)
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        new_sigs = (eng._prefill.retraces - before[0]
                    + eng._decode.retraces - before[1]
                    + eng._reset.retraces - before[2])
        toks = sum(len(r.out) for r in reqs)
        bad = [r.rid for r in reqs
               if r.state != "done" or len(r.out) != SERVE_NEW
               or not all(0 <= t < vocab for t in r.out)]
        if bad:
            raise AssertionError(f"{label} serve pass {rep + 1}: requests "
                                 f"{bad} not served in full")
        ttft = [r.ttft for r in reqs]
        passes.append({
            "wall_s": wall, "tokens": toks, "tok_s": toks / wall,
            "prefill_tokens": int(sum(SERVE_LENS)),
            "mixed_steps": eng._prefill.calls - calls0[0],
            "decode_steps": eng._decode.calls - calls0[1],
            "ttft_mean_s": sum(ttft) / len(ttft), "ttft_max_s": max(ttft),
            "new_signatures": new_sigs, "out": [list(r.out) for r in reqs]})
        log(f"  {label} pass {rep + 1}: {len(reqs)} requests, {toks} tokens "
            f"in {wall:.2f} s = {toks / wall:.1f} tok/s, ttft mean "
            f"{passes[-1]['ttft_mean_s'] * 1e3:.0f} ms max "
            f"{passes[-1]['ttft_max_s'] * 1e3:.0f} ms "
            f"({passes[-1]['mixed_steps']} mixed + "
            f"{passes[-1]['decode_steps']} decode steps, "
            f"{new_sigs} new signatures)")
    if passes[-1]["new_signatures"]:
        raise AssertionError(f"{label}: the warm pass added program "
                             "signatures")
    for alloc in eng.allocators.values():
        alloc.check()
        if alloc.free_pages != alloc.n_pages:
            raise AssertionError(f"{label}: pages leaked")
    return passes


def _engine(model, params):
    from repro_torch.serving import CacheConfig, EngineConfig, PagedEngine
    return PagedEngine(model, params, config=EngineConfig(
        slots=SLOTS, chunk=CHUNK,
        cache=CacheConfig(page_size=PAGE, max_len=MAX_LEN)))


def phase_serve(rec: dict, state: dict) -> None:
    import torch
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import paged_attention as pa
    model = _yi6b()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    state["params"] = params
    eng = _engine(model, params)
    kg.launches = 0
    pa.launches = 0
    passes = serve_passes(eng, "serve")
    launches = {"kraken_gemm": kg.launches,
                "paged_decode_attention": pa.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    # every GEMM of the path went through kraken_gemm, and every decode
    # attention through paged_decode_attention
    steps = eng._prefill.calls + eng._decode.calls
    per_step = LAYERS * 7 + 1
    if launches["kraken_gemm"] != per_step * steps or \
            launches["paged_decode_attention"] != LAYERS * eng._decode.calls:
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{eng._prefill.calls} mixed + "
                             f"{eng._decode.calls} decode steps")
    rec["serve"] = {"params": n_params, "init_s": init_s, "passes": passes,
                    "report": eng.report(),
                    "launches_per_decode_step": {
                        "kraken_gemm": per_step,
                        "paged_decode_attention": LAYERS},
                    "launches_per_mixed_step": {
                        "kraken_gemm": per_step,
                        "paged_decode_attention": 0}}
    rec["launches"] = launches
    state["engine"] = eng
    rec["serve"]["scatter"] = scatter_gate(model, params)
    log(f"  {eng.report()}")
    log(f"serve: yi-6b {n_params / 1e9:.2f} B params bf16, all "
        f"{2 * len(SERVE_LENS)} requests served, warm pass "
        f"{passes[1]['tok_s']:.1f} tok/s, zero new signatures, launches "
        f"{launches}")


SCATTER_PROMPTS = 4


def scatter_gate(model, params) -> dict:
    """The serving state protocol's whole-prompt scatter on the card: the
    first ``SCATTER_PROMPTS`` serve prompts prefilled whole into
    ``init_caches(4, L, clamp_window=False)`` and written into fresh pools of
    the serve geometry by ``StateTree.scatter_prefill``; the same prompts
    into other fresh pools through the chunked mixed step (``CHUNK``
    tokens a step).  Every live page entry holds the same position in both,
    and K/V within ``E2E_TOL`` of the largest; one decode step from each
    (``paged_decode_attention`` launched once a layer each) agrees within
    ``E2E_TOL`` of the largest logit."""
    import torch
    from repro_torch.models.layers import POS_EMPTY, PagedKVCache
    from repro_torch.serving import build_state_tree
    dev = torch.device("cuda")
    prompts = serve_prompts(model.cfg.vocab_size)[:SCATTER_PROMPTS]
    lens = [len(p) for p in prompts]
    width = max(lens)
    toks = torch.zeros((len(prompts), width), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(p, device=dev)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    slots = torch.arange(len(prompts), dtype=torch.int32, device=dev)

    def fresh():
        tree = build_state_tree(model, slots=SLOTS, page_size=PAGE,
                                max_len=MAX_LEN)
        pools = tree.init_device()
        for slot in range(len(prompts)):
            tree.admit(slot)
        return tree, tree.push_tables(pools)

    t0 = time.perf_counter()
    tree, whole = fresh()
    dense = model.init_caches(len(prompts), width, clamp_window=False)
    with torch.no_grad():
        logits, dense, _ = model.forward(params, {
            "tokens": toks,
            "positions": torch.arange(width, dtype=torch.int32, device=dev),
            "lengths": lengths}, mode="prefill", caches=dense)
    nxt = torch.argmax(logits[slots.long(), lengths.long() - 1],
                       dim=-1).to(torch.int32)[:, None]
    whole = tree.scatter_prefill(whole, dense, slots, lengths)
    del dense, logits
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, chunked = fresh()
    ar = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    for start in range(0, width, CHUNK):
        n = (lengths - start).clamp(0, CHUNK)
        tok = torch.zeros((len(prompts), CHUNK), dtype=torch.int32,
                          device=dev)
        part = toks[:, start:start + CHUNK]
        tok[:, :part.shape[1]] = part
        model.chunk_step(params, chunked, tok,
                         (start + ar).expand(len(prompts), CHUNK), n)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0

    live_entries, kv_err = 0, 0.0
    for a, b in zip(_leaves(whole), _leaves(chunked)):
        if not isinstance(a, PagedKVCache):
            continue
        n = a.n_pages       # the trash page is never read
        live = a.pos[:n] != POS_EMPTY
        live_entries += int(live.sum())
        if not torch.equal(a.pos[:n][live], b.pos[:n][live]) or not \
                torch.equal(live, b.pos[:n] != POS_EMPTY):
            raise AssertionError("scatter: the chunked step's live "
                                 "positions differ from the scatter's")
        for x, y in ((a.k, b.k), (a.v, b.v)):
            x = x[:n].permute(0, 2, 1, 3)[live].float()
            y = y[:n].permute(0, 2, 1, 3)[live].float()
            kv_err = max(kv_err, float((x - y).abs().max())
                         / float(y.abs().max()))
    if kv_err > E2E_TOL or live_entries != LAYERS * sum(lens):
        raise AssertionError(f"scatter: K/V apart by {kv_err:.4f} of the "
                             f"largest (gate {E2E_TOL}), {live_entries} live "
                             "entries")

    _zero_counts()
    step = {}
    for label, pools in (("whole", whole), ("chunked", chunked)):
        step[label], _ = model.decode_step(
            params, pools, nxt, lengths, lengths=torch.ones_like(lengths))
    launches = _read_counts()
    got, want_logits = step["whole"].float(), step["chunked"].float()
    err = {"rel": float((got - want_logits).abs().max())
           / float(want_logits.abs().max()),
           "argmax_agree": float((got.argmax(-1) == want_logits.argmax(-1))
                                 .float().mean())}
    want = _want_launches(launches, {"kraken_gemm": 2 * (LAYERS * 7 + 1),
                                     "paged_decode_attention": 2 * LAYERS})
    if not (torch.isfinite(got).all() and torch.isfinite(want_logits).all()
            ) or not err["rel"] <= E2E_TOL or launches != want:
        raise AssertionError(f"scatter: decode logits apart by "
                             f"{err['rel']:.4f} of the largest (gate "
                             f"{E2E_TOL}); launches {launches}, want {want}")
    log(f"  serve scatter: {len(prompts)} prompts of {lens} tokens, whole "
        f"({whole_s:.2f} s) and chunked ({chunk_s:.2f} s): {live_entries} "
        f"live entries at the same positions, K/V within {kv_err:.4f} of the "
        f"largest, one decode step from each within {err['rel']:.4f} "
        f"(gate {E2E_TOL}), launches {launches}")
    return {"prompts": lens, "live_entries": live_entries,
            "kv_rel_err": kv_err, "decode": err, "launches": launches,
            "whole_s": whole_s, "chunked_s": chunk_s}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _plain_kernels():
    from repro_torch.kernels import ref
    from repro_torch.models.layers import Kernels
    return Kernels(ref.matmul, ref.paged_decode_attention,
                   ref.grouped_expert_ffn, ref.decode_attention,
                   ref.sliding_window_attention)


def two_steps(model, params, seed: int = 1):
    """One mixed step (rows of 64, 40, 1 and 0 tokens; slot 3 unallocated)
    and then one decode step of the three live rows through ``model`` on
    fresh pools, with tokens drawn from ``seed``.  Returns the logits of
    the live rows of each step."""
    import numpy as np
    import torch
    from repro_torch.serving.state import build_state_tree
    vocab = model.cfg.vocab_size
    tree = build_state_tree(model, slots=SLOTS, page_size=PAGE,
                            max_len=MAX_LEN, device="cuda")
    for s in (0, 1, 2):                 # slot 3 stays unallocated
        tree.admit(s)
    pools = tree.push_tables(tree.init_device())
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, vocab, (SLOTS, CHUNK)),
                             device="cuda")
    lengths = torch.as_tensor(np.asarray([CHUNK, 40, 1, 0], np.int32),
                              device="cuda")
    positions = torch.arange(CHUNK, dtype=torch.int32,
                             device="cuda").repeat(SLOTS, 1)
    live = lengths > 0
    last, _, pools = model.chunk_step(params, pools, tokens, positions,
                                      lengths, return_greedy=True)
    dec_tok = torch.as_tensor(rng.integers(0, vocab, (SLOTS, 1)),
                              device="cuda")
    logits, pools = model.decode_step(params, pools, dec_tok, lengths,
                                      lengths=live.to(torch.int32))
    return last[live], logits[live]


def compare_logits(name: str, got, want, vocab: int, rows: int = 3) -> dict:
    """max |kernel - plain| against ``E2E_TOL`` times max |plain|; raises
    on non-finite or misshapen logits (``rows`` live rows), reports (does
    not raise) on the tolerance."""
    import torch
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"e2e {name}: non-finite logits")
    if got.shape != (rows, vocab) or want.shape != got.shape:
        raise AssertionError(f"e2e {name}: logits shape {got.shape}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"  e2e {name}: max |kernel - plain| {err:.4f} of max |plain| "
        f"{scale:.2f} ({err / scale:.4f}), argmax agree {agree:.2f}")
    return {"max_abs_err": err, "max_abs_plain": scale, "rel": err / scale,
            "argmax_agree": agree, "ok": err <= E2E_TOL * scale}


def phase_e2e(rec: dict, state: dict) -> None:
    """One mixed step's and one decode step's logits through the kernels
    and through the plain versions (passed in as the model's kernels)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_model = _yi6b()
    params = state.get("params")
    if params is None:
        params = kernel_model.init(
            torch.Generator(device="cuda").manual_seed(0))
    got = two_steps(kernel_model, params)
    want = two_steps(_yi6b(_plain_kernels()), params)
    res = {}
    for i, name in enumerate(("mixed step", "decode step")):
        res[name] = compare_logits(name, got[i], want[i],
                                   kernel_model.cfg.vocab_size)
        if not res[name]["ok"]:
            raise AssertionError(f"e2e {name}: {res[name]['max_abs_err']} > "
                                 f"{E2E_TOL} * {res[name]['max_abs_plain']}")
    rec["e2e"] = res
    log(f"e2e: kernels agree with the plain versions within {E2E_TOL} of "
        "the largest logit (bf16, full yi-6b)")


# ---------------------------------------------------------------------------
# the serving features: prefix cache, preemption, speculation, faults and
# seeded sampling, on the serve phase's engine geometry
# ---------------------------------------------------------------------------

# the workloads: a FEAT_PREFIX-token prefix shared by 8 requests (prefix
# cache); 6 class-1 requests, then 2 class-0 ones FEAT_URGENT_AFTER steps
# later (preemption); 8 prompts repeating one FEAT_SEGMENT-token segment
# (speculation, FEAT_SPECULATE drafts a slot from the n-gram drafter); the
# serve workload under the seeded fault plan FEAT_FAULTS with the watchdog;
# the serve workload sampled at FEAT_T, twice from one seed
FEAT_PREFIX, FEAT_URGENT_AFTER, FEAT_SEGMENT, FEAT_SPECULATE = 128, 8, 32, 4
FEAT_FAULTS = "seed=0,n=8,ticks=48,kinds=step_exc+alloc_exhaust+swap_corrupt"
FEAT_T = 0.8
# the float32 identity gates: yi-6b at full width cut to FEAT_F32_LAYERS
# layers, zamba2-1.2b at full width and depth.  The bf16 runs serve the
# serve phase's weights cut to their first FEAT_BF16_LAYERS layers (views,
# nothing copied), to keep the whole script near 780 s
FEAT_F32_LAYERS, FEAT_BF16_LAYERS = 4, 8
FEATURES = ("prefix_cache", "preempt", "speculate", "faults")


def feature_workloads(vocab: int) -> dict:
    """name -> (engine options, submissions ``(step, prompt, max_new,
    priority)``, each submitted once the engine has run ``step`` steps)."""
    import numpy as np
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, (FEAT_PREFIX,))
    plain = [(0, p, SERVE_NEW, 0) for p in serve_prompts(vocab)]
    return {
        "prefix_cache": (dict(prefix_cache=True), [
            (0, np.concatenate([shared, rng.integers(0, vocab, (17 + 13 * i,))]),
             SERVE_NEW, 0) for i in range(8)]),
        "preempt": (dict(preempt=True), [
            (0, rng.integers(0, vocab, (40 + 20 * i,)), SERVE_NEW, 1)
            for i in range(6)] + [
            (FEAT_URGENT_AFTER, rng.integers(0, vocab, (30 + 10 * i,)),
             SERVE_NEW, 0) for i in range(2)]),
        "speculate": (dict(speculate=FEAT_SPECULATE), [
            (0, np.tile(rng.integers(0, vocab, (FEAT_SEGMENT,)), 4)[
                :3 * FEAT_SEGMENT + 7 * i], SERVE_NEW, 0) for i in range(8)]),
        "faults": (dict(faults=FEAT_FAULTS, watchdog=True), plain),
        "sampled": (dict(temperature=FEAT_T, seed=1), plain),
    }


def _feature_engine(model, params, *, prefix_cache=False, preempt=False,
                    speculate=0, faults=None, watchdog=False,
                    temperature=0.0, seed=0):
    from repro_torch.serving import (CacheConfig, EngineConfig, FaultConfig,
                                     FaultPlan, PagedEngine, SchedulerConfig,
                                     SpecConfig)
    return PagedEngine(model, params, config=EngineConfig(
        slots=SLOTS, chunk=CHUNK, temperature=temperature, seed=seed,
        sched=SchedulerConfig(preempt=preempt),
        cache=CacheConfig(page_size=PAGE, max_len=MAX_LEN,
                          prefix_cache=prefix_cache),
        spec=SpecConfig(speculate=speculate),
        fault=FaultConfig(watchdog=watchdog or None,
                          plan=FaultPlan.from_spec(faults) if faults
                          else None)))


def drive(eng, subs) -> tuple[list, float]:
    """Submit ``subs`` (``(step, prompt, max_new, priority)``) as the engine
    reaches each step, run to idle (the fault plan drained and the
    watchdog's at-drain sweep run), and return the requests and the wall
    seconds."""
    import torch
    start, i, reqs = eng.ticks, 0, []
    t0 = time.perf_counter()
    while i < len(subs) or not eng.sched.idle:
        while i < len(subs) and subs[i][0] <= eng.ticks - start:
            _, p, max_new, prio = subs[i]
            reqs.append(eng.submit(p, max_new, priority=prio))
            i += 1
        eng.step()
    eng.run_until_idle()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def check_drained(eng, reqs, label: str, faulted_ok: bool = False) -> None:
    """Every request served in full (or, under faults, failed with a
    reason), every page back but the prefix cache's own."""
    vocab = eng.model.cfg.vocab_size
    for r in reqs:
        if faulted_ok and r.state == "failed" and r.error:
            continue
        if r.state != "done" or len(r.out) != r.max_new or \
                not all(0 <= t < vocab for t in r.out):
            raise AssertionError(f"{label}: request {r.rid} ended {r.state} "
                                 f"with {len(r.out)} tokens ({r.error})")
    cached = eng.prefix_cache.cached_pages if eng.prefix_cache else 0
    for alloc in eng.allocators.values():
        alloc.check()
        if alloc.free_pages != alloc.n_pages - cached:
            raise AssertionError(f"{label}: pages leaked")
    if eng.prefix_cache is not None:
        eng.prefix_cache.check()
    if eng.faults is not None and eng.faults.stats()["held_hostage_groups"]:
        raise AssertionError(f"{label}: the fault plan kept pages")


def reference_outputs(model, params, workloads: dict) -> dict:
    """Every workload's submissions at once through one engine with every
    feature off: ``name -> [tokens per request]``."""
    eng = _feature_engine(model, params)
    reqs = {name: [eng.submit(p, n, priority=prio) for _, p, n, prio in subs]
            for name, (_, subs) in workloads.items()}
    eng.run_until_idle()
    return {name: [list(r.out) for r in rs] for name, rs in reqs.items()}


def feature_identity(model, params, label: str) -> dict:
    """Each feature's workload through its engine, held token for token to
    the feature-off engine on the same submissions (the replay of
    ``EngineConfig.verify_reference()``, and the cache-off engine for the
    prefix cache)."""
    import torch
    workloads = {k: v for k, v in feature_workloads(
        model.cfg.vocab_size).items() if k in FEATURES}
    ref = reference_outputs(model, params, workloads)
    res = {}
    for name, (opts, subs) in workloads.items():
        eng = _feature_engine(model, params, **opts)
        reqs, wall = drive(eng, subs)
        check_drained(eng, reqs, f"{label} {name}", faulted_ok=name == "faults")
        served = [i for i, r in enumerate(reqs) if r.state == "done"]
        diff = [i for i in served if list(reqs[i].out) != ref[name][i]]
        s = eng.stats()
        res[name] = {"requests": len(reqs), "served": len(served),
                     "differ": diff, "wall_s": wall,
                     **{k: s[k] for k in ("prefix_hit_rate", "preemptions",
                                          "spec_accept_rate", "recovered",
                                          "swap_rejects")}}
        log(f"  {label} {name}: {len(served)}/{len(reqs)} served, "
            f"{len(served) - len(diff)} token-identical to the feature-off "
            f"engine ({wall:.1f} s)")
        del eng
    torch.cuda.empty_cache()
    return res


def phase_serve_features(rec: dict, state: dict) -> None:
    """The serving features on the serve phase's bf16 yi-6b (its weights'
    first FEAT_BF16_LAYERS layers, its engine geometry), each workload on
    a fresh engine: served in full,
    no page leaked, zero new signatures on a warm second pass, the kernels'
    launches counted against the steps.  Token identity with the
    feature-off engine is reported in bf16 and gated in float32 on yi-6b
    at FEAT_F32_LAYERS layers and zamba2-1.2b at full depth."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    params = state.get("params")
    if params is None:
        params = _yi6b().init(torch.Generator(device="cuda").manual_seed(0))
    model = Model(dataclasses.replace(get_arch("yi-6b"),
                                      num_layers=FEAT_BF16_LAYERS))
    params = {**params, "stack": {**params["stack"], "slots": [
        {k: w[:FEAT_BF16_LAYERS] for k, w in slot.items()}
        for slot in params["stack"]["slots"]]}}
    workloads = feature_workloads(model.cfg.vocab_size)
    ref = reference_outputs(model, params, {
        k: v for k, v in workloads.items() if k != "sampled"})
    per_step = FEAT_BF16_LAYERS * 7 + 1
    runs, launches = {}, {name: 0 for name in _read_counts()}
    sampled = []
    for name, (opts, subs) in workloads.items():
        eng = _feature_engine(model, params, **opts)
        _zero_counts()
        reqs, wall = drive(eng, subs)
        counts = _read_counts()
        mixed, dec = eng._prefill.calls, eng._decode.calls
        want = {k: 0 for k in counts}
        want["kraken_gemm"] = per_step * (mixed + dec)
        want["paged_decode_attention"] = FEAT_BF16_LAYERS * dec
        if counts != want:
            raise AssertionError(f"serve_features {name}: launch counts "
                                 f"{counts} do not match {mixed} mixed + "
                                 f"{dec} decode steps: {want}")
        for k, v in counts.items():
            launches[k] += v
        check_drained(eng, reqs, f"serve_features {name}",
                      faulted_ok=name == "faults")
        s, report = eng.stats(), eng.report()
        sigs = (eng._prefill.retraces, eng._decode.retraces,
                eng._reset.retraces)
        warm, _ = drive(eng, [(0, p, 4, prio) for _, p, _, prio in subs[:2]])
        check_drained(eng, warm, f"serve_features {name} warm",
                      faulted_ok=name == "faults")
        new_sigs = sum(a - b for a, b in zip(
            (eng._prefill.retraces, eng._decode.retraces,
             eng._reset.retraces), sigs))
        if new_sigs:
            raise AssertionError(f"serve_features {name}: the warm pass "
                                 f"added {new_sigs} program signatures")
        served = [i for i, r in enumerate(reqs) if r.state == "done"]
        toks = sum(len(reqs[i].out) for i in served)
        run = {"requests": len(reqs), "served": len(served), "tokens": toks,
               "wall_s": wall, "tok_s": toks / wall, "mixed_steps": mixed,
               "decode_steps": dec, "launches": counts,
               "new_signatures_warm": new_sigs, "report": report,
               **{k: s[k] for k in (
                   "prefix_hit_rate", "cached_prefill_tokens", "cow_forks",
                   "preemptions", "resumes", "spec_drafted", "spec_accepted",
                   "spec_accept_rate", "spec_accepted_per_step", "recovered",
                   "swap_rejects", "failed_total", "watchdog", "faults")}}
        if name in ref:
            # reported: the schedule decides which program (mixed or
            # decode) computes a token, and in bf16 they round apart
            run["identical_bf16"] = sum(list(reqs[i].out) == ref[name][i]
                                        for i in served)
        else:
            sampled.append([list(r.out) for r in reqs])
        runs[name] = run
        log(f"  serve_features {name}: {report}")
        del eng
    # the sampled workload again, from the same seed on a fresh engine
    eng = _feature_engine(model, params, **workloads["sampled"][0])
    again, _ = drive(eng, workloads["sampled"][1])
    del eng
    if [list(r.out) for r in again] != sampled[0]:
        raise AssertionError("serve_features sampled: the same seed gave "
                             "other tokens")
    runs["sampled"]["same_seed_identical"] = True
    checks = {"prefix_cache": ("prefix_hit_rate", 0.0),
              "preempt": ("preemptions", 0)}
    for name, (key, floor) in checks.items():
        if not runs[name][key] > floor:
            raise AssertionError(f"serve_features {name}: {key} "
                                 f"{runs[name][key]}")

    # float32 identity gates
    torch.backends.cuda.matmul.allow_tf32 = False
    gates = {}
    for arch, layers in (("yi-6b", FEAT_F32_LAYERS), ("zamba2-1.2b", None)):
        cfg = dataclasses.replace(get_arch(arch), dtype="float32")
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        m32 = Model(cfg)
        p32 = m32.init(torch.Generator(device="cuda").manual_seed(0))
        gates[arch] = feature_identity(m32, p32, f"{arch} float32")
        del m32, p32
        _release(state)
    bad = {f"{a} {n}": r["differ"] for a, g in gates.items()
           for n, r in g.items() if r["differ"]}
    if bad:
        raise AssertionError(f"serve_features: float32 requests that differ "
                             f"from the feature-off engine: {bad}")
    if gates["zamba2-1.2b"]["prefix_cache"]["prefix_hit_rate"] != 0.0:
        raise AssertionError("zamba2-1.2b hit the prefix cache")
    rec["serve_features"] = {"runs": runs, "launches": launches,
                             "float32_identity": gates}
    log(f"serve_features: bf16 yi-6b ({FEAT_BF16_LAYERS} layers) " + ", ".join(
        f"{n} {r['tok_s']:.1f} tok/s"
        + (f" ({r['identical_bf16']}/{r['served']} as feature-off)"
           if "identical_bf16" in r else "") for n, r in runs.items())
        + f"; prefix hit rate {runs['prefix_cache']['prefix_hit_rate']}, "
        f"{runs['preempt']['preemptions']} preemptions, accept rate "
        f"{runs['speculate']['spec_accept_rate']}, "
        f"{runs['faults']['recovered']} recovered; float32 yi-6b "
        f"({FEAT_F32_LAYERS} layers) and zamba2-1.2b token-identical to the "
        "feature-off engine under every feature")


# device_trace's groups of the port's own kernels
PORTED_GROUPS = ("kraken_conv2d_direct",
                 "kraken_conv2d_direct: the weights' K-major copy",
                 "kraken_conv2d_direct: the split's fixed-order sum",
                 "grouped_moe_gemm", "kraken_gemm", "paged_decode_attention",
                 "swa_attention", "swa_attention_bwd", "decode_attention")


#: the port's profiler ranges (``record_function``) a trace can group, by
#: the module whose ``_span()`` opens each
RANGE_MODULES = {"recurrence": "repro_torch.models.ssm",
                 "adamw": "repro_torch.optim.adamw"}
#: the kernel ``torch.cuda._sleep(0)`` launches: the ranges' device markers
MARKER = "spin_kernel"


@contextlib.contextmanager
def range_markers(ranges: tuple):
    """While the block runs, every opening of a range in ``ranges`` (at most
    one name) also launches a marker kernel (``torch.cuda._sleep(0)``, ~2
    us) before it and after it, so a trace of the device activity alone
    shows which kernels ran inside the range: those between a marker pair
    on the stream."""
    import importlib
    import torch
    if len(ranges) > 1:
        raise ValueError(f"one marked range a trace, not {ranges}")
    saved = []
    for name in ranges:
        mod = importlib.import_module(RANGE_MODULES[name])
        span = mod._span

        @contextlib.contextmanager
        def marked(span=span):
            torch.cuda._sleep(0)
            try:
                with span():
                    yield
            finally:
                torch.cuda._sleep(0)

        saved.append((mod, span))
        mod._span = marked
    try:
        yield
    finally:
        for mod, span in saved:
            mod._span = span


#: the Chrome trace's categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(prof) -> list:
    """The trace's device activity (kernels, copies, memsets) in order of
    its start on the card, each ``{"name", "ts", "dur", "tid"}`` (us; the
    stream as ``tid``), as the profiler's Chrome trace lists it.  Read from
    ``export_chrome_trace``'s file, which the profiler writes in C++: the
    profiler's own parse of a serve pass's trace into Python events
    (``key_averages``, ``events``) takes several times as long."""
    import tempfile
    out = ROOT / "build"
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out) as d:
        path = str(Path(d) / "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    evs = [e for e in trace.get("traceEvents", [])
           if e.get("cat") in DEVICE_CATS]
    return sorted(evs, key=lambda e: e["ts"])


def marked_kernels(evs: list, ranges: tuple) -> dict:
    """{range: {kernel name: device us}} of the device activity that ran
    between ``range_markers``' marker pairs on the markers' stream (one
    range a trace; ``evs`` from ``trace_events``).  Raises when the markers
    do not pair up."""
    if not ranges:
        return {}
    (name,) = ranges
    stream, by_name, pairs = None, {}, 0
    for e in evs:
        if MARKER in e["name"]:
            if stream is None:
                stream = e["tid"]
            else:
                stream, pairs = None, pairs + 1
        elif stream is not None and e["tid"] == stream:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    if stream is not None or not pairs:
        raise AssertionError(f"device_trace: the {name} markers do not pair "
                             f"up ({pairs} pairs)")
    return {name: by_name}


def profiled(run, ranges: tuple = (), host: bool = False):
    """(profiler, wall s) of ``run()`` under ``torch.profiler`` with the
    ranges' markers; the device activity alone unless ``host``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with range_markers(ranges), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def device_trace(run, label: str, ranges: tuple = ()) -> dict:
    """``torch.profiler`` over ``run()``, the device activity alone: device
    time by kernel group and the device's busy share of the wall time.
    Kernels that ran inside a port range named in ``ranges`` (the
    recurrences' ``"recurrence"``, AdamW's ``"adamw"``) form a group of that
    name, found between the range's marker kernels (``range_markers``)."""
    prof, wall = profiled(run, ranges)
    t0 = time.perf_counter()
    evs = trace_events(prof)
    out = trace_groups(evs, wall, label, marked_kernels(evs, ranges))
    out["post_s"] = time.perf_counter() - t0
    log(f"  profile {label}: the trace read in {out['post_s']:.1f} s")
    return out


def trace_groups(evs: list, wall: float, label: str, inside: dict) -> dict:
    """``device_trace``'s record of a trace's device activity ``evs``, with
    ``inside`` ({range: {kernel name: device us}}) grouped under each
    range's name."""
    by_key: dict = {}
    for e in evs:
        # the markers are the trace's, not the program's
        if MARKER not in e["name"]:
            us, n = by_key.get(e["name"], (0.0, 0))
            by_key[e["name"]] = (us + e["dur"], n + 1)
    rows = sorted(((us, n, key) for key, (us, n) in by_key.items()
                   if us > 0), reverse=True)
    total_us = sum(r[0] for r in rows)

    def group(key):
        if "kraken_conv_kernel" in key:
            return "kraken_conv2d_direct"
        if "kraken_conv_weights" in key:
            return "kraken_conv2d_direct: the weights' K-major copy"
        if "kraken_conv_reduce" in key:
            return "kraken_conv2d_direct: the split's fixed-order sum"
        # the wgmma kernel, the split's fixed-order sum and the tile loop;
        # before kraken_gemm's test, which "grouped_moe_gemm_kernel" meets
        if "grouped_moe_gemm" in key:
            return "grouped_moe_gemm"
        # the wgmma kernel, the split's fixed-order sum, the fp32 kernel
        if "kraken_gemm" in key:
            return "kraken_gemm"
        # the split kernel and the combine; before decode_attention's test,
        # which "paged_decode_attention_combine" meets
        if "paged_decode_attention" in key:
            return "paged_decode_attention"
        if "swa_bwd" in key:   # the delta pass and the dQ/dK/dV grid
            return "swa_attention_bwd"
        if "swa_wgmma" in key or "swa_fma" in key:
            return "swa_attention"
        if "decode_attention_" in key:   # the split kernel and the combine
            return "decode_attention"
        low = key.lower()
        if "gemm" in low or "cutlass" in low or "sm90" in low:
            return ("library GEMM (chunk and chunked attention, router, "
                    "combine)")
        if "index" in low or "gather" in low or "scatter" in low:
            return "indexing (pool gather/scatter, embed, dispatch)"
        if "copy" in low:
            return "copies and dtype casts"
        if "reduce" in low or "softmax" in low or "sort" in low:
            return "reductions (norms, softmax, argmax, routing sort)"
        return "other elementwise (rope, residual, silu*up, masks)"

    groups: dict = {}
    for us, _, key in rows:
        for rng, by_name in inside.items():
            part = min(us, by_name.get(key, 0.0))
            groups[rng] = groups.get(rng, 0.0) + part
            us -= part
        groups[group(key)] = groups.get(group(key), 0.0) + us
    out = {
        "wall_s": wall, "device_s": total_us / 1e6,
        "device_busy": total_us / 1e6 / wall,
        "groups_ms": {k: v / 1e3 for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])},
        "top": [{"us": us, "count": c, "name": key[:120]}
                for us, c, key in rows[:15]],
        # every kernel of the port by name (a split's sum apart from its
        # product kernel)
        "ported": [{"us": us, "count": c, "name": key[:120]}
                   for us, c, key in rows if group(key) in PORTED_GROUPS]}
    log(f"  profile {label}: wall {wall:.2f} s, device busy "
        f"{total_us / 1e6:.2f} s ({100 * total_us / 1e6 / wall:.1f}%)")
    for k, v in out["groups_ms"].items():
        log(f"    {k:50s} {v:9.1f} ms")
    for r in out["top"][:8]:
        log(f"    {r['us'] / 1e3:8.1f} ms x{r['count']:<6d} {r['name'][:70]}")
    if total_us <= 0:
        # the profiler could not trace the card here: say so, measure nothing
        out["device_busy"] = None
        log("  profile: the profiler recorded no device time (not measured)")
    return out


def trace_pass(eng, seed: int, ranges: tuple = ()) -> dict:
    """``device_trace`` over one more pass of the serve workload through
    the warm engine ``eng``, with ``ranges`` grouped."""
    import numpy as np
    rng = np.random.default_rng(seed)
    calls0 = (eng._prefill.calls, eng._decode.calls)

    def run():
        for n in SERVE_LENS:
            eng.submit(rng.integers(0, eng.model.cfg.vocab_size, (n,)),
                       SERVE_NEW)
        eng.run_until_idle()

    out = device_trace(run, eng.model.cfg.name, ranges)
    out["mixed_steps"] = eng._prefill.calls - calls0[0]
    out["decode_steps"] = eng._decode.calls - calls0[1]
    log(f"  profile {eng.model.cfg.name}: {out['mixed_steps']} mixed + "
        f"{out['decode_steps']} decode steps")
    return out


def phase_profile(rec: dict, state: dict) -> None:
    """Where a warm yi-6b serving pass spends its time (the mixtral pass is
    traced by ``moe_serve``).  Runs after the launch counts are read, so
    it adds none to them."""
    if "engine" not in state:
        raise RuntimeError("the profile phase needs the serve phase")
    rec["profile"] = trace_pass(state["engine"], seed=2)


# ---------------------------------------------------------------------------
# the tile tuner: serve --autotune --tile-cache on the serve phase's weights
# ---------------------------------------------------------------------------

# the archs whose decode cells the tune phase measures beside yi-6b's
TUNE_DECODE_ARCHS = ("rwkv6-3b", "musicgen-large")


def _tuned_shape(key: str, entry: dict):
    """The planner's shape of a tuned cell, from its key and guards."""
    kind, m, k, n = key.split(":")[:4]
    m, k, n = int(m[1:]), int(k[1:]), int(n[1:])
    if kind == "gemm":
        return (m, k, n)
    if kind == "paged_decode":
        ps = entry["page_size"]
        return (m, *entry["heads"], n, ps, k // ps)
    if kind == "moe_gemm":
        return (entry["experts"], m // entry["experts"], k, n)
    x, w, stride, pad, r = entry["geometry"]
    return (tuple(x), tuple(w), tuple(stride), tuple(map(tuple, pad)), r)


def retime_overruled(entries: dict) -> dict:
    """Every cell whose measured winner overruled the planner, timed again
    (fresh operands, the same card timer): does the winner stay faster?
    The spread between the two timings is what a measured win has to beat
    before it means anything."""
    from repro_torch.tuning import search
    out = {}
    for key, e in entries.items():
        if e["agrees_with_model"]:
            continue
        kind = key.split(":")[0]
        fields = search._op(kind).fields
        timer = search.card_timer(kind, _tuned_shape(key, e),
                                  dtype_name=key.split(":")[4],
                                  extra={"window": e["window"]}
                                  if "window" in e else None)
        win = tuple(e[f] for f in fields)
        pick = tuple(e["model_pick"][f] for f in fields)
        out[key] = {"winner_us": [e["measured_us"], timer(win)],
                    "pick_us": [e["model_pick"]["measured_us"], timer(pick)]}
    held = sum(r["winner_us"][1] < r["pick_us"][1] for r in out.values())
    log(f"  tune: re-timed, the winner stayed faster than the planner's pick "
        f"in {held} of {len(out)} overruled cells")
    return out


def _recording(mod, seen: dict, nshape: int):
    """Wrap ``mod._launch_plan`` so that every call records its shape (the
    first ``nshape`` arguments) and its choice (the last) in ``seen``;
    returns the original, to restore."""
    orig = mod._launch_plan

    def launch_plan(*args):
        seen.setdefault(tuple(args[:nshape]), set()).add(args[-1])
        return orig(*args)
    mod._launch_plan = launch_plan
    return orig


def phase_tune(rec: dict, state: dict) -> None:
    """``serve --autotune --tile-cache`` on the card: yi-6b's serving cells
    (its 10 ``kraken_gemm`` cells and its ``paged_decode_attention`` pool
    geometry) warmed into a fresh cache file through
    ``launch.serve.warm_tile_cache``, every candidate held against the plain
    version before it is timed; a second warm-up from the file must be
    fully warm.  ``grouped_moe_gemm`` is tuned at mixtral-8x22b's two cell
    widths (random operands), ``kraken_conv2d_direct``'s (BN, split) at
    VGG-16's conv layers at batch 1 and 32.  Then the serve phase's weights
    are served in mode ``cached``: every logit finite, zero new signatures
    when warm, every launch's choice the cached winner (the plans
    ``_launch_plan`` saw), and tok/s and token agreement with the serve
    phase's model-plan engine reported, not gated."""
    import numpy as np
    import torch
    from repro_torch import tuning
    from repro_torch.configs import get_arch
    from repro_torch.core.conv_cases import CONV_R, conv_geometries
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.core.unified import (arch_cells, dedup_cells,
                                          tunable_cells)
    from repro_torch.launch.serve import warm_tile_cache
    from repro_torch.models.model import Model
    from repro_torch.serving import PagedEngine
    from repro_torch.tuning import search
    if "params" not in state:
        raise RuntimeError("the tune phase needs the serve phase's weights")
    path = ROOT / "build" / "tune" / "plans.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    model = _yi6b()
    cfg = model.cfg
    kw = dict(slots=SLOTS, prompt_lens=[CHUNK], cache_len=MAX_LEN,
              prefill_batch=SLOTS, page_size=PAGE,
              paged_geoms=PagedEngine.pool_geoms(
                  model, slots=SLOTS, page_size=PAGE, max_len=MAX_LEN))
    out: dict = {"cache": str(path.relative_to(ROOT))}
    try:
        lines = []

        def say(msg):
            lines.append(msg)
            log(f"  {msg}")
        for run in ("first", "second"):
            tuning.set_tile_cache(str(path))     # the file, as a server reads it
            t0 = time.perf_counter()
            statuses = warm_tile_cache(cfg, autotune=True, log=say, **kw)
            torch.cuda.synchronize()
            out[f"{run}_warm_s"] = time.perf_counter() - t0
            out[f"{run}_statuses"] = statuses
            out[f"{run}_summary"] = lines[-1]
        n = len(out["first_statuses"])
        if out["first_statuses"] != ["tuned"] * n:
            raise AssertionError(f"tune: a fresh cache did not tune every "
                                 f"cell: {out['first_statuses']}")
        want = f"tile-cache: {n}/{n} cells hit — fully warm"
        if out["second_summary"] != want:
            raise AssertionError(f"tune: the second warm-up printed "
                                 f"{out['second_summary']!r}, not {want!r}")
        cache = tuning.get_tile_cache()
        sms = tuning.card_sms()
        t0 = time.perf_counter()
        out["moe_statuses"] = tuning.warm_moe_gemm(
            get_arch("mixtral-8x22b"), [SLOTS, SLOTS * CHUNK], cache=cache,
            log=say)
        for net, layer, h, w, ci, k, s, pad, co in conv_geometries():
            if net == "vgg16":
                for nb in (1, 32):
                    tuning.autotune_conv((nb, h, w, ci), (k, k, ci, co),
                                         stride=(s, s), padding=pad,
                                         R=CONV_R, sms=sms, cache=cache,
                                         log=say)
        # the decode cells where the planner is least trusted: rwkv6-3b's
        # and musicgen-large's small weights, and the G = 1 paged geometry
        # musicgen-large and zamba2-1.2b's shared block serve
        for arch in TUNE_DECODE_ARCHS:
            acfg = get_arch(arch)
            tuning.autotune_cells(dedup_cells(tunable_cells(arch_cells(
                acfg, batch=SLOTS, seq_q=1, seq_kv=MAX_LEN))), cache=cache,
                sms=sms, log=say)
            if acfg.num_heads:
                tuning.warm_paged_decode(
                    acfg, PagedEngine.pool_geoms(
                        Model(acfg), slots=SLOTS, page_size=PAGE,
                        max_len=MAX_LEN), page_size=PAGE, cache=cache,
                    sms=sms, log=say)
        out["other_cells_s"] = time.perf_counter() - t0
        out["cells"] = {key: entry for key, entry in cache.entries.items()}
        out["retimed"] = retime_overruled(cache.entries)
        agree = sum(e["agrees_with_model"] for e in cache.entries.values())
        log(f"  tune: {len(cache)} cells measured, the planner's pick won "
            f"{agree}")

        # serve the serve phase's weights in mode "cached"
        tuning.set_tile_cache(str(path))
        tuning.set_tile_mode("cached")
        seen = {"gemm": {}, "paged": {}}
        orig = (_recording(kg, seen["gemm"], 3),
                _recording(pa, seen["paged"], 6))
        try:
            eng = _engine(model, state["params"])
            finite = _check_logits(eng)
            _zero_counts()
            passes = serve_passes(eng, "tune")
            launches = _read_counts()
        finally:
            kg._launch_plan, pa._launch_plan = orig
        if not bool(finite[0]):
            raise AssertionError("tune: a served logit is not finite")
        steps = eng._prefill.calls + eng._decode.calls
        if launches["kraken_gemm"] != (LAYERS * 7 + 1) * steps or \
                launches["paged_decode_attention"] != LAYERS * \
                eng._decode.calls:
            raise AssertionError(f"tune: launch counts {launches} do not "
                                 f"match {steps} steps")
        wrong, missing = [], []
        for kind, op in (("gemm", "gemm"), ("paged", "paged_decode")):
            for shape, choices in seen[kind].items():
                winner = search.lookup(op, shape, dtype_name="bfloat16",
                                       sms=sms, cache=cache, count=False)
                if winner is None:
                    missing.append((op, shape))
                if choices != {winner}:
                    wrong.append((op, shape, sorted(map(str, choices)),
                                  winner))
        plans = sum(len(c) for v in seen.values() for c in v.values())
        if wrong or missing:
            raise AssertionError(f"tune: launched choices differ from the "
                                 f"cached winners: {wrong}; no entry: "
                                 f"{missing}")
        # one more warm pass under each mode on the same engine, in turns:
        # the host's state then weighs on both alike
        pair = {}
        for mode in ("model", "cached"):
            tuning.set_tile_mode(mode)
            pair[mode] = serve_passes(eng, f"tune {mode}", reps=1)[0]
        out["pair_tok_s"] = {m: p["tok_s"] for m, p in pair.items()}
        ref_out = [t for p in rec["serve"]["passes"] for r in p["out"]
                   for t in r]
        got_out = [t for p in passes for r in p["out"] for t in r]
        same = float(np.mean(np.asarray(ref_out) == np.asarray(got_out)))
        out.update(passes=passes, launches=launches, launched_plans=plans,
                   token_agreement_with_model_plans=same,
                   tok_s_model_plans=rec["serve"]["passes"][1]["tok_s"])
        log(f"  tune: {plans} plans launched ({len(seen['gemm'])} kraken_gemm "
            f"shapes, {len(seen['paged'])} paged geometry), each the cached "
            f"winner; warm pass {passes[1]['tok_s']:.1f} tok/s (the serve "
            f"phase's model plans {rec['serve']['passes'][1]['tok_s']:.1f}; "
            f"one more pass each on this engine: model "
            f"{pair['model']['tok_s']:.1f}, cached "
            f"{pair['cached']['tok_s']:.1f}), bf16 tokens agree with the "
            f"model-plan engine {same:.3f}")
        del eng
    finally:
        tuning.set_tile_mode("model")
        tuning.set_tile_cache(tuning.TileCache(path=None))
    rec["tune"] = out
    log(f"tune: {n} yi-6b cells tuned, then fully warm; "
        f"{len(out['moe_statuses'])} grouped_moe_gemm cells, VGG-16's conv "
        f"layers and the decode cells of {', '.join(TUNE_DECODE_ARCHS)} "
        f"tuned ({len(out['cells'])} cells in all); served in mode cached "
        f"with every launch on its cached winner, every logit finite, zero "
        f"new signatures warm")


def _mixtral(kernels=None, layers: int = MOE_LAYERS, dtype: str = "bfloat16"):
    """mixtral-8x22b at full width and ``layers`` of its 56 layers."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_arch("mixtral-8x22b"), num_layers=layers,
                              dtype=dtype)
    return Model(cfg, kernels=kernels)


def _release(state: dict, *keys) -> None:
    import gc
    import torch
    for k in keys:
        state.pop(k, None)
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_serve(rec: dict, state: dict) -> None:
    import torch
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import kraken_moe_gemm as mg
    from repro_torch.kernels import paged_attention as pa
    _release(state, "engine", "params",
             *(f"{k}_{x}" for k in RECURRENT for x in ("engine", "params")))
    log(f"  released the earlier models: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()
    model = _mixtral()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    state["moe_params"] = params
    eng = _engine(model, params)
    if eng.stats()["moe_gemm"] != "kernel":
        raise AssertionError("the mixtral engine does not run the kernel")
    kg.launches = pa.launches = mg.launches = 0
    passes = serve_passes(eng, "moe_serve")
    launches = {"kraken_gemm": kg.launches,
                "paged_decode_attention": pa.launches,
                "grouped_moe_gemm": mg.launches}
    mixed, dec = eng._prefill.calls, eng._decode.calls
    want = {"kraken_gemm": (4 * MOE_LAYERS + 1) * (mixed + dec),
            "paged_decode_attention": MOE_LAYERS * dec,
            "grouped_moe_gemm": 3 * MOE_LAYERS * (mixed + dec)}
    if launches != want:
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{mixed} mixed + {dec} decode steps: {want}")
    peak = torch.cuda.max_memory_allocated()
    rec["moe_serve"] = {"params": n_params, "init_s": init_s,
                        "layers": MOE_LAYERS, "passes": passes,
                        "report": eng.report(), "launches": launches,
                        "max_memory_allocated_gb": peak / 1e9}
    state["moe_engine"] = eng
    log(f"  {eng.report()}")
    log(f"moe_serve: mixtral-8x22b {MOE_LAYERS} layers "
        f"{n_params / 1e9:.2f} B params bf16, peak "
        f"{peak / 1e9:.1f} GB allocated, warm pass "
        f"{passes[1]['tok_s']:.1f} tok/s, ttft mean "
        f"{passes[1]['ttft_mean_s'] * 1e3:.0f} ms, zero new signatures, "
        f"launches {launches} (grouped_moe_gemm = 3 x {MOE_LAYERS} per step)")
    rec["moe_serve"]["long_context"] = long_context_full(
        model, params, "moe_serve", {"kraken_gemm": 4 * MOE_LAYERS + 1,
                                     "grouped_moe_gemm": 3 * MOE_LAYERS})
    if "profile" in rec["phases"]:
        rec["moe_profile"] = trace_pass(eng, seed=2)
        for r in rec["moe_profile"]["ported"]:
            if "grouped_moe_gemm" in r["name"]:
                log(f"    grouped_moe_gemm by kernel: {r['us'] / 1e3:.2f} ms "
                    f"x{r['count']} {r['name'][:80]}")


def _capture_moe_inputs(fn):
    """Run ``fn()`` while recording every MoE layer's (params, input)."""
    from repro_torch.models import moe as M
    seen = []
    orig = M.moe_block

    def recording(cfg, params, prefix, x, **kw):
        seen.append((params, x))
        return orig(cfg, params, prefix, x, **kw)

    M.moe_block = recording
    try:
        out = fn()
    finally:
        M.moe_block = orig
    return out, seen


def _routes(cfg, seen):
    """The top-k expert set of every row of every recorded MoE input, as
    the port routes it (stable sort: the lower expert first on a tie)."""
    import torch
    out = []
    for params, x in seen:
        xt = x.reshape(-1, x.shape[-1]).float()
        probs = torch.softmax(xt @ params["moe_router"].float(), dim=-1)
        ids = torch.sort(probs, dim=-1, descending=True,
                         stable=True)[1][:, :cfg.experts_per_token]
        out.append(ids.sort(dim=-1)[0])
    return out


def _flips(cfg, seen_k, seen_p) -> int:
    """(token, layer) routing choices that differ between two runs of
    ``two_steps``, over the live tokens only (64, 40 and 1 mixed-step
    tokens, then 3 decode tokens)."""
    import torch
    n_moe = len(seen_k) // 2
    flips = 0
    for i, (a, b) in enumerate(zip(_routes(cfg, seen_k),
                                   _routes(cfg, seen_p))):
        diff = (a != b).any(-1)
        if i < n_moe:                         # mixed step [SLOTS * CHUNK]
            diff = diff.reshape(SLOTS, CHUNK)
            cols = torch.arange(CHUNK, device=diff.device)
            lens = torch.tensor([CHUNK, 40, 1, 0], device=diff.device)
            diff = diff & (cols[None, :] < lens[:, None])
        else:                                 # decode step [SLOTS]
            diff = diff[:3]
        flips += int(diff.sum().item())
    return flips


def _layer_gate(cfg, seen, plain) -> float:
    """Every recorded MoE layer's input through the kernel block and through
    the plain block, so both route alike and only the expert FFN differs;
    the first kernel block runs under ``set_sync_debug_mode("error")``, so
    a host sync anywhere in it raises.  Returns the largest error."""
    import torch
    from repro_torch.models import moe as M
    from repro_torch.core.gemm_cases import GEMM_TOL
    from repro_torch.models.layers import DEFAULT_KERNELS
    atol, rtol = GEMM_TOL["bfloat16"]
    err = 0.0
    for i, (p, x) in enumerate(seen):
        torch.cuda.synchronize()
        if i == 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            yk = M.moe_block(cfg, p, "moe", x, kernels=DEFAULT_KERNELS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        yp = M.moe_block(cfg, p, "moe", x, kernels=plain)
        step = "mixed" if i < len(seen) // 2 else "decode"
        err = max(err, assert_close(f"moe layer {i % (len(seen) // 2)} "
                                    f"({step} step)", yk.y, yp.y, atol, rtol))
        if not torch.equal(yk.aux_loss, yp.aux_loss):
            raise AssertionError(f"moe layer {i}: the aux loss differs")
    return err


def phase_moe_e2e(rec: dict, state: dict) -> None:
    """The MoE gates: per layer with shared routing, then the whole
    model."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = _plain_kernels()
    model = _mixtral()
    cfg = model.cfg
    params = state.get("moe_params")
    if params is None:
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
    got, seen_k = _capture_moe_inputs(lambda: two_steps(model, params))

    layer_err = _layer_gate(cfg, seen_k, plain)
    log(f"  moe_e2e: {len(seen_k)} MoE layers (mixed + decode) agree with "
        f"the plain block at shared routing, max err {layer_err:.2e}; one "
        "ran under set_sync_debug_mode('error')")
    res = {"layer_gate": {"layers": len(seen_k), "max_abs_err": layer_err,
                          "sync_debug_error_mode": True}}

    # 2. the whole model, kernels against plain versions
    want, seen_p = _capture_moe_inputs(
        lambda: two_steps(_mixtral(plain), params))
    flips = _flips(cfg, seen_k, seen_p)
    res["bf16"] = {"routing_flips": flips, "layers": MOE_LAYERS}
    for i, name in enumerate(("mixed step", "decode step")):
        res["bf16"][name] = compare_logits(f"mixtral bf16 {name}", got[i],
                                           want[i], cfg.vocab_size)
    log(f"  moe_e2e: {flips} of {MOE_LAYERS * (CHUNK + 40 + 1 + 3)} "
        "(token, layer) routing choices differ between the kernel run and "
        "the plain run")
    ok = all(res["bf16"][n]["ok"] for n in ("mixed step", "decode step"))
    if not ok:
        if not flips:
            raise AssertionError("moe_e2e: bf16 logits out of tolerance "
                                 "with identical routing")
        # routing flips of near-tied tokens are what separates the runs:
        # hold the whole model in float32 at 2 layers, where the kernel
        # and the plain sums agree to ~1e-6 and nothing near-ties
        _release(state, "moe_engine", "moe_params")
        del params, got, want, seen_k, seen_p
        _release(state)
        m32 = _mixtral(layers=2, dtype="float32")
        p32 = m32.init(torch.Generator(device="cuda").manual_seed(0))
        got, seen_k = _capture_moe_inputs(lambda: two_steps(m32, p32))
        want, seen_p = _capture_moe_inputs(lambda: two_steps(
            _mixtral(plain, layers=2, dtype="float32"), p32))
        flips32 = _flips(m32.cfg, seen_k, seen_p)
        res["float32_2_layers"] = {"routing_flips": flips32}
        for i, name in enumerate(("mixed step", "decode step")):
            r = compare_logits(f"mixtral f32 2 layers {name}", got[i],
                               want[i], cfg.vocab_size)
            res["float32_2_layers"][name] = r
            if not r["ok"]:
                raise AssertionError(f"moe_e2e float32 {name}: "
                                     f"{r['max_abs_err']} > {E2E_TOL} * "
                                     f"{r['max_abs_plain']}")
        log(f"  moe_e2e: float32 at 2 layers: {flips32} routing choices "
            "differ")
    rec["moe_e2e"] = res
    log(f"moe_e2e: grouped_moe_gemm agrees with the plain expert FFN in "
        f"every MoE layer; whole mixtral {'bf16' if ok else 'float32 (2 layers)'} "
        f"logits within {E2E_TOL} of the largest logit")


# ---------------------------------------------------------------------------
# the dense-cache path: decode_attention and int8 KV
# ---------------------------------------------------------------------------

# the dense cases (DENSE_Q_POS, DENSE_EMPTY_ROW, DENSE_CASES) are
# repro_torch.core.attention_cases's
# the decode step of dense_e2e: per-slot positions after a 64-token prefill
DENSE_E2E_POS = [64, 65, 100, 600]
# dense_serve's decode_attention calls: one slot, a MAX_LEN cache, each
# prompt's decode at positions n .. n + SERVE_NEW - 2; its middle stands for
# the prompt's 15 steps
DENSE_SERVE_Q_POS = [n + (SERVE_NEW - 2) // 2 for n in SERVE_LENS]


def dense_positions(s: int, shared: bool, q_pos: list, empty_row):
    """kv_pos as decode leaves a ring of ``s`` slots: slot ``p % s`` holds
    the last ``s`` positions up to q_pos; row ``empty_row`` holds nothing.
    Returns (kv_pos [B, S] or [S] numpy, q_pos list)."""
    import numpy as np
    if shared:
        pos = np.full((s,), -(2 ** 30), np.int32)
        p = np.arange(s, dtype=np.int32)
        pos[p % s] = p
        return pos, [s - 1] * len(q_pos)
    pos = np.full((len(q_pos), s), -(2 ** 30), np.int32)
    for i, qp in enumerate(q_pos):
        if i == empty_row:
            continue
        p = np.arange(max(0, qp + 1 - s), qp + 1, dtype=np.int32)
        pos[i, p % s] = p
    return pos, list(q_pos)


def dense_attn_case(torch, dec, ref, *, dtype, s, window, shared, timed,
                    q_pos, empty_row, seed=0):
    """One ``decode_attention`` call at the yi-6b decode shape, one slot
    per ``q_pos``: parity with the plain version under ``DECODE_TOL`` (the
    ``empty_row`` must be exact zeros) and the same bits on a second run;
    when ``timed``, the kernel's, the plain version's and one SDPA's time,
    event-timed (host included) and device-only (``graph_ms``).  The timed
    K/V rotate over copies that exceed the 50 MB L2, as the 32 layers'
    distinct caches of a decode step do.  A miss does not raise: the row
    says ``ok`` False and the least atol it needs (``check_rows``)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core.attention_cases import DECODE_TOL
    b, h, kvh, d = len(q_pos), HEADS, KV_HEADS, HEAD_DIM
    quant = dtype == torch.int8
    qdt = torch.bfloat16 if quant else dtype
    pos_np, q_pos = dense_positions(s, shared, q_pos, empty_row)
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, kvh, s, d)

    def make_kv():
        if quant:
            kv = [torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int32).to(torch.int8)
                  for _ in range(2)]
            return kv + [torch.rand(shape[:3], generator=g, device="cuda")
                         / 127 for _ in range(2)]
        return [torch.randn(shape, generator=g, device="cuda").to(dtype)
                for _ in range(2)] + [None, None]

    isz_kv = 1 if quant else torch.tensor([], dtype=dtype).element_size()
    caches = (rotating(make_kv, 2 * b * kvh * s * d * isz_kv, most=512)
              if timed else [make_kv()])
    q = torch.randn((b, h, d), generator=g, device="cuda").to(qdt)
    kw = dict(kv_pos=torch.as_tensor(pos_np, device="cuda"),
              q_pos=torch.tensor(q_pos, dtype=torch.int32, device="cuda"),
              window=window)
    k, v, ks, vs = caches[0]
    got = dec.decode_attention(q, k, v, k_scale=ks, v_scale=vs, **kw)
    again = dec.decode_attention(q, k, v, k_scale=ks, v_scale=vs, **kw)
    want = ref.decode_attention(q, k, v, k_scale=ks, v_scale=vs, **kw)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    atol, rtol = DECODE_TOL[str(qdt).split(".")[-1]]
    err = (got.float() - want.float()).abs()
    finite = bool(torch.isfinite(got.float()).all())
    need = (float((err - rtol * want.float().abs()).max().clamp_min(0))
            if finite else math.inf)
    same = torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    empty_zero = (shared or empty_row is None
                  or got[empty_row].abs().max().item() == 0.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = dec.plan(b, h, kvh, s, d, dtype, sms=sms)
    row = {"dtype": name, "b": b, "s": s, "window": window, "shared": shared,
           "q_pos": q_pos, "max_abs_err": float(err.max()) if finite
           else math.inf, "atol_needed": need, "same_bits": same,
           "empty_row_zero": empty_zero,
           "ok": finite and need <= atol and same and empty_zero,
           "plan": plan, "plan_text": dec.describe(plan), "ms": None,
           "plain_ms": None, "library_ms": None, "bound_ms": None,
           "bound_by": None}
    del got, again, want, err
    if not timed:
        return row

    def cycle(items, fn):
        it = [0]

        def run():
            it[0] = (it[0] + 1) % len(items)
            return fn(*items[it[0]])
        return run

    def kernel(kk, vv, sk, sv):
        return dec.decode_attention(q, kk, vv, k_scale=sk, v_scale=sv, **kw)

    row["ms"] = time_ms(cycle(caches, kernel), 50)
    row["device_ms"] = graph_ms(cycle(caches, kernel), len(caches))
    row["plain_ms"] = time_ms(cycle(caches, lambda kk, vv, sk, sv:
                                    ref.decode_attention(q, kk, vv, k_scale=sk,
                                                         v_scale=sv, **kw)), 10)
    # the live entries of this run's positions
    kvp = pos_np if pos_np.ndim == 2 else np.broadcast_to(pos_np, (b, s))
    qp = np.asarray(q_pos)[:, None]
    live = (kvp >= 0) & (kvp <= qp)
    if window:
        live &= kvp > qp - window
    n_live = int(live.sum())
    # library: one SDPA on a bf16 (f32 for the f32 rows) cache with the
    # boolean mask; for int8 it reads a bf16 cache and skips the dequant
    lib_dt = torch.float32 if dtype == torch.float32 else torch.bfloat16
    lib = [(kk.to(lib_dt), vv.to(lib_dt)) for kk, vv, _, _ in caches]
    mask = torch.as_tensor(live, device="cuda")[:, None, None, :]
    q4 = q.to(lib_dt)[:, :, None, :]

    def sdpa(kk, vv):
        return F.scaled_dot_product_attention(q4, kk, vv, attn_mask=mask,
                                              enable_gqa=True)

    row["library_ms"] = time_ms(cycle(lib, sdpa), 50)
    row["device_library_ms"] = graph_ms(cycle(lib, sdpa), len(lib))
    del lib
    nbytes = (2 * b * h * d * q.element_size() + kvp.size * 4 + b * 4
              + n_live * (2 * kvh * d * isz_kv + (8 * kvh if quant else 0)))
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 4.0 * h * d * n_live,
                                                peak)
    row["live_entries"] = n_live
    return row


def check_rows(label: str, rows: list) -> None:
    """Raise, after every case has run, if any row of ``dense_attn_case``
    or ``swa_case`` missed its tolerance (or, for ``decode_attention``, gave
    other bits on its second run or a non-zero empty row)."""
    bad = [r for r in rows if not r["ok"]]
    if bad:
        need = max(r["atol_needed"] for r in bad)
        raise AssertionError(
            f"{label}: {len(bad)} of {len(rows)} cases fail (largest atol "
            f"needed {need:.3e}): "
            + "; ".join(f"{r.get('name', '')} {r['dtype']} S={r['s']} "
                        f"window={r['window']} need {r['atol_needed']:.2e}"
                        + (f" same_bits={r['same_bits']} empty_row_zero="
                           f"{r['empty_row_zero']}" if "same_bits" in r
                           else "")
                        for r in bad[:12]))


def dense_line(label: str, r: dict) -> str:
    """One log line of a ``dense_attn_case`` row."""
    out = (f"  {label} err={r['max_abs_err']:.2e} atol_needed="
           f"{r['atol_needed']:.2e}{'' if r['same_bits'] else ' BITS DIFFER'}"
           f" [{r['plan_text']}]")
    if r["ms"] is not None:
        out += (f" ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
                f"sdpa={r['library_ms']:.4f} bound={r['bound_ms']:.5f}; "
                f"device (graph) {r['device_ms']:.4f} sdpa "
                f"{r['device_library_ms']:.4f}")
    return out


def phase_dense_kernels(rec: dict, state: dict) -> None:
    import torch
    from repro_torch.core.attention_cases import (DENSE_CASES,
                                                  DENSE_EMPTY_ROW,
                                                  DENSE_Q_POS)
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        for s, window, shared, timed in DENSE_CASES:
            r = dense_attn_case(torch, dec, ref, dtype=dtype, s=s,
                                window=window, shared=shared, timed=timed,
                                q_pos=DENSE_Q_POS, empty_row=DENSE_EMPTY_ROW,
                                seed=len(rows))
            rows.append(r)
            log(dense_line(f"decode_attention {r['dtype']:8s} B={SLOTS} "
                           f"S={s:<3d} window={window:<3d} "
                           f"{'shared  ' if shared else 'per-slot'}", r))
            torch.cuda.empty_cache()
    # dense_serve's shape: int8, one slot, each prompt's middle decode step
    serve = []
    for qp in DENSE_SERVE_Q_POS:
        r = dense_attn_case(torch, dec, ref, dtype=torch.int8, s=MAX_LEN,
                            window=0, shared=False, timed=True, q_pos=[qp],
                            empty_row=None, seed=len(rows) + len(serve))
        serve.append(r)
        log(dense_line(f"decode_attention int8     B=1 S={MAX_LEN} "
                       f"q_pos={qp:<3d}", r))
        torch.cuda.empty_cache()
    rec["dense_attention"] = rows
    rec["dense_attention_serve"] = serve
    check_rows("dense_kernels: decode_attention", rows + serve)
    mean = {key: sum(r[key] for r in serve) / len(serve)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "device_ms", "device_library_ms")}
    log(f"dense_kernels: decode_attention matches plain in "
        f"{len(rows) + len(serve)} cases, each bit-identical over two runs "
        "(bf16, f32, int8; wrapped ring, window, ragged S, shared positions, "
        "all-empty row exact zero); at dense_serve's shape "
        f"[{serve[0]['plan_text']}] {mean['ms']:.4f} ms per call (plain "
        f"{mean['plain_ms']:.4f}, sdpa {mean['library_ms']:.4f}, x_sdpa "
        f"{mean['ms'] / mean['library_ms']:.2f}, bound "
        f"{mean['bound_ms']:.5f}); device (graph) {mean['device_ms']:.4f} "
        f"(sdpa {mean['device_library_ms']:.4f})")


def _yi6b_int8(kernels=None, layers: int | None = None,
               dtype: str = "bfloat16"):
    """yi-6b at full width with an int8 KV cache, at full depth or
    ``layers`` deep."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_arch("yi-6b"), kv_cache_dtype="int8",
                              dtype=dtype)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return Model(cfg, kernels=kernels)


def serve_prompts(vocab: int):
    """The serve workload's 8 prompts, as ``serve_passes`` draws its first
    pass."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)) for n in SERVE_LENS]


def dense_sequential(model, params, prompts, max_new: int) -> list:
    """Each prompt alone through the dense-cache path: ``init_caches`` (one
    slot, ``MAX_LEN`` entries), ``prefill``, then greedy ``decode_step`` at
    its own position.  Returns the generated tokens per prompt."""
    return sequential_requests(model, params, prompts, max_new)[0]


def sequential_requests(model, params, prompts, max_new: int, feeds=None):
    """``dense_sequential`` with, when ``feeds`` is given, each prompt's
    frontend (``frontend_feeds``: the prefill's, then one a decode step or
    None).  Returns (tokens per prompt, each prefill's last logits [V] in
    f32, the last prompt's caches)."""
    import torch
    outs, first, caches = [], [], None
    for i, prompt in enumerate(prompts):
        pre, steps = feeds[i] if feeds else (None, None)
        caches = model.init_caches(1, MAX_LEN)
        n = len(prompt)
        logits, caches = model.prefill(params, {
            "tokens": torch.as_tensor(prompt[None], device="cuda"),
            "positions": torch.arange(n, dtype=torch.int32, device="cuda"),
            "frontend": pre}, caches)
        first.append(logits[0, -1].float())
        seq = [int(torch.argmax(logits[0, -1]))]
        while len(seq) < max_new:
            pos = torch.full((1,), n + len(seq) - 1, dtype=torch.int32,
                             device="cuda")
            logits, caches = model.decode_step(
                params, caches, torch.tensor([[seq[-1]]], device="cuda"), pos,
                frontend=steps[len(seq) - 1] if steps else None)
            seq.append(int(torch.argmax(logits[0])))
        outs.append(seq)
    return outs, first, caches


def _counters():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import kraken_conv as kc
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import kraken_moe_gemm as mg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import swa_attention as sw
    return {"kraken_gemm": (kg, "launches"),
            "paged_decode_attention": (pa, "launches"),
            "grouped_moe_gemm": (mg, "launches"),
            "decode_attention": (dec, "launches"),
            "swa_attention": (sw, "launches"),
            "swa_attention_bwd": (sw, "bwd_launches"),
            "kraken_conv2d_direct": (kc, "launches")}


def _zero_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def phase_dense_serve(rec: dict, state: dict) -> None:
    import torch
    model = _yi6b_int8()
    params = state.get("params")
    if params is None:
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        state["params"] = params
    prompts = serve_prompts(model.cfg.vocab_size)
    dense_sequential(model, params, prompts[:1], 2)     # first-use warm-up

    # 1. the dense-cache path, one request at a time
    _zero_counts()
    t0 = time.perf_counter()
    outs = dense_sequential(model, params, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    toks = sum(len(o) for o in outs)
    dec_steps = len(prompts) * (SERVE_NEW - 1)
    _check_launches(f"dense path ({len(prompts)} prefills + {dec_steps} "
                    "decode steps)", launches,
                    {"kraken_gemm": (LAYERS * 7 + 1) * (len(prompts)
                                                        + dec_steps),
                     "decode_attention": LAYERS * dec_steps})
    bad = [i for i, o in enumerate(outs)
           if len(o) != SERVE_NEW
           or not all(0 <= t < model.cfg.vocab_size for t in o)]
    if bad:
        raise AssertionError(f"dense_serve: requests {bad} not served in "
                             "full")
    log(f"  dense int8 sequential: {len(prompts)} requests, {toks} tokens in "
        f"{wall:.2f} s = {toks / wall:.1f} tok/s, {dec_steps} decode steps, "
        f"launches {launches}")

    # 2. the same requests through an int8 PagedEngine
    eng = _engine(model, params)
    pool = eng.pools["slots"][0][0]
    if pool.k.dtype != torch.int8 or not pool.quantized:
        raise AssertionError("the int8 engine's pools are not int8")
    _zero_counts()
    passes = serve_passes(eng, "dense_serve int8 engine")
    eng_launches = _read_counts()
    dec_calls = eng._decode.calls
    if (eng_launches["paged_decode_attention"] != LAYERS * dec_calls
            or eng_launches["decode_attention"] != 0
            or eng_launches["kraken_gemm"] <= 0):
        raise AssertionError(f"int8 engine launch counts {eng_launches} "
                             f"({dec_calls} decode steps)")
    same = sum(a == b for a, b in zip(passes[0]["out"], outs))
    rec["dense_serve"] = {
        "sequential": {"wall_s": wall, "tokens": toks, "tok_s": toks / wall,
                       "decode_steps": dec_steps, "out": outs},
        "engine": passes, "report": eng.report(),
        "launches": launches, "engine_launches": eng_launches,
        "engine_requests_identical_to_sequential": same}
    log(f"  {eng.report()}")
    log(f"dense_serve: yi-6b int8 KV, dense sequential "
        f"{toks / wall:.1f} tok/s ({LAYERS} decode_attention launches per "
        f"decode step), int8 engine warm {passes[1]['tok_s']:.1f} tok/s; "
        f"{same} of {len(prompts)} requests token-identical between the two "
        f"(bf16, chunk {CHUNK})")


def dense_decode_logits(model, params, seed: int = 3):
    """Prefill 64 tokens in every slot of a dense cache, then one decode
    step at the per-slot positions ``DENSE_E2E_POS``; returns its logits."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab_size
    caches = model.init_caches(SLOTS, MAX_LEN)
    model.prefill(params, {
        "tokens": torch.as_tensor(rng.integers(0, vocab, (SLOTS, 64)),
                                  device="cuda"),
        "positions": torch.arange(64, dtype=torch.int32, device="cuda")},
        caches)
    logits, _ = model.decode_step(
        params, caches,
        torch.as_tensor(rng.integers(0, vocab, (SLOTS, 1)), device="cuda"),
        torch.tensor(DENSE_E2E_POS, dtype=torch.int32, device="cuda"))
    return logits


def phase_dense_e2e(rec: dict, state: dict) -> None:
    import torch
    from repro_torch.serving import CacheConfig, EngineConfig, PagedEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_model = _yi6b_int8()
    params = state.get("params")
    if params is None:
        params = kernel_model.init(
            torch.Generator(device="cuda").manual_seed(0))
    # 1. full width: one int8 dense decode step, kernels against plain
    got = dense_decode_logits(kernel_model, params)
    want = dense_decode_logits(_yi6b_int8(_plain_kernels()), params)
    res = {"decode step": compare_logits(
        "yi-6b int8 dense decode step", got, want,
        kernel_model.cfg.vocab_size, rows=SLOTS)}
    if not res["decode step"]["ok"]:
        r = res["decode step"]
        raise AssertionError(f"dense_e2e: {r['max_abs_err']} > {E2E_TOL} * "
                             f"{r['max_abs_plain']}")
    del got, want

    # 2. float32, 2 layers: the int8 engine (whole-prompt prefill) against
    # the int8 dense sequential path, token for token
    m32 = _yi6b_int8(layers=2, dtype="float32")
    p32 = m32.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = serve_prompts(m32.cfg.vocab_size)
    _zero_counts()
    seq = dense_sequential(m32, p32, prompts, SERVE_NEW)
    eng = PagedEngine(m32, p32, config=EngineConfig(
        slots=SLOTS, chunk=None,
        cache=CacheConfig(page_size=PAGE, max_len=MAX_LEN)))
    reqs = [eng.submit(p, SERVE_NEW) for p in prompts]
    eng.run_until_idle()
    counts = _read_counts()
    if not (counts["decode_attention"] and counts["paged_decode_attention"]):
        raise AssertionError(f"dense_e2e: a kernel did not run: {counts}")
    diff = [i for i, (r, o) in enumerate(zip(reqs, seq)) if list(r.out) != o]
    if diff:
        raise AssertionError(f"dense_e2e: int8 engine requests {diff} differ "
                             "from the int8 dense sequential path")
    res["float32_2_layers"] = {"requests": len(prompts),
                               "tokens": sum(len(o) for o in seq),
                               "token_identical": True, "launches": counts}
    rec["dense_e2e"] = res
    log(f"  dense_e2e: float32 2 layers: the int8 engine (chunk None) is "
        f"token-identical to the int8 dense sequential path on all "
        f"{len(prompts)} requests ({sum(len(o) for o in seq)} tokens)")
    log(f"dense_e2e: int8 dense decode logits within {E2E_TOL} of the "
        "largest logit (bf16, full yi-6b); engine == sequential in float32")


# ---------------------------------------------------------------------------
# the recurrent families: rwkv6-3b and zamba2-1.2b
# ---------------------------------------------------------------------------

# (arch, its kraken_gemm table in repro_torch.core.gemm_cases, calls of the
# shared attention block per decode step: paged_decode_attention launches)
RECURRENT = {"rwkv": ("rwkv6-3b", "RWKV_GEMMS", 0),
             "zamba": ("zamba2-1.2b", "ZAMBA_GEMMS", 6)}
# the recurrence phase: one full-width layer of each mixer in float32 over
# RECUR_SEQ tokens (five chunks of the port's 64), rows of RECUR_LENS
# tokens; the chunked mix against a token-by-token loop of the same layer's
# step, outputs and final states within RECUR_TOL * max |want| (on the CPU
# the two agree within 6e-6 of it, and JAX's own chunked mix is NaN there)
RECUR_SEQ, RECUR_LENS, RECUR_TOL = 300, (300, 217), 1e-4
# the *_e2e phases' float32 engine-against-sequential check: rwkv6-3b at 2
# layers, zamba2-1.2b at 7 (one period of 6 Mamba2 layers and the shared
# block, then one tail layer)
RECUR_E2E_LAYERS = {"rwkv": 2, "zamba": 7}

# the *_e2e phases' bf16 gate, one recurrent layer at a time at shared
# inputs: the layer's increment (output - input) and its new state rows,
# kernels against plain versions, within RECUR_LAYER_TOL in relative L2.
# Emulated on the CPU at full width (one layer, random inputs), a last-ulp
# GEMM difference moves them by 1.8e-3 (RWKV6) and 2.4e-4 (Mamba2); a GEMM
# that drops its first 64 of K moves them by 0.32-0.40
RECUR_LAYER_TOL = 0.02


def _capture_recurrent_inputs(fn):
    """Run ``fn()`` while recording every recurrent layer's (slot, params,
    input, state before the layer, context)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving.state import map_tensors
    seen = []
    orig = T.apply_slot

    def recording(cfg, slot, params, x, cache, ctx):
        if slot.kind in ("rwkv", "mamba"):
            seen.append((slot, params, x.clone(),
                         map_tensors(torch.clone, cache), ctx))
        return orig(cfg, slot, params, x, cache, ctx)

    T.apply_slot = recording
    try:
        out = fn()
    finally:
        T.apply_slot = orig
    return out, seen


def _rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _recurrent_layer_errs(cfg, rec, kernels, plain) -> tuple[float, float]:
    """One recorded layer through ``kernels`` and through ``plain`` from the
    same input and state: the relative L2 error of its increment and the
    largest of its new state rows'."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving.state import map_tensors, tensor_leaves
    slot, params, x, st, ctx = rec
    outs = []
    for k in (kernels, plain):
        c = map_tensors(torch.clone, st)
        y, c, _ = T.apply_slot(cfg, slot, params, x, c,
                               ctx._replace(kernels=k))
        outs.append((y - x, c))
    (dk, ck), (dp, cp) = outs
    if not (torch.isfinite(dk).all() and torch.isfinite(dp).all()):
        raise AssertionError("a recurrent layer's output is not finite")
    return _rel_l2(dk, dp), max(_rel_l2(a, b) for a, b in zip(
        tensor_leaves(ck), tensor_leaves(cp)))


def recurrent_layer_gate(cfg, seen, plain) -> dict:
    """Every recorded recurrent layer (a mixed step's, then a decode
    step's) at shared inputs, kernels against plain versions, within
    RECUR_LAYER_TOL; then the first layer again with a planted fault (its
    GEMMs drop the first 64 of K), which the gate must catch."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import DEFAULT_KERNELS

    def dropping(a, b, **kw):
        return ops.kraken_matmul(a[..., 64:].contiguous(),
                                 b[64:].contiguous(), **kw)

    errs = [_recurrent_layer_errs(cfg, r, DEFAULT_KERNELS, plain)
            for r in seen]
    worst = max(range(len(errs)), key=lambda i: max(errs[i]))
    planted = _recurrent_layer_errs(
        cfg, seen[0], DEFAULT_KERNELS._replace(matmul=dropping), plain)
    res = {"layers": len(seen), "tol": RECUR_LAYER_TOL,
           "max_rel_l2_out": max(e[0] for e in errs),
           "max_rel_l2_state": max(e[1] for e in errs),
           "worst_layer": worst, "planted_fault": planted,
           "ok": max(max(e) for e in errs) <= RECUR_LAYER_TOL,
           "planted_caught": max(planted) > RECUR_LAYER_TOL}
    log(f"  {cfg.name} bf16 per-layer gate: {len(seen)} layer calls, "
        f"increment {res['max_rel_l2_out']:.2e} state "
        f"{res['max_rel_l2_state']:.2e} relative L2 (worst call {worst}); "
        f"planted fault {planted[0]:.2e} / {planted[1]:.2e}")
    return res


def rwkv_bonus_gap(model, params, plain) -> dict:
    """The bf16 whole-model gap (kernels against plain versions) again with
    every RWKV bonus ``u`` drawn from a seeded normal instead of the init's
    zeros, reported: with u = 0 a head's output at its second token is
    sign(r . k) times a normalized v, so a last-ulp change of a near-zero
    r . k flips it; a nonzero u adds the current token's own term."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(7)
    saved = []
    for layer in params["stack"]["slots"] + params["stack"]["tail"]:
        if "rwkv_bonus" in layer:
            saved.append((layer, layer["rwkv_bonus"].clone()))
            layer["rwkv_bonus"].copy_(torch.randn(
                layer["rwkv_bonus"].shape, generator=g, device="cuda"))
    try:
        got = two_steps(model, params)
        want = two_steps(type(model)(model.cfg, kernels=plain), params)
        out = {name: compare_logits(f"{model.cfg.name} bf16 seeded bonus "
                                    f"{name}", got[i], want[i],
                                    model.cfg.vocab_size)
               for i, name in enumerate(("mixed step", "decode step"))}
    finally:
        for layer, u in saved:
            layer["rwkv_bonus"].copy_(u)
    return out


def _full_width(arch: str, kernels=None, dtype: str = "bfloat16",
                layers: int | None = None):
    """``arch`` at full width, at full depth or ``layers`` deep."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_arch(arch), dtype=dtype)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return Model(cfg, kernels=kernels)


def _check_logits(eng) -> list:
    """Make ``eng`` check every logit row it samples from on the device
    (no sync); the returned list's one element is the running flag."""
    import torch
    flag = [torch.ones((), dtype=torch.bool, device="cuda")]
    sample = eng._sample

    def checked(logits):
        flag[0] = flag[0] & torch.isfinite(logits).all()
        return sample(logits)

    eng._sample = checked
    return flag


def serve_full_width(state: dict, key: str, arch: str, table: str,
                     attn_calls: int):
    """Serve ``arch`` at full width and depth (bf16, seeded weights)
    through the engine, twice (``serve_passes``: no new signature when
    warm): every logit finite and the launches exactly ``table``'s
    ``kraken_gemm`` count a step and ``attn_calls``
    ``paged_decode_attention`` a decode step.  The caller releases the
    earlier models first.  Returns (model, params, engine, the phase's
    record so far)."""
    import torch
    from repro_torch.core import gemm_cases
    log(f"  released the earlier models: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()
    model = _full_width(arch)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    state[f"{key}_params"] = params
    eng = _engine(model, params)
    state[f"{key}_engine"] = eng
    finite = _check_logits(eng)
    _zero_counts()
    passes = serve_passes(eng, f"{key}_serve")
    launches = _read_counts()
    mixed, dec = eng._prefill.calls, eng._decode.calls
    per_step = sum(c for *_, c in getattr(gemm_cases, table))
    want = {name: 0 for name in launches}
    want["kraken_gemm"] = per_step * (mixed + dec)
    want["paged_decode_attention"] = attn_calls * dec
    if launches != want:
        raise AssertionError(f"{key}_serve: launch counts {launches} do not "
                             f"match {mixed} mixed + {dec} decode steps: "
                             f"{want}")
    if not bool(finite[0]):
        raise AssertionError(f"{key}_serve: a served logit is not finite")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {eng.report()}")
    log(f"{key}_serve: {arch} {n_params / 1e9:.2f} B params bf16, peak "
        f"{peak / 1e9:.1f} GB allocated, warm pass "
        f"{passes[1]['tok_s']:.1f} tok/s, ttft mean "
        f"{passes[1]['ttft_mean_s'] * 1e3:.0f} ms, every logit finite, zero "
        f"new signatures; per step {per_step} kraken_gemm and, per decode "
        f"step, {attn_calls} paged_decode_attention launches")
    return model, params, eng, {
        "arch": arch, "params": n_params, "init_s": init_s,
        "passes": passes, "report": eng.report(), "launches": launches,
        "launches_per_decode_step": {"kraken_gemm": per_step,
                                     "paged_decode_attention": attn_calls},
        "launches_per_mixed_step": {"kraken_gemm": per_step,
                                    "paged_decode_attention": 0},
        "max_memory_allocated_gb": peak / 1e9, "logits_finite": True}


def f32_engine_gate(key: str, arch: str, layers: int) -> dict:
    """``arch`` in float32 at full width cut to ``layers`` deep: the serve
    workload's 8 requests through the engine (chunk 64) must be
    token-identical to the sequential path."""
    import torch
    m32 = _full_width(arch, dtype="float32", layers=layers)
    p32 = m32.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = serve_prompts(m32.cfg.vocab_size)
    seq = dense_sequential(m32, p32, prompts, SERVE_NEW)
    eng = _engine(m32, p32)
    reqs = [eng.submit(p, SERVE_NEW) for p in prompts]
    eng.run_until_idle()
    diff = [i for i, (r, o) in enumerate(zip(reqs, seq)) if list(r.out) != o]
    if diff:
        raise AssertionError(f"{key}_e2e: float32 {layers} layers: engine "
                             f"requests {diff} differ from the sequential "
                             "path")
    log(f"  {key}_e2e: float32 {layers} layers: the engine (chunk {CHUNK}) "
        f"is token-identical to the sequential path on all {len(prompts)} "
        "requests")
    return {"requests": len(prompts), "tokens": sum(len(o) for o in seq),
            "token_identical": True}


def recurrent_serve(rec: dict, state: dict, key: str) -> None:
    """Serve ``RECURRENT[key]``'s arch through ``serve_full_width``, then
    the same 8 requests one at a time through ``init_caches`` /
    ``prefill`` / ``decode_step``."""
    import torch
    arch, table, attn_calls = RECURRENT[key]
    _release(state, "engine", "params",
             *(f"{k}_{x}" for k in RECURRENT for x in ("engine", "params")))
    model, params, eng, out = serve_full_width(state, key, arch, table,
                                               attn_calls)

    # the same requests one at a time through the sequential path
    prompts = serve_prompts(model.cfg.vocab_size)
    t0 = time.perf_counter()
    outs = dense_sequential(model, params, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(o) for o in outs)
    same = sum(a == b for a, b in zip(out["passes"][0]["out"], outs))
    rec[f"{key}_serve"] = dict(
        out, sequential={"wall_s": wall, "tokens": toks,
                         "tok_s": toks / wall, "out": outs},
        engine_requests_identical_to_sequential=same)
    log(f"  {key}_serve sequential: {len(prompts)} requests one at a time, "
        f"{toks} tokens in {wall:.2f} s = {toks / wall:.1f} tok/s; {same} of "
        f"{len(prompts)} token-identical to the engine's first pass")
    rec[f"{key}_serve"]["long_context"] = long_context_full(
        model, params, f"{key}_serve",
        {"kraken_gemm": out["launches_per_decode_step"]["kraken_gemm"]})
    if "profile" in rec["phases"]:
        rec[f"{key}_profile"] = trace_pass(eng, seed=2,
                                           ranges=("recurrence",))


def recurrent_e2e(rec: dict, state: dict, key: str) -> None:
    """One mixed and one decode step of ``RECURRENT[key]``'s arch through
    the hand kernels and through the plain versions, on the served bf16
    weights (reported) and, gated within E2E_TOL, in float32 at full width
    and depth.  In bf16 the two differ by the GEMMs' last-ulp rounding,
    which rwkv6-3b at this init amplifies without bound: with its bonus
    u = 0, a head's normalized output at the second token is sign(r.k)
    times a normalized v, and a dot product near 0 flips sign on a
    one-ulp change.  Then, in float32 at ``RECUR_E2E_LAYERS`` deep, the
    serve workload's 8 requests through the engine (chunk 64) must be
    token-identical to the sequential path."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = RECURRENT[key][0]
    plain = _plain_kernels()
    res = {}
    for dtype in ("bfloat16", "float32"):
        model = _full_width(arch, dtype=dtype)
        params = state.get(f"{key}_params") if dtype == "bfloat16" else None
        if params is None:
            params = model.init(torch.Generator(device="cuda").manual_seed(0))
        got, seen = _capture_recurrent_inputs(lambda: two_steps(model,
                                                                params))
        want = two_steps(_full_width(arch, plain, dtype), params)
        for i, name in enumerate(("mixed step", "decode step")):
            res[f"{dtype} {name}"] = compare_logits(
                f"{arch} {dtype} {name}", got[i], want[i],
                model.cfg.vocab_size)
        if dtype == "bfloat16":
            res["bfloat16 layer gate"] = recurrent_layer_gate(model.cfg,
                                                              seen, plain)
            if key == "rwkv":
                res["bfloat16 seeded bonus"] = rwkv_bonus_gap(
                    model, params, plain)
        del params, got, want, seen
        _release(state, f"{key}_engine", f"{key}_params")
    gate = res["bfloat16 layer gate"]
    if not (gate["ok"] and gate["planted_caught"]):
        raise AssertionError(f"{key}_e2e: bf16 per-layer gate {gate}")
    bad = {k: v for k, v in res.items()
           if k.startswith("float32") and not v["ok"]}
    if bad:
        raise AssertionError(f"{key}_e2e: float32 kernels against plain "
                             f"beyond {E2E_TOL} of the largest logit: {bad}")
    layers = RECUR_E2E_LAYERS[key]
    res[f"float32_{layers}_layers"] = f32_engine_gate(key, arch, layers)
    rec[f"{key}_e2e"] = res
    log(f"{key}_e2e: float32 kernels agree with the plain versions within "
        f"{E2E_TOL} of the largest logit (full {arch}); bf16 every recurrent "
        f"layer within {RECUR_LAYER_TOL} at shared inputs, whole model "
        f"(reported) {max(res[f'bfloat16 {n}']['rel'] for n in ('mixed step', 'decode step')):.4f}")


def phase_recurrence(rec: dict, state: dict) -> None:
    """One full-width float32 layer of each mixer: the chunked mix over
    RECUR_SEQ tokens, rows of RECUR_LENS, against a loop of the layer's own
    per-token step (live while t < the row's length)."""
    import torch
    from repro_torch.models import ssm as SSM
    from repro_torch.models.layers import init_param
    torch.backends.cuda.matmul.allow_tf32 = False
    mixers = {"rwkv": ("rwkv", SSM.rwkv_specs, SSM.rwkv_mix, SSM.rwkv_step,
                       SSM.rwkv_state_init),
              "zamba": ("mamba", SSM.mamba_specs, SSM.mamba_mix,
                        SSM.mamba_step, SSM.mamba_state_init)}
    lengths = torch.tensor(RECUR_LENS, dtype=torch.int32, device="cuda")
    res = {}
    for key, (prefix, specs, mix, step, init) in mixers.items():
        cfg = _full_width(RECURRENT[key][0], dtype="float32").cfg
        g = torch.Generator(device="cuda").manual_seed(0)
        params = {n: init_param(g, sp, torch.float32, "cuda")
                  for n, sp in specs(cfg, prefix).items()}
        x = torch.randn((len(RECUR_LENS), RECUR_SEQ, cfg.d_model),
                        generator=g, device="cuda")
        y, st = mix(cfg, params, prefix, x, lengths=lengths)
        s = init(cfg, len(RECUR_LENS), torch.float32, "cuda")
        ys = []
        for t in range(RECUR_SEQ):
            yt, s = step(cfg, params, prefix, x[:, t:t + 1], s,
                         lengths=(t < lengths).to(torch.int32))
            ys.append(yt)
        want = torch.cat(ys, dim=1)
        torch.cuda.synchronize()
        if not torch.isfinite(y).all():
            raise AssertionError(f"recurrence {prefix}: non-finite output")
        y_err = max(float((y[b, :n] - want[b, :n]).abs().max()
                          / want[b, :n].abs().max())
                    for b, n in enumerate(RECUR_LENS))
        s_err = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(st, s))
        mix_ms = time_ms(lambda: mix(cfg, params, prefix, x,
                                     lengths=lengths), 5)
        step_ms = time_ms(lambda: step(cfg, params, prefix, x[:, :1], s,
                                       lengths=lengths), 20)
        res[RECURRENT[key][0]] = {
            "mixer": prefix, "seq": RECUR_SEQ, "lengths": list(RECUR_LENS),
            "rel_err_out": y_err, "rel_err_state": s_err,
            "mix_ms": mix_ms, "step_ms": step_ms,
            "ok": y_err <= RECUR_TOL and s_err <= RECUR_TOL}
        log(f"  recurrence {prefix} (d {cfg.d_model}, S {RECUR_SEQ}, rows "
            f"{RECUR_LENS}, float32): chunked mix against {RECUR_SEQ} steps "
            f"out {y_err:.2e} state {s_err:.2e} of max |want|; mix "
            f"{mix_ms:.3f} ms, one step {step_ms:.3f} ms")
        del params, x, y, st, s, ys, want
    rec["recurrence"] = res
    bad = {k: v for k, v in res.items() if not v["ok"]}
    if bad:
        raise AssertionError(f"recurrence: beyond {RECUR_TOL}: {bad}")
    log(f"recurrence: both chunked mixers finite at {RECUR_SEQ} tokens and "
        f"within {RECUR_TOL} of max |want| of their own steps")


# ---------------------------------------------------------------------------
# the cache-less windowed forward: swa_attention
# ---------------------------------------------------------------------------

def window_pairs(s: int, window: int) -> int:
    """(query, key) pairs inside a causal window of ``window`` over ``s``
    tokens: sum over i of min(i + 1, window)."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def swa_atol(torch, dt: str, s: int, window: int, device):
    """``SWA_TOL``'s atol of dtype ``dt`` for each query row [S, 1] of a
    call over ``s`` tokens: in bf16, row i attends to n = min(i + 1, W)
    keys, and past ``SWA_ROW_KEYS`` its atol is scaled by
    sqrt(SWA_ROW_KEYS / n)."""
    from repro_torch.core.attention_cases import SWA_ROW_KEYS, SWA_TOL
    atol = SWA_TOL[dt][0]
    if dt != "bfloat16":
        return torch.full((s, 1), atol, device=device)
    n = torch.clamp(torch.arange(s, device=device) + 1, max=window)
    scale = (SWA_ROW_KEYS / n.double()).clamp(max=1).sqrt()
    return (atol * scale).float()[:, None]


def swa_case(torch, sw, ref, *, name, b, h, kvh, s, d, window, dtype, timed,
             seed):
    """One ``swa_attention`` call: parity with the plain version under
    ``SWA_TOL`` and, when ``timed``, the kernel's, the plain version's and
    one SDPA's time (a boolean band mask, ``enable_gqa``), event-timed and
    device-only (``graph_ms``), beside the bound.  A miss does not raise:
    the row says ``ok`` False and the least atol it needs
    (``check_rows``)."""
    import torch.nn.functional as F
    from repro_torch.core.attention_cases import SWA_TOL
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, s, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(dtype)
    got = sw.swa_attention(q, k, v, window=window).float()
    want = ref.sliding_window_attention(q, k, v, window=window).float()
    torch.cuda.synchronize()
    dt = str(dtype).split(".")[-1]
    finite = bool(torch.isfinite(got).all())
    rtol = SWA_TOL[dt][1]
    atol = swa_atol(torch, dt, s, window, want.device)
    diff = (got - want).abs()
    over = (diff - rtol * want.abs()).clamp(min=0)
    # the least SWA_TOL atol that passes (per row in bf16, as swa_atol)
    need = (float((over * (SWA_TOL[dt][0] / atol)).max().item()) if finite
            else math.inf)
    small = want.abs() < 0.1
    plan = sw.plan(b, h, kvh, s, d, window, dtype)
    row = {"name": name, "dtype": dt, "b": b, "h": h, "kv": kvh, "s": s,
           "d": d, "window": window,
           "max_abs_err": float(diff.max().item()) if finite else math.inf,
           "small_err": float(diff[small].max().item()) if small.any()
           else 0.0,
           "atol_needed": need, "ok": finite and need <= SWA_TOL[dt][0],
           "plan": plan, "plan_text": sw.describe(plan), "ms": None,
           "plain_ms": None, "library_ms": None, "bound_ms": None,
           "bound_by": None}
    del got, want, diff, over, small
    if not timed:
        return row

    def kernel():
        return sw.swa_attention(q, k, v, window=window)

    row["ms"] = time_ms(kernel, 20)
    row["device_ms"] = graph_ms(kernel, 10)
    row["plain_ms"] = time_ms(
        lambda: ref.sliding_window_attention(q, k, v, window=window), 3)
    i = torch.arange(s, device="cuda")[:, None]
    j = torch.arange(s, device="cuda")[None, :]
    band = (j <= i) & (j > i - window)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)

    row["library_ms"] = time_ms(sdpa, 10)
    row["device_library_ms"] = graph_ms(sdpa, 5)
    # each input read once and the output written once; the operations of
    # the pairs inside the window (QK^T and PV, 2 each per pair and dim),
    # at the tensor-core rate for bf16 and the fp32 rate (no TF32) for f32
    nbytes = (2 * h + 2 * kvh) * b * s * d * q.element_size()
    flops = 4.0 * b * h * d * window_pairs(s, window)
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, peak)
    row["tflop_s"] = flops / row["ms"] / 1e9
    return row


def _unit_err(got, want, tol, floor: float = 1e-30) -> tuple[float, float]:
    """(max |got - want| / max |want|, the least atol at that unit scale
    that passes with ``tol``'s rtol): the gradients' comparison.  The scale
    is at least ``floor``."""
    import torch
    scale = want.float().abs().max().clamp_min(floor)
    g, w = got.float() / scale, want.float() / scale
    if not bool(torch.isfinite(g).all()):
        return math.inf, math.inf
    err = (g - w).abs()
    need = (err - tol[1] * w.abs()).clamp(min=0).max()
    return float(err.max()), float(need)


def swa_bwd_case(torch, sw, ref, *, name, b, h, kvh, s, d, window, dtype,
                 timed, seed):
    """One ``swa_attention_bwd`` call on the forward kernel's own out and
    lse: dq, dk and dv against ``ref.sliding_window_attention_bwd`` on the
    same inputs under ``SWA_BWD_TOL`` at unit scale (each divided by its
    largest |entry|, at least a hundredth of the three's), a second call with the
    same bits, the forward's output with the same bits with the lse on and
    off and its lse within ``SWA_LSE_TOL`` of the plain one's; the plain
    backward against autograd through the plain forward in float32 (on the
    first KV group of the first row when the [S, S] scores of the whole
    call pass 2 GB).  When ``timed``: the kernel event-timed and
    device-only (``graph_ms``), the plain backward, one SDPA backward (a
    boolean band mask, ``enable_gqa``, the graph kept for repeated
    backwards) and the bound: the backward's operations taken as 2.5 times
    the forward's on in-window pairs, the inputs, lse and gradients moved
    once.  A miss does not raise: the row says ``ok`` False."""
    import torch.nn.functional as F
    from repro_torch.core.attention_cases import SWA_BWD_TOL, SWA_LSE_TOL
    dt = str(dtype).split(".")[-1]
    tol = SWA_BWD_TOL[dt]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    q, k, v, dout = (draw(b, h, s, d), draw(b, kvh, s, d), draw(b, kvh, s, d),
                     draw(b, h, s, d))
    out, lse = sw.swa_attention(q, k, v, window=window, return_lse=True)
    fwd_bits = torch.equal(out, sw.swa_attention(q, k, v, window=window))
    _, want_lse = ref.sliding_window_attention(q, k, v, window=window,
                                               return_lse=True)
    lse_err = float((lse - want_lse).abs().max())
    del want_lse
    got = sw.swa_attention_bwd(q, k, v, out, dout, lse, window=window)
    again = sw.swa_attention_bwd(q, k, v, out, dout, lse, window=window)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    want = ref.sliding_window_attention_bwd(q, k, v, out, dout, lse,
                                            window=window)
    # each gradient at its own scale, at least a hundredth of the three's
    # largest entry: under window 1 dq and dk are zero up to rounding
    floor = 0.01 * max(float(y.float().abs().max()) for y in want)
    errs = {lab: _unit_err(x, y, tol, floor)
            for lab, x, y in zip(("dq", "dk", "dv"), got, want)}
    max_abs = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got, want))
    del got, want
    # the plain backward against autograd through the plain forward, f32
    grp = h // kvh
    part = (b * h * s * s * 4 > 2e9)
    sl = (slice(0, 1), slice(0, grp)) if part else (slice(None),) * 2
    kv_sl = (slice(0, 1), slice(0, 1)) if part else (slice(None),) * 2
    xs = [t[sl].float().contiguous() for t in (q, dout)]
    ys = [t[kv_sl].float().contiguous() for t in (k, v)]
    leaves = [xs[0].requires_grad_(), ys[0].requires_grad_(),
              ys[1].requires_grad_()]
    with torch.enable_grad():
        o32 = ref.sliding_window_attention(*leaves, window=window)
        auto = torch.autograd.grad(o32, leaves, xs[1])
    with torch.no_grad():
        o32, l32 = ref.sliding_window_attention(*leaves, window=window,
                                                return_lse=True)
        plain = ref.sliding_window_attention_bwd(*leaves, o32, xs[1], l32,
                                                 window=window)
    floor = 0.01 * max(float(y.abs().max()) for y in auto)
    auto_err = max(_unit_err(x, y, SWA_BWD_TOL["float32"], floor)[1]
                   for x, y in zip(plain, auto))
    del xs, ys, leaves, o32, auto, l32, plain
    need = max(e[1] for e in errs.values())
    row = {"name": name, "dtype": dt, "b": b, "h": h, "kv": kvh, "s": s,
           "d": d, "window": window, "max_abs_err": max_abs,
           "rel_err": {lab: e[0] for lab, e in errs.items()},
           "atol_needed": need, "lse_err": lse_err,
           "fwd_bits_same_with_lse": fwd_bits, "same_bits": same,
           "plain_vs_autograd_atol_needed": auto_err,
           "autograd_on": "one KV group" if part else "the whole call",
           "ok": (need <= tol[0] and same and fwd_bits
                  and lse_err <= SWA_LSE_TOL
                  and auto_err <= SWA_BWD_TOL["float32"][0]),
           "plan": sw.plan_bwd(b, h, kvh, s, d, window, dtype),
           "ms": None, "plain_ms": None, "library_ms": None,
           "bound_ms": None, "bound_by": None}
    row["plan_text"] = sw.describe_bwd(row["plan"])
    if timed:
        def kernel():
            return sw.swa_attention_bwd(q, k, v, out, dout, lse,
                                        window=window)
        row["ms"] = time_ms(kernel, 3)
        row["device_ms"] = graph_ms(kernel, 1, replays=2)
        row["plain_ms"] = time_ms(lambda: ref.sliding_window_attention_bwd(
            q, k, v, out, dout, lse, window=window), 2)
        i = torch.arange(s, device="cuda")[:, None]
        j = torch.arange(s, device="cuda")[None, :]
        band = (j <= i) & (j > i - window)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(*leaves, attn_mask=band,
                                               enable_gqa=True)
            row["library_ms"] = time_ms(lambda: torch.autograd.grad(
                o, leaves, dout, retain_graph=True), 3)
        del o, leaves, band
        pairs = window_pairs(s, window)
        flops = 2.5 * 4.0 * b * h * d * pairs
        nbytes = ((4 * h + 4 * kvh) * b * s * d * q.element_size()
                  + 4 * b * h * s)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, peak)
        # the operations the kernel does: the plan's count a pair and dim
        # (14 on both paths: S and dP once in each pass)
        row["kernel_flops"] = float(row["plan"]["ops"]) * b * h * d * pairs
        row["tflop_s"] = row["kernel_flops"] / row["ms"] / 1e9
    del q, k, v, dout, out, lse
    return row


def phase_swa_kernels(rec: dict, state: dict) -> None:
    import torch
    from repro_torch.core.attention_cases import SWA_CASES, SWA_EDGE
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as sw
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    cases = [c + (dt,) for c in SWA_CASES
             for dt in (torch.bfloat16, torch.float32)]
    # every head-dim and window class of the bf16 kernel, untimed
    cases += [c + (False, torch.bfloat16) for c in SWA_EDGE]
    for name, b, h, kvh, s, d, window, timed, dtype in cases:
        r = swa_case(torch, sw, ref, name=name, b=b, h=h, kvh=kvh, s=s, d=d,
                     window=window, dtype=dtype, timed=timed, seed=len(rows))
        rows.append(r)
        times = ("" if not timed else
                 f" ms={r['ms']:.4f} ({r['tflop_s']:.0f} TFLOP/s) plain="
                 f"{r['plain_ms']:.4f} sdpa={r['library_ms']:.4f} bound="
                 f"{r['bound_ms']:.4f}; device (graph) {r['device_ms']:.4f} "
                 f"sdpa {r['device_library_ms']:.4f}")
        log(f"  swa_attention {name:20s} {r['dtype']:8s} B={b} H={h}/{kvh} "
            f"S={s} D={d} W={window} err={r['max_abs_err']:.2e} "
            f"small={r['small_err']:.2e} atol_needed="
            f"{r['atol_needed']:.2e} [{r['plan_text']}]{times}")
        torch.cuda.empty_cache()
    rec["swa_attention"] = rows
    check_rows("swa_kernels: swa_attention", rows)
    served = next(r for r in rows
                  if r["name"] == "gemma3 local" and r["dtype"] == "bfloat16")
    log(f"swa_kernels: swa_attention matches plain in {len(rows)} cases "
        f"(bf16, f32; windows 1..4096, GQA groups 2 and 6, ragged S, D 40, "
        f"64, 128 and 240); gemma3 local layer bf16 [{served['plan_text']}] "
        f"{served['ms']:.4f} ms per call = {served['tflop_s']:.0f} TFLOP/s "
        f"(plain {served['plain_ms']:.4f}, sdpa {served['library_ms']:.4f}, "
        f"x_sdpa {served['ms'] / served['library_ms']:.2f}, bound "
        f"{served['bound_ms']:.4f} by {served['bound_by']}); device (graph) "
        f"{served['device_ms']:.4f} (sdpa {served['device_library_ms']:.4f})")

    # the backward on the forward kernel's out and lse
    from repro_torch.core.attention_cases import SWA_BWD_CASES
    for fn, lines in rec.get("build", {}).get("swa_attention_bwd", {}).get(
            "kernels", {}).items():
        log(f"  ptxas {fn}: {' | '.join(lines)}")
    t0 = time.perf_counter()
    bwd = []
    for name, b, h, kvh, s, d, window, timed in SWA_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            r = swa_bwd_case(torch, sw, ref, name=name, b=b, h=h, kvh=kvh,
                             s=s, d=d, window=window, dtype=dtype,
                             timed=timed and dtype == torch.bfloat16,
                             seed=100 + len(bwd))
            bwd.append(r)
            times = ("" if r["ms"] is None else
                     f" ms={r['ms']:.3f} ({r['tflop_s']:.1f} TFLOP/s done) "
                     f"device={r['device_ms']:.3f} plain={r['plain_ms']:.3f}"
                     f" sdpa_bwd={r['library_ms']:.3f} bound="
                     f"{r['bound_ms']:.4f} ({r['bound_by']})")
            log(f"  swa_attention_bwd {name:22s} {r['dtype']:8s} B={b} "
                f"H={h}/{kvh} S={s} D={d} W={window} err/max dq "
                f"{r['rel_err']['dq']:.2e} dk {r['rel_err']['dk']:.2e} dv "
                f"{r['rel_err']['dv']:.2e} atol_needed "
                f"{r['atol_needed']:.2e} lse {r['lse_err']:.1e} plain-vs-"
                f"autograd {r['plain_vs_autograd_atol_needed']:.1e} "
                f"({r['autograd_on']})"
                + ("" if r["same_bits"] else " BITS DIFFER")
                + ("" if r["fwd_bits_same_with_lse"] else
                   " FORWARD BITS MOVE WITH LSE")
                + f" [{r['plan_text']}]{times}")
            torch.cuda.empty_cache()
    rec["swa_attention_bwd"] = bwd
    bad = [r for r in bwd if not r["ok"]]
    if bad:
        raise AssertionError(
            "swa_kernels: swa_attention_bwd fails "
            + "; ".join(f"{r['name']} {r['dtype']} need {r['atol_needed']}"
                        f" lse {r['lse_err']} bits {r['same_bits']}/"
                        f"{r['fwd_bits_same_with_lse']} autograd "
                        f"{r['plain_vs_autograd_atol_needed']}" for r in bad))
    g3 = next(r for r in bwd if r["name"] == "gemma3 local train"
              and r["dtype"] == "bfloat16")
    log(f"swa_kernels: swa_attention_bwd matches plain in {len(bwd)} cases "
        f"({time.perf_counter() - t0:.1f} s); gemma3 local train bf16 "
        f"{g3['ms']:.3f} ms per call (device {g3['device_ms']:.3f}, plain "
        f"{g3['plain_ms']:.3f}, sdpa bwd {g3['library_ms']:.3f}, bound "
        f"{g3['bound_ms']:.4f} by {g3['bound_by']}); mixtral train bf16 "
        + "{ms:.3f} ms (device {device_ms:.3f}, sdpa bwd {library_ms:.3f}, "
        "bound {bound_ms:.4f})".format(**next(
            r for r in bwd if r["name"] == "mixtral train"
            and r["dtype"] == "bfloat16")))

    # the gemma3 forward's kraken_gemm shapes, bf16 (the forward) and f32
    # (the float32 period), against the plain version: both sides of every
    # swa_forward comparison run the same kraken_gemm
    from repro_torch.core.gemm_cases import GEMMA_GEMMS
    from repro_torch.kernels import kraken_gemm as kg
    gemms = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, k, n, act, calls in GEMMA_GEMMS:
            r = gemm_case(torch, kg, ref, SWA_SEQ, k, n, act, dtype,
                          seed=len(gemms), iters=(5, 2, 5))
            r["name"], r["calls_per_forward"] = name, calls
            gemms.append(r)
            torch.cuda.empty_cache()
            log(gemm_line(f"gemma3 gemm {name:8s}", r))
    check_gemm_rows("swa_kernels", gemms)
    per_fwd = {dt: {key: sum(r[key] * r["calls_per_forward"] for r in gemms
                             if r["dtype"] == dt)
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "device_ms", "device_library_ms")}
               for dt in ("bfloat16", "float32")}
    bf = per_fwd["bfloat16"]
    flops = sum(2.0 * SWA_SEQ * r["k"] * r["n"] * r["calls_per_forward"]
                for r in gemms if r["dtype"] == "bfloat16")
    log(f"swa_kernels: the gemma3 forward's kraken_gemm shapes match plain "
        f"(bf16, f32); bf16 per forward ({GEMMA_LAYERS} layers x 7 + "
        f"unembed): {bf['ms']:.1f} ms = {flops / bf['ms'] / 1e9:.0f} TFLOP/s "
        f"(plain {bf['plain_ms']:.1f}, torch.matmul {bf['library_ms']:.1f}, "
        f"bound {bf['bound_ms']:.1f}; x_matmul "
        f"{bf['ms'] / bf['library_ms']:.2f})")
    rec["gemma3_path"] = {"gemm": gemms,
                          "kraken_gemm_ms_per_forward": per_fwd}


def _gemma3(kernels=None, layers: int = GEMMA_LAYERS,
            dtype: str = "bfloat16"):
    """gemma3-12b at full width and ``layers`` of its 48 layers."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_arch("gemma3-12b"), num_layers=layers,
                              dtype=dtype)
    return Model(cfg, kernels=kernels)


def _plain_swa():
    """The default kernels with only ``swa_attention`` swapped for its
    plain version."""
    from repro_torch.kernels import ref
    from repro_torch.models.layers import DEFAULT_KERNELS
    return DEFAULT_KERNELS._replace(swa_attention=ref.sliding_window_attention)


def compare_rows(name: str, got, want, tol: float) -> dict:
    """max |got - want| against ``tol`` times max |want| over [rows, vocab]
    logits, a block of rows at a time (a 4096 x 262144 float copy is 4 GB);
    raises on non-finite or misshapen logits and on the tolerance."""
    import torch
    if got.shape != want.shape or got.dim() != 2:
        raise AssertionError(f"{name}: logits shapes {tuple(got.shape)} and "
                             f"{tuple(want.shape)}")
    err = scale = 0.0
    agree = 0
    for r0 in range(0, got.shape[0], 256):
        g, w = got[r0:r0 + 256].float(), want[r0:r0 + 256].float()
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{name}: non-finite logits")
        err = max(err, (g - w).abs().max().item())
        scale = max(scale, w.abs().max().item())
        agree += int((g.argmax(-1) == w.argmax(-1)).sum().item())
    res = {"rows": got.shape[0], "max_abs_err": err, "max_abs_ref": scale,
           "rel": err / scale, "argmax_agree": agree / got.shape[0],
           "tol": tol, "ok": err <= tol * scale}
    log(f"  {name}: max |err| {err:.5f} of max |ref| {scale:.3f} "
        f"({err / scale:.2e}, limit {tol}), argmax agree "
        f"{res['argmax_agree']:.4f} over {got.shape[0]} rows")
    if not res["ok"]:
        raise AssertionError(f"{name}: {err} > {tol} * {scale}")
    return res


def _check_launches(label: str, got: dict, want: dict) -> None:
    """``want`` for the named kernels, 0 for every other counter."""
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise AssertionError(f"{label}: launch counts {got}, expected {full}")


def phase_swa_forward(rec: dict, state: dict) -> None:
    """gemma3-12b's cache-less windowed forward at full width and depth."""
    import numpy as np
    import torch
    _release(state, "engine", "params", "moe_engine", "moe_params",
             *(f"{k}_{x}" for k in RECURRENT for x in ("engine", "params")))
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  released the earlier models: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()
    model = _gemma3()
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SWA_SEQ + 1)),
                             device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    fwd = {"tokens": batch["tokens"]}
    per_forward = {"kraken_gemm": GEMMA_LAYERS * 7 + 1,
                   "swa_attention": GEMMA_LOCAL}

    model.forward(params, fwd)            # warm: first launches, the tied
    model.loss(params, batch)             # unembed's one transpose
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    logits, _, _ = model.forward(params, fwd)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = _read_counts()
    _check_launches("gemma3 forward", launches, per_forward)
    _zero_counts()
    t0 = time.perf_counter()
    total, parts = model.loss(params, batch)
    torch.cuda.synchronize()
    loss_s = time.perf_counter() - t0
    _check_launches("gemma3 loss", _read_counts(), per_forward)
    if tuple(logits.shape) != (1, SWA_SEQ, cfg.vocab_size):
        raise AssertionError(f"gemma3 logits shape {tuple(logits.shape)}")
    ce, aux = float(parts["ce"]), float(parts["aux"])
    if not (math.isfinite(float(total)) and math.isfinite(ce) and ce > 0
            and aux == 0.0):
        raise AssertionError(f"gemma3 loss {float(total)} (ce {ce}, aux {aux})")
    if "profile" in rec["phases"]:
        rec["swa_profile"] = device_trace(
            lambda: model.forward(params, fwd), "gemma3-12b forward")
    log(f"  gemma3-12b forward: {n_params / 1e9:.2f} B params bf16, S "
        f"{SWA_SEQ}: forward {fwd_s * 1e3:.1f} ms = "
        f"{SWA_SEQ / fwd_s:.0f} tok/s, loss {loss_s * 1e3:.1f} ms = "
        f"{SWA_SEQ / loss_s:.0f} tok/s (ce {ce:.4f}), launches {launches}")

    # 1. the same forward with only swa_attention swapped for its plain
    # version
    plain = _gemma3(_plain_swa())
    _zero_counts()
    want, _, _ = plain.forward(params, fwd)
    _check_launches("gemma3 forward, plain swa", _read_counts(),
                    {"kraken_gemm": per_forward["kraken_gemm"]})
    res = {"bf16_vs_plain_swa": compare_rows(
        "gemma3 bf16 logits, swa kernel vs plain", logits[0], want[0],
        E2E_TOL)}
    del plain, want
    _release(state)

    # 2. Model.prefill into a dense cache: the local layers run the chunked
    # attention, not the kernel
    caches = model.init_caches(1, SWA_SEQ)
    _zero_counts()
    last, caches = model.prefill(params, {
        "tokens": fwd["tokens"],
        "positions": torch.arange(SWA_SEQ, dtype=torch.int32, device="cuda")},
        caches)
    _check_launches("gemma3 prefill", _read_counts(),
                    {"kraken_gemm": per_forward["kraken_gemm"]})
    res["prefill_last_row"] = compare_rows(
        "gemma3 bf16 last row, forward vs prefill", logits[0, -1:],
        last[0], E2E_TOL)
    peak = torch.cuda.max_memory_allocated()
    del logits, last, caches, total, parts
    del params, model
    _release(state)

    # 3. one period (5 local + 1 global) in float32, kernel against plain
    m32 = _gemma3(layers=GEMMA_PERIOD, dtype="float32")
    p32 = m32.init(torch.Generator(device="cuda").manual_seed(0))
    _zero_counts()
    got32, _, _ = m32.forward(p32, fwd)
    f32_launches = _read_counts()
    _check_launches("gemma3 float32 period", f32_launches,
                    {"kraken_gemm": GEMMA_PERIOD * 7 + 1,
                     "swa_attention": GEMMA_PERIOD - 1})
    want32, _, _ = _gemma3(_plain_swa(), layers=GEMMA_PERIOD,
                           dtype="float32").forward(p32, fwd)
    res["float32_one_period"] = compare_rows(
        "gemma3 float32 one period logits, swa kernel vs plain", got32[0],
        want32[0], F32_E2E_TOL)
    del got32, want32, p32, m32
    _release(state)
    rec["swa_forward"] = {
        "params": n_params, "init_s": init_s, "seq": SWA_SEQ,
        "forward_s": fwd_s, "forward_tok_s": SWA_SEQ / fwd_s,
        "loss_s": loss_s, "loss_tok_s": SWA_SEQ / loss_s, "ce": ce,
        "launches": launches, "float32_period_launches": f32_launches,
        "max_memory_allocated_gb": peak / 1e9, **res}
    log(f"swa_forward: gemma3-12b 48 layers bf16, {SWA_SEQ} tokens: forward "
        f"{SWA_SEQ / fwd_s:.0f} tok/s, loss {SWA_SEQ / loss_s:.0f} tok/s, "
        f"{launches['swa_attention']} swa_attention + "
        f"{launches['kraken_gemm']} kraken_gemm launches per forward, logits "
        f"within {E2E_TOL} of the plain-swa forward and of prefill, float32 "
        f"period within {F32_E2E_TOL}; peak {peak / 1e9:.1f} GB allocated")


# ---------------------------------------------------------------------------
# the conv path: kraken_conv2d_direct and the im2col route on the conv layers
# of AlexNet, VGG-16 and ResNet-50
# ---------------------------------------------------------------------------

class ConvMismatch(AssertionError):
    """A conv output outside ``CONV_TOL``; ``need`` is the least atol that
    would pass at the rtol (inf for a wrong shape or a non-finite value)."""

    def __init__(self, msg: str, need: float):
        super().__init__(msg)
        self.need = need


def conv_check(label: str, got, want, dt: str) -> tuple[float, float]:
    """``got`` within ``CONV_TOL[dt]`` of ``want`` elementwise; returns the
    max |err| and the least atol that passes at the rtol."""
    import torch
    from repro_torch.core.conv_cases import CONV_TOL
    atol, rtol = CONV_TOL[dt]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ConvMismatch(f"{label}: got {tuple(got.shape)} {got.dtype}, "
                           f"want {tuple(want.shape)} {want.dtype}",
                           math.inf)
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise ConvMismatch(f"{label}: non-finite output", math.inf)
    diff = (g - w).abs()
    need = float((diff - rtol * w.abs()).clamp(min=0).max().item())
    err = float(diff.max().item())
    if need > atol:
        raise ConvMismatch(f"{label}: max |err| {err:.3e}, needs atol "
                           f"{need:.3e} > {atol} (rtol {rtol})", need)
    return err, need


def conv_case(torch, kc, ref, *, name, n, h, w, ci, k, s, padding, co, R,
              dtype, out_dtype=None, timed, seed, iters=(20, 5, 20),
              inf=False):
    """One ``kraken_conv2d_direct`` call against ``ref.conv2d``; when
    ``timed``, the kernel's, the plain version's and one cuDNN
    ``F.conv2d``'s time (channels_last, TF32 off) beside the bound, whose
    operations count only the taps inside the input (no padding zeros).
    With ``inf``, x[0, h // 2, w // 2, 0] is Inf: the outputs the plain
    version leaves finite must be finite and within tolerance, the others
    not finite."""
    import torch.nn.functional as F
    from repro_torch.core.networks import LayerSpec
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, h, w, ci), generator=g, device="cuda").to(dtype)
    if inf:
        x[0, h // 2, w // 2, 0] = math.inf
    wt = (torch.randn((k, k, ci, co), generator=g, device="cuda")
          / math.sqrt(ci * k * k)).to(dtype)
    kw = dict(stride=(s, s), padding=padding, out_dtype=out_dtype)
    got = kc.kraken_conv2d_direct(x, wt, R=R, **kw)
    again = kc.kraken_conv2d_direct(x, wt, R=R, **kw)
    want = ref.conv2d(x, wt, **kw)
    torch.cuda.synchronize()
    dt = str(dtype).split(".")[-1]
    odt = str(got.dtype).split(".")[-1]
    label = f"kraken_conv2d_direct {name} N={n} {dt}"
    if inf:
        fin = torch.isfinite(want)
        if fin.all() or not torch.equal(torch.isfinite(got), fin):
            raise ConvMismatch(
                f"{label}: {int((~torch.isfinite(got)).sum())} outputs not "
                f"finite, the plain version {int((~fin).sum())}", math.inf)
        got, again, want = got[fin], again[fin], want[fin]
    err, need = conv_check(label, got, want, odt)
    if not torch.equal(got, again):     # the split's sum has a fixed order
        raise AssertionError(f"{label}: two runs of one call differ")
    (pt, pb), (pl, pr) = padding
    oh, ow = (h + pt + pb - k) // s + 1, (w + pl + pr - k) // s + 1
    q = kc.plan(x.shape, wt.shape, R=R, dtype=dtype, sms=torch.cuda.
                get_device_properties(0).multi_processor_count, **kw)
    plan = ({"kernel": "fma", "ck": q["ck"], "khs": q["khs"],
             "smem": q["smem"], "blocks": (-(-co // 64)) * n * q["L"]
             * (-(-ow // 16))} if q["path"] == 0 else
            {"kernel": "wgmma", "tile": f"{q['G']}x{q['TR']}x{q['TC']}",
             "BN": q["BN"], "packed": q["packed"],
             "band": ("tma", "ld2")[q["band_mode"]],
             "stages": f"{q['NB']}+{q['NW']}", "split": q["split"],
             "smem": q["smem"], "tiles": q["tiles"], "blocks": q["grid"]})
    row = {"name": name, "n": n, "h": h, "w": w, "c_i": ci, "k": k, "s": s,
           "padding": padding, "c_o": co, "R": R, "dtype": dt,
           "out_dtype": odt, "max_abs_err": err, "atol_needed": need,
           "plan": plan, "ms": None, "plain_ms": None, "library_ms": None,
           "bound_ms": None, "bound_by": None}
    del got, want
    if not timed:
        return row
    row["ms"] = time_ms(lambda: kc.kraken_conv2d_direct(x, wt, R=R, **kw),
                        iters[0])
    row["plain_ms"] = time_ms(lambda: ref.conv2d(x, wt, **kw), iters[1])
    if (pt, pl) != (pb, pr):
        raise ValueError(f"{name}: F.conv2d pads symmetrically only")
    xl = x.permute(0, 3, 1, 2)        # NCHW view of NHWC memory
    wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    row["library_ms"] = time_ms(lambda: F.conv2d(
        xl, wl, stride=(s, s), padding=(pt, pl)), iters[2])
    esize = x.element_size()
    macs = LayerSpec(name, "conv", h, w, k, k, s, s, tuple(padding[0]),
                     tuple(padding[1]), ci, co, N=n).macs_valid
    nbytes = (x.numel() + wt.numel() + n * oh * ow * co) * esize
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    row["macs"], row["bytes"] = macs, nbytes
    row["ops_ms"] = 2.0 * macs / peak * 1e3
    row["bytes_ms"] = nbytes / PEAK_BYTES * 1e3
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * macs, peak)
    row["tflops"] = 2.0 * macs / row["ms"] * 1e-9        # in-bounds taps
    row["x_cudnn"] = row["ms"] / row["library_ms"]
    return row


def phase_conv_kernels(rec: dict, state: dict) -> None:
    import torch
    from repro_torch.core.conv_cases import (CONV_BATCHES, CONV_EDGE,
                                             CONV_NONFINITE, CONV_R,
                                             conv_geometries)
    from repro_torch.kernels import kraken_conv as kc
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, failed = [], []

    def case(**kw):
        """One case; a mismatch is kept, so that every case is checked
        before the phase fails."""
        try:
            return conv_case(torch, kc, ref, seed=len(rows) + len(failed),
                             **kw)
        except ConvMismatch as e:
            failed.append(e)
            log(f"  FAIL {e}")
            return None

    for net, layer, h, w, ci, k, s, padding, co in conv_geometries():
        for n, dtype in ((1, torch.bfloat16), (1, torch.float32),
                         (CONV_BATCHES[-1], torch.bfloat16)):
            r = case(name=f"{net} {layer}", n=n, h=h, w=w, ci=ci, k=k, s=s,
                     padding=padding, co=co, R=CONV_R, dtype=dtype,
                     timed=True,
                     iters=(20, 5, 20) if n == 1 else (5, 2, 5))
            if r is None:
                continue
            r["net"] = net
            rows.append(r)
            log(f"  conv {net:8s} {layer:18s} N={n:<2d} {r['dtype']:8s} "
                f"err={r['max_abs_err']:.2e} atol_needed="
                f"{r['atol_needed']:.2e} ms={r['ms']:.4f} "
                f"plain={r['plain_ms']:.4f} cudnn={r['library_ms']:.4f} "
                f"bound={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"TFLOP/s={r['tflops']:.1f} x_cudnn={r['x_cudnn']:.2f} "
                f"plan={json.dumps(r['plan'])}")
            torch.cuda.empty_cache()
    edge = ([c + (False,) for c in CONV_EDGE]
            + [c + (None, True) for c in CONV_NONFINITE])
    for (name, n, h, w, ci, k, s, padding, co, R, odt, inf) in edge:
        for dtype in (torch.bfloat16, torch.float32):
            if odt and dtype == torch.float32:
                continue
            r = case(name=name, n=n, h=h, w=w, ci=ci, k=k, s=s,
                     padding=padding, co=co, R=R, dtype=dtype,
                     out_dtype=getattr(torch, odt) if odt else None,
                     timed=False, inf=inf)
            if r is None:
                continue
            r["net"] = None
            rows.append(r)
            log(f"  conv edge {name:32s} {r['dtype']:8s}->{r['out_dtype']:8s} "
                f"err={r['max_abs_err']:.2e} atol_needed="
                f"{r['atol_needed']:.2e} plan={json.dumps(r['plan'])}")
    from repro_torch.core.conv_cases import CONV_TOL
    rec["conv_kernels"] = rows
    if failed:
        worst = max(failed, key=lambda e: e.need)
        raise AssertionError(
            f"conv_kernels: {len(failed)} of {len(rows) + len(failed)} "
            f"cases outside CONV_TOL; largest atol needed {worst.need:.3e} "
            f"({worst}); first: {failed[0]}")
    need = {dt: max(r["atol_needed"] for r in rows if r["out_dtype"] == dt)
            for dt in ("bfloat16", "float32")}
    splits = sum(r["plan"].get("split", 1) > 1 for r in rows)
    log(f"conv_kernels: kraken_conv2d_direct matches plain in {len(rows)} "
        f"cases ({len(conv_geometries())} network geometries x (N 1 bf16, "
        f"N 1 f32, N 32 bf16) + {len(rows) - 3 * len(conv_geometries())} "
        f"edge cases), each bit-identical over two runs ({splits} split "
        f"C_i); largest atol needed bf16 {need['bfloat16']:.2e} of "
        f"{CONV_TOL['bfloat16'][0]}, f32 {need['float32']:.2e} of "
        f"{CONV_TOL['float32'][0]}")


def conv_layers(torch, net: str, batch: int, seed: int) -> list[dict]:
    """A network's conv layers at ``batch`` in bf16: per layer a random
    input [N, H, W, C_i] and HWIO weights scaled by 1/sqrt(fan-in), split
    per group (AlexNet) into contiguous channel slices, and the same tensors
    as channels_last NCHW views for cuDNN."""
    from repro_torch.core.networks import get_network
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for sp in get_network(net, batch)["conv"]:
        x = torch.randn((sp.N, sp.H, sp.W, sp.C_i), generator=g,
                        device="cuda").to(torch.bfloat16)
        cig, cog = sp.c_i_per_group, sp.c_o_per_group
        k = (torch.randn((sp.K_H, sp.K_W, cig, sp.C_o), generator=g,
                         device="cuda")
             / math.sqrt(cig * sp.K_H * sp.K_W)).to(torch.bfloat16)
        calls = [(x, k)] if sp.groups == 1 else [
            (x[..., i * cig:(i + 1) * cig].contiguous(),
             k[..., i * cog:(i + 1) * cog].contiguous())
            for i in range(sp.groups)]
        out.append({"spec": sp, "calls": calls, "stride": (sp.S_H, sp.S_W),
                    "padding": (sp.pad_h, sp.pad_w),
                    "x_cl": x.permute(0, 3, 1, 2),
                    "w_cl": k.permute(3, 2, 0, 1).contiguous(
                        memory_format=torch.channels_last)})
    return out


def run_frame(layers: list[dict], conv) -> list[list]:
    """Every conv layer in order (each repeat, each group its own call);
    the outputs of each layer's last repeat."""
    outs = []
    for lay in layers:
        for _ in range(lay["spec"].repeat):
            got = [conv(x, k, lay) for x, k in lay["calls"]]
        outs.append(got)
    return outs


def conv_trace(torch, layers: list[dict], direct, batch: int) -> dict:
    """``device_trace`` over VGG-16 frames through the direct kernel, back
    to back (20 at batch 1, 4 at batch 32), after one untraced profiler
    session: the profiler's start-up drops the first kernels of a session.
    The traced launches must be every launch of those frames, so that the
    busy share is read from a whole trace.  A session can still lose a few
    records (an H100 run once traced 256 of 260): such a trace is not read,
    the frames are traced again, at most ``CONV_TRACE_ATTEMPTS`` times in
    all, and the phase fails if no trace is whole.  The lost counts are
    kept in ``incomplete_traces``."""
    from torch.profiler import ProfilerActivity, profile
    frames = 20 if batch == 1 else 4
    expected = frames * CONV_FRAME_LAUNCHES["vgg16"]

    def run():
        for _ in range(frames):
            run_frame(layers, direct)

    def traced(out, kernel):
        return sum(t["count"] for t in out["top"] if kernel in t["name"])

    incomplete = []
    for _ in range(CONV_TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]):
            run_frame(layers, direct)
            torch.cuda.synchronize()
        out = device_trace(run, f"vgg16 b{batch}, {frames} frames, direct")
        got = traced(out, "kraken_conv_kernel")
        if got == expected:
            break
        incomplete.append(got)
        log(f"    trace incomplete: {got} of {expected} "
            "kraken_conv2d_direct launches traced; tracing again")
    out["frames"] = frames
    out["traced_launches"] = got
    out["traced_weight_copies"] = traced(out, "kraken_conv_weights")
    out["traced_split_sums"] = traced(out, "kraken_conv_reduce")
    out["expected_launches"] = expected
    out["incomplete_traces"] = incomplete
    log(f"    traced {got} of {expected} kraken_conv2d_direct launches "
        f"(kraken_conv_kernel), {out['traced_weight_copies']} "
        f"kraken_conv_weights, {out['traced_split_sums']} "
        f"kraken_conv_reduce; per frame: wall "
        f"{out['wall_s'] / frames * 1e3:.4f} ms, device "
        f"{out['device_s'] / frames * 1e3:.4f} ms")
    if got != expected:
        raise AssertionError(
            f"vgg16 b{batch} trace: {got} kraken_conv2d_direct launches "
            f"traced, {expected} made, in each of {CONV_TRACE_ATTEMPTS} "
            f"sessions ({incomplete})")
    return out


def phase_conv_nets(rec: dict, state: dict) -> None:
    """The conv layers of AlexNet, VGG-16 and ResNet-50 through the direct
    kernel, the im2col route and cuDNN, at batch 1 and 32, bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.conv_cases import CONV_BATCHES, CONV_NETS, CONV_R
    from repro_torch.core.networks import get_network, total_macs, total_words
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False

    def direct(x, k, lay):
        return ops.kraken_conv2d_direct(x, k, stride=lay["stride"],
                                        padding=lay["padding"], R=CONV_R)

    def im2col(x, k, lay):
        return ops.kraken_conv2d(x, k, stride=lay["stride"],
                                 padding=lay["padding"])

    def plain(x, k, lay):
        return ref.conv2d(x, k, stride=lay["stride"], padding=lay["padding"])

    def cudnn_frame(layers):
        for lay in layers:
            sp = lay["spec"]
            for _ in range(sp.repeat):
                F.conv2d(lay["x_cl"], lay["w_cl"], stride=lay["stride"],
                         padding=(sp.pad_h[0], sp.pad_w[0]), groups=sp.groups)

    res = {}
    for net in CONV_NETS:
        for batch in CONV_BATCHES:
            key = f"{net} b{batch}"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            layers = conv_layers(torch, net, batch, seed=len(res))
            per_frame = CONV_FRAME_LAUNCHES[net]
            run_frame(layers, direct)        # first use
            run_frame(layers, im2col)
            torch.cuda.synchronize()
            _zero_counts()
            got = run_frame(layers, direct)
            torch.cuda.synchronize()
            launches = _read_counts()
            _check_launches(f"{key} direct", launches,
                            {"kraken_conv2d_direct": per_frame})
            _zero_counts()
            got2 = run_frame(layers, im2col)
            torch.cuda.synchronize()
            im2col_launches = _read_counts()
            _check_launches(f"{key} im2col", im2col_launches,
                            {"kraken_gemm": per_frame})
            errs = {"direct": 0.0, "im2col": 0.0}
            need = {"direct": 0.0, "im2col": 0.0}
            for lay, d_outs, i_outs in zip(layers, got, got2):
                for (x, k), d, i in zip(lay["calls"], d_outs, i_outs):
                    want = plain(x, k, lay)
                    for route, out in (("direct", d), ("im2col", i)):
                        e, nd = conv_check(
                            f"{key} {lay['spec'].name} {route}", out, want,
                            "bfloat16")
                        errs[route] = max(errs[route], e)
                        need[route] = max(need[route], nd)
                    del want
            del got, got2
            it = 10 if batch == 1 else 3
            batch_ms = {
                "direct": time_ms(lambda: run_frame(layers, direct), it),
                "im2col": time_ms(lambda: run_frame(layers, im2col), it),
                "cudnn": time_ms(lambda: cudnn_frame(layers), it),
                "plain": time_ms(lambda: run_frame(layers, plain),
                                 max(1, it // 3))}
            peak = torch.cuda.max_memory_allocated()
            specs = get_network(net, batch)["conv"]
            macs = total_macs(specs, valid=True)   # no padding taps
            nbytes = 2 * sum(total_words(specs, w) for w in ("x", "k", "y"))
            bnd, by = bound_ms(nbytes, 2.0 * macs, PEAK_BF16)
            r = {"net": net, "batch": batch, "gmac": macs / 1e9,
                 "mbytes": nbytes / 1e6, "bound_ms": bnd, "bound_by": by,
                 "launches": launches, "im2col_launches": im2col_launches,
                 "max_abs_err": errs, "atol_needed": need,
                 "batch_ms": batch_ms,
                 "frame_ms": {k: v / batch for k, v in batch_ms.items()},
                 "fps": {k: 1e3 * batch / v for k, v in batch_ms.items()},
                 "direct_x_cudnn": batch_ms["direct"] / batch_ms["cudnn"],
                 "direct_x_im2col": batch_ms["direct"] / batch_ms["im2col"],
                 "bound_frame_ms": bnd / batch,
                 "max_memory_allocated_gb": peak / 1e9}
            if net == "vgg16":
                r["trace"] = conv_trace(torch, layers, direct, batch)
            res[key] = r
            fps = r["fps"]
            log(f"  {key:12s} {macs / 1e9 / batch:6.2f} GMAC/frame: frames/s "
                f"direct {fps['direct']:.1f}, im2col {fps['im2col']:.1f}, "
                f"cudnn {fps['cudnn']:.1f}, plain {fps['plain']:.1f}; frame "
                f"ms direct {r['frame_ms']['direct']:.4f} bound "
                f"{r['bound_frame_ms']:.4f} ({by}); launches/frame "
                f"{per_frame}; direct / cudnn {r['direct_x_cudnn']:.2f}, "
                f"direct / im2col {r['direct_x_im2col']:.2f}; err direct "
                f"{errs['direct']:.2e} im2col {errs['im2col']:.2e}; peak "
                f"{peak / 1e9:.2f} GB")
            del layers
    rec["conv_nets"] = res
    log("conv_nets: every conv layer of " + ", ".join(CONV_NETS) + " at "
        f"batch {' and '.join(map(str, CONV_BATCHES))} through "
        "kraken_conv2d_direct (launches/frame "
        + "/".join(str(CONV_FRAME_LAUNCHES[n]) for n in CONV_NETS)
        + ") and the im2col route (as many kraken_gemm launches), both "
        "within CONV_TOL of the plain version")


# ---------------------------------------------------------------------------
# cross attention and audio: llama-3.2-vision-11b and musicgen-large
# ---------------------------------------------------------------------------

# (arch, its kraken_gemm table in repro_torch.core.gemm_cases,
# paged_decode_attention launches a decode step, the float32 gate's depth):
# the VLM's 32 self-attention layers (its 8 cross layers attend over their
# frozen rows in torch ops) and musicgen's 48; the gate runs one VLM period
# (4 self-attention layers and the cross layer) and 2 musicgen layers
FRONTEND = {"vlm": ("llama-3.2-vision-11b", "VLM_GEMMS", 32, 5),
            "audio": ("musicgen-large", "MUSICGEN_GEMMS", 48, 2)}
# the dense path with the frontend: the serve workload's first
# FRONTEND_REQUESTS prompts one at a time; the *_e2e phases' prefill with
# the frontend: 2 rows of FRONTEND_E2E_SEQ tokens
FRONTEND_REQUESTS, FRONTEND_E2E_SEQ = 2, 64


def _cross_rows(model, caches) -> list:
    """Every cross-attention layer's K and V rows in ``caches`` (the
    engine's pools and ``init_caches``'s share one layout)."""
    return [c[name] for s, slot in enumerate(model.stack.pattern)
            if slot.kind == "cross" for c in caches["slots"][s]
            for name in ("k", "v")]


def frontend_feeds(cfg, lens, seed: int) -> list:
    """Seeded frontends drawn on the card, one per prompt length: (the
    prefill's, the decode steps' or None).  The VLM's image patches [1,
    1601, d] feed the prefill's cross layers, which keep their K/V;
    musicgen's audio frames [1, S, d] are added to the prefill's
    embeddings and [1, 1, d] to each decode step's."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(n):
        return torch.randn((1, n, cfg.d_model), generator=g,
                           device="cuda").to(getattr(torch, cfg.dtype))

    if cfg.frontend == "image_patches":
        return [(draw(cfg.num_frontend_tokens), None) for _ in lens]
    return [(draw(n), [draw(1) for _ in range(SERVE_NEW - 1)])
            for n in lens]


def frontend_dense(model, params, per_step: int) -> dict:
    """The serve workload's first FRONTEND_REQUESTS prompts one at a time
    through ``init_caches`` / ``prefill`` / ``decode_step``, with seeded
    frontends and again without: tok/s of each, ``kraken_gemm`` exactly
    ``per_step`` a step (and, with the VLM's patches, the cross layers'
    K/V projections in each prefill), no other kernel; the cross rows
    filled by the patches and zero without; the first token's logits
    finite and moved by the frontend in every request."""
    import torch
    from repro_torch.core.gemm_cases import VLM_CROSS
    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size)[:FRONTEND_REQUESTS]
    feeds = frontend_feeds(cfg, [len(p) for p in prompts], seed=1)
    sequential_requests(model, params, prompts[:1], 2, feeds)  # warm-up
    out = {}
    for label, fd in (("frontend", feeds), ("text", None)):
        _zero_counts()
        t0 = time.perf_counter()
        outs, first, caches = sequential_requests(model, params, prompts,
                                                  SERVE_NEW, fd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        patches = fd is not None and cfg.frontend == "image_patches"
        prefill = per_step + (2 * VLM_CROSS if patches else 0)
        want = {name: 0 for name in launches}
        want["kraken_gemm"] = len(prompts) * (prefill
                                              + per_step * (SERVE_NEW - 1))
        if launches != want:
            raise AssertionError(f"dense {label}: launch counts {launches} "
                                 f"do not match {want}")
        rows = _cross_rows(model, caches)
        if any(bool(t.any()) != patches for t in rows):
            raise AssertionError(f"dense {label}: cross rows "
                                 f"{'zero' if patches else 'not zero'}")
        toks = sum(len(o) for o in outs)
        out[label] = {"wall_s": wall, "tokens": toks, "tok_s": toks / wall,
                      "launches": launches, "out": outs,
                      "first_logits": first}
        log(f"  dense {label}: {len(prompts)} requests, {toks} tokens in "
            f"{wall:.2f} s = {toks / wall:.1f} tok/s, launches {launches}")
    moved = []
    for a, b in zip(out["frontend"].pop("first_logits"),
                    out["text"].pop("first_logits")):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("dense path: non-finite logits")
        moved.append((a - b).abs().max().item() / b.abs().max().item())
    if min(moved) <= 0:
        raise AssertionError(f"the frontend does not reach the logits: "
                             f"{moved}")
    out["frontend_moves_first_logits_rel"] = moved
    log(f"  dense: the frontend moves the first token's logits by "
        f"{', '.join(f'{m:.3f}' for m in moved)} of the largest; "
        f"{sum(a == b for a, b in zip(out['frontend']['out'], out['text']['out']))}"
        f" of {len(prompts)} requests emit the same tokens with and without")
    return out


def frontend_serve(rec: dict, state: dict, key: str) -> None:
    """Serve ``FRONTEND[key]``'s arch through ``serve_full_width``,
    text-only as the reference's engine serves, and check every cross row
    still zero; then the dense path with and without the frontend
    (``frontend_dense``)."""
    arch, table, attn_calls, _ = FRONTEND[key]
    _release(state, *list(state))
    model, params, eng, out = serve_full_width(state, key, arch, table,
                                               attn_calls)
    rows = _cross_rows(model, eng.pools)
    if any(t.any() for t in rows):
        raise AssertionError(f"{key}_serve: a cross row is not zero after "
                             "text-only serving")
    per_step = out["launches_per_decode_step"]["kraken_gemm"]
    dense = frontend_dense(model, params, per_step)
    rec[f"{key}_serve"] = dict(out, cross_rows=len(rows) // 2,
                               cross_rows_zero=True, dense=dense)
    log(f"{key}_serve: every cross row zero after text-only serving "
        f"({len(rows) // 2} layers); dense path "
        f"{dense['frontend']['tok_s']:.1f} tok/s with the frontend, "
        f"{dense['text']['tok_s']:.1f} without")
    if "profile" in rec["phases"]:
        rec[f"{key}_profile"] = trace_pass(eng, seed=2)


def frontend_prefill_logits(model, params, seed: int = 3):
    """One prefill of 2 rows of FRONTEND_E2E_SEQ tokens into a dense cache
    with seeded frontends (the VLM's patches or musicgen's frames); the
    last position's logits [2, V]."""
    import numpy as np
    import torch
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    n = cfg.num_frontend_tokens or FRONTEND_E2E_SEQ
    fe = torch.cat([f for f, _ in frontend_feeds(cfg, [n, n], seed)])
    caches = model.init_caches(2, MAX_LEN)
    logits, _ = model.prefill(params, {
        "tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                               (2, FRONTEND_E2E_SEQ)),
                                  device="cuda"),
        "positions": torch.arange(FRONTEND_E2E_SEQ, dtype=torch.int32,
                                  device="cuda"),
        "frontend": fe}, caches)
    return logits[:, -1]


def frontend_e2e(rec: dict, state: dict, key: str) -> None:
    """``FRONTEND[key]``'s arch on the served bf16 weights, kernels against
    plain versions within E2E_TOL: one mixed and one decode step of the
    engine's programs, and one prefill with the frontend; then, in float32
    at full width cut to the gate's depth, the serve workload's 8 requests
    through the engine (chunk 64) token-identical to the sequential
    path."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, _, _, layers = FRONTEND[key]
    plain = _plain_kernels()
    model = _full_width(arch)
    params = state.get(f"{key}_params")
    if params is None:
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
    vocab = model.cfg.vocab_size
    res = {}
    got = two_steps(model, params)
    want = two_steps(_full_width(arch, plain), params)
    for i, name in enumerate(("mixed step", "decode step")):
        res[name] = compare_logits(f"{arch} {name}", got[i], want[i], vocab)
    res["prefill with the frontend"] = compare_logits(
        f"{arch} prefill with the frontend",
        frontend_prefill_logits(model, params),
        frontend_prefill_logits(_full_width(arch, plain), params), vocab,
        rows=2)
    del params, got, want
    _release(state, f"{key}_engine", f"{key}_params")
    bad = {k: v for k, v in res.items() if not v["ok"]}
    if bad:
        raise AssertionError(f"{key}_e2e: kernels against plain beyond "
                             f"{E2E_TOL} of the largest logit: {bad}")
    res[f"float32_{layers}_layers"] = f32_engine_gate(key, arch, layers)
    rec[f"{key}_e2e"] = res
    log(f"{key}_e2e: bf16 kernels agree with the plain versions within "
        f"{E2E_TOL} of the largest logit (full {arch}: a mixed step, a "
        "decode step and a prefill with the frontend); float32 "
        f"{layers} layers token-identical")


# ---------------------------------------------------------------------------
# phase: examples -- repro_torch.examples on the card
# ---------------------------------------------------------------------------

# serve_lm's archs, each with the kernels beside kraken_gemm its engine
# must launch (and no other)
EXAMPLE_SERVE = {"yi-6b": ("paged_decode_attention",),
                 "mixtral-8x22b": ("paged_decode_attention",
                                   "grouped_moe_gemm"),
                 "rwkv6-3b": (),
                 "zamba2-1.2b": ("paged_decode_attention",)}
# train_lm's steps on the card (the example's own 300)
TRAIN_LM_STEPS = 300
# long_context at full width on each serve phase's weights: batch 2, a
# 32-entry cache and LONG_HORIZON decode steps (the position passes the
# cache twice)
LONG_BATCH, LONG_CACHE, LONG_HORIZON = 2, 32, 64


def _captured(label: str, fn, *args, **kw):
    """``fn(*args, **kw)`` with its standard output captured, then logged
    line by line under ``label`` (also when it raises): (result, output)."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = fn(*args, **kw)
    finally:
        for ln in buf.getvalue().splitlines():
            log(f"  {label}: {ln}")
    return res, buf.getvalue()


def _want_launches(launches: dict, want: dict) -> dict:
    """``want`` with every other counter at 0."""
    return {name: want.get(name, 0) for name in launches}


def example_quickstart() -> dict:
    """The quickstart on smoke yi-6b on the card: every loss finite and
    falling, 9 greedy tokens (the prefill's and 8 decode steps'), and
    ``kraken_gemm`` launched exactly as counted: a forward, three loss
    steps under grad (remat none), a prefill and 8 decode steps."""
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.core.gemm_cases import windowed_train_launches
    from repro_torch.examples import quickstart
    from repro_torch.models.model import Model
    model = Model(smoke_config(get_arch("yi-6b")))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    _zero_counts()
    t0 = time.perf_counter()
    got = quickstart.run(model, params, device=torch.device("cuda"),
                         log=lambda m: log(f"  quickstart: {m}"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_counts()
    layers = model.cfg.num_layers
    fwd = 7 * layers + 1
    want = _want_launches(launches, {"kraken_gemm": 10 * fwd + 3 * (
        windowed_train_launches(layers, 0, "none")["kraken_gemm"])})
    losses = got["losses"]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[0] > losses[1] > losses[2]:
        raise AssertionError(f"quickstart: losses {losses} not finite and "
                             "falling")
    if len(got["tokens"]) != 9 or not all(
            0 <= t < model.cfg.vocab_size for t in got["tokens"]):
        raise AssertionError(f"quickstart: decoded {got['tokens']}")
    if not bool(torch.isfinite(got["logits"]).all()):
        raise AssertionError("quickstart: a forward logit is not finite")
    if launches != want:
        raise AssertionError(f"quickstart: launches {launches}, want {want}")
    return {"seconds": secs, "losses": losses, "tokens": got["tokens"],
            "launches": launches}


def example_serve_lm(arch: str, needs: tuple) -> dict:
    """serve_lm on the card with ``--repeat 2``: every request served on
    both passes, the warm pass with no new signature, and beside
    ``kraken_gemm`` exactly the kernels in ``needs`` launched."""
    from repro_torch.examples import serve_lm
    _zero_counts()
    t0 = time.perf_counter()
    rc, out = _captured(f"serve_lm {arch}", serve_lm.main,
                        ["--arch", arch, "--repeat", "2"])
    secs = time.perf_counter() - t0
    launches = _read_counts()
    expect = ["pass 2: prefill retraces=0 decode retraces=0",
              "served 12/12 requests", f"# {arch} on cuda"]
    missing = [w for w in expect if w not in out]
    on = {name for name, n in launches.items() if n}
    if rc or missing or on != {"kraken_gemm", *needs}:
        raise AssertionError(f"serve_lm {arch}: rc {rc}, missing {missing}, "
                             f"launches {launches} (want kraken_gemm and "
                             f"{needs})")
    return {"seconds": secs, "launches": launches}


def example_long_context() -> dict:
    """long_context at JAX's smoke sizes (batch 2, an 8-token prompt, a
    32-entry cache, 128 decode steps) for its three archs: every logit
    finite (the example raises otherwise), the allocated bytes the same
    after the last decode step as after the first, ``kraken_gemm`` (and
    for mixtral ``grouped_moe_gemm``) launched the same number of times each
    step."""
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.examples import long_context
    from repro_torch.models.model import Model
    out = {}
    for arch in long_context.ARCHS:
        model = Model(smoke_config(get_arch(arch)))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        _zero_counts()
        r = long_context.run(model, params, device=torch.device("cuda"),
                             log=lambda m: log(f"  long_context: {m}"))
        launches = _read_counts()
        steps = 1 + 128
        bad = [k for k, n in launches.items() if n % steps]
        needs = {"kraken_gemm"} | ({"grouped_moe_gemm"}
                                   if arch.startswith("mixtral") else set())
        if r["allocated_first"] != r["allocated_last"] or bad or \
                {k for k, n in launches.items() if n} != needs:
            raise AssertionError(f"long_context {arch}: allocated "
                                 f"{r['allocated_first']} -> "
                                 f"{r['allocated_last']}, launches "
                                 f"{launches}")
        out[arch] = {"tok_s": r["tok_s"], "launches": launches,
                     "allocated": r["allocated_last"]}
    return out


def example_train_lm(steps: int = TRAIN_LM_STEPS) -> dict:
    """train_lm on the card, in this process, for ``steps`` steps: every
    step's loss and grad norm finite, no restart, the checkpoints the
    supervisor keeps (100, 200 and 300 of 300 steps), the last logged loss
    at least 1 nat under the first, ``kraken_gemm`` launched exactly as a
    remat-none step counts; the warm step time, the peak allocation and the
    losses against the ln 16 floor reported.  The step function the
    launcher builds is wrapped to read each step's metrics (synchronized
    there, so the step times are the card's)."""
    import re
    import shutil
    import torch
    from repro_torch.configs import registry as R
    from repro_torch.core.gemm_cases import (TRAIN_LM_LAYERS,
                                             windowed_train_launches)
    from repro_torch.examples import train_lm
    from repro_torch.launch import steps as S
    ck = ROOT / "build" / "train_lm_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    real, seen = S.make_train_step, []

    def recording(*a, **kw):
        step = real(*a, **kw)

        def run(params, opt_state, batch):
            out = step(params, opt_state, batch)
            torch.cuda.synchronize()
            m = out[2]
            seen.append((time.perf_counter(), torch.stack(
                [m["loss"].detach().float(),
                 m["grad_norm"].detach().float()])))
            return out
        return run

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    S.make_train_step = recording
    t0 = time.perf_counter()
    try:
        rc, out = _captured("train_lm", train_lm.main,
                            ["--steps", str(steps), "--ckpt-dir", str(ck)])
    finally:
        S.make_train_step = real
        R.ARCHS.pop("yi-100m", None)
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = windowed_train_launches(TRAIN_LM_LAYERS, 0,
                                       "none")["kraken_gemm"]
    metrics = torch.stack([m for _, m in seen]).cpu() if seen else None
    logged = [(int(a), float(b)) for a, b in
              re.findall(r"step +(\d+) loss (\S+) ce", out)]
    saved = sorted(int(d.name[5:]) for d in ck.glob("step_*")
                   if not d.name.endswith(".tmp"))
    want_saved = sorted({s for s in range(1, steps + 1)
                         if s % 100 == 0 or s == steps})[-3:]
    times = [b - a for (a, _), (b, _) in zip(seen, seen[1:])]
    warm = sorted(times[10:] or times)
    res = {"steps": steps, "wall_s": wall,
           "step_ms_median": 1e3 * warm[len(warm) // 2] if warm else None,
           "step_ms_first": 1e3 * (seen[0][0] - t0) if seen else None,
           "peak_gb": peak / 1e9, "launches": launches,
           "launches_per_step": per_step, "logged": logged,
           "loss_at": {n: float(metrics[n - 1, 0]) for n in (100, 200, 300)
                       if metrics is not None and n <= len(metrics)},
           "floor_loss": train_lm.FLOOR_LOSS,
           "start_loss": train_lm.START_LOSS, "checkpoints": saved}
    problems = []
    if rc or f"done: {steps} steps" not in out or "(0 restarts" not in out:
        problems.append(f"rc {rc} or a restart")
    if metrics is None or len(metrics) != steps or \
            not bool(torch.isfinite(metrics).all()):
        problems.append("a loss or grad norm not finite (or steps missing)")
    if saved != want_saved:
        problems.append(f"checkpoints {saved}, want {want_saved}")
    if len(logged) < 2 or not logged[-1][1] <= logged[0][1] - 1.0:
        problems.append(f"logged losses {logged[:1]} .. {logged[-1:]} fall "
                        "less than 1 nat")
    if launches != _want_launches(launches, {"kraken_gemm":
                                             per_step * steps}):
        problems.append(f"launches {launches}, want {per_step} kraken_gemm "
                        "a step")
    if problems:
        raise AssertionError(f"train_lm: {'; '.join(problems)}")
    return res


def phase_examples(rec: dict, state: dict) -> None:
    """``repro_torch.examples`` on the card, through the functions and
    entry points a user calls: kraken_paper's printed lines against the
    same function's on the CPU, quickstart, serve_lm for four archs,
    long_context at JAX's smoke sizes and train_lm's 300 steps; then
    ``kraken_gemm``'s float32 route at train_lm's cells (the forward and
    both backward products, timed)."""
    import gc
    import torch
    from repro_torch.core.gemm_cases import TRAIN_LM_GEMMS, TRAIN_LM_M
    from repro_torch.examples import kraken_paper
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import ops, ref
    res, secs = {}, {}

    t0 = time.perf_counter()
    _, card = _captured("kraken_paper", kraken_paper.main,
                        ["--device", "cuda"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        kraken_paper.main(["--device", "cpu"])
    if card != buf.getvalue() or card.count("\n") < 20:
        raise AssertionError("kraken_paper: the card's entry printed other "
                             "lines than the CPU's")
    res["kraken_paper"] = {"lines": card.count("\n")}
    secs["kraken_paper"] = time.perf_counter() - t0

    for name, fn in (("quickstart", example_quickstart),
                     ("long_context", example_long_context),
                     ("train_lm", example_train_lm)):
        t0 = time.perf_counter()
        res[name] = fn()
        secs[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    res["serve_lm"] = {}
    t0 = time.perf_counter()
    for arch, needs in EXAMPLE_SERVE.items():
        res["serve_lm"][arch] = example_serve_lm(arch, needs)
        gc.collect()
        torch.cuda.empty_cache()
    secs["serve_lm"] = time.perf_counter() - t0

    # kraken_gemm's float32 route at train_lm's cells, timed
    t0 = time.perf_counter()
    rows = [grad_case(torch, kg, ref, ops, name, TRAIN_LM_M, k, n, act,
                      bias, torch.float32, timed=True)
            for name, k, n, act, bias, _ in TRAIN_LM_GEMMS]
    for r in rows:
        log(grad_line(r))
    if not all(r["ok"] for r in rows):
        raise AssertionError("kraken_gemm at train_lm's cells: "
                             f"{[r['name'] for r in rows if not r['ok']]}")
    sums = train_lm_sums(rows)
    for fn, lines in rec.get("build", {}).get("kraken_gemm", {}).get(
            "fma", {}).items():
        log(f"  ptxas {fn}: {' | '.join(lines)}")
    # each product's device time over torch.matmul's on the same operands
    sums["x_matmul_by_product"] = {
        f"{r['name']} {lab}": r[f"{lab}_device_ms"]
        / r[f"{lab}_device_matmul_ms"]
        for r in rows for lab in ("Y", "dA", "dB")}
    worst = max(sums["x_matmul_by_product"].items(), key=lambda kv: kv[1])
    log(f"  train_lm's products, device time over torch.matmul's: "
        + ", ".join(f"{k} {v:.2f}"
                    for k, v in sums["x_matmul_by_product"].items())
        + f"; worst {worst[0]} {worst[1]:.2f}")
    secs["train_lm_gemms"] = time.perf_counter() - t0
    res["train_lm_gemms"] = rows
    res["train_lm_gemm_step"] = sums
    res["seconds"] = secs
    rec["examples"] = res
    t = res["train_lm"]
    log(f"  train_lm's kraken_gemm a step (float32, {sums['launches']} "
        f"launches): {sums['ms']:.2f} ms event-timed, {sums['device_ms']:.2f}"
        f" device-only, plain {sums['plain_ms']:.2f}, torch.matmul "
        f"{sums['matmul_ms']:.2f} (device {sums['device_matmul_ms']:.2f}), "
        f"bound {sums['bound_ms']:.2f}; z relaunches {sums['z_ms']:.2f}")
    log(f"examples: kraken_paper's {res['kraken_paper']['lines']} lines as "
        f"on the CPU; quickstart losses {res['quickstart']['losses']}; "
        f"serve_lm warm passes with no new signature for "
        f"{len(EXAMPLE_SERVE)} archs; long_context "
        + ", ".join(f"{a} {r['tok_s']:.1f} tok/s"
                    for a, r in res["long_context"].items())
        + f"; train_lm {t['steps']} steps in {t['wall_s']:.1f} s (warm step "
        f"{t['step_ms_median']:.1f} ms, peak {t['peak_gb']:.2f} GB), loss "
        f"{t['logged'][0][1]:.4f} -> {t['logged'][-1][1]:.4f} (floor "
        f"{t['floor_loss']:.4f}); seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))


def long_context_full(model, params, label: str, per_step: dict) -> dict:
    """The long_context example's ``run`` on a serve phase's own model and
    weights at full width: batch 2, a 32-entry cache, 64 decode steps.
    Every logit finite at every step (the example raises otherwise), the
    allocated bytes after the last decode step equal to those after the
    first, and the launches exactly ``per_step`` a forward (the prefill and
    each decode step)."""
    import torch
    from repro_torch.examples import long_context
    _zero_counts()
    r = long_context.run(model, params, cache_len=LONG_CACHE,
                         horizon=LONG_HORIZON, batch=LONG_BATCH,
                         device=torch.device("cuda"),
                         log=lambda m: log(f"  {label} long_context: {m}"))
    launches = _read_counts()
    want = _want_launches(launches, {k: v * (1 + LONG_HORIZON)
                                     for k, v in per_step.items()})
    if launches != want:
        raise AssertionError(f"{label} long_context: launches {launches}, "
                             f"want {want}")
    if r["allocated_first"] != r["allocated_last"]:
        raise AssertionError(f"{label} long_context: allocated "
                             f"{r['allocated_first']} after the first decode "
                             f"step, {r['allocated_last']} after the last")
    log(f"  {label} long_context: {model.cfg.name} at "
        f"{model.cfg.num_layers} layers, batch {LONG_BATCH}, a {LONG_CACHE}"
        f"-entry cache, {LONG_HORIZON} decode steps: {r['tok_s']:.1f} tok/s, "
        f"every logit finite, {r['allocated_last']} bytes allocated after "
        f"the first and the last step, launches {launches}")
    return {"tok_s": r["tok_s"], "seconds": r["seconds"],
            "allocated_bytes": r["allocated_last"],
            "cache_bytes": r["cache_bytes_last"], "launches": launches,
            "batch": LONG_BATCH, "cache_len": LONG_CACHE,
            "horizon": LONG_HORIZON, "last_tokens": r["tokens"][-1]}


# ---------------------------------------------------------------------------
# phase: train -- the gradient of kraken_matmul and yi-6b train steps
# ---------------------------------------------------------------------------

# the full-width steps: batch x seq from SyntheticLM, remat "full", one
# microbatch, TRAIN_STEPS steps through launch/steps.make_train_step
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 3
# the gradient gate: yi-6b at full width and TRAIN_GATE_LAYERS layers,
# kernels against plain versions, per-leaf relative L2 in float32
TRAIN_GATE_LAYERS, TRAIN_GATE_TOL = 2, 1e-4
# free device memory the full-width steps must leave
TRAIN_HEADROOM = 4e9


def _norm_close(got, want, dt: str):
    """(max |err| / max |want|, ok): the gradient and the plain one, both
    divided by the plain one's largest |entry|, within ``GEMM_TOL``."""
    from repro_torch.core.gemm_cases import GEMM_TOL
    import torch
    atol, rtol = GEMM_TOL[dt]
    scale = want.float().abs().max().clamp_min(1e-30)
    g, w = got.float() / scale, want.float() / scale
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


def grad_case(torch, kg, ref, ops, name, m, k, n, act, bias, dtype, *,
              timed, seed=0):
    """``ops.kraken_matmul_grad``'s forward and backward on the card at [M,
    K] @ [K, N] against autograd through ``ref.matmul`` on the same inputs:
    the output Y, dA, dB and dbias each within ``GEMM_TOL`` at unit scale;
    a second forward and backward must give the same bits, and the launches are counted (one
    forward, two products, one recomputed z when activated).  When
    ``timed`` the forward's product (``Y``, with its epilogue) and the
    backward's two are timed event-timed and device-only beside the plain
    version and ``torch.matmul`` on the same operands and the bound, and the
    operand transposes (and the z relaunch) apart."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = str(dtype).split(".")[-1]
    a = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    b = (torch.randn((k, n), generator=g, device="cuda")
         / math.sqrt(k)).to(dtype)
    c = (torch.randn((n,), generator=g, device="cuda").to(dtype)
         if bias else None)
    dy = torch.randn((m, n), generator=g, device="cuda").to(dtype)
    leaves = [t for t in (a, b, c) if t is not None]

    def grads(fn):
        xs = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn(*xs)
        return out.detach(), torch.autograd.grad(out, xs, dy)

    def kernel(*xs):
        return ops.kraken_matmul_grad(xs[0], xs[1],
                                      bias=xs[2] if bias else None,
                                      activation=act)

    def plain(*xs):
        return ref.matmul(xs[0], xs[1], bias=xs[2] if bias else None,
                          activation=act)

    before = kg.launches
    out, got = grads(kernel)
    torch.cuda.synchronize()
    launches = kg.launches - before
    out2, again = grads(kernel)
    want_out, want = grads(plain)
    same = torch.equal(out, out2) and all(
        torch.equal(x, y) for x, y in zip(got, again))
    got, want = (out, *got), (want_out, *want)
    errs = [_norm_close(x, y, dt) for x, y in zip(got, want)]
    row = {"name": name, "m": m, "k": k, "n": n, "act": act, "bias": bias,
           "dtype": dt, "launches": launches,
           "launches_ok": launches == 3 + (act is not None),
           "max_abs_err": max(float((x.float() - y.float()).abs().max())
                              for x, y in zip(got, want)),
           "rel_err": {lab: e for lab, (e, _) in
                       zip(("Y", "dA", "dB", "dbias"), errs)},
           "same_bits": same,
           "ok": all(ok for _, ok in errs) and same
           and launches == 3 + (act is not None)}
    if timed:
        z = ref.matmul(a, b, bias=c)
        gp = (dy.float() * (ops.activation_grad(act, z) if act else 1.0)
              ).to(dtype).contiguous()
        bt, at = b.t().contiguous(), a.t().contiguous()
        isz = a.element_size()
        for lab, x, y, kw in (("Y", a, b, dict(bias=c, activation=act)),
                              ("dA", gp, bt, {}), ("dB", at, gp, {})):
            mm, kk, nn = x.shape[0], x.shape[1], y.shape[1]
            row[f"{lab}_ms"] = time_ms(lambda: kg.kraken_gemm(x, y, **kw),
                                       10)
            row[f"{lab}_device_ms"] = graph_ms(
                lambda: kg.kraken_gemm(x, y, **kw), 4)
            row[f"{lab}_plain_ms"] = time_ms(lambda: ref.matmul(x, y, **kw),
                                             10)
            row[f"{lab}_matmul_ms"] = time_ms(lambda: torch.matmul(x, y), 10)
            row[f"{lab}_device_matmul_ms"] = graph_ms(
                lambda: torch.matmul(x, y), 4)
            row[f"{lab}_bound_ms"], row[f"{lab}_bound_by"] = bound_ms(
                (mm * kk + kk * nn + mm * nn) * isz, 2.0 * mm * nn * kk,
                PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
            row[f"{lab}_plan"] = kg.describe(kg.plan(
                mm, kk, nn, dtype=dtype, a_align=kg.alignment(x),
                b_align=kg.alignment(y)))
        row["bT_ms"] = time_ms(lambda: b.t().contiguous(), 10)
        row["aT_ms"] = time_ms(lambda: a.t().contiguous(), 10)
        row["z_ms"] = (time_ms(lambda: kg.kraken_gemm(a, b, bias=c), 10)
                       if act else 0.0)
    return row


def grad_line(r: dict) -> str:
    out = (f"  {r['name']}: M={r['m']} K={r['k']} N={r['n']} {r['dtype']} "
           f"act={r['act']} bias={r['bias']} launches={r['launches']} "
           f"err/max Y {r['rel_err']['Y']:.2e} dA {r['rel_err']['dA']:.2e} "
           f"dB {r['rel_err']['dB']:.2e}"
           + (f" dbias {r['rel_err']['dbias']:.2e}" if r["bias"] else "")
           + ("" if r["same_bits"] else " BITS DIFFER")
           + ("" if r["ok"] else " FAIL"))
    if "dA_ms" in r:
        for lab in ("Y", "dA", "dB"):
            out += (f"\n    {lab} [{r[lab + '_plan']}] ms={r[lab + '_ms']:.4f}"
                    f" device={r[lab + '_device_ms']:.4f} plain="
                    f"{r[lab + '_plain_ms']:.4f} matmul="
                    f"{r[lab + '_matmul_ms']:.4f} (device "
                    f"{r[lab + '_device_matmul_ms']:.4f}) bound="
                    f"{r[lab + '_bound_ms']:.4f} ({r[lab + '_bound_by']})")
        out += (f"\n    transposes: b.T {r['bT_ms']:.4f} a.T {r['aT_ms']:.4f}"
                f" ms; z relaunch {r['z_ms']:.4f} ms")
    return out


def train_step_sums(rows: list) -> dict:
    """The backward's products summed over one yi-6b train step (each
    ``TRAIN_GEMMS`` cell times its forward calls a step): ms, device ms,
    ``torch.matmul`` ms, bound; the transposes and z relaunches apart."""
    from repro_torch.core.gemm_cases import TRAIN_GEMMS
    calls = {name: c for name, *_, c in TRAIN_GEMMS}
    by = {r["name"]: r for r in rows if r["name"] in calls}
    out = {}
    for key in ("ms", "device_ms", "matmul_ms", "device_matmul_ms",
                "bound_ms"):
        out[key] = sum(calls[nm] * (by[nm][f"dA_{key}"] + by[nm][f"dB_{key}"])
                       for nm in calls)
    out["transposes_ms"] = sum(calls[nm] * (by[nm]["bT_ms"] + by[nm]["aT_ms"])
                               for nm in calls)
    out["z_ms"] = sum(calls[nm] * by[nm]["z_ms"] for nm in calls)
    return out


def train_lm_sums(rows: list) -> dict:
    """``kraken_gemm``'s share of one ``train_lm`` step (yi-100m, float32,
    remat none): each ``TRAIN_LM_GEMMS`` cell's forward product and its two
    backward products times its calls a step, and one z relaunch a silu
    gate: ms, device ms, the plain version's ms, ``torch.matmul`` ms, the
    bound."""
    from repro_torch.core.gemm_cases import TRAIN_LM_GEMMS
    calls = {name: c for name, *_, c in TRAIN_LM_GEMMS}
    by = {r["name"]: r for r in rows}
    out = {}
    for key in ("ms", "device_ms", "plain_ms", "matmul_ms",
                "device_matmul_ms", "bound_ms"):
        out[key] = sum(calls[nm] * sum(by[nm][f"{lab}_{key}"]
                                       for lab in ("Y", "dA", "dB"))
                       for nm in calls)
    out["z_ms"] = sum(calls[nm] * by[nm]["z_ms"] for nm in calls)
    out["launches"] = sum(by[nm]["launches"] * calls[nm] for nm in calls)
    return out


def _param_grads(model, params, batch, remat="none"):
    """(loss, [grad per leaf]) of ``Model.loss``."""
    import torch
    from repro_torch import tree as T
    leaves = T.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss(params, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads


def _train_batch(torch, cfg, step: int, batch: int = TRAIN_BATCH,
                 seq: int = TRAIN_SEQ) -> dict:
    from repro_torch.data.pipeline import SyntheticLM
    pipe = SyntheticLM(cfg.vocab_size, seq, batch)
    return {k: torch.as_tensor(v, device="cuda")
            for k, v in pipe.batch_at(step).items()}


def gradient_gate(torch) -> dict:
    """One step's gradients at full width and ``TRAIN_GATE_LAYERS``
    layers, with the kernels (remat ``"none"`` and ``"full"``, the train
    step's, whose checkpoint recomputes each period through the kernel)
    and with the plain versions, on the same parameters and batch: each
    leaf's relative L2 within ``TRAIN_GATE_TOL`` in float32 (gated) and in
    bf16 (reported)."""
    import gc
    from repro_torch import tree as T
    out = {}
    base = _full_width("yi-6b", dtype="float32", layers=TRAIN_GATE_LAYERS)
    params32 = base.init(torch.Generator(device="cuda").manual_seed(5))
    batch = _train_batch(torch, base.cfg, 0)
    for dt in ("float32", "bfloat16"):
        params = T.map_leaves(lambda p: p.detach().to(getattr(torch, dt)),
                              params32)
        res = {}
        for label, kernels, remat in (
                ("plain", _plain_kernels(), "none"),
                ("none", None, "none"), ("full", None, "full")):
            model = _full_width("yi-6b", kernels, dt, TRAIN_GATE_LAYERS)
            loss, grads = _param_grads(model, params, batch, remat)
            res[label] = (float(loss), [g.float() for g in grads])
            del grads
        out[dt] = {"loss_plain": res["plain"][0]}
        for remat in ("none", "full"):
            worst, where = 0.0, ""
            for (path, _), g, w in zip(T.leaves_with_path(params),
                                       res[remat][1], res["plain"][1]):
                rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
                if rel > worst:
                    worst, where = rel, path
            out[dt][remat] = {"loss_kernels": res[remat][0],
                              "worst_rel_l2": worst, "worst_leaf": where}
            log(f"  gradient gate {dt}, {TRAIN_GATE_LAYERS} layers, remat "
                f"{remat}: loss {res[remat][0]:.6f} / plain "
                f"{res['plain'][0]:.6f}, worst leaf {where} relative L2 "
                f"{worst:.3e}" + (f" (gate {TRAIN_GATE_TOL})"
                                  if dt == "float32" else " (reported)"))
        del res, params
        gc.collect()
    bad = {remat: out["float32"][remat] for remat in ("none", "full")
           if out["float32"][remat]["worst_rel_l2"] > TRAIN_GATE_TOL}
    if bad:
        raise AssertionError(f"train: float32 gradients, kernels vs plain, "
                             f"{bad}")
    del params32
    return out


def train_cli(out_dir: Path) -> dict:
    """The launcher on the card, as ``tests/test_system.py`` drives the
    reference's: 12 smoke steps with a failure injected at step 8, then a
    second invocation resuming from the last checkpoint."""
    import os
    import shutil
    ck = out_dir / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "yi-6b", "--smoke", "--batch", "4", "--seq", "32", "--ckpt-dir",
            str(ck), "--ckpt-every", "5", "--log-every", "5"]
    runs = {}
    for label, extra, want in (
            ("restart", ["--steps", "12", "--inject-failure-at", "8"],
             ["injected failure", "[restore] resumed from step 5",
              "done: 12 steps", "(1 restarts"]),
            ("resume", ["--steps", "15"],
             ["[restore] resumed from step 12", "done: 15 steps",
              "(0 restarts"])):
        t0 = time.perf_counter()
        res = subprocess.run(base + extra, capture_output=True, text=True,
                             env=env, timeout=300)
        secs = time.perf_counter() - t0
        for ln in res.stdout.splitlines():
            log(f"  train cli {label}: {ln}")
        missing = [w for w in want if w not in res.stdout]
        if res.returncode or missing:
            raise AssertionError(f"train cli {label}: rc {res.returncode}, "
                                 f"missing {missing}: {res.stderr[-2000:]}")
        runs[label] = {"seconds": secs, "stdout": res.stdout}
    # kept for the mesh phase, which restores it onto its mesh
    runs["ckpt_dir"] = str(ck)
    return runs


def phase_train(rec: dict, state: dict) -> None:
    """The gradient of ``kraken_matmul`` at yi-6b's training cells (and
    the other epilogues, and a ragged shape), full-width yi-6b train steps,
    the float32 gradient gate and the training launcher."""
    import gc
    import torch
    from repro_torch import tree as T
    from repro_torch.core.gemm_cases import (TRAIN_EDGE, TRAIN_GEMMS,
                                             TRAIN_M, train_launches)
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps as S
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    state.clear()                       # every earlier phase's model
    gc.collect()
    torch.cuda.empty_cache()
    # the full-width step holds 72.7 GB of state on an 80 GB card: its
    # per-layer gradients and their stacks must not strand reserved
    # blocks (launch/train.py asks the same of a fresh process)
    set_alloc = getattr(torch._C, "_accelerator_setAllocatorSettings",
                        torch.cuda.memory._set_allocator_settings)
    set_alloc("expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    res: dict = {}

    # 1. the Function at the training cells, bf16 (timed) and float32
    rows = []
    cases = ([(name, TRAIN_M, k, n, act, bias)
              for name, k, n, act, bias, _ in TRAIN_GEMMS]
             + list(TRAIN_EDGE))
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, m, k, n, act, bias) in enumerate(cases):
            r = grad_case(torch, kg, ref, ops, name, m, k, n, act, bias,
                          dtype, timed=dtype == torch.bfloat16
                          and m == TRAIN_M, seed=i)
            log(grad_line(r))
            rows.append(r)
            gc.collect()
    res["gemm_grads"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(
            "train: kraken_matmul's gradient fails "
            + "; ".join(f"{r['name']} {r['dtype']} launches {r['launches']} "
                        f"{r['rel_err']} same_bits={r['same_bits']}"
                        for r in bad))
    sums = train_step_sums([r for r in rows if r["dtype"] == "bfloat16"])
    res["backward_per_step"] = sums
    log(f"  backward products per yi-6b step (bf16, 450 launches): "
        f"{sums['ms']:.2f} ms event-timed, {sums['device_ms']:.2f} device; "
        f"torch.matmul {sums['matmul_ms']:.2f} / "
        f"{sums['device_matmul_ms']:.2f}; bound {sums['bound_ms']:.2f}; "
        f"transposes {sums['transposes_ms']:.2f}; z relaunches "
        f"{sums['z_ms']:.2f}")

    # 2. full-width yi-6b steps through the launcher's train step
    model = _yi6b()
    cfg = model.cfg
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=20, total=100))
    step_fn = S.make_train_step(model, opt, num_microbatches=1,
                                remat="full")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    ostate = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    want = train_launches(cfg.num_layers, "full")
    steps = []
    for i in range(TRAIN_STEPS):
        batch = _train_batch(torch, cfg, i)
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        _zero_counts()
        t0 = time.perf_counter()
        params, ostate, m = step_fn(params, ostate, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_counts()
        # the caching allocator's retries: each frees its cache and syncs
        retries = torch.cuda.memory_stats().get("num_alloc_retries",
                                                0) - retries
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        steps.append({"loss": loss, "ce": float(m["ce"]), "grad_norm": gn,
                      "seconds": dt, "launches": counts,
                      "alloc_retries": retries})
        log(f"  yi-6b train step {i}: loss {loss:.4f} gnorm {gn:.3f} "
            f"{dt * 1e3:.1f} ms, kraken_gemm {counts['kraken_gemm']}, "
            f"{retries} allocator retries")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"train: step {i} loss {loss} gnorm {gn}")
        if counts["kraken_gemm"] != want or any(
                v for k, v in counts.items() if k != "kraken_gemm"):
            raise AssertionError(f"train: step {i} launches {counts}, "
                                 f"want {want} kraken_gemm only")
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    # one more step traced: device time by kernel group, the update's
    # kernels (launched inside its "adamw" range) apart
    res["trace"] = device_trace(
        lambda: step_fn(params, ostate, _train_batch(torch, cfg,
                                                     TRAIN_STEPS)),
        "yi-6b train step", ranges=("adamw",))
    res["steps"] = steps
    res["full_width"] = {
        "params": sum(p.numel() for p in T.leaves(params)),
        "layers": cfg.num_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "init_s": init_s, "peak_bytes": peak, "total_bytes": total,
        "peak_reserved_bytes": reserved,
        "launches_per_step": want,
        "warm_step_s": min(s["seconds"] for s in steps[1:])}
    log(f"  yi-6b full width ({res['full_width']['params'] / 1e9:.2f} B "
        f"params, {cfg.num_layers} layers, batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, remat full): warm step "
        f"{res['full_width']['warm_step_s'] * 1e3:.1f} ms, peak "
        f"{peak / 1e9:.2f} GB of {total / 1e9:.2f} ({reserved / 1e9:.2f} "
        f"reserved), {want} kraken_gemm a step")
    if total - peak < TRAIN_HEADROOM:
        raise AssertionError(f"train: peak {peak / 1e9:.2f} GB leaves less "
                             f"than {TRAIN_HEADROOM / 1e9:.0f} GB free")
    del params, ostate, m, step_fn, model
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the gradient gate, 4. the launcher
    res["gate"] = gradient_gate(torch)
    gc.collect()
    torch.cuda.empty_cache()
    res["cli"] = train_cli(ROOT / "build")
    rec["train"] = res


# ---------------------------------------------------------------------------
# phase: swa_train -- the windowed archs trained through swa_attention's
# forward and backward kernels
# ---------------------------------------------------------------------------

# gemma3-12b at full width and one period (5 local layers of window 1024 +
# 1 global), batch x seq from SyntheticLM, remat "full"; its float32
# gradient gate at batch 1 x SWA_GATE_SEQ (past the window); mixtral-8x22b
# at full width and one layer at MIXTRAL_TRAIN_SEQ, past its 4096 window
SWA_TRAIN_BATCH, SWA_TRAIN_SEQ, SWA_TRAIN_STEPS = 2, 4096, 3
SWA_GATE_SEQ = 2048
MIXTRAL_TRAIN_SEQ, MIXTRAL_TRAIN_STEPS = 8192, 2


def windowed_steps(torch, label: str, model, *, batch: int, seq: int,
                   steps: int, want: dict, trace: bool = False) -> dict:
    """``steps`` train steps of ``model`` (bf16 parameters, fp32 AdamW
    moments, seeded weights) through ``launch/steps.make_train_step`` with
    remat ``"full"``: every loss and grad norm finite, exactly ``want``
    launches a step (0 of every other kernel), the step times and the peak
    allocation, which must leave ``TRAIN_HEADROOM`` free; with ``trace``
    one more step under ``device_trace`` (AdamW's kernels apart)."""
    from repro_torch import tree as T
    from repro_torch.launch import steps as S
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=20, total=100))
    step_fn = S.make_train_step(model, opt, num_microbatches=1,
                                remat="full")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    ostate = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in T.leaves(params))
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(steps):
        b = _train_batch(torch, model.cfg, i, batch, seq)
        _zero_counts()
        t0 = time.perf_counter()
        params, ostate, m = step_fn(params, ostate, b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_counts()
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        rows.append({"loss": loss, "ce": float(m["ce"]), "grad_norm": gn,
                     "seconds": dt, "launches": counts})
        log(f"  {label} train step {i}: loss {loss:.4f} gnorm {gn:.3f} "
            f"{dt * 1e3:.1f} ms, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"swa_train: {label} step {i} loss {loss} "
                                 f"gnorm {gn}")
        _check_launches(f"swa_train: {label} step {i}", counts, want)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    res = {"params": n_params, "layers": model.cfg.num_layers,
           "batch": batch, "seq": seq, "init_s": init_s, "steps": rows,
           "peak_bytes": peak, "total_bytes": total,
           "launches_per_step": want,
           "warm_step_s": min(r["seconds"] for r in rows[1:])}
    if trace:
        res["trace"] = device_trace(
            lambda: step_fn(params, ostate,
                            _train_batch(torch, model.cfg, steps, batch,
                                         seq)),
            f"{label} train step", ranges=("adamw",))
    log(f"  {label} full width ({n_params / 1e9:.2f} B params, "
        f"{model.cfg.num_layers} layers, batch {batch} x seq {seq}, remat "
        f"full): warm step {res['warm_step_s'] * 1e3:.1f} ms, peak "
        f"{peak / 1e9:.2f} GB of {total / 1e9:.2f}, launches a step {want}")
    if total - peak < TRAIN_HEADROOM:
        raise AssertionError(f"swa_train: {label} peak {peak / 1e9:.2f} GB "
                             f"leaves less than {TRAIN_HEADROOM / 1e9:.0f} "
                             "GB free")
    return res


def swa_gradient_gate(torch) -> dict:
    """gemma3-12b's one period at full width in float32, batch 1 x
    ``SWA_GATE_SEQ`` (past the 1024 window, so the kernels' window edges
    count): one step's gradients with the kernels (remat ``"none"`` and
    ``"full"``, each local layer through the swa forward and backward
    kernels) against the plain versions everywhere, each leaf within
    ``TRAIN_GATE_TOL`` relative L2."""
    import gc
    from repro_torch import tree as T
    from repro_torch.core.gemm_cases import windowed_train_launches
    base = _gemma3(layers=GEMMA_PERIOD, dtype="float32")
    params = base.init(torch.Generator(device="cuda").manual_seed(5))
    batch = _train_batch(torch, base.cfg, 0, 1, SWA_GATE_SEQ)
    _zero_counts()
    loss_p, want = _param_grads(_gemma3(_plain_kernels(), GEMMA_PERIOD,
                                        "float32"), params, batch)
    _check_launches("swa_train gate: plain", _read_counts(), {})
    out = {"loss_plain": float(loss_p)}
    for remat in ("none", "full"):
        _zero_counts()
        loss, grads = _param_grads(_gemma3(None, GEMMA_PERIOD, "float32"),
                                   params, batch, remat)
        counts = _read_counts()
        need = windowed_train_launches(GEMMA_PERIOD, GEMMA_PERIOD - 1, remat)
        # the gradient alone: no AdamW, and the z relaunches are the
        # backward's (so the train step's count)
        _check_launches(f"swa_train gate: remat {remat}", counts, need)
        worst, where = 0.0, ""
        for (path, _), g, w in zip(T.leaves_with_path(params), grads, want):
            rel = float((g.float() - w.float()).norm()
                        / w.float().norm().clamp_min(1e-30))
            if rel > worst:
                worst, where = rel, path
        out[remat] = {"loss_kernels": float(loss), "worst_rel_l2": worst,
                      "worst_leaf": where, "launches": counts}
        log(f"  gradient gate float32, gemma3-12b {GEMMA_PERIOD} layers, "
            f"seq {SWA_GATE_SEQ}, remat {remat}: loss {float(loss):.6f} / "
            f"plain {float(loss_p):.6f}, worst leaf {where} relative L2 "
            f"{worst:.3e} (gate {TRAIN_GATE_TOL})")
        del grads
        gc.collect()
    del want, params
    bad = {r: out[r] for r in ("none", "full")
           if not out[r]["worst_rel_l2"] <= TRAIN_GATE_TOL}
    if bad:
        raise AssertionError(f"swa_train: float32 gradients, kernels vs "
                             f"plain, {bad}")
    return out


def swa_train_cli(out_dir: Path) -> dict:
    """``launch/train.py --arch gemma3-12b --smoke`` on the card at its
    default seq 128 (the swa branch, smoke window 8): 6 steps with a
    checkpoint at step 3 and 6, then a second invocation resuming from step
    6; every logged loss finite."""
    import os
    import shutil
    ck = out_dir / "swa_train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "gemma3-12b", "--smoke", "--ckpt-dir", str(ck), "--ckpt-every",
            "3", "--log-every", "1"]
    runs = {}
    for label, extra, want in (
            ("first", ["--steps", "6"], ["done: 6 steps"]),
            ("resume", ["--steps", "9"],
             ["[restore] resumed from step 6", "done: 9 steps"])):
        t0 = time.perf_counter()
        res = subprocess.run(base + extra, capture_output=True, text=True,
                             env=env, timeout=300)
        secs = time.perf_counter() - t0
        for ln in res.stdout.splitlines():
            log(f"  swa train cli {label}: {ln}")
        losses = [float(ln.split(" loss ")[1].split()[0])
                  for ln in res.stdout.splitlines() if " loss " in ln]
        missing = [w for w in want if w not in res.stdout]
        if res.returncode or missing or not losses or not all(
                math.isfinite(x) for x in losses):
            raise AssertionError(f"swa train cli {label}: rc "
                                 f"{res.returncode}, missing {missing}, "
                                 f"losses {losses}: {res.stderr[-2000:]}")
        runs[label] = {"seconds": secs, "losses": losses}
    shutil.rmtree(ck, ignore_errors=True)
    return runs


def phase_swa_train(rec: dict, state: dict) -> None:
    """gemma3-12b (one period) and mixtral-8x22b (one layer) trained at
    full width through swa_attention's forward and backward kernels, the
    float32 gradient gate, and the launcher on gemma3's smoke config."""
    import gc
    import torch
    from repro_torch.core.gemm_cases import windowed_train_launches
    state.clear()                       # every earlier phase's model
    gc.collect()
    torch.cuda.empty_cache()
    set_alloc = getattr(torch._C, "_accelerator_setAllocatorSettings",
                        torch.cuda.memory._set_allocator_settings)
    set_alloc("expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    res: dict = {}
    t0 = time.perf_counter()
    res["gemma3"] = windowed_steps(
        torch, "gemma3-12b", _gemma3(layers=GEMMA_PERIOD),
        batch=SWA_TRAIN_BATCH, seq=SWA_TRAIN_SEQ, steps=SWA_TRAIN_STEPS,
        want=windowed_train_launches(GEMMA_PERIOD, GEMMA_PERIOD - 1),
        trace=True)
    res["gemma3"]["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["gate"] = swa_gradient_gate(torch)
    res["gate"]["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the experts run the einsum path under grad, as JAX's do: no
    # grouped_moe_gemm launch (the launch check wants 0 of it)
    res["mixtral"] = windowed_steps(
        torch, "mixtral-8x22b", _mixtral(layers=1),
        batch=1, seq=MIXTRAL_TRAIN_SEQ, steps=MIXTRAL_TRAIN_STEPS,
        want=windowed_train_launches(1, 1, dense=4, gated=0))
    res["mixtral"]["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["cli"] = swa_train_cli(ROOT / "build")
    res["cli"]["seconds"] = time.perf_counter() - t0
    rec["swa_train"] = res
    g, m = res["gemma3"], res["mixtral"]
    log(f"swa_train: gemma3-12b {g['layers']} layers ({g['params'] / 1e9:.2f}"
        f" B) batch {g['batch']} x {g['seq']}: warm step "
        f"{g['warm_step_s'] * 1e3:.1f} ms, peak {g['peak_bytes'] / 1e9:.2f} "
        f"GB; gate within {TRAIN_GATE_TOL}; mixtral-8x22b 1 layer "
        f"({m['params'] / 1e9:.2f} B) seq {m['seq']}: warm step "
        f"{m['warm_step_s'] * 1e3:.1f} ms, peak {m['peak_bytes'] / 1e9:.2f} "
        f"GB; the smoke launcher resumed")


# ---------------------------------------------------------------------------
# the multi-device code: the dry run, a one-rank NCCL mesh, the roofline
# ---------------------------------------------------------------------------

# the dry run's cells (arch, shape, --multi-pod, extra flags): full width on
# the production meshes; the train cells cut to DRYRUN_TRAIN_LAYERS layers
# (their microbatches stay), decode at full depth; each prints the 8 ops
# that move the most bytes
DRYRUN_TRAIN_LAYERS = 2
DRYRUN_CELLS = (
    ("yi-6b", "train_4k", "off",
     ["--layers", str(DRYRUN_TRAIN_LAYERS), "--ops", "8"]),
    ("yi-6b", "decode_32k", "off", ["--ops", "8"]),
    ("mixtral-8x22b", "train_4k", "on",
     ["--layers", str(DRYRUN_TRAIN_LAYERS), "--ops", "8"]))
# the mesh phase: yi-6b at full width, MESH_SLOTS prompts of MESH_PROMPT
# tokens into caches of MESH_CACHE, MESH_DECODE decode steps; two train
# steps at MESH_TRAIN_LAYERS layers
MESH_SLOTS, MESH_PROMPT, MESH_CACHE, MESH_DECODE = 4, 64, 128, 4
MESH_TRAIN_LAYERS = 2
# a share of the bound above this means the count is wrong
ROOFLINE_SHARE_MAX = 1.05


# dry-run processes started ahead of their phase (``dryrun``'s start with
# ``roofline``'s, so the host traces both at once), by phase
_STARTED: dict = {}


def _start_dryrun(cells, out: Path) -> tuple:
    """Start every cell of ``cells`` through ``python -m
    repro_torch.launch.dryrun`` in a process of its own (the fake group is
    its default group), all at once; their output goes to files beside
    ``out``.  Returns (start time, [(record path, process)])."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, (arch, shape, pod, extra) in enumerate(cells):
        path = out.with_name(f"{out.stem}_{i}.jsonl")
        path.unlink(missing_ok=True)
        with open(path.with_suffix(".out"), "w") as so, \
                open(path.with_suffix(".err"), "w") as se:
            procs.append((path, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--multi-pod", pod,
                 "--out", str(path), *extra], env=env, stdout=so,
                stderr=se)))
    return time.perf_counter(), procs


def _collect_dryrun(started, timeout: int = 900) -> list:
    """Wait for the processes of :func:`_start_dryrun`; returns their
    records, and raises if a process fails."""
    _, procs = started
    recs = []
    for path, proc in procs:
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        for ln in path.with_suffix(".out").read_text().splitlines():
            log(f"  dryrun: {ln}")
        got = [json.loads(ln) for ln in path.read_text().splitlines()] \
            if path.exists() else []
        if proc.returncode or not got:
            err = path.with_suffix(".err").read_text()
            raise AssertionError(f"dryrun: rc {proc.returncode}: "
                                 f"{err[-3000:]}")
        recs += got
    return recs


def _stop_dryruns() -> None:
    """Kill the started dry-run processes no phase collected."""
    for _, procs in _STARTED.values():
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    _STARTED.clear()


def _run_dryrun(cells, out: Path, timeout: int = 900) -> list:
    """:func:`_start_dryrun` and :func:`_collect_dryrun` of ``cells``."""
    return _collect_dryrun(_start_dryrun(cells, out), timeout)


def phase_dryrun(rec: dict, state: dict) -> None:
    """``repro_torch.launch.dryrun`` at full width on the production meshes:
    yi-6b ``train_4k`` and ``decode_32k`` on 16x16 and mixtral-8x22b
    ``train_4k`` on 2x16x16, each on a fake process group of 256 or 512
    ranks, traced on fake tensors (the host's CPU; nothing of it runs on
    the card).  Per-device bytes, the bottleneck and the roofline fraction
    of each; any ``"status": "fail"`` fails the phase."""
    card = card_line()
    started = _STARTED.pop("dryrun", None) or _start_dryrun(
        DRYRUN_CELLS, ROOT / "build" / "dryrun.jsonl")
    recs = _collect_dryrun(started)
    for r in recs:
        if r["status"] != "ok":
            raise AssertionError(f"dryrun: {r['arch']} x {r['shape']} x "
                                 f"{r['mesh']}: {r.get('error')}")
        m, roof = r["memory"], r["roofline"]
        log(f"  dryrun {r['arch']} x {r['shape']} x {r['mesh']} "
            f"({r.get('cuts', {})}): per device args "
            f"{m['argument_bytes'] / 2**30:.2f} GiB, temp "
            f"{m['temp_bytes'] / 2**30:.2f} GiB, peak "
            f"{m['peak_per_device_bytes'] / 2**30:.2f} GiB; collectives "
            f"{r['collectives']['counts']}; bottleneck {roof['bottleneck']}, "
            f"roofline fraction {roof['roofline_fraction']:.4f} (bound "
            f"{max(roof['t_compute_s'], roof['t_memory_s'], roof['t_collective_s']) * 1e3:.3f} ms "
            f"against the peaks of {card}); traced in {r['compile_s']} s")
    rec["dryrun"] = {"cells": recs,
                     "seconds": time.perf_counter() - started[0],
                     "card": card}


def _dtensors_whole(tree):
    from repro_torch import sharding as Sh
    from repro_torch import tree as T
    return [t.full_tensor() if Sh.is_dtensor(t) else t
            for t in T.leaves(tree)]


def _mesh_serve(torch, mesh, res: dict) -> None:
    """Prefill and decode of full-width bf16 yi-6b (the serve phase's
    weights: the same init and seed) unsharded and under the mesh: the
    logits bit for bit; the unsharded warm decode step timed for the
    roofline phase."""
    import gc
    from repro_torch import sharding as Sh
    from repro_torch.checkpoint.elastic import reshard_tree
    from repro_torch.launch import steps as S
    model = _yi6b()
    cfg = model.cfg
    rules = Sh.RULES_SINGLE_POD
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (MESH_SLOTS, MESH_PROMPT),
                           generator=g, device="cuda", dtype=torch.int32)
    steps_tok = torch.randint(0, cfg.vocab_size, (MESH_DECODE, MESH_SLOTS, 1),
                              generator=g, device="cuda", dtype=torch.int32)
    prefill, decode = S.make_prefill_step(model), S.make_decode_step(model)

    def run(p, caches, dist_in):
        out = []
        batch = {"tokens": dist_in(tokens, ("batch", "seq"))}
        logits, caches = prefill(p, caches, batch)
        out.append(logits)
        for i in range(MESH_DECODE):
            pos = torch.full((MESH_SLOTS,), MESH_PROMPT + i,
                             dtype=torch.int32, device="cuda")
            logits, caches = decode(p, caches,
                                    dist_in(steps_tok[i], ("batch", None)),
                                    dist_in(pos, ("batch",)))
            out.append(logits)
        return out

    plain = run(params, model.init_caches(MESH_SLOTS, MESH_CACHE),
                lambda t, ax: t)
    # the unsharded warm decode step, for the roofline phase
    caches = model.init_caches(MESH_SLOTS, MESH_CACHE)
    prefill(params, caches, {"tokens": tokens})
    pos = torch.full((MESH_SLOTS,), MESH_PROMPT, dtype=torch.int32,
                     device="cuda")
    res["decode_step_ms"] = time_ms(
        lambda: decode(params, caches, steps_tok[0], pos), 20)
    del caches
    with Sh.use_mesh_and_rules(mesh, rules):
        pd = reshard_tree(params, model.param_axes(), mesh, rules)
        axes = iter(model.cache_axes_list(MESH_SLOTS, MESH_CACHE))
        cd = S.map_cache(model.init_caches(MESH_SLOTS, MESH_CACHE),
                         lambda _, t: Sh.distribute(t, mesh, Sh.placements(
                             mesh, Sh.partition_spec(t.shape, next(axes)))))

        def dist_in(t, ax):
            return Sh.distribute(t, mesh, Sh.placements(
                mesh, Sh.partition_spec(t.shape, ax)))
        _zero_counts()
        sharded = run(pd, cd, dist_in)
        counts = _read_counts()
    got = [t.full_tensor() for t in sharded]
    same = all(torch.equal(a, b) for a, b in zip(got, plain))
    res["serve"] = {"steps": 1 + MESH_DECODE, "bit_equal": same,
                    "launches": counts,
                    "max_abs_diff": max(float((a.float() - b.float()).abs()
                                              .max()) for a, b in
                                        zip(got, plain))}
    log(f"  mesh serve: yi-6b full width bf16, {MESH_SLOTS} x "
        f"{MESH_PROMPT} prefill + {MESH_DECODE} decode steps under a (1, 1) "
        f"NCCL mesh: logits bit-equal to unsharded {same}; kraken_gemm "
        f"{counts['kraken_gemm']} launches in the sharded pass; unsharded "
        f"warm decode step {res['decode_step_ms']:.3f} ms")
    if not same:
        raise AssertionError(f"mesh: sharded logits differ: {res['serve']}")
    if counts["kraken_gemm"] == 0:
        raise AssertionError("mesh: no kraken_gemm launch in the sharded "
                             "pass")
    del params, pd, cd, plain, sharded, got
    gc.collect()
    torch.cuda.empty_cache()


def _mesh_train(torch, mesh, res: dict) -> None:
    """Two train steps at yi-6b's width and MESH_TRAIN_LAYERS layers,
    unsharded and under the mesh with ZeRO-1 moments: losses and updated
    parameters bit for bit."""
    import gc
    from repro_torch import sharding as Sh
    from repro_torch.checkpoint.elastic import reshard_tree
    from repro_torch.launch import steps as S
    from repro_torch.launch.sharding_rules import zero1_param_rules
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    model = _full_width("yi-6b", layers=MESH_TRAIN_LAYERS)
    cfg = model.cfg
    rules = Sh.RULES_SINGLE_POD
    axes = model.param_axes()
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=20, total=100))
    step = S.make_train_step(model, opt, num_microbatches=1, remat="full")
    out = {}
    for label in ("plain", "mesh"):
        params = model.init(torch.Generator(device="cuda").manual_seed(7))
        if label == "mesh":
            params = reshard_tree(params, axes, mesh, rules)
            ost = opt.init(params, axes=axes, mesh=mesh,
                           rules=zero1_param_rules(rules))
        else:
            ost = opt.init(params)
        losses = []
        _zero_counts()
        for i in range(2):
            batch = _train_batch(torch, cfg, i)
            if label == "mesh":
                batch = {k: Sh.distribute(v, mesh, Sh.placements(
                    mesh, Sh.partition_spec_of(mesh, rules, v.shape,
                                               ("batch", "seq"))))
                         for k, v in batch.items()}
            with Sh.use_mesh_and_rules(mesh if label == "mesh" else None,
                                       rules):
                params, ost, m = step(params, ost, batch)
            losses.append(m["loss"].detach().clone())
        out[label] = (losses, [t.detach().clone()
                               for t in _dtensors_whole(params)],
                      _read_counts()["kraken_gemm"])
        del params, ost
        gc.collect()
    same_loss = all(torch.equal(a, b) for a, b in zip(out["mesh"][0],
                                                      out["plain"][0]))
    same_params = all(torch.equal(a, b) for a, b in zip(out["mesh"][1],
                                                        out["plain"][1]))
    res["train"] = {"layers": MESH_TRAIN_LAYERS,
                    "losses": [float(x) for x in out["mesh"][0]],
                    "losses_plain": [float(x) for x in out["plain"][0]],
                    "losses_bit_equal": same_loss,
                    "params_bit_equal": same_params,
                    "kraken_gemm": out["mesh"][2],
                    "kraken_gemm_plain": out["plain"][2]}
    log(f"  mesh train: yi-6b full width, {MESH_TRAIN_LAYERS} layers, two "
        f"steps, ZeRO-1 moments: losses {res['train']['losses']} bit-equal "
        f"{same_loss}, parameters bit-equal {same_params}; kraken_gemm "
        f"{out['mesh'][2]} launches (unsharded {out['plain'][2]})")
    if not (same_loss and same_params):
        raise AssertionError(f"mesh: sharded train steps differ: "
                             f"{res['train']}")
    if out["mesh"][2] != out["plain"][2] or out["mesh"][2] == 0:
        raise AssertionError(f"mesh: sharded train steps launched "
                             f"{out['mesh'][2]} kraken_gemm, unsharded "
                             f"{out['plain'][2]}")
    del out
    gc.collect()
    torch.cuda.empty_cache()


def phase_mesh(rec: dict, state: dict) -> None:
    """A real one-rank NCCL group and a ``(1, 1)`` ``DeviceMesh`` on the
    card: prefill/decode and ZeRO-1 train steps of full-width yi-6b through
    DTensor and ``dense_gemm``'s sharding rule (``kraken_gemm`` on each
    rank's local shards) equal the unsharded steps bit for bit;
    ``allreduce_compressed`` over NCCL equals the local compress and
    decompress; the train phase's checkpoint restores onto the mesh equal."""
    import datetime
    import gc
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as Sh
    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.checkpoint.elastic import elastic_restore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import compress
    # the train phase's checkpoint (run alone, the phase writes one through
    # the same launcher)
    ck = Path((rec.get("train", {}).get("cli")
               or train_cli(ROOT / "build"))["ckpt_dir"])
    if ckpt.latest_step(str(ck)) is None:
        raise RuntimeError(f"mesh: no checkpoint in {ck}")
    state.clear()
    gc.collect()
    torch.cuda.empty_cache()
    store = ROOT / "build" / "mesh_store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=300))
    res: dict = {}
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"mesh: backend {dist.get_backend()}")
        mesh = make_host_mesh(1, 1)
        if mesh.device_type != "cuda":
            raise AssertionError(f"mesh on {mesh.device_type}")
        _mesh_serve(torch, mesh, res)
        _mesh_train(torch, mesh, res)

        # the compressed all-reduce over NCCL: one rank's mean is its own
        # compress and decompress
        g = torch.Generator(device="cuda").manual_seed(11)
        grads = {"a": torch.randn(4096, 1024, generator=g, device="cuda"),
                 "b": torch.randn(11008, generator=g, device="cuda")}
        with Sh.use_mesh_and_rules(mesh, Sh.RULES_SINGLE_POD):
            mean, _ = compress.allreduce_compressed(
                grads, compress.init_state(grads), "model")
        q, sc, _ = compress.compress_grads(grads, compress.init_state(grads))
        local = compress.decompress_grads(q, sc)
        res["compress_equal"] = all(torch.equal(mean[k], local[k])
                                    for k in grads)
        log(f"  mesh allreduce_compressed over NCCL equals the local "
            f"compress + decompress: {res['compress_equal']}")
        if not res["compress_equal"]:
            raise AssertionError("mesh: allreduce_compressed differs")

        # the train phase's checkpoint, restored onto the mesh
        from repro_torch.configs import get_arch, smoke_config
        from repro_torch.models.model import Model
        model = Model(smoke_config(get_arch("yi-6b")))
        specs = model.param_specs(lambda s: torch.empty(
            s.shape, dtype=getattr(torch, model.cfg.dtype), device="meta"))
        tree, step, _ = ckpt.restore(str(ck), {"params": specs})
        placed, step2, _ = elastic_restore(
            str(ck), {"params": specs}, {"params": model.param_axes()},
            mesh, Sh.RULES_SINGLE_POD)
        ok = step == step2 and all(
            a.device.type == "cuda" and torch.equal(a.full_tensor().cpu(), b)
            for a, b in zip(T.leaves(placed), T.leaves(tree)))
        res["elastic"] = {"step": step2, "equal": ok,
                          "leaves": len(T.leaves(tree))}
        log(f"  mesh elastic_restore of the train phase's checkpoint (step "
            f"{step2}, {res['elastic']['leaves']} leaves) onto the mesh: "
            f"equal {ok}")
        if not ok:
            raise AssertionError("mesh: elastic_restore differs")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
        shutil.rmtree(ck, ignore_errors=True)
    rec["mesh"] = res


def phase_roofline(rec: dict, state: dict) -> None:
    """The op walk of the yi-6b warm decode step (the mesh phase's shapes)
    and of the full-width train step (the train phase's), each traced by
    the dry run on a fake one-rank ``(1, 1)`` mesh with the plain versions,
    beside the times the card measured: t_compute, t_memory, the bound,
    the share of the bound and MFU against 989 TFLOP/s.  Reported, not
    gated, but a share of the bound above ROOFLINE_SHARE_MAX means the
    count is wrong and fails."""
    from repro_torch.configs import get_arch
    from repro_torch.roofline.analysis import PEAK_FLOPS
    card = card_line()
    layers = get_arch("yi-6b").num_layers
    tr = rec.get("train", {}).get("full_width")
    dec = rec.get("mesh", {}).get("decode_step_ms")
    if tr is None or dec is None:
        raise RuntimeError("the roofline phase needs the train and mesh "
                           "phases")
    cells = (("yi-6b", "decode_32k", "off",
              ["--mesh", "1x1", "--batch", str(MESH_SLOTS), "--seq",
               str(MESH_CACHE)]),
             ("yi-6b", "train_4k", "off",
              ["--mesh", "1x1", "--batch", str(tr["batch"]), "--seq",
               str(tr["seq"]), "--microbatches", "1", "--remat", "full"]))
    if "dryrun" in rec["phases"] and "dryrun" not in _STARTED:
        _STARTED["dryrun"] = _start_dryrun(DRYRUN_CELLS,
                                           ROOT / "build" / "dryrun.jsonl")
    recs = _run_dryrun(cells, ROOT / "build" / "roofline.jsonl")
    out = {}
    for r, (what, secs) in zip(recs, (("decode step", dec / 1e3),
                                      ("train step", tr["warm_step_s"]))):
        if r["status"] != "ok":
            raise AssertionError(f"roofline: {what}: {r.get('error')}")
        roof = r["roofline"]
        bound = max(roof["t_compute_s"], roof["t_memory_s"],
                    roof["t_collective_s"])
        share = bound / secs
        mfu = roof["model_flops"] / (secs * PEAK_FLOPS)
        out[what] = {"t_compute_s": roof["t_compute_s"],
                     "t_memory_s": roof["t_memory_s"], "bound_s": bound,
                     "measured_s": secs, "share_of_bound": share, "mfu": mfu,
                     "flops": roof["flops"], "hbm_bytes": roof["hbm_bytes"],
                     "model_flops": roof["model_flops"],
                     "layers": layers, "walked_in_s": r["compile_s"]}
        log(f"  roofline yi-6b {what} ({card}): t_compute "
            f"{roof['t_compute_s'] * 1e3:.3f} ms, t_memory "
            f"{roof['t_memory_s'] * 1e3:.3f} ms, bound {bound * 1e3:.3f} ms "
            f"({roof['bottleneck']}), measured {secs * 1e3:.3f} ms, share of "
            f"the bound {share:.3f}, MFU {mfu:.4f}")
        if share > ROOFLINE_SHARE_MAX:
            raise AssertionError(f"roofline: {what} runs at {share:.3f} of "
                                 "its bound: the count is wrong")
    out["card"] = card
    rec["roofline"] = out


def conv_entry(rec: dict, by_path) -> dict:
    """The kernels line's ``kraken_conv2d_direct`` entry: one VGG-16 frame
    at batch 1 in bf16 as ``conv_nets`` timed it (its 13 layers back to
    back); the times are null when that phase did not run."""
    from repro_torch.core.conv_cases import CONV_R
    vgg = rec.get("conv_nets", {}).get("vgg16 b1", {})
    frame = vgg.get("frame_ms", {})
    return {"name": "kraken_conv2d_direct", "route": "cuda",
            "source": "src/repro_torch/csrc/kraken_conv.cu",
            "replaces": "src/repro/kernels/kraken_conv.py:115",
            "launches": vgg.get("launches", {}).get("kraken_conv2d_direct"),
            "launches_by_path": by_path("kraken_conv2d_direct"),
            "max_abs_err": max(r["max_abs_err"] for r in rec["conv_kernels"]),
            "ms": frame.get("direct"), "plain_ms": frame.get("plain"),
            "bound_ms": vgg.get("bound_frame_ms"),
            "bound_by": vgg.get("bound_by"),
            "library_ms": frame.get("cudnn"),
            "shape": "one VGG-16 frame at batch 1, bf16: its 13 conv layers "
                     f"one call each, R {CONV_R}; library = cuDNN F.conv2d, "
                     "channels_last"}


def yi_entries(rec: dict, launches: dict, by_path) -> list[dict]:
    """The kernels line's entries of the yi-6b path's two kernels."""
    from repro_torch.core.gemm_cases import GEMMS
    dec = {r["name"]: r for r in rec["gemm"]
           if r.get("ms") is not None and r["m"] == SLOTS
           and r["dtype"] == "bfloat16"}
    counts = {name: c for name, _, _, _, c in GEMMS}

    def step(key):
        return sum(dec[nm][key] * counts[nm] for nm in counts)

    att = next(r for r in rec["attention"]
               if r["name"] == "yi-6b 4 slots" and r["dtype"] == "bfloat16")
    z = next(r for r in rec["attention"]
             if r["name"] == "zamba2 4 slots" and r["dtype"] == "bfloat16")
    vlm = next(r for r in rec["attention"]
               if r["name"] == "llama-3.2-vision 4 slots"
               and r["dtype"] == "bfloat16")

    def calls(r, n):   # n calls of a timed case: one decode step
        return {key: r[key] * n for key in ("ms", "device_ms", "plain_ms",
                                            "bound_ms")}
    return [
        {"name": "kraken_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/kraken_gemm.cu",
         "replaces": "src/repro/kernels/kraken_gemm.py:74",
         "launches": launches.get("kraken_gemm"),
         "launches_by_path": by_path("kraken_gemm"),
         "max_abs_err": max(r["max_abs_err"] for r in rec["gemm"]),
         "ms": step("ms"), "plain_ms": step("plain_ms"),
         "bound_ms": step("bound_ms"), "bound_by": "bytes",
         "library_ms": step("library_ms"),
         "decode_steps_by_arch": {
             k: v for k, v in rec.get("gemm_steps", {}).items()
             if k.endswith("decode")},
         "train_step_backward": rec.get("train", {}).get(
             "backward_per_step"),
         "train_lm_step": rec.get("examples", {}).get("train_lm_gemm_step"),
         "shape": "one yi-6b decode step, bf16, M=4: 32 x (q,k,v,o,gate,up,"
                  "down) + unembed; decode_steps_by_arch: rwkv6-3b's 289, "
                  "zamba2-1.2b's 119, llama-3.2-vision-11b's 265 and "
                  "musicgen-large's 289 GEMMs of one decode step; "
                  "train_step_backward: the dA and dB products of one "
                  "yi-6b train step (bf16, M 1024: 225 calls x 2), "
                  "library = torch.matmul on the same contiguous "
                  "operands, transposes and z relaunches apart; "
                  "train_lm_step: the forward, dA and dB products of one "
                  "train_lm step (yi-100m, float32, M 2048: 85 calls x 3), "
                  "z relaunches apart"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:234",
         "launches": launches.get("paged_decode_attention"),
         "launches_by_path": by_path("paged_decode_attention"),
         "max_abs_err": max(r["max_abs_err"] for r in rec["attention"]),
         "ms": att["ms"] * LAYERS, "plain_ms": att["plain_ms"] * LAYERS,
         "device_ms": att["device_ms"] * LAYERS,
         "bound_ms": att["bound_ms"] * LAYERS, "bound_by": att["bound_by"],
         "library_ms": None, "plan": att["plan_text"],
         "zamba2_decode_step": calls(z, RECURRENT["zamba"][2]),
         "musicgen_decode_step": calls(z, FRONTEND["audio"][2]),
         "llama_vision_decode_step": calls(vlm, FRONTEND["vlm"][2]),
         "shape": "one yi-6b decode step, bf16: 32 layers x (4 slots, "
                  "32/4 heads, D 128, page 16, q_pos 300/700/dead/17); no "
                  "single PyTorch call walks a page table; zamba2_decode_step: "
                  "6 calls at 32/32 heads of 64, same slots; "
                  "musicgen_decode_step: 48 calls at that geometry; "
                  "llama_vision_decode_step: 32 calls at 32/8 heads of 128"},
    ]


def kernels_line(rec: dict) -> dict:
    """One entry per kernel; times are one decode step's worth: at yi-6b
    (bf16, M = 4 slots) the GEMM row sums every decode-step GEMM (32 layers
    x q,k,v,o,gate,up,down + unembed), the attention row 32 calls; at
    mixtral (bf16, 8 layers, C = 1) the grouped row 8 x (gate, up, down).
    ``launches`` counts the yi-6b serve path's launches (the grouped GEMM's
    the mixtral path's, ``decode_attention``'s the int8 dense path's,
    ``swa_attention``'s one gemma3 forward's, whose times are that
    forward's 40 calls; ``kraken_conv2d_direct``'s one VGG-16 frame's at
    batch 1, whose times are its 13 layers); ``launches_by_path`` every
    path."""
    # launches are counted only by the serve phases: null when they did not
    # run
    launches = rec.get("launches", {})
    moe_launches = rec.get("moe_serve", {}).get("launches", {})
    dense = rec.get("dense_serve", {})

    swa_fwd = rec.get("swa_forward", {})
    examples = rec.get("examples", {})

    def by_path(name):
        return {"yi-6b": launches.get(name),
                "mixtral-8x22b": moe_launches.get(name),
                **{RECURRENT[k][0]: rec.get(f"{k}_serve", {}).get(
                    "launches", {}).get(name) for k in RECURRENT},
                **{FRONTEND[k][0]: rec.get(f"{k}_serve", {}).get(
                    "launches", {}).get(name) for k in FRONTEND},
                **{f"{FRONTEND[k][0]} dense {lab}": rec.get(
                    f"{k}_serve", {}).get("dense", {}).get(lab, {}).get(
                    "launches", {}).get(name)
                   for k in FRONTEND for lab in ("frontend", "text")},
                "yi-6b serve_features": rec.get("serve_features", {}).get(
                    "launches", {}).get(name),
                "yi-6b int8 dense": dense.get("launches", {}).get(name),
                "yi-6b int8 engine": dense.get("engine_launches",
                                               {}).get(name),
                "gemma3-12b forward": swa_fwd.get("launches", {}).get(name),
                **{f"{key} conv direct": r["launches"].get(name)
                   for key, r in rec.get("conv_nets", {}).items()},
                **{f"{key} conv im2col": r["im2col_launches"].get(name)
                   for key, r in rec.get("conv_nets", {}).items()},
                "yi-6b train step": next(iter(
                    rec.get("train", {}).get("steps", [])), {}).get(
                    "launches", {}).get(name),
                **{f"{arch} train step": next(iter(
                    rec.get("swa_train", {}).get(key, {}).get("steps", [])),
                    {}).get("launches", {}).get(name)
                   for key, arch in (("gemma3", "gemma3-12b"),
                                     ("mixtral", "mixtral-8x22b"))},
                "yi-6b whole-prompt scatter, two decode steps": rec.get(
                    "serve", {}).get("scatter", {}).get("launches", {}).get(
                    name),
                **{f"{arch} long_context": rec.get(key, {}).get(
                    "long_context", {}).get("launches", {}).get(name)
                   for key, arch in (("rwkv_serve", "rwkv6-3b"),
                                     ("zamba_serve", "zamba2-1.2b"),
                                     ("moe_serve", "mixtral-8x22b"))},
                "examples quickstart": examples.get("quickstart", {}).get(
                    "launches", {}).get(name),
                "examples train_lm (yi-100m)": examples.get(
                    "train_lm", {}).get("launches", {}).get(name),
                **{f"examples serve_lm {arch}": examples.get(
                    "serve_lm", {}).get(arch, {}).get("launches", {}).get(
                    name) for arch in EXAMPLE_SERVE},
                **{f"examples long_context {arch}": r["launches"].get(name)
                   for arch, r in examples.get("long_context", {}).items()}}

    entries = []
    if "gemm" in rec:
        entries += yi_entries(rec, launches, by_path)
    if "moe_gemm" in rec:
        dec = rec["moe_steps"]["decode"]
        plan = next(r["plan_text"] for r in rec["moe_gemm"]
                    if r["name"] == "mixtral gate|up decode"
                    and r["dtype"] == "bfloat16")
        entries.append(
            {"name": "grouped_moe_gemm", "route": "cuda",
             "source": "src/repro_torch/csrc/grouped_moe_gemm.cu",
             "replaces": "src/repro/kernels/kraken_moe_gemm.py:183",
             "launches": moe_launches.get("grouped_moe_gemm"),
             "launches_by_path": by_path("grouped_moe_gemm"),
             "max_abs_err": max(r["max_abs_err"] for r in rec["moe_gemm"]),
             "ms": dec["ms"], "plain_ms": dec["plain_ms"],
             "bound_ms": dec["bound_ms"], "bound_by": "bytes",
             "library_ms": dec["library_ms"],
             "device_ms": dec["device_ms"],
             "device_library_ms": dec["device_library_ms"],
             "plan": plan, "mixed_step": rec["moe_steps"]["mixed"],
             "shape": f"one mixtral-8x22b decode step at {MOE_LAYERS} layers, "
                      "bf16, C=1, 6 of 8 experts live: "
                      f"{MOE_LAYERS} x (gate, up: 6144x16384; down: "
                      "16384x6144); mixed_step: one [4, 64] step, C=80, 7 "
                      "of 8 live, 492 rows; library = torch.bmm on the "
                      "masked buffer, all 8 experts"})
    if "dense_attention" in rec:
        rows = rec["dense_attention"] + rec["dense_attention_serve"]
        serve = rec["dense_attention_serve"]

        def dense_step(key):   # mean over the prompts, 32 calls per step
            return LAYERS * sum(r[key] for r in serve) / len(serve)

        entries.append(
            {"name": "decode_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/decode_attention.cu",
             "replaces": "src/repro/kernels/decode_attention.py:120",
             "launches": dense.get("launches", {}).get("decode_attention"),
             "launches_by_path": by_path("decode_attention"),
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": dense_step("ms"), "plain_ms": dense_step("plain_ms"),
             "bound_ms": dense_step("bound_ms"),
             "bound_by": serve[0]["bound_by"],
             "library_ms": dense_step("library_ms"),
             "device_ms": dense_step("device_ms"),
             "device_library_ms": dense_step("device_library_ms"),
             "plan": serve[0]["plan_text"],
             "shape": "one yi-6b int8 dense decode step as dense_serve runs "
                      "it: 32 layers x (1 slot, 32/4 heads, D 128, S 512), "
                      "mean over the 8 prompts' middle decode positions "
                      f"{DENSE_SERVE_Q_POS}; library = SDPA on a bf16 "
                      "cache (no dequant)"})
    if "swa_attention" in rec:
        rows = rec["swa_attention"]
        served = next(r for r in rows if r["name"] == "gemma3 local"
                      and r["dtype"] == "bfloat16")

        def fwd(key):   # one gemma3 forward: 40 local layers
            return GEMMA_LOCAL * served[key]

        entries.append(
            {"name": "swa_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/swa_attention.cu",
             "replaces": "src/repro/kernels/swa_attention.py:74",
             "launches": swa_fwd.get("launches", {}).get("swa_attention"),
             "launches_by_path": by_path("swa_attention"),
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": fwd("ms"), "plain_ms": fwd("plain_ms"),
             "bound_ms": fwd("bound_ms"), "bound_by": served["bound_by"],
             "library_ms": fwd("library_ms"),
             "device_ms": fwd("device_ms"),
             "device_library_ms": fwd("device_library_ms"),
             "plan": served["plan_text"],
             "shape": f"one gemma3-12b forward: {GEMMA_LOCAL} local layers x "
                      f"(B 1, 16/8 heads, D 240, S {SWA_SEQ}, window 1024), "
                      "bf16; library = SDPA with a boolean band mask"})
    if "swa_attention_bwd" in rec:
        rows = rec["swa_attention_bwd"]
        g3 = next(r for r in rows if r["name"] == "gemma3 local train"
                  and r["dtype"] == "bfloat16")
        mx = next(r for r in rows if r["name"] == "mixtral train"
                  and r["dtype"] == "bfloat16")
        local = GEMMA_PERIOD - 1

        def step(key):   # one gemma3 train step: 5 local layers
            return local * g3[key]

        entries.append(
            {"name": "swa_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/csrc/swa_attention_bwd.cu",
             "replaces": "none: the gradient of "
                         "src/repro/kernels/swa_attention.py:74, whose "
                         "pallas_call (:124) has no transpose",
             "launches": next(iter(rec.get("swa_train", {}).get(
                 "gemma3", {}).get("steps", [])), {}).get(
                 "launches", {}).get("swa_attention_bwd"),
             "launches_by_path": by_path("swa_attention_bwd"),
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": step("ms"), "plain_ms": step("plain_ms"),
             "bound_ms": step("bound_ms"), "bound_by": g3["bound_by"],
             "library_ms": step("library_ms"),
             "device_ms": step("device_ms"), "plan": g3["plan_text"],
             "mixtral_train_step": {key: mx[key] for key in (
                 "ms", "device_ms", "plain_ms", "library_ms", "bound_ms")},
             "shape": f"one gemma3-12b train step: {local} local layers x "
                      "(B 2, 16/8 heads, D 240, S 4096, window 1024), "
                      "bf16; mixtral_train_step: one call at B 1, 48/8 "
                      "heads of 128, S 8192, window 4096; library = the "
                      "backward of SDPA with a boolean band mask, "
                      "enable_gqa"})
    if "conv_kernels" in rec:
        entries.append(conv_entry(rec, by_path))
    return {"kernels": entries}


PHASES = {"build": phase_build, "kernels": phase_kernels,
          "moe_kernels": phase_moe_kernels,
          "dense_kernels": phase_dense_kernels,
          "swa_kernels": phase_swa_kernels,
          "conv_kernels": phase_conv_kernels,
          # small models: before the full-width phases
          "examples": phase_examples,
          "recurrence": phase_recurrence, "serve": phase_serve,
          "serve_features": phase_serve_features, "e2e": phase_e2e, "profile": phase_profile,
          "tune": phase_tune,
          "dense_serve": phase_dense_serve, "dense_e2e": phase_dense_e2e,
          "moe_serve": phase_moe_serve, "moe_e2e": phase_moe_e2e,
          "swa_forward": phase_swa_forward, "conv_nets": phase_conv_nets,
          # after conv_nets: once, when their traces ran before it (with
          # the host activity traced too, as they were then), its VGG-16
          # b32 trace lost its first frame's kernels
          **{f"{key}_{what}": functools.partial(fn, key=key)
             for key in RECURRENT
             for what, fn in (("serve", recurrent_serve),
                              ("e2e", recurrent_e2e))},
          **{f"{key}_{what}": functools.partial(fn, key=key)
             for key in FRONTEND
             for what, fn in (("serve", frontend_serve),
                              ("e2e", frontend_e2e))},
          # last: it releases every earlier phase's model
          "train": phase_train,
          # after train, which it follows in releasing every earlier model
          "swa_train": phase_swa_train,
          # after train: its checkpoint and its warm step
          "mesh": phase_mesh, "roofline": phase_roofline,
          "dryrun": phase_dryrun}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ",".join(PHASES))
    p.add_argument("--out", type=Path, default=ROOT / "build" / "chip_smoke",
                   help="directory for chip_smoke.json (the full record)")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    phases = [s for s in args.phases.split(",") if s]
    unknown = set(phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")
    rec: dict = {"phases": phases}
    state: dict = {}        # tensors handed from one phase to the next
    t0 = time.perf_counter()
    try:
        for name in PHASES:
            if name in phases:
                ts = time.perf_counter()
                PHASES[name](rec, state)
                log(f"phase {name}: ok ({time.perf_counter() - ts:.1f} s)")
    finally:   # the record of the phases that ran, passed or not
        _stop_dryruns()
        rec["seconds"] = time.perf_counter() - t0
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(rec, indent=1))
    if "card" not in rec:
        rec["card"] = card_line()
    print(rec["card"])
    if any(key in rec for key in ("gemm", "moe_gemm", "dense_attention",
                                  "swa_attention", "conv_kernels")):
        print(json.dumps(kernels_line(rec)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
