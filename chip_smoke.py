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
   every epilogue at ragged shapes; rwkv6-3b's and zamba2-1.2b's
   decode-step GEMMs are timed too.  Each GEMM runs twice and must give the
   same bits; its plan, TFLOP/s, GB/s and ratios to ``torch.matmul`` and
   the bound are logged, and every case is checked before a miss fails the
   phase with the largest atol it needs.  ``paged_decode_attention`` runs
   every ``PAGED_CASES`` entry of ``repro_torch/core/attention_cases.py``
   (yi-6b, its int8 pools and mixtral at 1, 4 and 64 slots, zamba2's
   shared block at 4 and 64; a ring wrap, a
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
5. ``e2e``      -- one mixed step's and one decode step's logits through the
   kernels and again through the plain versions, on the card.
6. ``profile``  -- ``torch.profiler`` over one more pass of the serve
   phase's warm engine: device time by kernel and the device's busy share
   (and, with ``moe_serve``, over one more warm mixtral pass; with
   ``swa_forward``, over one more gemma3-12b forward).
7. ``moe_serve`` -- release yi-6b, then serve mixtral-8x22b at full width
   and 8 of its 56 layers (20.4 B parameters, bf16) with the same engine
   and traffic; every MoE layer's expert FFN must go through
   ``grouped_moe_gemm``, three launches per layer per step.
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
   band mask and the bound.
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
   token-identical to the engine's (reported).  With ``profile``, a traced
   warm pass whose ``recurrence`` group holds the scans' kernels.
18. ``rwkv_e2e`` -- one mixed and one decode step of rwkv6-3b, kernels
   against plain versions: in bf16 on the served weights (reported: the
   model at this init amplifies a last-ulp difference, see
   ``recurrent_e2e``) and in float32 at full depth, within ``E2E_TOL``;
   then in float32 at 2 layers the engine token-identical to the
   sequential path on the serve workload's 8 requests.
19. ``zamba_serve``, ``zamba_e2e`` -- the same for zamba2-1.2b (38 Mamba2
   layers and 6 calls of the weight-shared attention block): 119
   ``kraken_gemm`` launches a step and 6 ``paged_decode_attention``
   launches a decode step (32/32 heads of 64); its float32 engine check
   runs 7 layers (one period and the shared block, one tail layer).

Phases run in the order ``build, kernels, moe_kernels, dense_kernels,
swa_kernels, conv_kernels, recurrence, serve, e2e, profile, dense_serve,
dense_e2e, moe_serve, moe_e2e, swa_forward, conv_nets, rwkv_serve,
rwkv_e2e, zamba_serve, zamba_e2e``.

The line before the last is the kernels' JSON record; the last line is the
device record.  Any failure raises and the exit code is not 0; without a
CUDA device the script exits 2 before printing any result.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense): bf16 tensor cores, fp32 outside
# them, and HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

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
# kraken_conv2d_direct and the im2col route against ref.conv2d, (atol, rtol)
# elementwise by output dtype.  Both sides read the same inputs, sum the
# products in fp32 and round once, so they differ by the summation order
# and at most one output ulp: 2 bf16 ulps of rtol (8e-3) cover the rounding,
# the atol the fp32 order on outputs near zero (the weights are scaled by
# 1/sqrt(C_i K_H K_W), so outputs are O(1)).  The largest bf16 atol needed
# over every case of conv_kernels on an H100 was 8.9e-6 (at K_H K_W C_i
# 4608); a dropped tap or channel chunk needs 1.5 or more
CONV_TOL = {"bfloat16": (2e-5, 8e-3), "float32": (1e-5, 1e-5)}


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
                           "swa_attention", "kraken_conv"], force=True)
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
        "serialised; swa_wgmma's 3 variants at 168 registers, no spill, "
        "wgmma not serialised; decode_attention's 10 kernels spill nothing; "
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
    # the recurrent archs' decode-step GEMMs (M = 4 slots, bf16), summed
    # per decode step as yi-6b's are
    from repro_torch.core.gemm_cases import RWKV_GEMMS, ZAMBA_GEMMS
    for arch, table in (("rwkv6-3b", RWKV_GEMMS),
                        ("zamba2-1.2b", ZAMBA_GEMMS)):
        arows = []
        for name, k, n, act, calls in table:
            r = gemm_case(torch, kg, ref, SLOTS, k, n, act, torch.bfloat16,
                          seed=len(rows))
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
        f"split over K, {sum(r['plan']['fill_a'] or r['plan']['fill_b'] for r in rows)} "
        "with an operand TMA refuses), largest atol needed bf16 "
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


def serve_passes(eng, label: str) -> list[dict]:
    """The serve workload twice through ``eng``: each pass's wall time,
    tok/s, TTFT, steps and new program signatures.  Every request must be
    served in full."""
    import numpy as np
    import torch
    vocab = eng.model.cfg.vocab_size
    rng = np.random.default_rng(0)
    passes = []
    for rep in range(2):
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
    if passes[1]["new_signatures"]:
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
    log(f"  {eng.report()}")
    log(f"serve: yi-6b {n_params / 1e9:.2f} B params bf16, all "
        f"{2 * len(SERVE_LENS)} requests served, warm pass "
        f"{passes[1]['tok_s']:.1f} tok/s, zero new signatures, launches "
        f"{launches}")


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


# device_trace's groups of the port's own kernels
PORTED_GROUPS = ("kraken_conv2d_direct",
                 "kraken_conv2d_direct: the weights' K-major copy",
                 "kraken_conv2d_direct: the split's fixed-order sum",
                 "grouped_moe_gemm", "kraken_gemm", "paged_decode_attention",
                 "swa_attention", "decode_attention")


def _kernels_under(evt):
    """(kernel name, device us) of every kernel a host event and the host
    events inside it launched."""
    for k in getattr(evt, "kernels", []):
        yield k.name, k.duration
    for child in getattr(evt, "cpu_children", []):
        yield from _kernels_under(child)


def device_trace(run, label: str, ranges: tuple = ()) -> dict:
    """``torch.profiler`` over ``run()``: device time by kernel group and
    the device's busy share of the wall time.  Kernels launched inside a
    ``record_function`` range named in ``ranges`` (the recurrences'
    ``"recurrence"``) form a group of that name; finding them needs the host
    activity too, which is then traced as well."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    # device activity alone unless ranges are grouped: the host-op rows are
    # left out below either way, so nothing counts twice
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges
                                      else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    rows = []
    for evt in prof.key_averages():
        us = dev_us(evt)
        # the ranges' own device-side spans would count their kernels twice
        if (us > 0 and evt.key not in ranges
                and str(getattr(evt, "device_type", "CUDA")).endswith("CUDA")):
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    # device us by kernel name launched inside each named range
    inside: dict = {}
    if ranges:
        for evt in prof.events():
            if evt.name in ranges and str(evt.device_type).endswith("CPU"):
                for name, us in _kernels_under(evt):
                    slot = inside.setdefault(evt.name, {})
                    slot[name] = slot.get(name, 0.0) + us

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
        if "kraken_gemm" in key or "gemm_kernel" in key:
            return "kraken_gemm"
        # the split kernel and the combine; before decode_attention's test,
        # which "paged_decode_attention_combine" meets
        if "paged_decode_attention" in key:
            return "paged_decode_attention"
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
    import torch
    outs = []
    for prompt in prompts:
        caches = model.init_caches(1, MAX_LEN)
        n = len(prompt)
        logits, caches = model.prefill(params, {
            "tokens": torch.as_tensor(prompt[None], device="cuda"),
            "positions": torch.arange(n, dtype=torch.int32, device="cuda")},
            caches)
        seq = [int(torch.argmax(logits[0, -1]))]
        while len(seq) < max_new:
            pos = torch.full((1,), n + len(seq) - 1, dtype=torch.int32,
                             device="cuda")
            logits, caches = model.decode_step(
                params, caches, torch.tensor([[seq[-1]]], device="cuda"), pos)
            seq.append(int(torch.argmax(logits[0])))
        outs.append(seq)
    return outs


def _counters():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import kraken_conv as kc
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import kraken_moe_gemm as mg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import swa_attention as sw
    return {"kraken_gemm": kg, "paged_decode_attention": pa,
            "grouped_moe_gemm": mg, "decode_attention": dec,
            "swa_attention": sw, "kraken_conv2d_direct": kc}


def _zero_counts() -> None:
    for mod in _counters().values():
        mod.launches = 0


def _read_counts() -> dict:
    return {name: mod.launches for name, mod in _counters().items()}


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
    want = {"kraken_gemm": (LAYERS * 7 + 1) * (len(prompts) + dec_steps),
            "paged_decode_attention": 0, "grouped_moe_gemm": 0,
            "decode_attention": LAYERS * dec_steps, "swa_attention": 0,
            "kraken_conv2d_direct": 0}
    if launches != want:
        raise AssertionError(f"dense path launch counts {launches} do not "
                             f"match {len(prompts)} prefills + {dec_steps} "
                             f"decode steps: {want}")
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


def _recurrent(arch: str, kernels=None, dtype: str = "bfloat16",
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


def recurrent_serve(rec: dict, state: dict, key: str) -> None:
    """Serve ``RECURRENT[key]``'s arch at full width and depth (bf16,
    seeded weights) through the engine, twice, then the same 8 requests one
    at a time through ``init_caches`` / ``prefill`` / ``decode_step``."""
    import torch
    from repro_torch.core import gemm_cases
    arch, table, attn_calls = RECURRENT[key]
    _release(state, "engine", "params",
             *(f"{k}_{x}" for k in RECURRENT for x in ("engine", "params")))
    log(f"  released the earlier models: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()
    model = _recurrent(arch)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    state[f"{key}_params"] = params
    eng = _engine(model, params)
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

    # the same requests one at a time through the sequential path
    prompts = serve_prompts(model.cfg.vocab_size)
    t0 = time.perf_counter()
    outs = dense_sequential(model, params, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(o) for o in outs)
    same = sum(a == b for a, b in zip(passes[0]["out"], outs))
    rec[f"{key}_serve"] = {
        "arch": arch, "params": n_params, "init_s": init_s,
        "passes": passes, "report": eng.report(), "launches": launches,
        "launches_per_decode_step": {"kraken_gemm": per_step,
                                     "paged_decode_attention": attn_calls},
        "launches_per_mixed_step": {"kraken_gemm": per_step,
                                    "paged_decode_attention": 0},
        "max_memory_allocated_gb": peak / 1e9, "logits_finite": True,
        "sequential": {"wall_s": wall, "tokens": toks, "tok_s": toks / wall,
                       "out": outs},
        "engine_requests_identical_to_sequential": same}
    state[f"{key}_engine"] = eng
    log(f"  {eng.report()}")
    log(f"  {key}_serve sequential: {len(prompts)} requests one at a time, "
        f"{toks} tokens in {wall:.2f} s = {toks / wall:.1f} tok/s; {same} of "
        f"{len(prompts)} token-identical to the engine's first pass")
    log(f"{key}_serve: {arch} {n_params / 1e9:.2f} B params bf16, peak "
        f"{peak / 1e9:.1f} GB allocated, warm pass "
        f"{passes[1]['tok_s']:.1f} tok/s, ttft mean "
        f"{passes[1]['ttft_mean_s'] * 1e3:.0f} ms, every logit finite, zero "
        f"new signatures; per step {per_step} kraken_gemm and, per decode "
        f"step, {attn_calls} paged_decode_attention launches")
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
    res = {}
    for dtype in ("bfloat16", "float32"):
        model = _recurrent(arch, dtype=dtype)
        params = state.get(f"{key}_params") if dtype == "bfloat16" else None
        if params is None:
            params = model.init(torch.Generator(device="cuda").manual_seed(0))
        got = two_steps(model, params)
        want = two_steps(_recurrent(arch, _plain_kernels(), dtype), params)
        for i, name in enumerate(("mixed step", "decode step")):
            res[f"{dtype} {name}"] = compare_logits(
                f"{arch} {dtype} {name}", got[i], want[i],
                model.cfg.vocab_size)
        del params, got, want
        _release(state, f"{key}_engine", f"{key}_params")
    bad = {k: v for k, v in res.items()
           if k.startswith("float32") and not v["ok"]}
    if bad:
        raise AssertionError(f"{key}_e2e: float32 kernels against plain "
                             f"beyond {E2E_TOL} of the largest logit: {bad}")
    layers = RECUR_E2E_LAYERS[key]
    m32 = _recurrent(arch, dtype="float32", layers=layers)
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
    res[f"float32_{layers}_layers"] = {
        "requests": len(prompts), "tokens": sum(len(o) for o in seq),
        "token_identical": True}
    rec[f"{key}_e2e"] = res
    log(f"  {key}_e2e: float32 {layers} layers: the engine (chunk {CHUNK}) "
        f"is token-identical to the sequential path on all {len(prompts)} "
        "requests")
    log(f"{key}_e2e: float32 kernels agree with the plain versions within "
        f"{E2E_TOL} of the largest logit (full {arch}); bf16 (reported) "
        f"{max(v['rel'] for k, v in res.items() if k.startswith('bfloat16')):.4f}")


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
        cfg = _recurrent(RECURRENT[key][0], dtype="float32").cfg
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
    busy share is read from a whole trace."""
    from torch.profiler import ProfilerActivity, profile
    frames = 20 if batch == 1 else 4

    def run():
        for _ in range(frames):
            run_frame(layers, direct)

    with profile(activities=[ProfilerActivity.CUDA]):
        run_frame(layers, direct)
        torch.cuda.synchronize()
    out = device_trace(run, f"vgg16 b{batch}, {frames} frames, direct")
    out["frames"] = frames
    def traced(kernel):
        return sum(t["count"] for t in out["top"] if kernel in t["name"])

    out["traced_launches"] = traced("kraken_conv_kernel")
    out["traced_weight_copies"] = traced("kraken_conv_weights")
    out["traced_split_sums"] = traced("kraken_conv_reduce")
    out["expected_launches"] = frames * CONV_FRAME_LAUNCHES["vgg16"]
    log(f"    traced {out['traced_launches']} of "
        f"{out['expected_launches']} kraken_conv2d_direct launches "
        f"(kraken_conv_kernel), {out['traced_weight_copies']} "
        f"kraken_conv_weights, {out['traced_split_sums']} "
        f"kraken_conv_reduce; per frame: wall "
        f"{out['wall_s'] / frames * 1e3:.4f} ms, device "
        f"{out['device_s'] / frames * 1e3:.4f} ms")
    if out["traced_launches"] != out["expected_launches"]:
        raise AssertionError(
            f"vgg16 b{batch} trace: {out['traced_launches']} "
            f"kraken_conv2d_direct launches traced, "
            f"{out['expected_launches']} made")
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
         "recurrent_decode_steps": {
             k: v for k, v in rec.get("gemm_steps", {}).items()
             if k.endswith("decode")},
         "shape": "one yi-6b decode step, bf16, M=4: 32 x (q,k,v,o,gate,up,"
                  "down) + unembed; recurrent_decode_steps: rwkv6-3b's 289 "
                  "and zamba2-1.2b's 119 GEMMs of one decode step"},
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
         "zamba2_decode_step": {
             key: z[key] * RECURRENT["zamba"][2] for key in (
                 "ms", "device_ms", "plain_ms", "bound_ms")},
         "shape": "one yi-6b decode step, bf16: 32 layers x (4 slots, "
                  "32/4 heads, D 128, page 16, q_pos 300/700/dead/17); no "
                  "single PyTorch call walks a page table; zamba2_decode_step: "
                  "6 calls at 32/32 heads of 64, same slots"},
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

    def by_path(name):
        return {"yi-6b": launches.get(name),
                "mixtral-8x22b": moe_launches.get(name),
                **{RECURRENT[k][0]: rec.get(f"{k}_serve", {}).get(
                    "launches", {}).get(name) for k in RECURRENT},
                "yi-6b int8 dense": dense.get("launches", {}).get(name),
                "yi-6b int8 engine": dense.get("engine_launches",
                                               {}).get(name),
                "gemma3-12b forward": swa_fwd.get("launches", {}).get(name),
                **{f"{key} conv direct": r["launches"].get(name)
                   for key, r in rec.get("conv_nets", {}).items()},
                **{f"{key} conv im2col": r["im2col_launches"].get(name)
                   for key, r in rec.get("conv_nets", {}).items()}}

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
    if "conv_kernels" in rec:
        entries.append(conv_entry(rec, by_path))
    return {"kernels": entries}


PHASES = {"build": phase_build, "kernels": phase_kernels,
          "moe_kernels": phase_moe_kernels,
          "dense_kernels": phase_dense_kernels,
          "swa_kernels": phase_swa_kernels,
          "conv_kernels": phase_conv_kernels,
          "recurrence": phase_recurrence, "serve": phase_serve,
          "e2e": phase_e2e, "profile": phase_profile,
          "dense_serve": phase_dense_serve, "dense_e2e": phase_dense_e2e,
          "moe_serve": phase_moe_serve, "moe_e2e": phase_moe_e2e,
          "swa_forward": phase_swa_forward, "conv_nets": phase_conv_nets,
          # last: their traces record host activity too (device_trace's
          # ranges), and no earlier phase's trace then follows one
          **{f"{key}_{what}": functools.partial(fn, key=key)
             for key in RECURRENT
             for what, fn in (("serve", recurrent_serve),
                              ("e2e", recurrent_e2e))}}


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
