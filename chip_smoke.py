#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,kernels --out DIR

Phases, one report line each (details go to ``<out>/chip_smoke.json``,
default ``build/chip_smoke/``):

1. ``build``    -- compile every CUDA kernel of the main path from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once) and print
   the card's name and power limit.
2. ``kernels``  -- hold each kernel against its plain PyTorch version on the
   card at the yi-6b main-path shapes, in bfloat16 and float32, and time it
   (CUDA events) beside the plain version, one library call and its bound.
3. ``serve``    -- serve full-width, full-depth yi-6b (bf16, seeded random
   weights) through ``repro_torch``'s PagedEngine: 4 slots, page 16,
   max_len 512, chunk 64, 8 requests of 17-300 prompt tokens, 16 new tokens,
   twice through one engine; every kernel of the path must have launched.
4. ``e2e``      -- one mixed step's and one decode step's logits through the
   kernels and again through the plain versions, on the card.
5. ``profile``  -- ``torch.profiler`` over one more pass of the serve
   phase's warm engine: device time by kernel and the device's busy share.

The line before the last is the kernels' JSON record; the last line is the
device record.  Any failure raises and the exit code is not 0; without a
CUDA device the script exits 2 before printing any result.
"""

from __future__ import annotations

import argparse
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
PEAK_BYTES = 3.35e12

# yi-6b main-path widths: d_model 4096, 32 heads / 4 KV heads of 128,
# d_ff 11008, vocab 64000; serving at 4 slots x chunk 64
HEADS, KV_HEADS, HEAD_DIM, LAYERS = 32, 4, 128, 32
SLOTS, CHUNK, PAGE, MAX_LEN = 4, 64, 16, 512
# the serve workload: 8 prompts of 17..300 tokens, 16 new tokens each
SERVE_LENS = [round(17 + i * (300 - 17) / 7) for i in range(8)]
SERVE_NEW = 16
# (name, K, N, activation, calls per decode step)
GEMMS = [("wq|wo", 4096, 4096, None, 2 * LAYERS),
         ("wk|wv", 4096, 512, None, 2 * LAYERS),
         ("gate", 4096, 11008, "silu", LAYERS),
         ("up", 4096, 11008, None, LAYERS),
         ("down", 11008, 4096, None, LAYERS),
         ("unembed", 4096, 64000, None, 1)]
GEMM_TOL = {"bfloat16": (3e-2, 2e-2), "float32": (1e-4, 1e-4)}   # atol, rtol
ATTN_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}  # by q dtype
E2E_TOL = 0.05   # max |kernel - plain| <= E2E_TOL * max |plain| on bf16 logits


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


def rotating(make, nbytes: int, budget: int = 160 << 20):
    """Enough copies of an operand that cycling through them exceeds the
    50 MB L2, as a decode step's distinct layer weights do."""
    n = max(1, min(32, -(-budget // max(1, nbytes))))
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

def phase_build(rec: dict, state: dict) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build(["kraken_gemm", "paged_attention"], force=True)
    secs = time.perf_counter() - t0
    for name, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        rec.setdefault("build", {})[name] = {"seconds": r["seconds"],
                                             "ptxas": regs}
        for ln in regs:
            log(f"  ptxas {name}: {ln}")
    log(f"build: {len(report)} kernels in {secs:.1f} s (parallel nvcc)")
    rec["card"] = card_line()
    log(f"card: {rec['card']}")


# ---------------------------------------------------------------------------
# phase 2: kernel parity + timing
# ---------------------------------------------------------------------------

def gemm_case(torch, kg, ref, m, k, n, act, dtype, *, bias=False,
              timed=True, seed=0):
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
    want = ref.matmul(a, bs[0], bias=bv, activation=act)
    torch.cuda.synchronize()
    atol, rtol = GEMM_TOL[str(dtype).split(".")[-1]]
    err = assert_close(f"gemm {m}x{k}x{n} {act} {dtype}", got, want,
                       atol, rtol)
    row = {"m": m, "k": k, "n": n, "act": act, "bias": bias,
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err}
    if timed:
        it = [0]

        def cycle(fn):
            def run():
                it[0] = (it[0] + 1) % len(bs)
                return fn(bs[it[0]])
            return run
        row["ms"] = time_ms(cycle(lambda b: kg.kraken_gemm(
            a, b, bias=bv, activation=act)), 20)
        row["plain_ms"] = time_ms(cycle(lambda b: ref.matmul(
            a, b, bias=bv, activation=act)), 5)
        row["library_ms"] = time_ms(cycle(lambda b: torch.matmul(a, b)), 20)
        nbytes = (m * k + k * n + m * n) * isz + (n * isz if bias else 0)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * m * n * k,
                                                    peak)
    return row


def build_pool(torch, *, b, kvh, d, ps, mp, q_pos, dead, dtype, seed):
    """A page pool as token-by-token serving leaves it: shuffled physical
    pages, ring-written positions 0..q_pos[i] per slot, sentinel rows for
    slots in ``dead`` (and one sentinel entry in slot 3's row)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_pages = b * mp + 4
    logical = mp * ps
    table = np.full((b, mp), n_pages, np.int32)
    perm = rng.permutation(n_pages)
    for i in range(b):
        if i not in dead:
            table[i] = perm[i * mp:(i + 1) * mp]
    if b > 3 and 3 not in dead:
        table[3, 0] = n_pages
    pos = np.full((n_pages, ps), -(2 ** 30), np.int32)
    for i in range(b):
        if i in dead:
            continue
        for p in range(int(q_pos[i]) + 1):
            li = p % logical
            page = table[i, li // ps]
            if page < n_pages:
                pos[page, li % ps] = p
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n_pages, kvh, ps, d)
    scales = None
    if dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        scales = [torch.rand(shape[:3], generator=gen, device="cuda") / 127
                  for _ in range(2)]
    else:
        k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (k, v, torch.as_tensor(pos, device="cuda"),
            torch.as_tensor(table, device="cuda"), scales, pos, table)


def attn_case(torch, pa, ref, *, dtype, window, seed=0):
    b, h, kvh, d, ps, mp = SLOTS, HEADS, KV_HEADS, HEAD_DIM, PAGE, \
        MAX_LEN // PAGE
    q_pos = [300, 700, 40, 17]     # slot 1 wraps the 512-token ring
    dead = {2}                     # an all-dead (sentinel) slot
    qdt = torch.bfloat16 if dtype == torch.int8 else dtype
    k, v, pos, table, scales, pos_np, table_np = build_pool(
        torch, b=b, kvh=kvh, d=d, ps=ps, mp=mp, q_pos=q_pos, dead=dead,
        dtype=dtype, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(qdt)
    qp = torch.tensor(q_pos, dtype=torch.int32, device="cuda")
    ks, vs = scales if scales else (None, None)
    kw = dict(pos_pages=pos, page_table=table, q_pos=qp, k_scale=ks,
              v_scale=vs, window=window)
    got = pa.paged_decode_attention(q, k, v, **kw)
    want = ref.paged_decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    atol, rtol = ATTN_TOL[str(qdt).split(".")[-1]]
    err = assert_close(f"paged attention {name} window={window}", got, want,
                       atol, rtol)
    if got[2].abs().max().item() != 0.0:
        raise AssertionError("paged attention: all-dead slot is not zero")
    row = {"dtype": name, "window": window, "max_abs_err": err,
           "ms": time_ms(lambda: pa.paged_decode_attention(q, k, v, **kw), 50),
           "plain_ms": time_ms(lambda: ref.paged_decode_attention(
               q, k, v, **kw), 10),
           "library_ms": None}
    # the bound counts what these inputs need: q and out, the table, the
    # position rows of allocated pages, and K/V (+ scales) only of pages
    # with an entry that survives the mask
    isz_q = q.element_size()
    isz_kv = k.element_size()
    nbytes = 2 * b * h * d * isz_q + table.numel() * 4 + b * 4
    flops = 0.0
    n_pages = k.shape[0]
    for i in range(b):
        for j in range(mp):
            page = int(table_np[i, j])
            if page >= n_pages or j * ps > q_pos[i]:
                continue
            nbytes += ps * 4
            kp = pos_np[page]
            ok = (kp >= 0) & (kp <= q_pos[i])
            if window:
                ok &= kp > q_pos[i] - window
            if ok.any():
                nbytes += 2 * kvh * ps * d * isz_kv \
                    + (2 * kvh * ps * 4 if ks is not None else 0)
                flops += 4.0 * h * d * int(ok.sum())
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, peak)
    return row


def phase_kernels(rec: dict, state: dict) -> None:
    import torch
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
                log(f"  gemm {name:8s} M={m:<4d} K={k:<5d} N={n:<5d} "
                    f"{r['dtype']:8s} err={r['max_abs_err']:.2e} "
                    f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
                    f"lib={r['library_ms']:.4f} bound={r['bound_ms']:.4f}")
    # every epilogue, with and without bias, at ragged shapes: one that
    # takes the scalar (masked) loads and one that takes the 16-byte loads
    for (m, k, n) in ((37, 200, 123), (5, 136, 72)):
        for act in (None, "relu", "silu", "gelu"):
            for bias in (False, True):
                for dtype in (torch.bfloat16, torch.float32):
                    r = gemm_case(torch, kg, ref, m, k, n, act, dtype,
                                  bias=bias, timed=False, seed=3)
                    r["name"] = "ragged"
                    rows.append(r)
    log(f"kernels: kraken_gemm matches plain in {len(rows)} cases, max err "
        f"bf16 {max(r['max_abs_err'] for r in rows if r['dtype'] == 'bfloat16'):.2e} "
        f"f32 {max(r['max_abs_err'] for r in rows if r['dtype'] == 'float32'):.2e}")
    arows = []
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        for window in (0, 64):
            r = attn_case(torch, pa, ref, dtype=dtype, window=window)
            arows.append(r)
            log(f"  paged_attention {r['dtype']:8s} window={window:<3d} "
                f"err={r['max_abs_err']:.2e} ms={r['ms']:.4f} "
                f"plain={r['plain_ms']:.4f} bound={r['bound_ms']:.5f}")
    log(f"kernels: paged_decode_attention matches plain in {len(arows)} "
        "cases (live, dead, sentinel, ring-wrap, window, all-dead slot)")
    rec["gemm"] = rows
    rec["attention"] = arows


def _yi6b(kernels=None):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    return Model(get_arch("yi-6b"), kernels=kernels)   # bf16, full width


def phase_serve(rec: dict, state: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving import CacheConfig, EngineConfig, PagedEngine
    model = _yi6b()
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    state["params"] = params
    eng = PagedEngine(model, params, config=EngineConfig(
        slots=SLOTS, chunk=CHUNK,
        cache=CacheConfig(page_size=PAGE, max_len=MAX_LEN)))
    rng = np.random.default_rng(0)
    lens, max_new = SERVE_LENS, SERVE_NEW
    passes = []
    kg.launches = 0
    pa.launches = 0
    for rep in range(2):
        before = (eng._prefill.retraces, eng._decode.retraces,
                  eng._reset.retraces)
        reqs = [eng.submit(rng.integers(0, cfg.vocab_size, (n,)), max_new)
                for n in lens]
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
               if r.state != "done" or len(r.out) != max_new
               or not all(0 <= t < cfg.vocab_size for t in r.out)]
        if bad:
            raise AssertionError(f"serve pass {rep + 1}: requests {bad} not "
                                 "served in full")
        passes.append({
            "wall_s": wall, "tokens": toks, "tok_s": toks / wall,
            "prefill_tokens": int(sum(lens)),
            "mixed_steps": eng._prefill.calls - calls0[0],
            "decode_steps": eng._decode.calls - calls0[1],
            "new_signatures": new_sigs})
        log(f"  serve pass {rep + 1}: {len(reqs)} requests, {toks} tokens "
            f"in {wall:.2f} s = {toks / wall:.1f} tok/s "
            f"({passes[-1]['mixed_steps']} mixed + "
            f"{passes[-1]['decode_steps']} decode steps, "
            f"{new_sigs} new signatures)")
    launches = {"kraken_gemm": kg.launches,
                "paged_decode_attention": pa.launches}
    if passes[1]["new_signatures"]:
        raise AssertionError("the warm pass added program signatures")
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
    for alloc in eng.allocators.values():
        alloc.check()
        if alloc.free_pages != alloc.n_pages:
            raise AssertionError("pages leaked")
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
        f"{2 * len(lens)} requests served, warm pass "
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


def phase_e2e(rec: dict, state: dict) -> None:
    """One mixed step's and one decode step's logits through the kernels
    and through the plain versions (passed in as the model's kernels)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models.layers import Kernels
    from repro_torch.serving.state import build_state_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_model = _yi6b()
    plain_model = _yi6b(Kernels(ref.matmul, ref.paged_decode_attention))
    params = state.get("params")
    if params is None:
        params = kernel_model.init(
            torch.Generator(device="cuda").manual_seed(0))
    cfg = kernel_model.cfg
    pools = []
    for model in (kernel_model, plain_model):
        tree = build_state_tree(model, slots=SLOTS, page_size=PAGE,
                                max_len=MAX_LEN, device="cuda")
        for s in (0, 1, 2):             # slot 3 stays unallocated
            tree.admit(s)
        pools.append(tree.push_tables(tree.init_device()))
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SLOTS, CHUNK)),
                             device="cuda")
    lengths = np.asarray([CHUNK, 40, 1, 0], np.int32)
    positions = torch.arange(CHUNK, dtype=torch.int32,
                             device="cuda").repeat(SLOTS, 1)
    lens_t = torch.as_tensor(lengths, device="cuda")
    out = []
    for model, pl in zip((kernel_model, plain_model), pools):
        last, _, pl = model.chunk_step(params, pl, tokens, positions, lens_t,
                                       return_greedy=True)
        out.append(last)
    live = lengths > 0
    res = {}

    def compare(name, got, want, rows):
        got, want = got[rows].float(), want[rows].float()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"e2e {name}: non-finite logits")
        if got.shape != (int(rows.sum()), cfg.vocab_size):
            raise AssertionError(f"e2e {name}: logits shape {got.shape}")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        res[name] = {"max_abs_err": err, "max_abs_plain": scale,
                     "rel": err / scale, "argmax_agree": agree}
        log(f"  e2e {name}: max |kernel - plain| {err:.4f} of max |plain| "
            f"{scale:.2f} ({err / scale:.4f}), argmax agree {agree:.2f}")
        if err > E2E_TOL * scale:
            raise AssertionError(f"e2e {name}: {err} > {E2E_TOL} * {scale}")

    rows = torch.as_tensor(live, device="cuda")
    compare("mixed step", out[0], out[1], rows)
    dec_tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SLOTS, 1)),
                              device="cuda")
    pos = torch.as_tensor(lengths, device="cuda")
    out = []
    for model, pl in zip((kernel_model, plain_model), pools):
        logits, pl = model.decode_step(params, pl, dec_tok, pos,
                                       lengths=rows.to(torch.int32))
        out.append(logits)
    compare("decode step", out[0], out[1], rows)
    rec["e2e"] = res
    log(f"e2e: kernels agree with the plain versions within {E2E_TOL} of "
        "the largest logit (bf16, full yi-6b)")


def phase_profile(rec: dict, state: dict) -> None:
    """Where a warm serving pass spends its time: ``torch.profiler`` over
    one more pass of the serve phase's workload through its warm engine,
    device time by kernel and the device's busy share of the wall time.
    Runs after the launch counts are read, so it adds none to them."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if "engine" not in state:
        raise RuntimeError("the profile phase needs the serve phase")
    eng = state["engine"]
    rng = np.random.default_rng(2)
    calls0 = (eng._prefill.calls, eng._decode.calls)
    # device activity only: host-op rows would count their kernels twice
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for n in SERVE_LENS:
            eng.submit(rng.integers(0, eng.model.cfg.vocab_size, (n,)),
                       SERVE_NEW)
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = (eng._prefill.calls - calls0[0], eng._decode.calls - calls0[1])

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    rows = []
    for evt in prof.key_averages():
        us = dev_us(evt)
        if us > 0 and str(getattr(evt, "device_type", "CUDA")).endswith("CUDA"):
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)

    def group(key):
        if "gemm_kernel" in key:
            return "kraken_gemm"
        if "paged_decode_kernel" in key:
            return "paged_decode_attention"
        low = key.lower()
        if "gemm" in low or "cutlass" in low or "sm90" in low:
            return "library GEMM (chunk attention einsums)"
        if "index" in low or "gather" in low or "scatter" in low:
            return "indexing (pool gather/scatter, embed)"
        if "copy" in low:
            return "copies and dtype casts"
        if "reduce" in low or "softmax" in low:
            return "reductions (norms, softmax, argmax)"
        return "other elementwise (rope, residual, silu*up, masks)"

    groups: dict = {}
    for us, _, key in rows:
        groups[group(key)] = groups.get(group(key), 0.0) + us
    rec["profile"] = {
        "wall_s": wall, "device_s": total_us / 1e6,
        "device_busy": total_us / 1e6 / wall,
        "mixed_steps": steps[0], "decode_steps": steps[1],
        "groups_ms": {k: v / 1e3 for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])},
        "top": [{"us": us, "count": c, "name": key[:120]}
                for us, c, key in rows[:15]]}
    log(f"  profile: wall {wall:.2f} s, device busy {total_us / 1e6:.2f} s "
        f"({100 * total_us / 1e6 / wall:.1f}%), {steps[0]} mixed + "
        f"{steps[1]} decode steps")
    for k, v in rec["profile"]["groups_ms"].items():
        log(f"    {k:42s} {v:9.1f} ms")
    for r in rec["profile"]["top"][:8]:
        log(f"    {r['us'] / 1e3:8.1f} ms x{r['count']:<6d} {r['name'][:70]}")
    if total_us <= 0:
        # the profiler could not trace the card here: say so, measure nothing
        rec["profile"]["device_busy"] = None
        log("  profile: the profiler recorded no device time (not measured)")


def kernels_line(rec: dict) -> dict:
    """One entry per kernel; times are one decode step's worth at yi-6b
    (bf16, M = 4 slots): the GEMM row sums every decode-step GEMM (32
    layers x q,k,v,o,gate,up,down + unembed), the attention row 32 calls."""
    dec = {r["name"]: r for r in rec["gemm"]
           if r.get("ms") is not None and r["m"] == SLOTS
           and r["dtype"] == "bfloat16"}
    counts = {name: c for name, _, _, _, c in GEMMS}

    def step(key):
        return sum(dec[nm][key] * counts[nm] for nm in counts)

    att = next(r for r in rec["attention"]
               if r["dtype"] == "bfloat16" and r["window"] == 0)
    # launches are counted only by the serve phase: null when it did not run
    launches = rec.get("launches", {})
    return {"kernels": [
        {"name": "kraken_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/kraken_gemm.cu",
         "replaces": "src/repro/kernels/kraken_gemm.py:74",
         "launches": launches.get("kraken_gemm"),
         "max_abs_err": max(r["max_abs_err"] for r in rec["gemm"]),
         "ms": step("ms"), "plain_ms": step("plain_ms"),
         "bound_ms": step("bound_ms"), "bound_by": "bytes",
         "library_ms": step("library_ms"),
         "shape": "one yi-6b decode step, bf16, M=4: 32 x (q,k,v,o,gate,up,"
                  "down) + unembed"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:234",
         "launches": launches.get("paged_decode_attention"),
         "max_abs_err": max(r["max_abs_err"] for r in rec["attention"]),
         "ms": att["ms"] * LAYERS, "plain_ms": att["plain_ms"] * LAYERS,
         "bound_ms": att["bound_ms"] * LAYERS, "bound_by": att["bound_by"],
         "library_ms": None,
         "shape": "one yi-6b decode step, bf16: 32 layers x (4 slots, "
                  "32/4 heads, D 128, page 16, q_pos 300/700/dead/17)"},
    ]}


PHASES = {"build": phase_build, "kernels": phase_kernels,
          "serve": phase_serve, "e2e": phase_e2e, "profile": phase_profile}


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
    if "gemm" in rec:
        print(json.dumps(kernels_line(rec)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
