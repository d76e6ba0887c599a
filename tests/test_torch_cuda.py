"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode.  On a machine with one (and ``nvcc``):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
``chip_smoke.py`` makes the same comparisons at the main paths' shapes
(``GEMM_EDGE`` holds llama-3.2-vision-11b's cross K/V projection of 1601
patches and musicgen-large's bias + gelu MLP; ``PAGED_CASES`` the
llama-3.2-vision geometry and, in its zamba2 entries, musicgen's).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import attention_cases as ac  # noqa: E402
from repro_torch.core import conv_cases  # noqa: E402
from repro_torch.core.conv_cases import CONV_NONFINITE  # noqa: E402
from repro_torch.core.gemm_cases import GEMM_EDGE, GEMM_TOL  # noqa: E402
from repro_torch.core.moe_cases import (MOE_CASES, MOE_EDGE,  # noqa: E402
                                        moe_sizes)

POS_EMPTY = -(2 ** 30)


def ring_pool(rng, *, b, kvh, d, ps, mp, q_pos, dead, sentinel_entry, quant):
    """Numpy page pools as token-by-token serving leaves them: shuffled
    pages, ring positions 0..q_pos[i] written per slot (a slot whose q_pos
    passes mp * ps wraps), sentinel rows for ``dead`` slots, one sentinel
    entry ``(slot, logical page)`` inside a live row, POS_EMPTY everywhere
    unwritten.  Returns (k, v, pos, table, k_scale, v_scale)."""
    n_pages = b * mp + 3
    logical = mp * ps
    table = np.full((b, mp), n_pages, np.int32)
    perm = rng.permutation(n_pages)
    for i in range(b):
        if i not in dead:
            table[i] = perm[i * mp:(i + 1) * mp]
    i, j = sentinel_entry
    table[i, j] = n_pages
    pos = np.full((n_pages, ps), POS_EMPTY, np.int32)
    for i in range(b):
        if i in dead:
            continue
        for p in range(q_pos[i] + 1):
            li = p % logical
            page = table[i, li // ps]
            if page < n_pages:
                pos[page, li % ps] = p
    shape = (n_pages, kvh, ps, d)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) / 127).astype(np.float32)
        vs = (rng.random(shape[:3]) / 127).astype(np.float32)
        return k, v, pos, table, ks, vs
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return k, v, pos, table, None, None


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16: both round one fp32 sum to bf16, summed in another order (1 ulp);
# fp32: sums of <= 200 products in another order
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# decode_attention's and swa_attention's tolerances (atol, rtol), DECODE_TOL
# by q dtype and SWA_TOL by dtype (the bf16 atol of a row scaled by
# sqrt(SWA_ROW_KEYS / n) past n = SWA_ROW_KEYS keys), are chip_smoke.py's:
# repro_torch.core.attention_cases, with the reason for each
DECODE_TOL = {torch.float32: ac.DECODE_TOL["float32"],
              torch.bfloat16: ac.DECODE_TOL["bfloat16"]}
# swa_attention: chip_smoke.py's SWA_CASES, (name, B, H, KV, S, D, window),
# and the bf16 kernel's head-dim and window classes (SWA_EDGE)
SWA_CASES = [c[:7] for c in ac.SWA_CASES]
SWA_TOL = {torch.float32: ac.SWA_TOL["float32"],
           torch.bfloat16: ac.SWA_TOL["bfloat16"]}
SWA_ROW_KEYS = ac.SWA_ROW_KEYS
# kraken_conv2d_direct: repro_torch.core.conv_cases's CONV_TOL, (atol,
# rtol) by output dtype: both sides sum fp32 products and round once, so
# they differ by the summation order and one output ulp (2 bf16 ulps of
# rtol cover it)
CONV_TOL = {torch.float32: conv_cases.CONV_TOL["float32"],
            torch.bfloat16: conv_cases.CONV_TOL["bfloat16"]}
# (name, N, H, W, C_i, K, S, padding, C_o, R): the paper geometries of
# tests/test_kraken_conv.py at their (K, S) classes and chip_smoke.py's edge
# cases
CONV_CASES = [
    ("alexnet conv1 K11 S4", 1, 35, 35, 3, 11, 4, ((0, 0), (0, 0)), 8, 7),
    ("alexnet conv2 K5", 1, 27, 27, 8, 5, 1, ((2, 2), (2, 2)), 12, 2),
    ("3x3 N 2", 2, 14, 14, 8, 3, 1, ((1, 1), (1, 1)), 16, 7),
    ("resnet conv1 K7 S2", 1, 28, 28, 4, 7, 2, ((3, 3), (3, 3)), 8, 7),
    ("1x1", 1, 14, 14, 8, 1, 1, ((0, 0), (0, 0)), 12, 7),
    ("strided 3x3", 1, 16, 16, 8, 3, 2, ((1, 1), (1, 1)), 8, 7),
    ("R 1", 1, 28, 28, 64, 3, 1, ((1, 1), (1, 1)), 64, 1),
    ("R 3, ragged C_o 96", 2, 28, 28, 64, 3, 1, ((1, 1), (1, 1)), 96, 3),
    ("alexnet conv1 full, R 1", 1, 227, 227, 3, 11, 4, ((0, 0), (0, 0)), 96,
     1),
    ("(H + pads - K) % S != 0", 2, 30, 28, 16, 3, 2, ((1, 1), (1, 1)), 40, 7),
    ("N 3, odd OH", 3, 13, 13, 32, 3, 1, ((1, 1), (1, 1)), 64, 7),
    ("C_i 100 ragged chunk", 1, 14, 14, 100, 3, 1, ((1, 1), (1, 1)), 72, 7),
    ("C_i 35 odd, 2-byte band fill", 2, 12, 12, 35, 3, 1, ((1, 1), (1, 1)),
     40, 7),
    ("asymmetric padding K5 S3", 2, 20, 17, 24, 5, 3, ((1, 2), (0, 1)), 48,
     3),
    ("R 16", 1, 64, 64, 3, 7, 2, ((3, 3), (3, 3)), 64, 16),
    ("split over C_i at b1, VGG-16 conv5_1", 1, 14, 14, 512, 3, 1,
     ((1, 1), (1, 1)), 512, 7),
    ("7x7 maps, N 3", 3, 7, 7, 512, 3, 1, ((1, 1), (1, 1)), 512, 7),
    ("C_i 3 packed, K 11 S 4, padded", 1, 99, 99, 3, 11, 4, ((2, 2), (2, 2)),
     72, 7),
    ("C_i 3 packed, K 3 S 1", 2, 30, 30, 3, 3, 1, ((1, 1), (1, 1)), 64, 7),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernel_matches_plain(dtype):
    from repro_torch.kernels import kraken_gemm as tkg
    from repro_torch.kernels import ref
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    before = tkg.launches
    for (m, k, n) in ((4, 256, 512), (37, 200, 123), (64, 136, 72)):
        a = torch.randn((m, k), generator=g, device=dev).to(dtype)
        b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
        bias = torch.randn((n,), generator=g, device=dev).to(dtype)
        for act in (None, "relu", "silu", "gelu"):
            for bv in (None, bias):
                got = tkg.kraken_gemm(a, b, bias=bv, activation=act)
                want = ref.matmul(a, b, bias=bv, activation=act)
                torch.testing.assert_close(got, want, rtol=TOL[dtype],
                                           atol=TOL[dtype])
    assert tkg.launches == before + 3 * 4 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GEMM_EDGE, ids=[c[0] for c in GEMM_EDGE])
def test_gemm_kernel_edge_cases(case, dtype):
    """``kernels``' edge cases: one row, splits over K at decode, a second
    row tile, A (K 27, 363) and B (N 123) that TMA refuses, a ragged K;
    within the tolerance of the plain version, and the same bits twice."""
    from repro_torch.kernels import kraken_gemm as tkg
    from repro_torch.kernels import ref
    _, m, k, n, act, bias = case
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    bv = torch.randn((n,), generator=g, device=dev) if bias else None
    before = tkg.launches
    got = tkg.kraken_gemm(a, b, bias=bv, activation=act)
    again = tkg.kraken_gemm(a, b, bias=bv, activation=act)
    want = ref.matmul(a, b, bias=bv, activation=act)
    torch.cuda.synchronize()
    assert tkg.launches == before + 2
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(got.float(), again.float())


# float32 shapes of the FMA kernel: ragged M, N and K (A, transposed by
# 4-byte copies, at K 27; B by 4-byte copies at N 123), a split over K,
# several row and column tiles, train_lm's wk|wv dB (split)
F32_GEMM_CASES = [("ragged, B by 4-byte copies", 37, 200, 123, "silu", True),
                  ("K 27, A by 4-byte copies", 150, 27, 72, "relu", True),
                  ("split over K, one tile", 20, 4800, 64, "gelu", True),
                  ("ragged tiles, no split", 300, 1000, 260, None, False),
                  ("train_lm wk|wv dB", 768, 2048, 256, None, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_GEMM_CASES,
                         ids=[c[0] for c in F32_GEMM_CASES])
def test_gemm_float32_kernel_ragged_and_split(case):
    """The float32 FMA kernel at ragged and split shapes: within 1e-4 of
    the plain version, the same bits on a second call, and the plan's
    split and B's 4-byte copies as the planner says."""
    from repro_torch.kernels import kraken_gemm as tkg
    from repro_torch.kernels import ref
    _, m, k, n, act, bias = case
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=g, device=dev)
    b = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    bv = torch.randn((n,), generator=g, device=dev) if bias else None
    q = tkg.plan(m, k, n, dtype=torch.float32)
    assert q["path"] == tkg.PATH_FMA
    assert (q["fill_a"], q["fill_b"]) == (1, int(n % 4 != 0))
    before = tkg.launches
    got = tkg.kraken_gemm(a, b, bias=bv, activation=act)
    again = tkg.kraken_gemm(a, b, bias=bv, activation=act)
    want = ref.matmul(a, b, bias=bv, activation=act)
    torch.cuda.synchronize()
    assert tkg.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)
    if case[0].startswith("split") or "dB" in case[0]:
        assert q["split"] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 240])
def test_swa_attention_bwd_wgmma_each_width(d):
    """The bf16 backward at each padded width DP (64, 128, 256), a window
    across q tiles and a ragged S: within ``SWA_BWD_TOL`` of the plain
    backward at unit scale, the same bits on a second call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as tsw
    dev = _cuda()
    b, h, kvh, s, window = 1, 4, 2, 700, 150
    q_plan = tsw.plan_bwd(b, h, kvh, s, d, window)
    assert q_plan["DP"] == {64: 64, 128: 128, 240: 256}[d]
    assert q_plan["ops"] == 14
    atol, rtol = ac.SWA_BWD_TOL["bfloat16"]
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(
        torch.bfloat16) for shape in ((b, h, s, d), (b, kvh, s, d),
                                      (b, kvh, s, d), (b, h, s, d)))
    out, lse = tsw.swa_attention(q, k, v, window=window, return_lse=True)
    got = tsw.swa_attention_bwd(q, k, v, out, dout, lse, window=window)
    again = tsw.swa_attention_bwd(q, k, v, out, dout, lse, window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = ref.sliding_window_attention_bwd(q, k, v, out, dout, lse,
                                            window=window)
    floor = 0.01 * max(float(y.float().abs().max()) for y in want)
    for x, y in zip(got, want):
        scale = max(float(y.float().abs().max()), floor)
        err = (x.float() - y.float()).abs() / scale
        assert (err <= atol + rtol * y.float().abs() / scale).all(), \
            float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_paged_attention_kernel_matches_plain(kv):
    from repro_torch.kernels import paged_attention as tpa
    from repro_torch.kernels import ref
    dev = _cuda()
    rng = np.random.default_rng(0)
    quant = kv == "int8"
    qdt = torch.float32 if kv == "float32" else torch.bfloat16
    k, v, pos, table, ks, vs = ring_pool(
        rng, b=4, kvh=2, d=16, ps=4, mp=4, q_pos=[9, 21, 6, 3], dead={2},
        sentinel_entry=(3, 0), quant=quant)

    def put(a, dt=None):
        t = torch.from_numpy(a).to(dev)
        return t.to(dt) if dt is not None else t

    kt = put(k) if quant else put(k, qdt)
    vt = put(v) if quant else put(v, qdt)
    q = put(rng.normal(size=(4, 4, 16)).astype(np.float32), qdt)
    kw = dict(pos_pages=put(pos), page_table=put(table),
              q_pos=torch.tensor([9, 21, 6, 3], dtype=torch.int32,
                                 device=dev),
              k_scale=put(ks) if quant else None,
              v_scale=put(vs) if quant else None)
    for window in (0, 5):
        got = tpa.paged_decode_attention(q, kt, vt, window=window, **kw)
        want = ref.paged_decode_attention(q, kt, vt, window=window, **kw)
        torch.testing.assert_close(got, want, rtol=TOL[qdt], atol=TOL[qdt])
        assert not got[2].any()          # the all-dead slot is exact zero


# paged_decode_attention: chip_smoke.py's PAGED_CASES, each in its pool
# dtypes, under ATTN_TOL (atol, rtol) by q dtype
PAGED_TOL = {torch.float32: ac.ATTN_TOL["float32"],
             torch.bfloat16: ac.ATTN_TOL["bfloat16"]}
PAGED_RUNS = [(c, dt) for c in ac.PAGED_CASES for dt in c[7]]


def _paged_on(x, dtype, window, dev):
    """``paged_pool``'s numpy inputs on the card: q, the first n_pages
    pages of K and V (the trash page stays past them), and the keywords."""
    quant = dtype == "int8"
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    kvdt = torch.int8 if quant else qdt
    n = x["n_pages"]
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    kw = dict(pos_pages=put(x["pos"])[:n], page_table=put(x["table"]),
              q_pos=put(x["q_pos"]), window=window,
              k_scale=put(x["k_scale"])[:n] if quant else None,
              v_scale=put(x["v_scale"])[:n] if quant else None)
    return (put(x["q"]).to(qdt), put(x["k"]).to(kvdt)[:n],
            put(x["v"]).to(kvdt)[:n], kw)


def _bits(t):
    return t.view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("case, dtype", PAGED_RUNS,
                         ids=[f"{c[0]} {dt}" for c, dt in PAGED_RUNS])
def test_paged_attention_kernel_plans(case, dtype):
    """Every PAGED_CASES entry: within ATTN_TOL of the plain version, dead
    slots exact zeros, two calls bit-identical, and the same bits with Inf
    in K and NaN in V (int8: in their scales) wherever no slot attends, the
    trash page included."""
    from repro_torch.kernels import paged_attention as tpa
    from repro_torch.kernels import ref
    dev = _cuda()
    window, dead = case[8], case[10]
    q, k, v, kw = _paged_on(ac.paged_pool(case, dtype, 0), dtype, window,
                            dev)
    before = tpa.launches
    got = tpa.paged_decode_attention(q, k, v, **kw)
    again = tpa.paged_decode_attention(q, k, v, **kw)
    want = ref.paged_decode_attention(q, k, v, **kw)
    yq, yk, yv, ykw = _paged_on(ac.paged_pool(case, dtype, 0, nonfinite=True),
                                dtype, window, dev)
    inf = tpa.paged_decode_attention(yq, yk, yv, **ykw)
    torch.cuda.synchronize()
    assert tpa.launches == before + 3
    atol, rtol = PAGED_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    for i in dead:
        assert not got[i].any()
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(_bits(got), _bits(inf))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, h, kvh, d, ps, mp = case[1:7]
    plan = tpa.plan(b, h, kvh, d, ps, mp, k.dtype, sms=sms)
    assert plan["tma"] == (tpa.route(d, ps, k.dtype) == "tma")


@pytest.mark.cuda
def test_paged_attention_replays_from_a_cuda_graph():
    """yi-6b's decode shape captured in one CUDA graph; the replay is right
    after q_pos, the positions and the table change in place (another
    slot dead, another sentinel, other lengths): the same bits as an eager
    call on the new state, within ATTN_TOL of the plain version."""
    from repro_torch.kernels import paged_attention as tpa
    from repro_torch.kernels import ref
    dev = _cuda()
    case = next(c for c in ac.PAGED_CASES if c[0] == "yi-6b 4 slots")
    other = case[:9] + ([301, 12, 511, 160], (), ((0, 5),)) + case[12:]
    q, k, v, kw = _paged_on(ac.paged_pool(case, "bfloat16", 0), "bfloat16",
                            0, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpa.paged_decode_attention(q, k, v, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tpa.paged_decode_attention(q, k, v, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(captured),
                       _bits(tpa.paged_decode_attention(q, k, v, **kw)))
    # the same seed draws the same pools: only positions, table and q_pos
    # differ, and they change in place
    q2, k2, v2, kw2 = _paged_on(ac.paged_pool(other, "bfloat16", 0),
                                "bfloat16", 0, dev)
    assert torch.equal(_bits(k2), _bits(k)) and torch.equal(_bits(q2), _bits(q))
    for key in ("pos_pages", "page_table", "q_pos"):
        kw[key].copy_(kw2[key])
    graph.replay()
    eager = tpa.paged_decode_attention(q, k, v, **kw)
    want = ref.paged_decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(captured), _bits(eager))
    atol, rtol = PAGED_TOL[torch.bfloat16]
    torch.testing.assert_close(captured.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert captured[2].any()           # slot 2 is live now
    del graph


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_decode_attention_kernel_matches_plain(kv):
    """A ragged S (no multiple of the kernel's tile), per-slot and shared
    positions, a wrapped ring, a window, and an all-empty row (exact
    zeros)."""
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import ref
    dev = _cuda()
    rng = np.random.default_rng(0)
    quant = kv == "int8"
    qdt = torch.float32 if kv == "float32" else torch.bfloat16
    b, h, kvh, s, d = 4, 8, 2, 45, 64
    q_pos = [30, 100, 7, 44]             # slot 1 wraps; slot 2 is empty
    pos = np.full((b, s), POS_EMPTY, np.int32)
    for i in (0, 1, 3):
        for p in range(q_pos[i] + 1):
            pos[i, p % s] = p
    shape = (b, kvh, s, d)
    if quant:
        k = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        ks = torch.from_numpy((rng.random(shape[:3]) / 127).astype(np.float32))
        vs = torch.from_numpy((rng.random(shape[:3]) / 127).astype(np.float32))
        ks, vs = ks.to(dev), vs.to(dev)
    else:
        k = torch.from_numpy(rng.normal(size=shape)).to(qdt)
        v = torch.from_numpy(rng.normal(size=shape)).to(qdt)
        ks = vs = None
    k, v = k.to(dev), v.to(dev)
    q = torch.from_numpy(rng.normal(size=(b, h, d))).to(qdt).to(dev)
    before = tdec.launches
    for kv_pos, qp in ((pos, q_pos), (pos[3], [44] * b)):
        kw = dict(kv_pos=torch.from_numpy(kv_pos).to(dev),
                  q_pos=torch.tensor(qp, dtype=torch.int32, device=dev),
                  k_scale=ks, v_scale=vs)
        for window in (0, 9):
            got = tdec.decode_attention(q, k, v, window=window, **kw)
            want = ref.decode_attention(q, k, v, window=window, **kw)
            torch.cuda.synchronize()
            atol, rtol = DECODE_TOL[qdt]
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    empty = tdec.decode_attention(q, k, v, kv_pos=torch.from_numpy(pos).to(
        dev), q_pos=torch.tensor(q_pos, dtype=torch.int32, device=dev),
        k_scale=ks, v_scale=vs)
    assert not empty[2].any()            # the all-empty row is exact zero
    assert tdec.launches == before + 5


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ac.DECODE_SPLIT_CASES,
                         ids=[c[0] for c in ac.DECODE_SPLIT_CASES])
def test_decode_attention_kernel_splits(case, kv):
    """The split plan's corners (no split once B * KV fills the card, one
    tile a split, several tiles a split over a ragged S, GQA 6): a wrapped
    ring, an all-empty row, then positions live only in the first 40 slots
    (every later chunk dead); the same bits on a second run."""
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import ref
    dev = _cuda()
    _, b, h, kvh, s, d = case
    rng = np.random.default_rng(b * s)
    quant = kv == "int8"
    qdt = torch.float32 if kv == "float32" else torch.bfloat16
    shape = (b, kvh, s, d)
    if quant:
        k = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        ks = torch.from_numpy((rng.random(shape[:3]) / 127).astype(
            np.float32)).to(dev)
        vs = torch.from_numpy((rng.random(shape[:3]) / 127).astype(
            np.float32)).to(dev)
    else:
        k = torch.from_numpy(rng.normal(size=shape)).to(qdt)
        v = torch.from_numpy(rng.normal(size=shape)).to(qdt)
        ks = vs = None
    k, v = k.to(dev), v.to(dev)
    q = torch.from_numpy(rng.normal(size=(b, h, d))).to(qdt).to(dev)
    q_pos = [(s * 3 // 2 + 7 * i) if i % 3 != 1 else s // 3 for i in range(b)]
    empty = b // 2 if b > 1 else None
    ring = np.full((b, s), POS_EMPTY, np.int32)
    first = np.full((b, s), POS_EMPTY, np.int32)
    for i, qp in enumerate(q_pos):
        p = np.arange(max(0, qp + 1 - s), qp + 1)
        if i != empty:
            ring[i, p % s] = p
        first[i, :40] = np.arange(40)
    pl = tdec.plan(b, h, kvh, s, d, torch.int8 if quant else qdt,
                   sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    assert (pl["splits"] == 1) == (b * kvh >= 132)
    atol, rtol = DECODE_TOL[qdt]
    for pos in (ring, first):
        kw = dict(kv_pos=torch.from_numpy(pos).to(dev),
                  q_pos=torch.tensor(q_pos, dtype=torch.int32, device=dev),
                  k_scale=ks, v_scale=vs)
        got = tdec.decode_attention(q, k, v, **kw)
        again = tdec.decode_attention(q, k, v, **kw)
        want = ref.decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        assert torch.equal(got, again)
        if pos is ring and empty is not None:
            assert not got[empty].any()  # the all-empty row is exact zero


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_grouped_moe_gemm_kernel_matches_plain(dtype):
    """Skewed sizes with an empty expert and one past C, an all-empty
    call, ragged and aligned widths, garbage in the dead capacity rows;
    int8 exactly."""
    from repro_torch.kernels import kraken_moe_gemm as tmg
    from repro_torch.kernels import ref
    dev = _cuda()
    rng = np.random.default_rng(0)
    before = tmg.launches
    cases = ((4, 8, 24, 40, [8, 0, 3, 9]), (3, 70, 64, 128, [70, 0, 65]),
             (2, 5, 13, 9, [0, 0]))
    for e, c, d, f, sizes in cases:
        if dtype == torch.int8:
            xs = torch.from_numpy(rng.integers(-128, 128, (e, c, d)).astype(
                np.int8))
            w = torch.from_numpy(rng.integers(-128, 128, (e, d, f)).astype(
                np.int8))
        else:
            xs = torch.from_numpy(rng.normal(size=(e, c, d))).to(dtype)
            w = (torch.from_numpy(rng.normal(size=(e, d, f))) / d ** 0.5).to(
                dtype)
        for i, s in enumerate(sizes):
            xs[i, min(s, c):] = 99
        xs, w = xs.to(dev), w.to(dev)
        sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
        got = tmg.grouped_moe_gemm(xs, w, sz)
        want = ref.grouped_moe_gemm(xs, w, sz)
        if dtype == torch.int8:
            assert got.dtype == torch.int32
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=TOL[dtype],
                                       atol=TOL[dtype])
        for i, s in enumerate(sizes):
            assert not got[i, min(s, c):].any()
    assert tmg.launches == before + len(cases)


# grouped_moe_gemm's bf16 plans: chip_smoke.py's MOE_CASES (full width) and
# MOE_EDGE, as (name, E, C, d, f, sizes, the value in the dead rows)
MOE_PLAN_CASES = ([(n, e, c, d, f, moe_sizes(s, e), 99.0)
                   for n, e, c, d, f, s, _ in MOE_CASES] + MOE_EDGE)


def _moe_operands(dev, e, c, d, f, sizes, fill, seed):
    """bf16 xs [e, c, d] with ``fill`` in the rows at or past each size,
    weights [e, d, f] scaled by 1/sqrt(d), and the sizes, made on the card
    one expert at a time."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.empty((e, d, f), dtype=torch.bfloat16, device=dev)
    for i in range(e):
        w[i] = torch.randn((d, f), generator=g, device=dev) / max(d, 1) ** 0.5
    xs = torch.randn((e, c, d), generator=g, device=dev).to(torch.bfloat16)
    for i, s in enumerate(sizes):
        xs[i, min(max(s, 0), c):] = fill
    return xs, w, torch.tensor(sizes, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_PLAN_CASES,
                         ids=[c[0] for c in MOE_PLAN_CASES])
def test_grouped_moe_gemm_kernel_plans(case):
    """bf16 at every plan class (the wgmma kernel's 64 x 256 and 128 x 128
    tiles, f under BN, a split of d taken at run time, two m tiles, the tile
    route) against the plain version within GEMM_TOL; rows past the sizes
    exactly zero (garbage or Inf there); two calls bit-identical."""
    from repro_torch.kernels import kraken_moe_gemm as tmg
    from repro_torch.kernels import ref
    dev = _cuda()
    _, e, c, d, f, sizes, fill = case
    xs, w, sz = _moe_operands(dev, e, c, d, f, sizes, fill, seed=e * c + d)
    before = tmg.launches
    got = tmg.grouped_moe_gemm(xs, w, sz)
    again = tmg.grouped_moe_gemm(xs, w, sz)
    want = ref.grouped_moe_gemm(xs, w, sz)
    torch.cuda.synchronize()
    assert tmg.launches == before + 2
    atol, rtol = GEMM_TOL["bfloat16"]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    for i, s in enumerate(sizes):
        assert not got[i, min(max(s, 0), c):].any()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@pytest.mark.cuda
def test_grouped_expert_ffn_captures_in_a_cuda_graph():
    """mixtral's decode-step expert FFN (E 8, C 1, d 6144, f 16384) captured
    in one CUDA graph: a replay gives the eager call's bits; after the sizes
    change in place (one live expert: the kernel now splits d) a replay
    gives the new eager call's bits, within GEMM_TOL of the plain FFN."""
    from repro_torch.kernels import kraken_moe_gemm as tmg
    from repro_torch.kernels import ref
    dev = _cuda()
    e, d, f = 8, 6144, 16384
    buf, wg, sz = _moe_operands(dev, e, 1, d, f, [1, 0, 1, 1, 0, 1, 1, 1],
                                0.0, seed=1)
    _, wu, _ = _moe_operands(dev, e, 1, d, f, [0] * e, 0.0, seed=2)
    _, wo, _ = _moe_operands(dev, e, 1, f, d, [0] * e, 0.0, seed=3)
    args = (buf, sz, wg, wu, wo)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tmg.grouped_expert_ffn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tmg.grouped_expert_ffn(*args)
    atol, rtol = GEMM_TOL["bfloat16"]
    for sizes in ([1, 0, 1, 1, 0, 1, 1, 1], [0, 0, 0, 0, 0, 1, 0, 0]):
        sz.copy_(torch.tensor(sizes, dtype=torch.int32, device=dev))
        graph.replay()
        eager = tmg.grouped_expert_ffn(*args)
        want = ref.grouped_expert_ffn(*args)
        torch.cuda.synchronize()
        assert torch.equal(captured.view(torch.int16), eager.view(torch.int16))
        torch.testing.assert_close(captured, want, rtol=rtol, atol=atol)
        assert not captured[torch.tensor(sizes, device=dev) == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x22b",
                                  "llama-3.2-vision-11b", "musicgen-large"])
def test_engine_on_the_card_matches_the_cpu(arch):
    """The f32 smoke engine through the CUDA kernels emits the same greedy
    tokens as through the plain versions on the CPU."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.kernels import kraken_gemm as tkg
    from repro_torch.kernels import kraken_moe_gemm as tmg
    from repro_torch.kernels import paged_attention as tpa
    from repro_torch.models.model import Model
    from repro_torch.serving import CacheConfig, EngineConfig, PagedEngine
    dev = _cuda()
    moe_before = tmg.launches
    cfg = dataclasses.replace(smoke_config(get_arch(arch)),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    config = EngineConfig(slots=2, chunk=4,
                          cache=CacheConfig(page_size=4, max_len=32))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (3, 5, 9, 12)]
    outs = []
    for p in (params, _to(params, dev)):
        eng = PagedEngine(model, p, config=config)
        for pr in prompts:
            eng.submit(pr, 5)
        outs.append(eng.run_until_idle())
    assert outs[0] == outs[1] and len(outs[0]) == 4
    assert tkg.launches > 0 and tpa.launches > 0
    assert (tmg.launches > moe_before) == bool(cfg.num_experts)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SWA_CASES, ids=[c[0] for c in SWA_CASES])
def test_swa_attention_kernel_matches_plain(case, dtype):
    """``swa_kernels``' cases, one test each: gemma3's local layer (D 240,
    window 1024), mixtral's (group 6, window past S), windows 1, 16 and
    100, and a ragged S with D 40 (no multiple of 16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as tsw
    dev = _cuda()
    _, b, h, kvh, s, d, window = case
    _check_swa(tsw, ref, dev, b, h, kvh, s, d, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ac.SWA_EDGE, ids=[c[0] for c in ac.SWA_EDGE])
def test_swa_attention_kernel_head_dims_and_windows(case):
    """The bf16 kernel at D 40, 64, 128 and 240 (one, two and four 64-column
    boxes, zero columns past D) under windows 1, 16, 100, 1024 and 4096,
    over a ragged S."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as tsw
    dev = _cuda()
    _, b, h, kvh, s, d, window = case
    _check_swa(tsw, ref, dev, b, h, kvh, s, d, window, torch.bfloat16)


def _check_swa(tsw, ref, dev, b, h, kvh, s, d, window, dtype):
    atol, rtol = SWA_TOL[dtype]
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, h, s, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, kvh, s, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, kvh, s, d), generator=g, device=dev).to(dtype)
    before = tsw.launches
    got = tsw.swa_attention(q, k, v, window=window)
    want = ref.sliding_window_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        n = torch.clamp(torch.arange(s, device=dev) + 1, max=window)
        atol = atol * (SWA_ROW_KEYS / n.double()).clamp(max=1).sqrt()
        atol = atol.float()[:, None]
    assert got.dtype == dtype and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    assert (err <= atol + rtol * want.float().abs()).all(), err.max().item()
    assert tsw.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_kraken_conv_kernel_matches_plain(case, dtype):
    """The direct conv kernel against ``ref.conv2d`` under ``CONV_TOL``,
    through ``ops`` (a CUDA tensor launches the kernel, never the plain
    version) and its wrapper, with the exact output shape."""
    from repro_torch.kernels import kraken_conv as tkc
    from repro_torch.kernels import ops, ref
    dev = _cuda()
    _, n, h, w, ci, k, s, padding, co, R = case
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, h, w, ci), generator=g, device=dev).to(dtype)
    wt = (torch.randn((k, k, ci, co), generator=g, device=dev)
          / (ci * k * k) ** 0.5).to(dtype)
    kw = dict(stride=(s, s), padding=padding)
    before = tkc.launches
    got = ops.kraken_conv2d_direct(x, wt, R=R, **kw)
    want = ref.conv2d(x, wt, **kw)
    torch.cuda.synchronize()
    (pt, pb), (pl, pr) = padding
    oh, ow = (h + pt + pb - k) // s + 1, (w + pl + pr - k) // s + 1
    assert tuple(got.shape) == (n, oh, ow, co) and got.dtype == dtype
    assert tkc.launches == before + 1
    atol, rtol = CONV_TOL[dtype]
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert (err <= atol + rtol * want.float().abs()).all(), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_NONFINITE,
                         ids=[c[0] for c in CONV_NONFINITE])
def test_kraken_conv_inf_stays_in_its_window(case, dtype):
    """chip_smoke.py's Inf cases: an Inf at x[0, H // 2, W // 2, 0] makes
    exactly the outputs whose window holds it non-finite, as in
    ``ref.conv2d``; the others stay within ``CONV_TOL``
    (packed, the kernel's lanes also load the next pixels' elements under
    zero weights)."""
    from repro_torch.kernels import ops, ref
    dev = _cuda()
    _, n, h, w, ci, k, s, padding, co, R = case
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, h, w, ci), generator=g, device=dev).to(dtype)
    x[0, h // 2, w // 2, 0] = float("inf")
    wt = (torch.randn((k, k, ci, co), generator=g, device=dev)
          / (ci * k * k) ** 0.5).to(dtype)
    kw = dict(stride=(s, s), padding=padding)
    got = ops.kraken_conv2d_direct(x, wt, R=R, **kw).float()
    want = ref.conv2d(x, wt, **kw).float()
    fin = torch.isfinite(want)
    assert not fin.all()
    assert torch.equal(torch.isfinite(got), fin)
    atol, rtol = CONV_TOL[dtype]
    err = (got[fin] - want[fin]).abs()
    assert (err <= atol + rtol * want[fin].abs()).all(), err.max().item()


@pytest.mark.cuda
def test_kraken_conv_im2col_route_matches_plain():
    """``ops.kraken_conv2d`` on the card: im2col, then one ``kraken_gemm``
    launch, within ``CONV_TOL`` of the plain version."""
    from repro_torch.kernels import kraken_gemm as tkg
    from repro_torch.kernels import ops, ref
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((2, 15, 15, 24), generator=g, device=dev).to(dtype)
        wt = (torch.randn((3, 3, 24, 40), generator=g, device=dev)
              / (24 * 9) ** 0.5).to(dtype)
        kw = dict(stride=(2, 2), padding=((1, 1), (1, 1)))
        before = tkg.launches
        got = ops.kraken_conv2d(x, wt, **kw)
        want = ref.conv2d(x, wt, **kw)
        torch.cuda.synchronize()
        assert tkg.launches == before + 1
        atol, rtol = CONV_TOL[dtype]
        err = (got.float() - want.float()).abs()
        assert (err <= atol + rtol * want.float().abs()).all(), err.max()


# the tile tuner's choices on the card: (op kind, the planner's shape)
TUNE_SHAPES = {
    "gemm": (4, 4096, 4096),
    "paged_decode": (4, 32, 4, 128, 16, 32),
    "moe_gemm": (8, 16, 1024, 2048),
    "conv_direct": ((1, 14, 14, 512), (3, 3, 512, 512), (1, 1),
                    ((1, 1), (1, 1)), 7),
}


def _tune_other(search, op_kind, sms):
    """A candidate of ``op_kind`` at its TUNE_SHAPES shape that is not the
    planner's pick (``kraken_gemm``'s from the shortlist the tuner times)."""
    shape = TUNE_SHAPES[op_kind]
    fields = search._op(op_kind).fields
    pick = search.model_pick(op_kind, shape, dtype_name="bfloat16", sms=sms)
    cands = search.candidates_of(op_kind, shape, dtype_name="bfloat16",
                                 sms=sms)
    if op_kind == "gemm":
        cands = search.shortlist(cands, fields, keep=pick)
    return pick, next(tuple(c[f] for f in fields) for c in cands
                      if tuple(c[f] for f in fields) != pick)


@pytest.mark.cuda
@pytest.mark.parametrize("op_kind", sorted(TUNE_SHAPES))
def test_tune_non_default_choice_matches_plain(op_kind):
    """One candidate the planner does not pick, through the tuner's card
    timer: held against the plain version within the kernel's tolerance
    (the timer raises otherwise), then timed."""
    from repro_torch.tuning import search
    _cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pick, other = _tune_other(search, op_kind, sms)
    timer = search.card_timer(op_kind, TUNE_SHAPES[op_kind],
                              dtype_name="bfloat16", reps=1, warmup=1)
    assert timer(other) > 0 and timer(pick) > 0


@pytest.mark.cuda
def test_tune_replayed_cache_launches_the_cached_choice(tmp_path):
    """A cache file tuned to a non-default plan, replayed in mode
    ``cached``: ``kraken_matmul`` launches that choice, within TOL."""
    from repro_torch import tuning
    from repro_torch.kernels import kraken_gemm as tkg
    from repro_torch.kernels import ops, ref
    from repro_torch.tuning import search
    dev = _cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = TUNE_SHAPES["gemm"]
    pick, other = _tune_other(search, "gemm", sms)
    path = str(tmp_path / "plans.json")
    search.autotune("gemm", shape, dtype_name="bfloat16", sms=sms,
                    cache=tuning.TileCache(path),
                    timer=lambda c: 0.5 if c == other else 1.0)
    seen = []
    orig = tkg._launch_plan

    def recording(*args):
        seen.append(args[-1])
        return orig(*args)
    tkg._launch_plan = recording
    tuning.set_tile_cache(path)
    tuning.set_tile_mode("cached")
    try:
        g = torch.Generator(device=dev).manual_seed(0)
        m, k, n = shape
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        b = (torch.randn((k, n), generator=g, device=dev)
             / k ** 0.5).to(torch.bfloat16)
        got = ops.kraken_matmul(a, b)
    finally:
        tkg._launch_plan = orig
        tuning.set_tile_mode(None)
        tuning.set_tile_cache(tuning.TileCache(path=None))
    assert seen == [other] and other != pick
    torch.testing.assert_close(got, ref.matmul(a, b), rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


# ---------------------------------------------------------------------------
# training: the gradient of kraken_matmul, and what never runs under grad
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
def test_train_matmul_grad_matches_plain(act, dtype):
    """``ops.KrakenMatmul`` at the ragged M 65 / K 27 / N 123 (TMA refuses
    the transposed operands), with a bias: its forward and dA, dB, dbias
    on the kernel against the same Function on the plain version, within
    TOL at unit scale; the launches counted."""
    from repro_torch.kernels import kraken_gemm as tkg
    from repro_torch.kernels import ops, ref
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(65)
    m, k, n = 65, 27, 123
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    c = torch.randn((n,), generator=g, device=dev).to(dtype)
    dy = torch.randn((m, n), generator=g, device=dev).to(dtype)

    def run(mm):
        xs = [t.clone().requires_grad_() for t in (a, b, c)]
        out = ops.kraken_matmul_grad(*xs[:2], bias=xs[2], activation=act,
                                     matmul=mm)
        return [out, *torch.autograd.grad(out, xs, dy)]

    before = tkg.launches
    got = run(ops.kraken_matmul)
    torch.cuda.synchronize()
    assert tkg.launches == before + 3 + (act is not None)
    for x, y in zip(got, run(ref.matmul)):
        s = y.float().abs().max()
        torch.testing.assert_close(x.float() / s, y.float() / s,
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_train_swa_attention_under_grad_raises():
    """Under grad ``ops.swa_attention`` is ``SwaAttention``: one forward
    launch, one backward launch, the gradients of the kernels' own; a call
    the kernels do not take (float16) raises before any launch and never
    falls back to the plain version or another attention."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as tsw
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(
        torch.bfloat16) for shape in ((1, 2, 128, 64), (1, 1, 128, 64),
                                      (1, 1, 128, 64), (1, 2, 128, 64)))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tsw.launches, tsw.bwd_launches)
    out = ops.swa_attention(*xs, window=16)
    got = torch.autograd.grad(out, xs, dout)
    torch.cuda.synchronize()
    assert (tsw.launches, tsw.bwd_launches) == (before[0] + 1, before[1] + 1)
    o, lse = tsw.swa_attention(q, k, v, window=16, return_lse=True)
    assert torch.equal(out, o)
    want = tsw.swa_attention_bwd(q, k, v, o, dout, lse, window=16)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    half = [t.detach().half().requires_grad_() for t in xs]
    before = (tsw.launches, tsw.bwd_launches)
    with pytest.raises(ValueError, match="dtypes"):
        ops.swa_attention(*half, window=16)
    assert (tsw.launches, tsw.bwd_launches) == before
    with torch.no_grad():
        assert torch.equal(ops.swa_attention(q, k, v, window=16), o)
    assert tsw.launches == before[0] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ac.SWA_BWD_CASES,
                         ids=[c[0] for c in ac.SWA_BWD_CASES])
def test_swa_attention_bwd_kernel_matches_plain(case, dtype):
    """``swa_kernels``' backward cases, one test each: dq, dk and dv of
    ``swa_attention_bwd`` on the forward kernel's own out and lse against
    ``ref.sliding_window_attention_bwd`` on the same inputs, within
    ``SWA_BWD_TOL`` at unit scale (each gradient over its largest |entry|,
    at least a hundredth of the three's); two calls with the same bits; the
    forward's output with the same bits with and without the lse, its lse
    within ``SWA_LSE_TOL`` of the plain one's; the launches counted."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as tsw
    dev = _cuda()
    _, b, h, kvh, s, d, window, _ = case
    atol, rtol = ac.SWA_BWD_TOL[str(dtype).split(".")[-1]]
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, h, s, d), (b, kvh, s, d),
                                   (b, kvh, s, d), (b, h, s, d)))
    before = (tsw.launches, tsw.bwd_launches)
    out, lse = tsw.swa_attention(q, k, v, window=window, return_lse=True)
    assert torch.equal(out, tsw.swa_attention(q, k, v, window=window))
    _, want_lse = ref.sliding_window_attention(q, k, v, window=window,
                                               return_lse=True)
    assert float((lse - want_lse).abs().max()) <= ac.SWA_LSE_TOL
    got = tsw.swa_attention_bwd(q, k, v, out, dout, lse, window=window)
    again = tsw.swa_attention_bwd(q, k, v, out, dout, lse, window=window)
    torch.cuda.synchronize()
    assert (tsw.launches, tsw.bwd_launches) == (before[0] + 2, before[1] + 2)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = ref.sliding_window_attention_bwd(q, k, v, out, dout, lse,
                                            window=window)
    floor = 0.01 * max(float(y.float().abs().max()) for y in want)
    for x, y in zip(got, want):
        assert x.dtype == dtype and torch.isfinite(x.float()).all()
        scale = max(float(y.float().abs().max()), floor)
        err = (x.float() - y.float()).abs() / scale
        assert (err <= atol + rtol * y.float().abs() / scale).all(), \
            float(err.max())


@pytest.mark.cuda
def test_train_moe_never_launches_grouped_gemm_under_grad():
    """mixtral's smoke config on the card: the loss's gradient takes the
    einsum expert path (no ``grouped_moe_gemm`` launch), the forward
    without grad the grouped kernel."""
    from repro_torch import tree as T
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.kernels import kraken_moe_gemm as tmg
    from repro_torch.models.model import Model
    dev = _cuda()
    model = Model(smoke_config(get_arch("mixtral-8x22b")))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, model.cfg.vocab_size, (2, 16), device=dev)
    batch = {"tokens": toks, "labels": toks}
    before = tmg.launches
    leaves = T.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    assert tmg.launches == before
    assert all(g is not None and bool(torch.isfinite(g.float()).all())
               for g in grads)
    with torch.no_grad():
        model.loss(params, batch)
    assert tmg.launches > before


@pytest.mark.cuda
def test_train_autotune_tile_cache_twice(tmp_path, capsys):
    """``train --smoke --autotune --tile-cache F`` twice: the second run
    finds every train cell in the file."""
    from repro_torch import tuning
    from repro_torch.launch import train
    _cuda()
    cache = str(tmp_path / "plans.json")
    outs = []
    try:
        for i in range(2):
            assert train.main(["--smoke", "--autotune", "--tile-cache", cache,
                               "--steps", "2", "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path / f"ck{i}")]) == 0
            outs.append(capsys.readouterr().out)
    finally:
        tuning.set_tile_mode(None)
        tuning.set_tile_cache(tuning.TileCache(path=None))
    assert "fully warm" not in outs[0] and "done: 2 steps" in outs[0]
    assert "train cells hit — fully warm" in outs[1]
