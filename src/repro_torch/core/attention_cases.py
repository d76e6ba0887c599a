"""The attention shapes ``paged_decode_attention``, ``decode_attention`` and
``swa_attention`` are checked and timed at, and their tolerances against the
plain versions.

``chip_smoke.py`` runs them on the card (phases ``kernels`` and
``moe_kernels``, ``dense_kernels`` and ``swa_kernels``),
``tests/test_torch_cuda.py`` holds the kernels to the same tolerances there,
and ``tests/test_torch_attention_plan.py`` and
``tests/test_torch_paged_plan.py`` check the kernels' plans and emulate
their arithmetic on the CPU, so all of them read them from here.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.gemm_cases import GEMMA_SEQ

POS_EMPTY = -(2 ** 30)

# ---- paged_decode_attention: the serving engines' decode ------------------------

# paged_decode_attention against the plain version, (atol, rtol) by q
# dtype: both compute in fp32 (the kernel dequantizes int8 in another
# order) and round once
ATTN_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}
# the serve engines' pools: pages of 16 over a 512-token ring (32 pages a
# slot); yi-6b (``YI_6B``: 32/4 heads of 128, bf16 or the int8 engine's
# int8 pools), mixtral-8x22b (48/8 heads of 128 under its 4096 window) and
# zamba2-1.2b's shared block (32/32 heads of 64: one query row a KV head)
PAGE, MAX_PAGES = 16, 32
# 64 slots' positions: every length from one token to past the ring
Q_POS_64 = [(37 * i * i + 11 * i) % 900 for i in range(64)]
ALL = ("bfloat16", "float32", "int8")
# (name, B, H, KV, D, ps, MP, pool dtypes, window, q_pos, dead slots,
# sentinel entries (slot, logical page) of live slots, timed, shift).  The
# serve shapes at 1, 4 and 64 slots (the 4-slot yi-6b case is the serve
# phase's: slot 1 has wrapped the ring, slot 2 is all dead, slot 3 has a
# sentinel first page), then the edge cases.  Every case also runs with Inf
# in its dead data (``paged_pool``'s ``nonfinite``).  ``shift`` moves every
# score by -shift (float pools), so that a split with no live page that
# wrote m = 0 instead of -1e30 would zero the slot's row.
PAGED_CASES = [
    ("yi-6b 4 slots", 4, 32, 4, 128, PAGE, MAX_PAGES, ALL, 0,
     [300, 700, 40, 17], (2,), ((3, 0),), True, 0.0),
    ("yi-6b 4 slots window 64", 4, 32, 4, 128, PAGE, MAX_PAGES, ALL, 64,
     [300, 700, 40, 17], (2,), ((3, 0),), True, 0.0),
    ("yi-6b 1 slot", 1, 32, 4, 128, PAGE, MAX_PAGES, ("bfloat16", "int8"), 0,
     [300], (), (), True, 0.0),
    ("yi-6b 64 slots", 64, 32, 4, 128, PAGE, MAX_PAGES, ("bfloat16", "int8"),
     0, Q_POS_64, (5,), ((7, 3),), True, 0.0),
    ("mixtral 4 slots", 4, 48, 8, 128, PAGE, MAX_PAGES, ("bfloat16",), 4096,
     [300, 700, 40, 17], (2,), ((3, 0),), True, 0.0),
    ("mixtral 1 slot", 1, 48, 8, 128, PAGE, MAX_PAGES, ("bfloat16",), 4096,
     [300], (), (), True, 0.0),
    ("mixtral 64 slots", 64, 48, 8, 128, PAGE, MAX_PAGES, ("bfloat16",), 4096,
     Q_POS_64, (5,), ((7, 3),), True, 0.0),
    ("zamba2 4 slots", 4, 32, 32, 64, PAGE, MAX_PAGES,
     ("bfloat16", "float32"), 0, [300, 700, 40, 17], (2,), ((3, 0),), True,
     0.0),
    ("zamba2 64 slots", 64, 32, 32, 64, PAGE, MAX_PAGES, ("bfloat16",), 0,
     Q_POS_64, (5,), ((7, 3),), True, 0.0),
    ("ring wrap in every slot", 3, 8, 2, 64, 16, 8, ALL, 0, [200, 129, 500],
     (), (), False, 0.0),
    ("window 5 across page edges", 3, 8, 2, 64, 4, 16, ALL, 5, [63, 30, 2],
     (), (), False, 0.0),
    ("all slots dead", 2, 8, 2, 64, 16, 8, ALL, 0, [50, 90], (0, 1), (),
     False, 0.0),
    ("sentinels mid-table", 2, 8, 2, 64, 16, 8, ALL, 0, [120, 127], (),
     ((0, 3), (1, 5), (1, 6)), False, 0.0),
    ("Inf in dead data: window 20 and a sentinel", 2, 8, 2, 64, 16, 8, ALL,
     20, [100, 127], (), ((1, 2),), False, 0.0),
    ("TMA refuses: page 6, D 18", 3, 6, 2, 18, 6, 10, ALL, 0, [40, 70, 3],
     (1,), (), False, 0.0),
    ("int8 TMA refuses the scales: page 6, D 32", 2, 8, 2, 32, 6, 10, ALL, 0,
     [59, 13], (), (), False, 0.0),
    ("the card test's shape: D 16, page 4", 4, 4, 2, 16, 4, 4, ALL, 0,
     [9, 21, 6, 3], (2,), ((3, 0),), False, 0.0),
    ("page 64, D 256, window 100", 2, 8, 2, 256, 64, 4, ALL, 100, [200, 255],
     (), (), False, 0.0),
    ("GQA 12, a slot at q_pos 0", 2, 24, 2, 64, 16, 8, ALL, 0, [0, 77], (),
     (), False, 0.0),
    ("scores far below zero, short slots", 4, 8, 2, 16, 16, 8,
     ("bfloat16", "float32"), 0, [3, 40, 127, 200], (), (), False, 120.0),
]


def paged_pool(case, dtype: str, seed: int, *, nonfinite: bool = False):
    """Numpy inputs of one ``PAGED_CASES`` entry as token-by-token serving
    leaves a pool: shuffled physical pages, ring positions 0..q_pos[i]
    written per slot (a slot past MP * ps has wrapped), all-sentinel rows for
    the dead slots, the case's sentinel entries, three pages no table entry
    points to, and the trash page at index ``n_pages`` (the tables' sentinel)
    that the kernel is not given.  Dead data (every entry no slot attends to,
    the unreferenced pages and the trash page) holds random values, or with
    ``nonfinite`` Inf in K and NaN in V (for int8 pools: in their scales);
    float pools take the case's ``shift``.

    Returns a dict: q [B, H, D] f32; k, v [n_pages + 1, KV, ps, D] (f32 or
    int8); pos [n_pages + 1, ps] and table [B, MP] int32; k_scale, v_scale
    [n_pages + 1, KV, ps] f32 or None; q_pos [B] int32; live [n_pages + 1,
    ps] bool (the entries some slot attends to); n_pages."""
    _, b, h, kv, d, ps, mp, _, window, q_pos, dead, sentinels, _, shift = case
    rng = np.random.default_rng(seed)
    n_pages = b * mp + 3
    logical = mp * ps
    table = np.full((b, mp), n_pages, np.int32)
    perm = rng.permutation(n_pages).astype(np.int32)
    for i in range(b):
        if i not in dead:
            table[i] = perm[i * mp:(i + 1) * mp]
    for i, j in sentinels:
        table[i, j] = n_pages
    pos = np.full((n_pages + 1, ps), POS_EMPTY, np.int32)
    live = np.zeros((n_pages + 1, ps), bool)
    for i in range(b):
        if i in dead:
            continue
        p = np.arange(max(0, q_pos[i] + 1 - logical), q_pos[i] + 1)
        page = table[i, (p % logical) // ps]
        ok = page < n_pages
        pos[page[ok], p[ok] % ps] = p[ok]
        attend = ok & (p <= q_pos[i])
        if window:
            attend &= p > q_pos[i] - window
        live[page[attend], p[attend] % ps] = True
    shape = (n_pages + 1, kv, ps, d)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    ks = vs = None
    if dtype == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) / 127).astype(np.float32)
        vs = (rng.random(shape[:3]) / 127).astype(np.float32)
        if nonfinite:
            dead_sc = np.broadcast_to(~live[:, None, :], shape[:3])
            ks[dead_sc] = np.inf
            vs[dead_sc] = np.nan
    else:
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
        if shift:
            # q's first coordinate -shift sqrt(d) / 8 against K's 8
            k[..., 0] = 8.0
            q[..., 0] = -shift * np.sqrt(d) / 8.0
        if nonfinite:
            dead_kv = np.broadcast_to(~live[:, None, :, None], shape)
            k[dead_kv] = np.inf
            v[dead_kv] = np.nan
    return dict(q=q, k=k, v=v, pos=pos, table=table, k_scale=ks, v_scale=vs,
                q_pos=np.asarray(q_pos, np.int32), live=live, n_pages=n_pages)


# ---- decode_attention: yi-6b's dense int8 decode -----------------------------

# yi-6b (``YI_6B``): 32 heads over 4 KV heads of 128; a 512-entry dense cache
DENSE_HEADS, DENSE_KV_HEADS, DENSE_HEAD_DIM, DENSE_LEN = 32, 4, 128, 512
# per-slot positions of the dense cases: slot 1 has wrapped the ring, slot
# 2 holds nothing (an all-empty row: its q_pos sees no live entry)
DENSE_Q_POS = [300, 700, 50, 17]
DENSE_EMPTY_ROW = 2
# (S, window, shared positions, timed): the serve cache length with and
# without a window, a ragged S (no multiple of the kernel's 32-entry tile),
# and one shared position row
DENSE_CASES = [(DENSE_LEN, 0, False, True), (DENSE_LEN, 64, False, True),
               (DENSE_LEN - 13, 0, False, False), (DENSE_LEN, 0, True, False)]
# the split plan's corners, (name, B, H, KV, S, D): no split once B * KV
# fills the card's 132 SMs, one tile a split at one slot, several tiles a
# split with a ragged S, GQA 6 at mixtral's heads
DECODE_SPLIT_CASES = [
    ("B*KV fills the card: no split", 34, 32, 4, DENSE_LEN, 128),
    ("one slot: one tile a split", 1, 32, 4, DENSE_LEN, 128),
    ("ragged S 333, D 64", 3, 16, 2, 333, 64),
    ("GQA 6, D 128, S 700", 2, 48, 8, 700, 128),
]
# (atol, rtol) by q dtype: kernel and plain version both compute in fp32 and
# round once, so they differ by at most one bf16 ulp (< 2^-7 of the value);
# the limit still fails a kernel that drops one live entry of a 512-entry row
DECODE_TOL = {"bfloat16": (1e-4, 1e-2), "float32": (1e-5, 1e-5)}

# ---- swa_attention: the cache-less windowed forward ---------------------------

# swa_attention cases: (name, B, H, KV, S, D, window, timed).  gemma3-12b's
# local layer (``GEMMA3_12B``: 16/8 heads of 240, window 1024 over the
# forward's 4096 tokens) and mixtral's (48/8 heads of 128 under its 4096
# window), then edge windows and a ragged S with a head dim that is no
# multiple of 16
SWA_CASES = [
    ("gemma3 local", 1, 16, 8, GEMMA_SEQ, 240, 1024, True),
    ("mixtral", 1, 48, 8, 2048, 128, 4096, True),
    ("edge window 1", 2, 4, 2, 256, 64, 1, False),
    ("edge window 16", 2, 4, 2, 256, 64, 16, False),
    ("edge window 100", 2, 4, 2, 256, 64, 100, False),
    ("ragged S 200, D 40", 2, 4, 2, 200, 40, 16, False),
]
# every head dim class of the bf16 kernel (one, two and four 64-column
# boxes; D 40 and 240 with zero columns) under every window class (the
# diagonal only, inside one kv tile, across tiles, gemma3's, past S), at a
# ragged S 1200: (name, B, H, KV, S, D, window)
SWA_EDGE = [(f"D {d} window {w}", 1, 4, 2, 1200, d, w)
            for d in (40, 64, 128, 240) for w in (1, 16, 100, 1024, 4096)]
# swa_attention by dtype (atol, rtol).  bf16: the kernel rounds its
# probabilities to bf16 before the PV product, as the Pallas kernel does
# (the plain version keeps them fp32, as JAX's oracle does), and both sides
# round the output (within rtol).  The probabilities' rounding error in a
# query row that attends to n keys falls as 1/sqrt(n), so past
# SWA_ROW_KEYS keys the bf16 atol of row i shrinks by sqrt(SWA_ROW_KEYS /
# min(i + 1, W)): 6.3e-4 on a full 1024-key window.  The largest need
# measured was 0.74 of the limit, both for the first (wmma) kernel over 7
# seeds of every case and for the wgmma kernel over every case of
# swa_kernels on an H100; a key dropped mid-window needs 336x it.  f32:
# sums in another order, ~1.5e-6.
SWA_TOL = {"bfloat16": (4e-3, 1e-2), "float32": (1e-5, 1e-5)}
SWA_ROW_KEYS = 25
