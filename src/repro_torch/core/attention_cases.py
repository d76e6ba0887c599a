"""The attention shapes ``decode_attention`` and ``swa_attention`` are checked
and timed at, and their tolerances against the plain versions.

``chip_smoke.py`` runs them on the card (phases ``dense_kernels`` and
``swa_kernels``), ``tests/test_torch_cuda.py`` holds the kernels to the same
tolerances there, and ``tests/test_torch_attention_plan.py`` checks the
kernels' plans and emulates their arithmetic on the CPU, so all three read
them from here.
"""

from __future__ import annotations

from repro_torch.core.gemm_cases import GEMMA_SEQ

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
