"""The bf16 ``kraken_gemm`` kernel's plan and addressing, on the CPU (the
kernel itself has no CPU mode).

* :func:`repro_torch.kernels.kraken_gemm.plan` for every projection of
  yi-6b, gemma3-12b and mixtral-8x22b at M 1, 4, 256 and 4096 (the tables of
  :mod:`repro_torch.core.gemm_cases`, which ``chip_smoke.py`` runs on the
  card), every im2col conv layer of AlexNet, VGG-16 and ResNet-50 at batch 1
  and 32, and the edge cases: the plan fits the card's 227 KB of shared
  memory, its tiles and splits cover every output element exactly once
  (each split a disjoint run of K steps, together all of K), it splits K
  only when the tiles alone leave SMs of the H100's 132 idle, and it picks
  the producer warps' fill for an operand exactly where TMA cannot take it
  (a base or row stride that is not a multiple of 16 bytes).
* A numpy emulation of ``csrc/kraken_gemm.cu``'s addressing: the stages as
  TMA's 128-byte swizzle lays them down (or as ``fill_tile`` writes them,
  which must be the same bytes); the element each wgmma lane pair reads
  through the K-major A descriptor and the MN-major B descriptor (which
  element each 16-byte chunk of B holds); the tiles, the split's runs of K
  and the fixed-order sum of its partials, with bias and the activation
  applied once, after the sum.  Held against ``ref.matmul``; the same
  emulation with bias and silu applied per partial, a swizzle one chunk
  off, or a partial dropped must fail.
* The plan's field order: ``PLAN_FIELDS`` against the kernel source's
  ``KRAKEN_GEMM_PLAN`` list (the library also reports it when loaded).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import conv_cases, gemm_cases  # noqa: E402
from repro_torch.kernels import kraken_gemm as kg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

H100_SMS = 132
SMEM_MAX = 227 * 1024


def _lm_cases():
    shapes = ([("yi-6b " + n, k, nn) for n, k, nn, _, _ in gemm_cases.GEMMS]
              + [("gemma3 " + n, k, nn)
                 for n, k, nn, _, _ in gemm_cases.GEMMA_GEMMS]
              + [("mixtral " + n, k, nn)
                 for n, k, nn, _ in gemm_cases.MIXTRAL_GEMMS]
              + [("rwkv6 " + n, k, nn)
                 for n, k, nn, _, _ in gemm_cases.RWKV_GEMMS]
              + [("zamba2 " + n, k, nn)
                 for n, k, nn, _, _ in gemm_cases.ZAMBA_GEMMS])
    return [(f"{name} M{m}", m, k, n, 16, 16)
            for m in gemm_cases.LM_ROWS for name, k, n in shapes]


def _conv_cases():
    """The im2col route's GEMM of each conv geometry: [N*OH*OW, C_i*K*K] @
    [C_i*K*K, C_o], both operands fresh contiguous copies."""
    out = []
    for net, layer, h, w, ci, k, s, pad, co in conv_cases.conv_geometries():
        oh = (h + sum(pad[0]) - k) // s + 1
        ow = (w + sum(pad[1]) - k) // s + 1
        for n in conv_cases.CONV_BATCHES:
            out.append((f"{net} {layer} b{n} im2col", n * oh * ow,
                        ci * k * k, co, 16, 16))
    return out


def _edge_cases():
    out = [(f"edge {name}", m, k, n, 16, 16)
           for name, m, k, n, _, _ in gemm_cases.GEMM_EDGE]
    out += [(f"ragged {m}x{k}x{n}", m, k, n, 16, 16)
            for m, k, n in gemm_cases.RAGGED]
    # operands that start off a 16-byte boundary (a view into a larger
    # tensor) though their rows are whole 16-byte multiples
    out += [("A at a 2-byte offset", 4, 4096, 512, 2, 16),
            ("B at an 8-byte offset", 256, 4096, 4096, 16, 8),
            ("both at 4-byte offsets, M 1", 1, 512, 1024, 4, 4),
            ("K 0: bias and activation only", 8, 0, 64, 16, 16)]
    return out


PLAN_CASES = _lm_cases() + _conv_cases() + _edge_cases()


def _plan(case, sms=H100_SMS):
    _, m, k, n, a_align, b_align = case
    return kg.plan(m, k, n, sms=sms, a_align=a_align, b_align=b_align)


def tiles_of(q):
    """Every block's (m0, n0, first k step, k steps), as the kernel's
    ``tile_at`` decodes blockIdx.x (row tile fastest, split z slowest)."""
    t = np.arange(q["tiles"], dtype=np.int64)
    mt, rest = t % q["mtiles"], t // q["mtiles"]
    z = rest // q["ntiles"]
    k0 = z * q["kps"]
    return (mt * q["BM"], (rest % q["ntiles"]) * q["BN"], k0,
            np.minimum(q["kps"], q["nk"] - k0))


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_fits_covers_and_splits_only_when_under_filled(case):
    _, m, k, n, a_align, b_align = case
    q = _plan(case)
    assert q["path"] == kg.PATH_WGMMA
    assert (q["M"], q["N"], q["K"]) == (m, n, k)
    assert q["BM"] in kg.TILE_M and q["BN"] in kg.TILE_N
    # the ring: 3-5 stages of an A box [BM, 64] and a B box [64, BN]
    assert 3 <= q["stages"] <= kg.STAGES_MAX
    assert q["smem"] == q["stages"] * (q["BM"] + q["BN"]) * 128 + kg.RESERVED
    assert q["smem"] <= SMEM_MAX
    # the tile grid covers [M, N] once, no tile wholly outside
    assert q["mtiles"] == -(-m // q["BM"]) and q["ntiles"] == -(-n // q["BN"])
    assert q["tiles"] == q["mtiles"] * q["ntiles"] * q["split"]
    m0, n0, k0, ks = tiles_of(q)
    assert m0.max() < m and n0.max() < n
    key = (m0 // q["BM"]) * q["ntiles"] + n0 // q["BN"]
    assert np.array_equal(np.bincount(key, minlength=q["mtiles"] * q["ntiles"]),
                          np.full(q["mtiles"] * q["ntiles"], q["split"]))
    # per output tile the splits are disjoint runs of K steps that together
    # are all of K, none empty
    assert q["nk"] == -(-k // kg.KB)
    if q["nk"]:
        assert ks.min() >= 1
    order = np.lexsort((k0, key))
    k0s, kss = k0[order].reshape(-1, q["split"]), ks[order].reshape(-1,
                                                                  q["split"])
    assert (k0s[:, 0] == 0).all()
    assert (k0s[:, 1:] == k0s[:, :-1] + kss[:, :-1]).all()
    assert (k0s[:, -1] + kss[:, -1] == q["nk"]).all()
    # K is split only when the tiles alone leave SMs idle
    if q["split"] > 1:
        assert q["mtiles"] * q["ntiles"] < H100_SMS
    # the producer warps fill exactly the operands TMA cannot take
    assert q["fill_a"] == (a_align % 16 != 0 or (2 * k) % 16 != 0)
    assert q["fill_b"] == (b_align % 16 != 0 or (2 * n) % 16 != 0)


@pytest.mark.parametrize("m", [1, 4, 64])
def test_small_m_takes_the_one_kernel_with_a_split(m):
    """At M <= 64 the same kernel runs on a 64-row tile (the rows past M are
    TMA's zeros) and, where the weight's tiles alone leave SMs idle, a
    split fills the card."""
    for _, k, n, _, _ in gemm_cases.GEMMS:
        q = kg.plan(m, k, n, sms=H100_SMS)
        assert q["BM"] == 64 and q["mtiles"] == 1
        if q["ntiles"] < H100_SMS:
            assert q["split"] > 1 and q["tiles"] >= H100_SMS // 2


def test_every_lm_shape_and_conv_layer_is_taken():
    """Every main-path shape is planned (none is refused), the im2col conv's
    first layers (K 27, 147, 363) fill A, and the largest M is the VGG-16
    conv1_1 im2col at batch 32."""
    fills = {c[0]: _plan(c)["fill_a"] for c in _conv_cases()}
    firsts = {k for _, _, k, _, _, _ in _conv_cases() if (2 * k) % 16}
    assert firsts == {27, 147, 363}
    assert all(fills[c[0]] == ((2 * c[2]) % 16 != 0) for c in _conv_cases())
    biggest = max(_conv_cases(), key=lambda c: c[1])
    assert biggest[1] == 32 * 224 * 224 and "vgg16" in biggest[0]


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        kg.plan(0, 64, 64)
    with pytest.raises(ValueError):
        kg.plan(4, -1, 64)
    with pytest.raises(ValueError):
        kg.plan(4, 64, 64, dtype=torch.float16)


def test_float32_plan_is_the_fma_kernel():
    q = kg.plan(37, 200, 123, dtype=torch.float32)
    assert q["path"] == kg.PATH_FMA
    assert all(q[f] == 0 for f in kg.PLAN_FIELDS
               if f not in ("path", "M", "N", "K"))


def test_gemm_tables_match_the_configs():
    """The shape tables are the models' own widths."""
    yi, gem, mix = (get_arch(a) for a in ("yi-6b", "gemma3-12b",
                                          "mixtral-8x22b"))
    for cfg, table, layers in ((yi, gemm_cases.GEMMS, gemm_cases.YI_LAYERS),
                               (gem, gemm_cases.GEMMA_GEMMS,
                                gemm_cases.GEMMA_LAYERS)):
        d, kv = cfg.d_model, cfg.num_kv_heads * cfg.head_dim
        want = {"wq|wo": (d, cfg.num_heads * cfg.head_dim),
                "wk|wv": (d, kv), "gate": (d, cfg.d_ff), "up": (d, cfg.d_ff),
                "down": (cfg.d_ff, d), "unembed": (d, cfg.vocab_size)}
        assert {n: (k, nn) for n, k, nn, _, _ in table} == want
        assert layers == cfg.num_layers
        # q, k, v, o, gate, up, down per layer and the unembed
        assert sum(c for *_, c in table) == 7 * layers + 1
    rwkv, zamba = get_arch("rwkv6-3b"), get_arch("zamba2-1.2b")
    d, f = rwkv.d_model, rwkv.d_ff
    assert {n: (k, nn) for n, k, nn, _, _ in gemm_cases.RWKV_GEMMS} == {
        "r|k|v|g|o|cmix r": (d, d), "lora a": (d, max(32, d // 16)),
        "cmix k": (d, f), "cmix v": (f, d), "unembed": (d, rwkv.vocab_size)}
    assert gemm_cases.RWKV_LAYERS == rwkv.num_layers
    assert sum(c for *_, c in gemm_cases.RWKV_GEMMS) == 9 * rwkv.num_layers + 1
    d, n, h = zamba.d_model, zamba.ssm_state, zamba.ssm_heads
    assert {nm: (k, nn) for nm, k, nn, _, _ in gemm_cases.ZAMBA_GEMMS} == {
        "in_proj": (d, 4 * d + 2 * n + h), "out_proj": (2 * d, d),
        "shared q|k|v|o": (d, zamba.num_heads * zamba.head_dim),
        "shared gate": (d, zamba.d_ff), "shared up": (d, zamba.d_ff),
        "shared down": (zamba.d_ff, d), "unembed": (d, zamba.vocab_size)}
    calls = zamba.num_layers // zamba.mamba_per_shared_attn
    assert (gemm_cases.ZAMBA_LAYERS, gemm_cases.ZAMBA_SHARED_CALLS) == (
        zamba.num_layers, calls)
    assert sum(c for *_, c in gemm_cases.ZAMBA_GEMMS) == \
        2 * zamba.num_layers + 7 * calls + 1
    d = mix.d_model
    assert {n: (k, nn) for n, k, nn, _ in gemm_cases.MIXTRAL_GEMMS} == {
        "wq|wo": (d, mix.num_heads * mix.head_dim),
        "wk|wv": (d, mix.num_kv_heads * mix.head_dim),
        "unembed": (d, mix.vocab_size)}


# ---------------------------------------------------------------------------
# a numpy emulation of the kernel's addressing
# ---------------------------------------------------------------------------

ROW = 128   # bytes of a swizzled 64-element row


def swizzle(addr):
    """The 128-byte swizzle on a shared-memory byte address: 16-byte chunk
    bits [4, 7) XOR the row bits [7, 10) (1024-byte aligned atoms)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(mat, r0, c0, rows, shift=0):
    """A TMA box [rows, 64] of ``mat`` at (r0, c0) with the 128-byte
    swizzle, as the 2-byte elements of its shared-memory bytes; zeros
    outside ``mat``.  ``shift`` plants a fault: the chunk index off by that
    many."""
    out = np.zeros(rows * 64, mat.dtype)
    r = np.arange(rows)[:, None]
    c = np.arange(64)[None, :]
    gr, gc = r0 + r, c0 + c
    inside = (gr < mat.shape[0]) & (gc < mat.shape[1])
    val = np.where(inside, mat[np.minimum(gr, mat.shape[0] - 1),
                               np.minimum(gc, mat.shape[1] - 1)], 0)
    chunk = ((c // 8) ^ (r % 8)) + shift
    out[(r * 64 + (chunk % 8) * 8 + c % 8).ravel()] = val.ravel()
    return out


def fill_tile(src, r0, c0, nrows, ncblk, fillers=128):
    """``fill_tile`` of kraken_gemm.cu: thread f takes chunks u = f, f +
    FILLERS, ...; chunk u is (block cb, row rr, chunk j) and holds elements
    c .. c+7 of row r0 + rr, stored at chunk j ^ (rr % 8) of that row."""
    out = np.full(ncblk * nrows * 64, -1, src.dtype)
    rows, cols = src.shape
    for f in range(fillers):
        for u in range(f, ncblk * nrows * 8, fillers):
            j, q = u & 7, u >> 3
            rr, cb = q % nrows, q // nrows
            r, c = r0 + rr, c0 + cb * 64 + j * 8
            vals = [src[r, c + e] if r < rows and c + e < cols else 0
                    for e in range(8)]
            at = (cb * nrows + rr) * 64 + ((j ^ (rr & 7)) * 8)
            out[at:at + 8] = vals
    return out


def desc_fields(start, lbo, sbo):
    """A wgmma descriptor as the kernel builds it (hopper.cuh desc_k128 /
    desc_mn128), decoded back to byte offsets."""
    d = ((start & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16) \
        | ((sbo >> 4) << 32) | (1 << 62)
    assert d >> 62 == 1   # the 128-byte swizzle
    return ((d & 0x3FFF) << 4, ((d >> 16) & 0x3FFF) << 4,
            ((d >> 32) & 0x3FFF) << 4)


def read_a(smem, start):
    """wgmma's A, 64 x 16, K-major with the 128-byte swizzle: element (m, k)
    at start + (m // 8) * SBO + (m % 8) * 128 + 2k, swizzled; SBO 1024 (the
    leading offset is unused for this layout)."""
    start, _, sbo = desc_fields(start, 16, 1024)
    m = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    addr = start + (m // 8) * sbo + (m % 8) * ROW + 2 * k
    return smem[swizzle(addr) // 2]


def read_b(smem, start, bn, lbo):
    """wgmma's B, 16 x BN, MN-major with the 128-byte swizzle (read through
    the transpose immediate): element (k, n) at start + (n // 64) * LBO +
    (k // 8) * SBO + (k % 8) * 128 + 2 (n % 64), swizzled; LBO steps 64-wide
    blocks along N, SBO 8-row groups along K."""
    start, lbo, sbo = desc_fields(start, lbo, 1024)
    k = np.arange(16)[:, None]
    n = np.arange(bn)[None, :]
    addr = start + (n // 64) * lbo + (k // 8) * sbo + (k % 8) * ROW \
        + 2 * (n % 64)
    return smem[swizzle(addr) // 2]


def emulate(a, b, bias, act, q, *, per_partial=False, shift=0, drop=None):
    """The kernel over a plan ``q``: per block, per K step, a stage filled
    by TMA or by ``fill_tile`` (both must give the same bytes), the products
    of each consumer warpgroup through the descriptors at k16 steps (A +32
    bytes, B +2048), float64 sums; the split's partials summed in order
    z = 0, 1, ..., then bias and the activation, rounded to float32.
    ``per_partial``, ``shift`` and ``drop`` plant faults: bias and the
    activation on each partial, a swizzle one chunk off, a partial left
    out."""
    m, n = q["M"], q["N"]
    bm, bn = q["BM"], q["BN"]
    a_bytes = bm * ROW
    parts = np.zeros((q["split"], m, n))
    for m0, n0, k0, ks in zip(*tiles_of(q)):
        z = k0 // q["kps"] if q["kps"] else 0
        acc = np.zeros((bm, bn))
        for i in range(ks):
            kk0 = (k0 + i) * kg.KB
            # the stage at a 1024-aligned base: A [BM, 64], then BN/64 B
            # boxes [64, 64]
            sa = tma_box(a, m0, kk0, bm, shift)
            sb = np.concatenate([tma_box(b, kk0, n0 + 64 * nb, kg.KB, shift)
                                 for nb in range(bn // 64)])
            if q["fill_a"]:
                assert np.array_equal(fill_tile(a, m0, kk0, bm, 1), sa)
            if q["fill_b"]:
                assert np.array_equal(
                    fill_tile(b, kk0, n0, kg.KB, bn // 64), sb)
            smem = np.concatenate([sa, sb])
            for wg in range(bm // 64):
                for k16 in range(kg.KB // 16):
                    ta = read_a(smem, wg * 64 * ROW + 32 * k16)
                    tb = read_b(smem, a_bytes + 2048 * k16, bn, kg.KB * ROW)
                    acc[wg * 64:(wg + 1) * 64] += ta @ tb
        rows, cols = min(bm, m - m0), min(bn, n - n0)
        parts[z, m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    if per_partial:
        parts = _epilogue(parts, bias, act)
    if drop is not None:
        parts[drop] = 0
    out = parts[0].copy()
    for z in range(1, q["split"]):
        out += parts[z]
    if not per_partial:
        out = _epilogue(out, bias, act)
    return out.astype(np.float32)


def _epilogue(x, bias, act):
    if bias is not None:
        x = x + bias
    if act == "silu":
        x = x / (1 + np.exp(-x))
    elif act == "relu":
        x = np.maximum(x, 0)
    elif act == "gelu":
        x = 0.5 * x * (1 + np.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3)))
    return x


# (name, M, K, N, act, bias, sms, a_align, b_align): small shapes whose
# plans reach every path: one and two consumer warpgroups, every BN, a split
# over K, ragged M/N/K, A and B filled, bias and each activation
EMULATED = [
    ("M 4 decode, split", 4, 2000, 200, None, False, 8, 16, 16),
    ("M 70, two warpgroups, silu + bias, split", 70, 2000, 96, "silu", True,
     8, 16, 16),
    ("K 27: A filled, relu", 150, 27, 72, "relu", True, 1, 16, 16),
    ("N 123: B filled, gelu, split", 5, 1200, 123, "gelu", True, 8, 16, 16),
    ("both filled (2-byte bases), M 1", 1, 136, 72, None, True, 8, 2, 2),
    ("wide tile, ragged M, N and K", 130, 104, 296, None, False, 1, 16, 16),
]


def _emulated_inputs(case, seed=0):
    name, m, k, n, act, bias, sms, a_al, b_al = case
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    bv = rng.normal(size=(n,)).astype(np.float32) if bias else None
    q = kg.plan(m, k, n, sms=sms, a_align=a_al, b_align=b_al)
    want = ref.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      bias=None if bv is None else torch.from_numpy(bv),
                      activation=act).numpy()
    return a, b, bv, act, q, want


@pytest.mark.parametrize("case", EMULATED, ids=[c[0] for c in EMULATED])
def test_emulated_kernel_matches_plain(case):
    a, b, bv, act, q, want = _emulated_inputs(case)
    got = emulate(a, b, bv, act, q)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_emulated_cases_reach_every_path():
    plans = [_emulated_inputs(c)[4] for c in EMULATED]
    assert {q["BM"] for q in plans} == {64, 128}
    assert {q["BN"] for q in plans} == {64, 128, 256}
    assert any(q["split"] > 1 for q in plans)
    assert any(q["fill_a"] for q in plans) and any(q["fill_b"] for q in plans)


@pytest.mark.parametrize("fault", ["bias and silu per partial", "silu per partial",
                                   "swizzle one chunk off",
                                   "one partial dropped"])
def test_emulated_faults_fail(fault):
    """What the kernel must not do shows: the activation (and bias) applied
    to each split's partial instead of to their sum, the swizzle one chunk
    off, a partial left out of the sum."""
    case = EMULATED[1] if "bias" in fault or "dropped" in fault else (
        EMULATED[3] if "partial" in fault else EMULATED[5])
    a, b, bv, act, q, want = _emulated_inputs(case)
    if fault == "silu per partial":
        act = "silu"
        want = ref.matmul(torch.from_numpy(a), torch.from_numpy(b),
                          bias=torch.from_numpy(bv), activation="silu").numpy()
    assert q["split"] > 1 or "swizzle" in fault
    kw = {"bias and silu per partial": dict(per_partial=True),
          "silu per partial": dict(per_partial=True),
          "swizzle one chunk off": dict(shift=1),
          "one partial dropped": dict(drop=q["split"] - 1)}[fault]
    got = emulate(a, b, bv, act, q, **kw)
    np.testing.assert_allclose(emulate(a, b, bv, act, q), want, rtol=1e-4,
                               atol=1e-4)
    assert np.abs(got - want).max() > 1e-2


def test_b_chunks_hold_the_elements_wgmma_reads():
    """Which element each 16-byte chunk of a B stage holds: row k of a
    [64, 64] box at 128 k, its 8-column group g at chunk g ^ (k % 8); and the
    MN-major descriptor's reads at each k16 step land on those chunks."""
    k_, n_ = 64, 256
    b = np.arange(k_ * n_, dtype=np.int64).reshape(k_, n_)
    smem = np.concatenate([tma_box(b, 0, 64 * nb, 64) for nb in range(4)])
    for nb in range(4):
        for k in range(64):
            for g in range(8):
                at = nb * 64 * 64 + k * 64 + (g ^ (k % 8)) * 8
                assert list(smem[at:at + 8]) == list(
                    b[k, 64 * nb + 8 * g:64 * nb + 8 * g + 8])
    for k16 in range(4):
        assert np.array_equal(read_b(smem, 2048 * k16, n_, 64 * ROW),
                              b[16 * k16:16 * k16 + 16])


def test_plan_fields_match_the_kernel_source():
    """``PLAN_FIELDS`` is the order of ``KRAKEN_GEMM_PLAN`` in the .cu, the
    list struct Plan and the library's reported names are made from."""
    src = (ROOT / "src/repro_torch/csrc/kraken_gemm.cu").read_text()
    m = re.search(r"#define KRAKEN_GEMM_PLAN\(X\)((?:.*\\\n)*.*\n)", src)
    assert m, "KRAKEN_GEMM_PLAN not found"
    assert tuple(re.findall(r"X\((\w+)\)", m.group(1))) == kg.PLAN_FIELDS
    assert "struct Plan {\n  KRAKEN_GEMM_PLAN(PLAN_DECL)\n};" in src
