"""The bf16 ``kraken_conv2d_direct`` kernel's plan and index arithmetic, on
the CPU (the kernel itself has no CPU mode).

* :func:`repro_torch.kernels.kraken_conv.plan` for every conv geometry of
  ``conv_cases.conv_geometries()`` at batch 1 and 32 and every edge case of
  :mod:`repro_torch.core.conv_cases` (the shapes ``chip_smoke.py`` runs on
  the card): the plan fits the card's 227 KB of shared
  memory, its tiles cover every output element exactly once (once per
  split), it splits C_i only when the unsplit tiles leave SMs of the H100's
  132 idle, and VGG-16 conv4_2 and conv5_1 at batch 1 fill every SM.
* A numpy emulation of ``csrc/kraken_conv.cu``'s addressing, held against
  ``ref.conv2d`` at small sizes: the weights' K-major copy; the band as TMA
  lays it down, 128-byte swizzle included, at the band box's signed
  coordinates, or as the filler warps' 2-byte loads write it where TMA
  cannot take the rows; the row each ldmatrix lane reads at tap (kh, kw),
  or, with C_i packed into k, the pairs each lane loads (zeros past
  K_W*C_i, so that an Inf outside an output's window stays out of it); the
  wgmma fragment layouts of A and of the accumulator; the split's chunk
  ranges and the fixed-order sum of its partials.  Strides 1, 2 and 4,
  asymmetric padding, C_i 3 packed, ragged and odd C_i, ragged C_o,
  several images per tile and a split over C_i.  Products and sums are
  float64, so the tolerance (1e-4 on O(1) outputs) covers only
  ref.conv2d's float32 sums.
* The plan's field order: ``PLAN_FIELDS`` against the kernel source's
  ``KRAKEN_CONV_PLAN`` list (the library also reports it when loaded).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import conv_cases  # noqa: E402
from repro_torch.kernels import kraken_conv as kc  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

H100_SMS = 132


def _geometry_cases():
    cases = []
    for net, layer, h, w, ci, k, s, pad, co in conv_cases.conv_geometries():
        for n in conv_cases.CONV_BATCHES:
            cases.append((f"{net} {layer} b{n}", n, h, w, ci, k, s, pad, co,
                          conv_cases.CONV_R))
    for name, n, h, w, ci, k, s, pad, co, R, _ in conv_cases.CONV_EDGE:
        cases.append((f"edge {name}", n, h, w, ci, k, s, pad, co, R))
    for name, *rest in conv_cases.CONV_NONFINITE:
        cases.append((f"edge {name}", *rest))
    return cases


GEOMETRY_CASES = _geometry_cases()


def _plan(case, **kw):
    _, n, h, w, ci, k, s, pad, co, R = case
    return kc.plan((n, h, w, ci), (k, k, ci, co), stride=(s, s), padding=pad,
                   R=R, **kw)


def tile_at(p, t):
    """The kernel's ``tile_at``: split z, first image, first output row and
    column, first output channel of tile t (c_o tile fastest)."""
    mn = p["ptiles"] * p["ctiles"]
    rem = t % mn
    pt, ct = divmod(rem, p["ctiles"])
    group, pr = divmod(pt, p["rts"] * p["cts"])
    return (t // mn, group * p["G"], (pr // p["cts"]) * p["TR"],
            (pr % p["cts"]) * p["TC"], ct * p["BN"])


def slot_at(p, slot):
    """The kernel's ``slot_at`` over an array of slots: (g, r, c, in tile);
    slots past G x TR x TC read pixel (0, 0, 0)."""
    per = p["TR"] * p["TC"]
    g, rem = np.divmod(slot, per)
    r, c = np.divmod(rem, p["TC"])
    ok = g < p["G"]
    return np.where(ok, g, 0), np.where(ok, r, 0), np.where(ok, c, 0), ok


@pytest.mark.parametrize("case", GEOMETRY_CASES,
                         ids=[c[0] for c in GEOMETRY_CASES])
def test_plan_fits_and_covers(case):
    p = _plan(case)
    _, n, h, w, ci, k, s, pad, co, R = case
    oh, ow = p["OH"], p["OW"]
    assert p["path"] == 1 and p["smem"] <= kc.SMEM_MAX
    assert p["smem"] >= (p["NB"] * p["band_bytes"] + p["NW"] * p["BN"] * 128
                         + 1024 + 16 * (kc.NB_MAX + kc.NW_MAX))
    assert p["G"] * p["TR"] * p["TC"] <= kc.SLOTS
    assert p["BR"] == (p["TR"] - 1) * s + k and p["BW"] == (p["TC"] - 1) * s + k
    assert p["BR"] <= 256 and p["BW"] <= 256
    # TR is whole bands of R rows, cut at the image's bottom
    assert p["TR"] % R == 0 or p["TR"] == oh
    if p["packed"]:
        assert ci < 16 and k * ci <= kc.CK and p["nchunks"] == 1
        assert p["rowlen"] >= p["BW"] * ci + 16
    # every (output element, split) exactly once
    cover = np.zeros((p["split"], n, oh, ow, co), np.int32)
    slots = np.arange(kc.SLOTS)
    g, r, c, ok = slot_at(p, slots)
    for t in range(p["tiles"]):
        z, n0, oh0, ow0, co0 = tile_at(p, t)
        nn, hh, ww = n0 + g, oh0 + r, ow0 + c
        live = ok & (nn < n) & (hh < oh) & (ww < ow)
        cos = np.arange(co0, min(co0 + p["BN"], co))
        for i in np.nonzero(live)[0]:
            cover[z, nn[i], hh[i], ww[i], cos] += 1
    assert (cover == 1).all()
    # the split: only when the unsplit tiles leave SMs idle, chunks of
    # every split non-empty and all of C_i summed once
    unsplit = p["ptiles"] * p["ctiles"]
    if p["split"] > 1:
        assert unsplit < kc.SMS
    chunks = [list(range(z * p["cps"], min(p["nchunks"], (z + 1) * p["cps"])))
              for z in range(p["split"])]
    assert all(chunks) and sum(chunks, []) == list(range(p["nchunks"]))
    assert p["grid"] == min(p["tiles"], kc.SMS)


@pytest.mark.parametrize("layer", ["conv4_2", "conv5_1"])
def test_vgg_deep_layers_fill_the_card_at_batch_1(layer):
    geo = {g[1]: g for g in conv_cases.conv_geometries() if g[0] == "vgg16"}
    _, _, h, w, ci, k, s, pad, co = geo[layer]
    p = kc.plan((1, h, w, ci), (k, k, ci, co), stride=(s, s), padding=pad,
                R=conv_cases.CONV_R, sms=H100_SMS)
    assert p["split"] > 1 and p["tiles"] >= H100_SMS
    assert p["grid"] == H100_SMS


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="R = 17"):
        kc.plan((1, 8, 8, 4), (3, 3, 4, 8), R=17)
    with pytest.raises(ValueError, match="TMA box"):   # a 1-row band > 256
        kc.plan((1, 600, 600, 16), (300, 300, 16, 8), R=1)


def test_float32_plan_is_the_fma_kernel():
    p = kc.plan((1, 28, 28, 64), (3, 3, 64, 64), padding=((1, 1), (1, 1)),
                dtype=torch.float32)
    assert p["path"] == 0 and p["ck"] == 32 and p["khs"] == 3
    assert p["smem"] <= 100 * 1024 and p["L"] == 4


# ---------------------------------------------------------------------------
# the numpy emulation of kraken_conv_kernel
# ---------------------------------------------------------------------------

def _weights_kmajor(k, p):
    """kraken_conv_weights: HWIO as [taps][J][C_o] -> [taps][C_o][kcp]."""
    taps, kcp = p["taps"], p["kcp"]
    j = k.shape[2] * (k.shape[1] if p["packed"] else 1)
    wt = np.zeros((taps, k.shape[3], kcp))
    wt[:, :, :j] = k.reshape(taps, j, k.shape[3]).transpose(0, 2, 1)
    return wt


def _swz(q, chunk):
    """Element offset of 16-byte chunk ``chunk`` of 128-byte row ``q``."""
    return q * 64 + ((chunk ^ (q & 7)) << 3)


def _fill_ld2(stage, x, p, n0, ih0, iw0, chunk):
    """``fill_band``'s unpacked loop, where TMA cannot take the rows: every
    (image, band pixel, channel pair) as one 4-byte store of two 2-byte
    loads, at the byte address the kernel computes."""
    n_img, h, w, ci = x.shape
    nimg = min(p["G"], n_img - n0)
    per_img = p["BR"] * p["BW"] * 32
    gi, v = np.divmod(np.arange(nimg * per_img), per_img)
    q, jp = v >> 5, v & 31
    br, bc = np.divmod(q, p["BW"])
    ih, iw, ch = ih0 + br, iw0 + bc, chunk * kc.CK + 2 * jp
    inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
    src = x[n0 + gi, np.clip(ih, 0, h - 1), np.clip(iw, 0, w - 1)]
    dst = (gi * p["img_bytes"] + q * 128 + (((jp >> 2) ^ (q & 7)) << 4)
           + (jp & 3) * 4) // 2
    every = np.arange(len(ch))
    for d in (0, 1):
        c = ch + d
        val = src[every, np.minimum(c, ci - 1)]
        stage[dst + d] = np.where(inside & (c < ci), val, 0.0)


def _band(x, p, n0, oh0, ow0, chunk):
    """One band stage as the kernel's loads lay it down (elements of 2
    bytes): per image a TMA box [1, BR, BW, 64] of x at signed coordinates
    (ih0, iw0, c0) with zeros outside, each pixel a 128-byte row with the
    128-byte swizzle (the filler warps' stores where TMA cannot take the
    rows); packed, whole input rows of rowlen elements."""
    n_img, h, w, ci = x.shape
    ih0, iw0 = oh0 * p["S_H"] - p["pt"], ow0 * p["S_W"] - p["pl"]
    stage = np.full(p["band_bytes"] // 2, np.nan)   # unfilled reads poison
    if not p["packed"] and p["band_mode"] == kc.BAND_LD2:
        _fill_ld2(stage, x, p, n0, ih0, iw0, chunk)
        return stage
    xp = np.zeros((h + 2 * p["BR"], w + 2 * p["BW"] + p["rowlen"], ci))
    for gi in range(min(p["G"], n_img - n0)):
        base = gi * p["img_bytes"] // 2
        xp[p["BR"]:p["BR"] + h, p["BW"]:p["BW"] + w] = x[n0 + gi]
        br = np.arange(p["BR"])[:, None]
        rows = xp[p["BR"] + ih0 + br[:, 0]]            # [BR, W', C_i]
        if p["packed"]:
            e = np.arange(p["rowlen"])[None, :]
            col, ch = np.divmod(e, ci)
            val = np.where(col < p["BW"],
                           rows[br, p["BW"] + iw0 + np.minimum(col, p["BW"]),
                                ch], 0.0)
            stage[base + br * p["rowlen"] + e] = val
            continue
        bc = np.arange(p["BW"])[None, :, None]
        ch = np.arange(kc.CK)[None, None, :]
        c = chunk * kc.CK + ch
        val = np.where(c < ci, rows[br[:, :, None], p["BW"] + iw0 + bc,
                                    np.minimum(c, ci - 1)], 0.0)
        q = br[:, :, None] * p["BW"] + bc
        stage[base + _swz(q, ch >> 3) + (ch & 7)] = val
    return stage


def _weight_stage(wt, p, chunk, co0, tap):
    """The TMA box [BN, 64] of the K-major weights, zeros outside, laid down
    with the 128-byte swizzle and read back through the wgmma descriptor
    (K-major): B [64, BN]."""
    bn = p["BN"]
    c0 = 0 if p["packed"] else chunk * kc.CK
    box = np.zeros((bn, kc.CK))
    blk = wt[tap, co0:co0 + bn, c0:c0 + kc.CK]
    box[:blk.shape[0], :blk.shape[1]] = blk
    nrow = np.arange(bn)[:, None]
    kk = np.arange(kc.CK)[None, :]
    at = _swz(nrow, kk >> 3) + (kk & 7)
    smem = np.zeros(bn * kc.CK)
    smem[at] = box
    return smem[at].T


def _a_tile(stage, p, tap, ks, mask_tail=True):
    """The 128 x 16ks A operand the two consumer warpgroups hand wgmma at
    this tap, built lane by lane from the kernel's addresses (packed: the
    elements at or past K_W*C_i read as zeros unless ``mask_tail`` is
    false)."""
    a = np.full((kc.SLOTS, 16 * ks), np.nan)
    tid = np.arange(256)
    wg, warp, lane = tid >> 7, (tid >> 5) & 3, tid & 31
    row0 = wg * 64 + warp * 16
    s_h, s_w, bw = p["S_H"], p["S_W"], p["BW"]
    if not p["packed"]:
        # ldmatrix.x4: lane l gives the address of row l % 8 of matrix
        # l // 8; matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) of the warp's
        # 16 x 16 A fragment
        g, r, c, _ = slot_at(p, row0 + (lane & 15))
        kh, kw = divmod(tap, p["K_W"])
        q = (r * s_h + kh) * bw + c * s_w + kw
        rows = row0 + (lane >> 3 & 1) * 8 + (lane & 7)
        for s in range(ks):
            off = g * p["img_bytes"] // 2 + _swz(q, (2 * s) | (lane >> 4))
            for e in range(8):
                a[rows, 16 * s + (lane >> 4) * 8 + e] = stage[off + e]
        return a
    # packed: the mma A fragment, pairs (j, j+1) of rows lane/4 and
    # lane/4 + 8 at j = 16s + 2(lane % 4) and j + 8
    kwc = p["K_W"] * p["C_i"] if mask_tail else 16 * ks
    for rows in (row0 + (lane >> 2), row0 + (lane >> 2) + 8):
        g, r, c, _ = slot_at(p, rows)
        e0 = (g * p["img_bytes"] // 2 + (r * s_h + tap) * p["rowlen"]
              + c * s_w * p["C_i"])
        for s in range(ks):
            for dj in (0, 1, 8, 9):
                j = 16 * s + 2 * (lane & 3) + dj
                a[rows, j] = np.where(j < kwc, stage[e0 + j], 0.0)
    return a


def emulate(x, k, p, mask_tail=True):
    """kraken_conv_kernel (+ kraken_conv_reduce) on numpy arrays."""
    n, oh, ow, co = x.shape[0], p["OH"], p["OW"], k.shape[3]
    wt = _weights_kmajor(k, p)
    part = np.zeros((p["split"], n, oh, ow, co))
    g, r, c, ok = slot_at(p, np.arange(kc.SLOTS))
    for t in range(p["tiles"]):
        z, n0, oh0, ow0, co0 = tile_at(p, t)
        acc = np.zeros((kc.SLOTS, p["BN"]))
        for chunk in range(z * p["cps"], min(p["nchunks"], (z + 1) * p["cps"])):
            ks = (-(-p["K_W"] * p["C_i"] // 16) if p["packed"] else
                  min(4, -(-(p["C_i"] - chunk * kc.CK) // 16)))
            stage = _band(x, p, n0, oh0, ow0, chunk)
            for tap in range(p["taps"]):
                a = _a_tile(stage, p, tap, ks, mask_tail)
                b = _weight_stage(wt, p, chunk, co0, tap)[:16 * ks]
                acc += a @ b    # a row that is NaN is never written
        # epilogue: slot (g, r, c) -> output pixel, masked to [OH, OW, C_o]
        for i in np.nonzero(ok)[0]:
            nn, hh, ww = n0 + g[i], oh0 + r[i], ow0 + c[i]
            if nn < n and hh < oh and ww < ow:
                m = min(p["BN"], co - co0)
                part[z, nn, hh, ww, co0:co0 + m] = acc[i, :m]
    out = part[0].copy()
    for z in range(1, p["split"]):      # kraken_conv_reduce's order
        out += part[z]
    return out


EMULATED = [
    # (name, N, H, W, C_i, K, S, padding, C_o, R); the plans are for the
    # H100's 132 SMs unless the name gives another count
    ("3x3 S1, ragged C_o", 2, 9, 9, 16, 3, 1, ((1, 1), (1, 1)), 24, 7),
    ("3x3 S2, (H + pads - K) % S", 1, 10, 9, 24, 3, 2, ((1, 1), (1, 1)), 40,
     3),
    ("K11 S4, C_i 3 packed", 1, 27, 23, 3, 11, 4, ((0, 0), (0, 0)), 20, 2),
    ("K3 S1, C_i 3 packed", 2, 8, 10, 3, 3, 1, ((1, 1), (1, 1)), 16, 1),
    ("K7 S2, C_i 4 packed, R 16", 1, 12, 12, 4, 7, 2, ((3, 3), (3, 3)), 8,
     16),
    ("asymmetric padding K5 S3", 1, 11, 10, 24, 5, 3, ((1, 2), (0, 1)), 16,
     3),
    ("C_i 100 ragged, split, 2-byte fill", 1, 5, 5, 100, 3, 1,
     ((1, 1), (1, 1)), 72, 7),
    ("C_i 19 odd, 2-byte fill", 2, 6, 7, 19, 3, 1, ((1, 1), (1, 1)), 24, 7),
    ("7x7 maps, N 3, split", 3, 4, 4, 160, 3, 1, ((1, 1), (1, 1)), 16, 7),
    ("1x1, several images a tile", 5, 3, 3, 32, 1, 1, ((0, 0), (0, 0)), 136,
     7),
    ("3x3, c_o tile 128 on 4 SMs", 2, 6, 7, 72, 3, 1, ((1, 1), (1, 1)), 136,
     7),
]


def _sms(name):
    return 4 if "on 4 SMs" in name else H100_SMS


@pytest.mark.parametrize("case", EMULATED, ids=[c[0] for c in EMULATED])
def test_emulated_kernel_matches_plain(case):
    name, n, h, w, ci, k, s, pad, co, R = case
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(n, h, w, ci))
    wk = rng.normal(size=(k, k, ci, co)) / np.sqrt(k * k * ci)
    p = kc.plan(x.shape, wk.shape, stride=(s, s), padding=pad, R=R,
                sms=_sms(name))
    got = emulate(x, wk, p)
    want = ref.conv2d(torch.from_numpy(x).float(),
                      torch.from_numpy(wk).float(), stride=(s, s),
                      padding=pad).double().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_emulated_cases_reach_every_path():
    """The emulated cases cover the packed and the unpacked band, both
    unpacked fills (TMA and the filler warps' stores, at an even and an odd
    C_i), both c_o tiles, several images per tile and a split."""
    plans = [_plan(c, sms=_sms(c[0])) for c in EMULATED]
    assert {p["packed"] for p in plans} == {0, 1}
    ld2 = [p["C_i"] % 2 for p in plans
           if not p["packed"] and p["band_mode"] == kc.BAND_LD2]
    assert set(ld2) == {0, 1}
    assert {p["band_mode"] for p in plans if not p["packed"]} == {
        kc.BAND_TMA, kc.BAND_LD2}
    assert {p["BN"] for p in plans} == {64, 128}
    assert max(p["G"] for p in plans) > 1
    assert max(p["split"] for p in plans) > 1
    assert {c[6] for c in EMULATED} >= {1, 2, 4}


INF_CASES = [
    # (name, N, H, W, C_i, K, S, padding, C_o, R): conv_cases.CONV_NONFINITE
    # at small sizes
    ("C_i 3 packed, K 3 S 1", 1, 9, 11, 3, 3, 1, ((1, 1), (1, 1)), 16, 7),
    ("C_i 3 packed, K 11 S 4", 1, 27, 27, 3, 11, 4, ((0, 0), (0, 0)), 8, 2),
    ("C_i 24, K 3 S 1", 1, 7, 7, 24, 3, 1, ((1, 1), (1, 1)), 16, 7),
]


@pytest.mark.parametrize("case", INF_CASES, ids=[c[0] for c in INF_CASES])
def test_emulated_inf_stays_in_its_window(case):
    """An Inf at x[0, H // 2, W // 2, 0] makes exactly the outputs whose
    window holds it non-finite, as in ref.conv2d; the rest match.  Packed,
    the lanes also load the next pixels' elements (under zero weights): the
    same emulation without the kernel's zeros past K_W*C_i spreads the Inf
    beyond the window."""
    name, n, h, w, ci, k, s, pad, co, R = case
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(n, h, w, ci))
    x[0, h // 2, w // 2, 0] = np.inf
    wk = rng.normal(size=(k, k, ci, co)) / np.sqrt(k * k * ci)
    # on 4 SMs: tiles wide enough that a lane reads the Inf past its window
    p = kc.plan(x.shape, wk.shape, stride=(s, s), padding=pad, R=R, sms=4)
    with np.errstate(invalid="ignore"):
        got = emulate(x, wk, p)
        want = ref.conv2d(torch.from_numpy(x).float(),
                          torch.from_numpy(wk).float(), stride=(s, s),
                          padding=pad).double().numpy()
        fin = np.isfinite(want)
        assert 0 < (~fin).sum() < fin.size
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], atol=1e-4, rtol=1e-4)
        if p["packed"]:
            unmasked = emulate(x, wk, p, mask_tail=False)
            assert (~np.isfinite(unmasked)).sum() > (~fin).sum()


def _tail_reads(p, h_inf, w_inf):
    """Packed: how many outputs have a lane that loads element 0 of input
    pixel (h_inf, w_inf) from its tile's band past its own window (at
    element K_W*C_i or later of its 16*ceil(K_W*C_i/16))."""
    ci, kwc = p["C_i"], p["K_W"] * p["C_i"]
    span = 16 * -(-kwc // 16)
    rows = sum(0 <= h_inf - (oh * p["S_H"] - p["pt"]) < p["K_H"]
               for oh in range(p["OH"]))
    hits = 0
    for ow0 in range(0, p["OW"], p["TC"]):
        col = w_inf - (ow0 * p["S_W"] - p["pl"])
        if not 0 <= col < p["BW"]:
            continue
        for c in range(min(p["TC"], p["OW"] - ow0)):
            hits += rows * (kwc <= col * ci - c * p["S_W"] * ci < span)
    return hits


@pytest.mark.parametrize(
    "case", [c for c in conv_cases.CONV_NONFINITE if c[4] < 16],
    ids=[c[0] for c in conv_cases.CONV_NONFINITE if c[4] < 16])
def test_card_inf_cases_put_the_inf_past_a_window(case):
    """The card's packed Inf cases, as planned for the H100, have outputs
    whose lanes load the Inf under zero weights: without the kernel's
    zeros past K_W*C_i those outputs would not be finite."""
    name, n, h, w, ci, k, s, pad, co, R = case
    p = kc.plan((n, h, w, ci), (k, k, ci, co), stride=(s, s), padding=pad,
                R=R, sms=H100_SMS)
    assert p["packed"] and _tail_reads(p, h // 2, w // 2) > 0


def test_plan_fields_match_the_kernel_source():
    """``PLAN_FIELDS`` is the order of ``KRAKEN_CONV_PLAN`` in the .cu, the
    list struct Plan and the library's reported names are made from."""
    src = (ROOT / "src/repro_torch/csrc/kraken_conv.cu").read_text()
    m = re.search(r"#define KRAKEN_CONV_PLAN\(X\)((?:.*\\\n)*.*\n)", src)
    assert m, "KRAKEN_CONV_PLAN not found"
    assert tuple(re.findall(r"X\((\w+)\)", m.group(1))) == kc.PLAN_FIELDS
    assert "struct Plan {\n  KRAKEN_CONV_PLAN(PLAN_DECL)\n};" in src
