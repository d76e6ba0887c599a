"""The plans of the ``decode_attention`` and bf16 ``swa_attention`` kernels
and their arithmetic, on the CPU (the kernels themselves have no CPU mode).

* :func:`repro_torch.kernels.decode_attention.plan` for every shape of
  :mod:`repro_torch.core.attention_cases` (which ``chip_smoke.py`` runs on
  the card) and for yi-6b, yi-9b, gemma3-12b and mixtral-8x22b at 1, 4 and
  64 serving slots: the block fits the card's 227 KB of shared memory, the
  splits cover every cache entry exactly once in order, the sequence is not
  split once ``B * KV`` fills the H100's 132 SMs, and otherwise the grid
  reaches 132 blocks or one tile a split.
* :func:`repro_torch.kernels.swa_attention.plan` and
  :func:`~repro_torch.kernels.swa_attention.tile_walk` for every swa shape
  there and gemma3-12b's and mixtral's forward shapes: the block fits
  227 KB, the tile walk takes every in-window (query, key) pair exactly
  once, takes no kv tile without one, and evaluates the mask on exactly the
  tiles that cross the diagonal or the window's edge.
* Numpy emulations of the kernels' arithmetic, held against the plain
  version and against JAX: the split walk with its online softmax and the
  fixed-order combine (wrapped rings, a window, a ragged S, shared
  positions, int8, an all-empty row that must be exact zeros, chunks with
  no live entry) against ``ref.decode_attention`` and
  ``repro.kernels.ref.decode_attention``; the bf16 swa tile walk (the
  scores in log2 units, p rounded to bf16 for the PV product, l summed
  unrounded) against ``ref.sliding_window_attention`` and JAX's Pallas
  ``swa_attention`` in interpret mode, under ``SWA_TOL``'s per-row atol.
  A dropped split, a combine without the ``e^(m_s - M)`` rescale, a dead
  chunk that writes ``m = 0`` and a kv tile skipped at the window's edge
  must each fail.
* The plans' field order: each ``PLAN_FIELDS`` against the kernel source's
  list (``DECODE_ATTENTION_PLAN``, ``SWA_ATTENTION_PLAN``,
  ``PAGED_ATTENTION_PLAN``), which the libraries also report when loaded.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import attention_cases as ac  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import swa_attention as sw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

H100_SMS = 132
SMEM_MAX = 227 * 1024
POS_EMPTY = -(2 ** 30)
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# decode_attention: plans
# ---------------------------------------------------------------------------

def _decode_shapes():
    out = []
    h, kv, d, s = (ac.DENSE_HEADS, ac.DENSE_KV_HEADS, ac.DENSE_HEAD_DIM,
                   ac.DENSE_LEN)
    for cs, _, _, _ in ac.DENSE_CASES:
        out.append((f"dense case S {cs}", len(ac.DENSE_Q_POS), h, kv, cs, d))
    out.append(("dense_serve one slot", 1, h, kv, s, d))
    out += [(name, b, hh, kk, ss, dd)
            for name, b, hh, kk, ss, dd in ac.DECODE_SPLIT_CASES]
    for arch in ("yi-6b", "yi-9b", "gemma3-12b", "mixtral-8x22b"):
        cfg = get_arch(arch)
        for slots in (1, 4, 64):
            out.append((f"{arch} {slots} slots", slots, cfg.num_heads,
                        cfg.num_kv_heads, s, cfg.head_dim))
    out.append(("S 0", 1, 8, 2, 0, 64))
    out.append(("one ragged tile", 2, 8, 2, 7, 40))
    return out


@pytest.mark.parametrize("case", _decode_shapes(), ids=lambda c: c[0])
def test_decode_plan_covers_every_entry_once(case):
    _, b, h, kv, s, d = case
    q = dec.plan(b, h, kv, s, d, sms=H100_SMS)
    assert q["smem"] <= SMEM_MAX and q["smem"] == dec.smem_bytes(h // kv, d)
    assert q["G"] == h // kv and q["blocks"] == b * kv * q["splits"]
    chunks = dec.chunks(q)
    seen = [j for lo, hi in chunks for j in range(lo, hi)]
    assert seen == list(range(s))                    # each entry once, in order
    assert all(hi > lo for lo, hi in chunks) or s == 0   # no split is empty
    base, ntiles = b * kv, math.ceil(s / dec.TILE)
    if base >= H100_SMS:
        assert q["splits"] == 1
    else:
        assert q["blocks"] >= min(H100_SMS, base * ntiles)
    assert q["tps"] * q["splits"] >= ntiles


def test_decode_plan_at_dense_serve_shape():
    """One slot of yi-6b's int8 cache: 16 splits of one tile, 64 blocks
    (the first design ran 4)."""
    q = dec.plan(1, ac.DENSE_HEADS, ac.DENSE_KV_HEADS, ac.DENSE_LEN,
                 ac.DENSE_HEAD_DIM, torch.int8)
    assert (q["splits"], q["tps"], q["blocks"]) == (16, 1, 64)
    assert q["blocks"] > ac.DENSE_KV_HEADS


@pytest.mark.parametrize("bad", [dict(h=6, kv=4), dict(d=0), dict(s=-1),
                                 dict(dtype=torch.float16),
                                 dict(h=256, kv=1, d=256)])
def test_decode_plan_refuses(bad):
    kw = dict(b=1, h=8, kv=2, s=64, d=64, dtype=torch.int8)
    kw.update(bad)
    with pytest.raises(ValueError):
        dec.plan(kw["b"], kw["h"], kw["kv"], kw["s"], kw["d"], kw["dtype"])


# ---------------------------------------------------------------------------
# decode_attention: the kernel's arithmetic in numpy
# ---------------------------------------------------------------------------

def emulate_decode(q, k, v, ks, vs, kv_pos, q_pos, window, pl, *,
                   fault=None):
    """decode_attention.cu in numpy: block (b, kv head, split z) walks the
    32-entry tiles of its chunk (a tile with no live entry is skipped
    unread), scores each live entry in fp32, updates (m, l, acc) online;
    the combine reads the splits in order z = 0, 1, ...  ``fault``: "drop"
    leaves the last split out of the combine, "no_rescale" combines without
    the e^(m_z - M) weights, "dead_m0" has a split with no live entry write
    m = 0."""
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    scale = np.float32(1.0 / math.sqrt(d))
    pos = kv_pos if kv_pos.ndim == 2 else np.broadcast_to(kv_pos, (b, s))
    qp = np.broadcast_to(np.asarray(q_pos).reshape(-1), (b,))
    splits = pl["splits"]
    part = np.zeros((b, h, splits, d + 2), np.float32)
    for bi in range(b):
        live_all = (pos[bi] >= 0) & (pos[bi] <= qp[bi])
        if window:
            live_all &= pos[bi] > qp[bi] - window
        for hk in range(kvh):
            rows = q[bi, hk * g:(hk + 1) * g].astype(np.float32)
            kf = k[bi, hk].astype(np.float32)
            vf = v[bi, hk].astype(np.float32)
            if ks is not None:
                kf = kf * ks[bi, hk][:, None]
                vf = vf * vs[bi, hk][:, None]
            for z, (lo, hi) in enumerate(dec.chunks(pl)):
                m = np.full(g, -1e30, np.float32)
                lsum = np.zeros(g, np.float32)
                acc = np.zeros((g, d), np.float32)
                for t0 in range(lo, hi, dec.TILE):
                    idx = np.arange(t0, min(hi, t0 + dec.TILE))
                    live = live_all[idx]
                    if not live.any():
                        continue
                    sc = (rows @ kf[idx].T) * scale
                    sc = np.where(live[None], sc, np.float32(-1e30))
                    m_new = np.maximum(m, sc.max(axis=1))
                    p = np.where(live[None], np.exp(sc - m_new[:, None]), 0)
                    alpha = np.exp(m - m_new)
                    lsum = lsum * alpha + p.sum(axis=1)
                    acc = acc * alpha[:, None] + p @ vf[idx]
                    m = m_new
                if fault == "dead_m0" and not live_all[lo:hi].any():
                    m = np.zeros(g, np.float32)
                part[bi, hk * g:(hk + 1) * g, z, 0] = m
                part[bi, hk * g:(hk + 1) * g, z, 1] = lsum
                part[bi, hk * g:(hk + 1) * g, z, 2:] = acc
    if fault == "drop":
        part = part[:, :, :-1]
    mx = part[..., 0].max(axis=2, keepdims=True)
    w = np.exp(part[..., 0] - mx)
    if fault == "no_rescale":
        w = np.ones_like(w)
    num = (w[..., None] * part[..., 2:]).sum(axis=2)
    den = (w * part[..., 1]).sum(axis=2)
    safe = np.where(den == 0, 1, den)
    return np.where(den[..., None] == 0, 0, num / safe[..., None]).astype(
        np.float32)


def dense_inputs(seed, *, b, h, kvh, s, d, q_pos, empty=(), shared=False,
                 quant=False, live_upto=None, shift=0.0):
    """A dense cache as decode leaves it: slot ``p % s`` holds position p
    for p <= q_pos[i] (a row whose q_pos passes s has wrapped its ring);
    ``empty`` rows hold nothing; ``live_upto`` keeps only slots below it
    written (the later chunks hold no live entry); ``shift`` moves every
    score by about -shift (a shared component of K against q), which the
    softmax cancels.  Returns (q, k, v, k_scale, v_scale, kv_pos)."""
    rng = np.random.default_rng(seed)
    pos = np.full((b, s), POS_EMPTY, np.int32)
    for i in range(b):
        if i in empty:
            continue
        for p in range(q_pos[i] + 1):
            if live_upto is None or p % s < live_upto:
                pos[i, p % s] = p
    if shared:
        pos = pos[0]
    shape = (b, kvh, s, d)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) / 127).astype(np.float32)
        vs = (rng.random(shape[:3]) / 127).astype(np.float32)
        return q, k, v, ks, vs, pos
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    if shift:
        # q's first coordinate -b against K's +8: every score moves by
        # -8 b / sqrt(d) = -shift, exactly
        k[..., 0] = 8.0
        q[..., 0] = -shift * math.sqrt(d) / 8.0
    return q, k, v, None, None, pos


# (name, b, h, kv, s, d, q_pos, empty, shared, quant, window, live_upto,
# shift)
DECODE_EMU = [
    ("wrapped ring, empty row", 4, 8, 2, 300, 32, [120, 700, 50, 299], {2},
     False, False, 0, None, 0.0),
    ("window 40", 4, 8, 2, 300, 32, [120, 700, 50, 299], {2}, False, False,
     40, None, 0.0),
    ("ragged S 261, int8", 3, 12, 2, 261, 16, [260, 400, 11], (), False,
     True, 0, None, 0.0),
    ("shared positions, int8 window", 2, 4, 1, 200, 16, [199, 199], (), True,
     True, 33, None, 0.0),
    ("all rows empty", 2, 4, 2, 256, 16, [100, 100], {0, 1}, False, False, 0,
     None, 0.0),
    ("live only in the first chunk", 2, 8, 2, 320, 16, [319, 319], (), False,
     False, 0, 40, 0.0),
    ("dead chunks under shifted scores", 2, 8, 2, 320, 16, [319, 319], (),
     False, False, 0, 40, 120.0),
    ("one slot, yi-6b heads, int8", 1, 32, 4, 512, 128, [300], (), False,
     True, 0, None, 0.0),
]


def _decode_case(case):
    (name, b, h, kvh, s, d, q_pos, empty, shared, quant, window, live_upto,
     shift) = case
    q, k, v, ks, vs, pos = dense_inputs(
        len(name), b=b, h=h, kvh=kvh, s=s, d=d, q_pos=q_pos, empty=empty,
        shared=shared, quant=quant, live_upto=live_upto, shift=shift)
    qp = np.asarray(q_pos, np.int32)
    pl = dec.plan(b, h, kvh, s, d, torch.int8 if quant else torch.float32)
    return q, k, v, ks, vs, pos, qp, window, pl


def _plain(q, k, v, ks, vs, pos, qp, window):
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    return ref.decode_attention(t(q), t(k), t(v), kv_pos=t(pos), q_pos=t(qp),
                                k_scale=t(ks), v_scale=t(vs),
                                window=window).numpy()


@pytest.mark.parametrize("case", DECODE_EMU, ids=lambda c: c[0])
def test_decode_split_and_combine_match_ref_and_jax(case):
    q, k, v, ks, vs, pos, qp, window, pl = _decode_case(case)
    assert pl["splits"] > 1
    got = emulate_decode(q, k, v, ks, vs, pos, qp, window, pl)
    want = _plain(q, k, v, ks, vs, pos, qp, window)
    jw = np.asarray(jref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_pos=jnp.asarray(pos), q_pos=jnp.asarray(qp),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), window=window))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jw, rtol=1e-5, atol=1e-5)
    empty = case[7]
    for i in empty:                        # no live entry: exact zeros
        assert not got[i].any() and not want[i].any()


def test_decode_chunk_with_no_live_entry_is_skipped():
    """A split whose chunk holds no live entry ends with m = -1e30, l = 0
    and acc = 0 and weighs nothing in the combine."""
    case = next(c for c in DECODE_EMU if c[0] == "live only in the first "
                "chunk")
    q, k, v, ks, vs, pos, qp, window, pl = _decode_case(case)
    live_chunks = [z for z, (lo, hi) in enumerate(dec.chunks(pl))
                   if (pos[0, lo:hi] >= 0).any()]
    assert len(live_chunks) < pl["splits"]
    got = emulate_decode(q, k, v, ks, vs, pos, qp, window, pl)
    np.testing.assert_allclose(got, _plain(q, k, v, ks, vs, pos, qp, window),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fault, case_name", [
    ("drop", "wrapped ring, empty row"),
    ("no_rescale", "wrapped ring, empty row"),
    ("dead_m0", "dead chunks under shifted scores"),
])
def test_decode_faults_fail_the_emulation(fault, case_name):
    case = next(c for c in DECODE_EMU if c[0] == case_name)
    q, k, v, ks, vs, pos, qp, window, pl = _decode_case(case)
    want = _plain(q, k, v, ks, vs, pos, qp, window)
    np.testing.assert_allclose(
        emulate_decode(q, k, v, ks, vs, pos, qp, window, pl), want,
        rtol=1e-5, atol=1e-5)
    bad = emulate_decode(q, k, v, ks, vs, pos, qp, window, pl, fault=fault)
    assert not np.allclose(bad, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# swa_attention: plans and the tile walk
# ---------------------------------------------------------------------------

def _swa_shapes():
    out = [(name, b, h, kv, s, d, w)
           for name, b, h, kv, s, d, w, _ in ac.SWA_CASES]
    out += list(ac.SWA_EDGE)
    g = get_arch("gemma3-12b")
    m = get_arch("mixtral-8x22b")
    for s in (4096, 8192):
        out.append((f"gemma3-12b forward S {s}", 1, g.num_heads,
                    g.num_kv_heads, s, g.head_dim, g.local_window))
        out.append((f"mixtral-8x22b forward S {s}", 1, m.num_heads,
                    m.num_kv_heads, s, m.head_dim, m.sliding_window))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", _swa_shapes(), ids=lambda c: c[0])
def test_swa_plan_fits(case, dtype):
    _, b, h, kv, s, d, w = case
    q = sw.plan(b, h, kv, s, d, w, dtype)
    assert q["smem"] <= SMEM_MAX
    if dtype == torch.float32:
        assert q["path"] == sw.PATH_FMA and q["qtiles"] == math.ceil(s / 32)
        return
    assert q["path"] == sw.PATH_WGMMA
    assert q["DB"] in (1, 2, 4) and 64 * q["DB"] >= d > 32 * q["DB"] - 32
    assert 2 <= q["stages"] <= sw.STAGES_MAX
    stage = 2 * q["DB"] * sw.BKV * sw.ROW
    assert q["smem"] == q["DB"] * sw.BQ * sw.ROW + q["stages"] * stage \
        + sw.RESERVED
    assert q["blocks"] == math.ceil(s / sw.BQ) * b * h


def _walk_matrix(q, qt):
    """count[i, j] of (warpgroup, kv tile) pairs of q tile ``qt``'s walk
    that take row i against key j, and the masked flags checked against
    brute force."""
    s, w = q["S"], q["W"]
    q0 = qt * sw.BQ
    count = np.zeros((sw.BQ, s), np.int32)
    masked_ok = True
    union = set()
    for r0, tiles in sw.tile_walk(q, qt):
        rows = np.arange(r0, r0 + sw.WG_ROWS)[:, None]
        for kt, masked in tiles:
            union.add(kt)
            keys = np.arange(kt * sw.BKV, (kt + 1) * sw.BKV)[None, :]
            inside = (keys <= rows) & (keys > rows - w)
            masked_ok &= masked == bool((~inside).any())
            cols = keys[0][keys[0] < s]
            count[r0 - q0:r0 - q0 + sw.WG_ROWS, cols] += 1
            # no tile without an in-window pair of a row < S
            assert (inside & (rows < s))[:, :len(cols)].any()
    lo = max(0, q0 - w + 1) // sw.BKV
    hi = (min(s, q0 + sw.BQ) - 1) // sw.BKV
    assert union == set(range(lo, hi + 1))   # the ring's range, no more
    return count, masked_ok


@pytest.mark.parametrize("case", _swa_shapes(), ids=lambda c: c[0])
def test_swa_tile_walk_takes_every_window_pair_once(case):
    _, b, h, kv, s, d, w = case
    q = sw.plan(b, h, kv, s, d, w)
    for qt in range(q["qtiles"]):
        count, masked_ok = _walk_matrix(q, qt)
        i = np.arange(qt * sw.BQ, qt * sw.BQ + sw.BQ)[:, None]
        j = np.arange(s)[None, :]
        inside = (j <= i) & (j > i - w) & (i < s)
        assert (count[inside] == 1).all()
        assert masked_ok


# ---------------------------------------------------------------------------
# swa_attention: the bf16 kernel's arithmetic in numpy
# ---------------------------------------------------------------------------

def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def emulate_swa(q, k, v, window, *, fault=None):
    """swa_attention.cu's bf16 path in numpy on bf16-valued float32 inputs:
    the tile walk of :func:`tile_walk`, scores in log2 units, masked scores
    -inf on the tiles that evaluate the mask, the running max from -1e30,
    p = 2^(x - m) rounded to bf16 for the PV product while l sums it
    unrounded, out = acc / l rounded to bf16.  ``fault="skip_edge"`` leaves
    out each warpgroup's first kv tile when it lies at the window's edge."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    pl = sw.plan(b, h, kvh, s, d, window)
    scale = np.float32(LOG2E / math.sqrt(d))
    out = np.zeros_like(q)
    for bh in range(b * h):
        bi, hi = divmod(bh, h)
        kk = k[bi, hi // (h // kvh)]
        vv = v[bi, hi // (h // kvh)]
        for qt in range(pl["qtiles"]):
            for r0, tiles in sw.tile_walk(pl, qt):
                n = min(sw.WG_ROWS, s - r0)
                qr = q[bi, hi, r0:r0 + n]
                rows = np.arange(r0, r0 + n)[:, None]
                m = np.full(n, -1e30, np.float32)
                lsum = np.zeros(n, np.float32)
                acc = np.zeros((n, d), np.float32)
                if fault == "skip_edge" and tiles and tiles[0][0] > 0:
                    tiles = tiles[1:]
                for kt, masked in tiles:
                    k0 = kt * sw.BKV
                    keys = np.arange(k0, min(s, k0 + sw.BKV))
                    x = (qr @ kk[keys].T) * scale
                    if masked:
                        inside = (keys[None] <= rows) & (keys[None] > rows - window)
                        x = np.where(inside, x, -np.inf)
                    m_new = np.maximum(m, x.max(axis=1))
                    alpha = np.exp2(m - m_new)
                    p = np.exp2(x - m_new[:, None])
                    lsum = lsum * alpha + p.sum(axis=1)
                    acc = acc * alpha[:, None] + _bf16(p) @ vv[keys]
                    m = m_new
                out[bi, hi, r0:r0 + n] = acc / np.where(lsum == 0, 1,
                                                        lsum)[:, None]
    return _bf16(out)


def _swa_inputs(b, h, kvh, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(_bf16(rng.normal(size=shape)) for shape in
                 ((b, h, s, d), (b, kvh, s, d), (b, kvh, s, d)))


def _swa_within(got, want, s, window):
    """SWA_TOL in bf16 with its per-row atol (``chip_smoke.swa_atol``)."""
    atol, rtol = ac.SWA_TOL["bfloat16"]
    n = np.minimum(np.arange(s) + 1, window)
    row_atol = atol * np.sqrt(np.minimum(1.0, ac.SWA_ROW_KEYS / n))
    return bool((np.abs(got - want)
                 <= row_atol[:, None] + rtol * np.abs(want)).all())


# the edge cases of SWA_CASES (the full-size ones run on the card only)
SWA_EMU = [c for c in ac.SWA_CASES if not c[-1]] + [
    ("window 200 across q tiles", 1, 4, 2, 384, 64, 200, False),
    ("D 240, window 70, ragged S 330", 1, 2, 1, 330, 240, 70, False),
]


@pytest.mark.parametrize("case", SWA_EMU, ids=lambda c: c[0])
def test_swa_tile_walk_matches_ref_and_pallas(case):
    name, b, h, kvh, s, d, w, _ = case
    q, k, v = _swa_inputs(b, h, kvh, s, d, len(name))
    got = emulate_swa(q, k, v, w)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = ref.sliding_window_attention(tq, tk, tv, window=w).float().numpy()
    assert _swa_within(got, want, s, w)
    if s % 128 == 0:   # the Pallas kernel's 128-row blocks
        pallas = np.asarray(jops.swa_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), window=w,
            use_pallas=True, interpret=True).astype(jnp.float32))
        assert _swa_within(got, pallas, s, w)


@pytest.mark.parametrize("case", [c for c in SWA_EMU if c[6] > 16],
                         ids=lambda c: c[0])
def test_swa_skipped_edge_tile_fails_the_emulation(case):
    name, b, h, kvh, s, d, w, _ = case
    q, k, v = _swa_inputs(b, h, kvh, s, d, len(name))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = ref.sliding_window_attention(tq, tk, tv, window=w).float().numpy()
    assert not _swa_within(emulate_swa(q, k, v, w, fault="skip_edge"), want,
                           s, w)


# ---------------------------------------------------------------------------
# the plans' field order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module, source, macro", [
    (dec, "decode_attention.cu", "DECODE_ATTENTION_PLAN"),
    (sw, "swa_attention.cu", "SWA_ATTENTION_PLAN"),
    (pa, "paged_attention.cu", "PAGED_ATTENTION_PLAN"),
])
def test_plan_fields_match_the_kernel_source(module, source, macro):
    text = (ROOT / "src/repro_torch/csrc" / source).read_text()
    body = re.search(r"#define " + macro + r"\(X\)(.*?)\n\n", text, re.S)
    names = tuple(re.findall(r"X\((\w+)\)", body.group(1)))
    assert names == module.PLAN_FIELDS
