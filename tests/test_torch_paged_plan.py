"""The plan of the ``paged_decode_attention`` kernel and its arithmetic, on
the CPU (the kernel itself has no CPU mode).

* :func:`repro_torch.kernels.paged_attention.plan` for every shape of
  ``PAGED_CASES`` (:mod:`repro_torch.core.attention_cases`, which
  ``chip_smoke.py`` and the card tests run) and for every attention arch and
  its smoke config at 1, 4 and 64 serving slots: the block fits the card's
  227 KB of shared memory, the pages are not split once ``B * KV`` fills the
  H100's 132 SMs, and otherwise the grid comes within ``B * KV`` blocks of
  132 or every split holds one page; the route is ``tma`` exactly where TMA
  takes every operand.  For every ``q_pos`` from 0 to past the ring, the
  splits' shares cover each live logical page exactly once, in order.
* A numpy emulation of the kernel: each split's share of the slot's live
  pages, the liveness pass (dead table entries, pages past ``q_pos``, pages
  with no live entry skipped unread), the steps of ``pps`` pages with the
  online softmax over live entries only (int8 scales applied to the score
  and the weight), the dead split's ``m = -1e30``, and the fixed-order
  combine -- held against ``ref.paged_decode_attention`` and JAX's Pallas
  ``paged_decode_attention`` in interpret mode, with garbage in the dead
  data, and against itself with Inf and NaN there.  A dead split that
  writes ``m = 0``, a combine without the ``e^(m_z - M)`` rescale and a
  split's share one page short must each fail.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import (paged_decode_attention as  # noqa: E402
                                           j_paged_decode_attention)

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.core import attention_cases as ac  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

H100_SMS = 132
SMEM_MAX = 227 * 1024
TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32,
               "int8": torch.int8}
CASES = {c[0]: c for c in ac.PAGED_CASES}


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _plan_shapes():
    out = [(name, b, h, kv, d, ps, mp, dt)
           for name, b, h, kv, d, ps, mp, dts, *_ in ac.PAGED_CASES
           for dt in dts]
    for arch, cfg in ARCHS.items():
        if not cfg.num_heads:
            continue
        for label, c in (("", cfg), (" smoke", smoke_config(cfg))):
            for slots in (1, 4, 64):
                for dt in ("bfloat16", "int8"):
                    out.append((f"{arch}{label} {slots} slots {dt}", slots,
                                c.num_heads, c.num_kv_heads, c.head_dim,
                                ac.PAGE, ac.MAX_PAGES, dt))
    return out


@pytest.mark.parametrize("case", _plan_shapes(), ids=lambda c: c[0])
def test_paged_plan_fits_and_splits(case):
    _, b, h, kv, d, ps, mp, dt = case
    q = pa.plan(b, h, kv, d, ps, mp, TORCH_DTYPE[dt], sms=H100_SMS)
    assert q["smem"] <= SMEM_MAX and q["smem"] == pa.smem_bytes(q)
    assert q["G"] == h // kv and q["blocks"] == b * kv * q["splits"]
    assert 1 <= q["splits"] <= max(1, mp)
    assert q["share"] == math.ceil(mp / q["splits"])
    if b * kv >= H100_SMS:
        assert q["splits"] == 1
    else:
        assert q["blocks"] > H100_SMS - b * kv or q["splits"] == mp
        assert q["blocks"] <= H100_SMS or q["splits"] == 1
    # a step scores up to 32 entries (one page where ps > 32); the ring
    # holds at least one step, and two steps of at least four pages where
    # shared memory allows
    assert q["pps"] == max(1, 32 // ps) and q["ring"] >= q["pps"]
    if q["ring"] < max(4, 2 * q["pps"]):
        bigger = pa.smem_bytes({**q, "ring": q["ring"] + 1})
        assert bigger > SMEM_MAX
    want_tma = (d * q["isz"]) % 16 == 0 and (dt != "int8" or ps % 4 == 0)
    assert q["tma"] == int(want_tma)
    assert pa.describe(q).startswith(pa.ROUTES[q["tma"]])


def test_paged_plan_at_the_serve_shapes():
    """yi-6b's 4 slots x 4 KV heads split 8 ways and mixtral's 4 x 8 split
    4 ways: 128 blocks each (the first design ran 16 and 32); 64 slots fill
    the card unsplit."""
    yi = pa.plan(4, 32, 4, 128, 16, 32, torch.bfloat16)
    mx = pa.plan(4, 48, 8, 128, 16, 32, torch.bfloat16)
    assert (yi["splits"], yi["blocks"], yi["tma"]) == (8, 128, 1)
    assert (mx["splits"], mx["blocks"], mx["tma"]) == (4, 128, 1)
    assert pa.plan(64, 32, 4, 128, 16, 32, torch.int8)["splits"] == 1
    assert pa.plan(1, 32, 4, 128, 16, 32, torch.int8)["splits"] == 32


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large",
                                  "zamba2-1.2b"])
def test_paged_cases_hold_each_served_geometry(arch):
    """``PAGED_CASES`` (which the card runs) holds every served attention
    geometry at 4 and 64 slots over the serve pools: llama-3.2-vision's
    32/8 heads of 128 (G 4) and musicgen's 32/32 heads of 64 (G 1, the
    zamba2 shared block's), each timed at 4 slots in bf16."""
    cfg = ARCHS[arch]
    geo = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, ac.PAGE,
           ac.MAX_PAGES, 0)
    found = {c[1]: c for c in ac.PAGED_CASES
             if (c[2], c[3], c[4], c[5], c[6], c[8]) == geo}
    assert {4, 64} <= set(found)
    assert found[4][12] and "bfloat16" in found[4][7]
    q = pa.plan(4, *geo[:5], torch.bfloat16, sms=H100_SMS)
    assert q["G"] == cfg.num_heads // cfg.num_kv_heads and q["tma"] == 1


def test_paged_plan_routes():
    """TMA where every row and scale row is a multiple of 16 bytes and the
    pools are aligned; the ``ldg`` route otherwise, chosen by the plan."""
    assert pa.route(128, 16, torch.bfloat16) == "tma"
    assert pa.route(16, 4, torch.int8) == "tma"
    assert pa.route(18, 6, torch.float32) == "ldg"      # 72-byte rows
    assert pa.route(32, 6, torch.bfloat16) == "tma"     # no scales
    assert pa.route(32, 6, torch.int8) == "ldg"         # 24-byte scale rows
    assert pa.route(128, 16, torch.bfloat16, aligned=False) == "ldg"
    q = pa.plan(4, 32, 4, 128, 16, 32, torch.bfloat16, aligned=False)
    assert q["tma"] == 0 and pa.describe(q).startswith("ldg")


@pytest.mark.parametrize("bad", [dict(h=6, kv=4), dict(d=0), dict(d=257),
                                 dict(ps=257), dict(mp=-1),
                                 dict(dtype=torch.float16),
                                 dict(h=64, kv=1, d=256, ps=256,
                                      dtype=torch.float32)])
def test_paged_plan_refuses(bad):
    kw = dict(b=1, h=8, kv=2, d=64, ps=16, mp=8, dtype=torch.bfloat16)
    kw.update(bad)
    with pytest.raises(ValueError):
        pa.plan(kw["b"], kw["h"], kw["kv"], kw["d"], kw["ps"], kw["mp"],
                kw["dtype"])


@pytest.mark.parametrize("shape", [(4, 4, 16, 32), (1, 4, 16, 32),
                                   (4, 8, 16, 32), (3, 2, 6, 10),
                                   (2, 2, 64, 4), (64, 4, 16, 32)],
                         ids=lambda s: "B%d KV%d ps%d MP%d" % s)
def test_paged_shares_cover_every_live_page_once(shape):
    b, kv, ps, mp = shape
    q = pa.plan(b, 4 * kv, kv, 64, ps, mp, sms=H100_SMS)
    for qp in range(-1, 2 * mp * ps + 3):
        n_live = len([j for j in range(mp) if 0 <= j * ps <= qp])
        got = pa.shares(q, qp)
        assert len(got) == q["splits"]
        seen = [j for lo, hi in got for j in range(lo, hi)]
        assert seen == list(range(n_live))         # each once, in order
        assert all(hi - lo <= q["share"] for lo, hi in got)
        sizes = [hi - lo for lo, hi in got]
        assert max(sizes) - min(sizes) <= 1        # equal shares


# ---------------------------------------------------------------------------
# the kernel's arithmetic in numpy
# ---------------------------------------------------------------------------

def emulate(x, window, pl, *, fault=None):
    """paged_attention.cu in numpy on ``paged_pool``'s inputs (the kernel
    sees the first n_pages pages).  Block (b, kv head, split z) walks its
    share of the slot's live logical pages: a dead table entry, and a page
    with no entry that survives the mask, are skipped unread; the listed
    pages are scored ``pps`` at a time over their live entries only, in
    fp32, updating (m, l, acc) online; the combine reads the splits in
    order z = 0, 1, ...  ``fault``: "dead_m0" has a split with no live entry
    write m = 0, "no_rescale" combines without the e^(m_z - M) weights,
    "short" drops the last page of every split's share."""
    q, k, v = x["q"], x["k"], x["v"]
    ks, vs = x["k_scale"], x["v_scale"]
    pos, table, q_pos, n_pages = x["pos"], x["table"], x["q_pos"], x["n_pages"]
    b, h, d = q.shape
    kvh, ps = k.shape[1], k.shape[2]
    g = h // kvh
    scale = np.float32(1.0 / math.sqrt(d))
    splits = pl["splits"]
    part = np.zeros((b, h, splits, d + 2), np.float32)
    for bi in range(b):
        qp = int(q_pos[bi])
        for hk in range(kvh):
            rows = q[bi, hk * g:(hk + 1) * g].astype(np.float32)
            for z, (lo, hi) in enumerate(pa.shares(pl, qp)):
                if fault == "short" and hi > lo:
                    hi -= 1
                listed = []
                for j in range(lo, hi):
                    pid = int(table[bi, j])
                    if pid < 0 or pid >= n_pages:
                        continue
                    kp = pos[pid]
                    ent = (kp >= 0) & (kp <= qp)
                    if window:
                        ent &= kp > qp - window
                    if ent.any():
                        listed.append((pid, ent))
                m = np.full(g, -1e30, np.float32)
                lsum = np.zeros(g, np.float32)
                acc = np.zeros((g, d), np.float32)
                for i0 in range(0, len(listed), pl["pps"]):
                    step = listed[i0:i0 + pl["pps"]]
                    kk = np.concatenate([k[p, hk][e] for p, e in step])
                    vv = np.concatenate([v[p, hk][e] for p, e in step])
                    sc = (rows @ kk.astype(np.float32).T) * scale
                    wv = np.ones(len(kk), np.float32)
                    if ks is not None:
                        sc = sc * np.concatenate([ks[p, hk][e] for p, e in step])
                        wv = np.concatenate([vs[p, hk][e] for p, e in step])
                    m_new = np.maximum(m, sc.max(axis=1))
                    p = np.exp(sc - m_new[:, None])
                    alpha = np.exp(m - m_new)
                    lsum = lsum * alpha + p.sum(axis=1)
                    acc = acc * alpha[:, None] + (p * wv) @ vv.astype(np.float32)
                    m = m_new
                if fault == "dead_m0" and not listed:
                    m = np.zeros(g, np.float32)
                part[bi, hk * g:(hk + 1) * g, z, 0] = m
                part[bi, hk * g:(hk + 1) * g, z, 1] = lsum
                part[bi, hk * g:(hk + 1) * g, z, 2:] = acc
    if splits == 1:
        lsum = part[:, :, 0, 1]
        return part[:, :, 0, 2:] / np.where(lsum == 0, 1, lsum)[..., None]
    mx = part[..., 0].max(axis=2, keepdims=True)
    w = np.exp(part[..., 0] - mx)
    if fault == "no_rescale":
        w = np.ones_like(w)
    num = (w[..., None] * part[..., 2:]).sum(axis=2)
    den = (w * part[..., 1]).sum(axis=2)
    safe = np.where(den == 0, 1, den)
    return np.where(den[..., None] == 0, 0, num / safe[..., None]).astype(
        np.float32)


def _inputs(case, dtype, *, nonfinite=False):
    """``paged_pool``'s inputs of ``case`` and its plan."""
    x = ac.paged_pool(case, dtype, len(case[0]), nonfinite=nonfinite)
    _, b, h, kv, d, ps, mp, *_ = case
    return x, pa.plan(b, h, kv, d, ps, mp, TORCH_DTYPE[dtype])


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _plain(x, window):
    n = x["n_pages"]
    sc = lambda a: None if a is None else _t(a[:n])  # noqa: E731
    return ref.paged_decode_attention(
        _t(x["q"]), _t(x["k"][:n]), _t(x["v"][:n]), pos_pages=_t(x["pos"][:n]),
        page_table=_t(x["table"]), q_pos=_t(x["q_pos"]),
        k_scale=sc(x["k_scale"]), v_scale=sc(x["v_scale"]),
        window=window).numpy()


def _emulated_cases():
    return [(c, dt) for c in ac.PAGED_CASES
            for dt in ("float32", "int8") if dt in c[7]]


@pytest.mark.parametrize("case, dtype", _emulated_cases(),
                         ids=lambda v: v if isinstance(v, str) else v[0])
def test_paged_emulation_matches_ref_and_ignores_dead_data(case, dtype):
    window, dead = case[8], case[10]
    x, pl = _inputs(case, dtype)
    got = emulate(x, window, pl)
    want = _plain(x, window)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for i in dead:                         # an all-dead slot: exact zeros
        assert not got[i].any() and not want[i].any()
    # Inf in K and NaN in V (int8: in their scales) wherever no slot attends,
    # the trash page included: the same result, to the bit
    y, _ = _inputs(case, dtype, nonfinite=True)
    assert not np.isfinite(y["k_scale"] if dtype == "int8" else y["k"]).all()
    np.testing.assert_array_equal(emulate(y, window, pl), got)


# small cases that JAX's Pallas kernel runs in interpret mode
PALLAS_CASES = ["ring wrap in every slot", "window 5 across page edges",
                "sentinels mid-table", "TMA refuses: page 6, D 18",
                "the card test's shape: D 16, page 4",
                "GQA 12, a slot at q_pos 0"]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", PALLAS_CASES)
def test_paged_emulation_matches_pallas(name, dtype):
    case = CASES[name]
    window = case[8]
    x, pl = _inputs(case, dtype)
    n = x["n_pages"]
    sc = lambda a: None if a is None else jnp.asarray(a[:n])  # noqa: E731
    want = np.asarray(j_paged_decode_attention(
        jnp.asarray(x["q"]), jnp.asarray(x["k"][:n]), jnp.asarray(x["v"][:n]),
        pos_pages=jnp.asarray(x["pos"][:n]), page_table=jnp.asarray(x["table"]),
        q_pos=jnp.asarray(x["q_pos"]), k_scale=sc(x["k_scale"]),
        v_scale=sc(x["v_scale"]), window=window, interpret=True))
    np.testing.assert_allclose(emulate(x, window, pl), want, rtol=1e-5,
                               atol=1e-5)


def test_paged_split_with_no_live_page_weighs_nothing():
    """yi-6b's 4 slots split 8 ways: the splits of the short slot (17
    tokens, its first page a sentinel) hold no live page; they write
    m = -1e30, l = 0 and the combine still matches the plain version."""
    case = CASES["yi-6b 4 slots"]
    x, pl = _inputs(case, "float32")
    empty = [z for z, (lo, hi) in enumerate(pa.shares(pl, 17)) if hi == lo]
    assert empty and pl["splits"] == 8
    np.testing.assert_allclose(emulate(x, 0, pl), _plain(x, 0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fault, name", [
    ("dead_m0", "scores far below zero, short slots"),
    ("no_rescale", "ring wrap in every slot"),
    ("short", "ring wrap in every slot"),
])
def test_paged_faults_fail_the_emulation(fault, name):
    """Each fault against the case that shows it: a split with no live page
    that writes m = 0 zeroes a row only when every live score is far below
    zero (the case's shift), so that e^(m_z - 0) underflows."""
    case = CASES[name]
    x, pl = _inputs(case, "float32")
    assert pl["splits"] > 1
    want = _plain(x, case[8])
    np.testing.assert_allclose(emulate(x, case[8], pl), want, rtol=1e-5,
                               atol=1e-5)
    bad = emulate(x, case[8], pl, fault=fault)
    assert not np.allclose(bad, want, rtol=1e-5, atol=1e-5)
