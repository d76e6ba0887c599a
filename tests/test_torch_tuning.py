"""The port's tile tuner on the CPU: plans, cache, search, policy and CLI.

* Plans.  Without a choice every planner returns the plan it returned
  before the tuner existed, for every entry of the case tables
  (``core/gemm_cases.py``, ``PAGED_CASES``, ``MOE_CASES``/``MOE_EDGE``,
  ``core/conv_cases.py``), pinned in ``tests/data/torch_seed_plans.json``.
  Every candidate a planner offers rebuilds, through ``plan(choice=...)``,
  a plan that fits 227 KB and covers its output exactly once per split;
  the numpy emulations of ``kraken_gemm`` and ``paged_decode_attention``
  (``test_torch_gemm_plan.py``, ``test_torch_paged_plan.py``) run one
  non-default split each against the plain version.
* Cache.  JAX's file format both ways without a hit across backends;
  round trips; a corrupt file, a version mismatch and an entry whose choice
  is not among the planner's candidates are warned misses; the
  ``page_size`` and ``experts`` guards as JAX's ``lookup_*``.
* Search.  With an injected timer the search picks the fastest candidate,
  persists ``model_pick`` and ``agrees_with_model``, and a second call is a
  hit; without a card, the measurement raises and names it.
* CLI.  ``--device cpu --tile-cache F`` loads and serves; ``--autotune``
  there fails.
"""

import json
import math
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_gemm_plan as gemm_plan  # noqa: E402
import test_torch_paged_plan as paged_plan  # noqa: E402

from repro import tuning as jtuning  # noqa: E402
from repro.core.elastic import TileConfig  # noqa: E402
from repro.tuning import cache as jcache  # noqa: E402

from repro_torch import tuning  # noqa: E402
from repro_torch.core import attention_cases as ac  # noqa: E402
from repro_torch.core import conv_cases, elastic, gemm_cases  # noqa: E402
from repro_torch.core import moe_cases  # noqa: E402
from repro_torch.core.elastic import SMEM_BUDGET, ceil_div  # noqa: E402
from repro_torch.kernels import kraken_conv as kc  # noqa: E402
from repro_torch.kernels import kraken_gemm as kg  # noqa: E402
from repro_torch.kernels import kraken_moe_gemm as mg  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.tuning import cache as tcache  # noqa: E402
from repro_torch.tuning import search  # noqa: E402

SEED_PLANS = Path(__file__).parent / "data" / "torch_seed_plans.json"
H100_SMS = 132
DT = {"bfloat16": torch.bfloat16, "float32": torch.float32,
      "int8": torch.int8}


@pytest.fixture(autouse=True)
def _fresh_policy():
    """Each test starts and ends with the default policy and an empty
    in-memory cache."""
    tuning.set_tile_mode(None)
    tuning.set_tile_cache(tcache.TileCache(path=None))
    yield
    tuning.set_tile_mode(None)
    tuning.set_tile_cache(tcache.TileCache(path=None))


# ---------------------------------------------------------------------------
# the case tables, as the planners take them
# ---------------------------------------------------------------------------

def gemm_plan_cases():
    tables = [("yi-6b", gemm_cases.GEMMS), ("gemma3", gemm_cases.GEMMA_GEMMS),
              ("mixtral", gemm_cases.MIXTRAL_GEMMS),
              ("rwkv6", gemm_cases.RWKV_GEMMS),
              ("zamba2", gemm_cases.ZAMBA_GEMMS),
              ("llama-3.2-vision", gemm_cases.VLM_GEMMS),
              ("musicgen", gemm_cases.MUSICGEN_GEMMS)]
    shapes = [(f"{arch} {n}", k, nn) for arch, table in tables
              for n, k, nn, *_ in table]
    out = [(f"{name} M{m}", m, k, n)
           for m in gemm_cases.LM_ROWS for name, k, n in shapes]
    out += [(f"edge {name}", m, k, n)
            for name, m, k, n, *_ in gemm_cases.GEMM_EDGE]
    out += [(f"ragged {m}x{k}x{n}", m, k, n) for m, k, n in gemm_cases.RAGGED]
    for net, layer, h, w, ci, kk, s, pad, co in conv_cases.conv_geometries():
        oh = (h + sum(pad[0]) - kk) // s + 1
        ow = (w + sum(pad[1]) - kk) // s + 1
        for nb in conv_cases.CONV_BATCHES:
            out.append((f"{net} {layer} b{nb} im2col", nb * oh * ow,
                        ci * kk * kk, co))
    return out


def paged_plan_cases():
    return [(f"{c[0]} {dt}", *c[1:7], dt) for c in ac.PAGED_CASES
            for dt in c[7]]


def moe_plan_cases():
    return ([(n, e, c, d, f, moe_cases.moe_sizes(s, e))
             for n, e, c, d, f, s, _ in moe_cases.MOE_CASES]
            + [(n, e, c, d, f, s)
               for n, e, c, d, f, s, _ in moe_cases.MOE_EDGE])


def conv_plan_cases():
    out = []
    for net, layer, h, w, ci, k, s, pad, co in conv_cases.conv_geometries():
        for n in conv_cases.CONV_BATCHES:
            out.append((f"{net} {layer} b{n}", n, h, w, ci, k, s, pad, co,
                        conv_cases.CONV_R))
    for name, n, h, w, ci, k, s, pad, co, R, _ in conv_cases.CONV_EDGE:
        out.append((f"edge {name}", n, h, w, ci, k, s, pad, co, R))
    for name, *rest in conv_cases.CONV_NONFINITE:
        out.append((f"edge {name}", *rest))
    return out


def _conv_args(case):
    _, n, h, w, ci, k, s, pad, co, R = case
    return (n, h, w, ci), (k, k, ci, co), dict(stride=(s, s), padding=pad,
                                               R=R)


def _today():
    """Every planner's plan without a choice, as the seed file lists them."""
    out = {"kraken_gemm": {}, "paged_decode_attention": {},
           "grouped_moe_gemm": {}, "kraken_conv2d_direct": {}}
    for name, m, k, n in gemm_plan_cases():
        for dt in ("bfloat16", "float32"):
            q = kg.plan(m, k, n, dtype=DT[dt])
            out["kraken_gemm"][f"{name} {dt}"] = [q[f] for f in kg.PLAN_FIELDS]
    for name, b, h, kv, d, ps, mp, dt in paged_plan_cases():
        q = pa.plan(b, h, kv, d, ps, mp, DT[dt])
        out["paged_decode_attention"][name] = [q[f] for f in pa.PLAN_FIELDS]
    for name, e, c, d, f, _ in moe_plan_cases():
        for dt in ("bfloat16", "float32", "int8"):
            q = mg.plan(e, c, d, f, DT[dt])
            out["grouped_moe_gemm"][f"{name} {dt}"] = [
                q[x] for x in mg.PLAN_FIELDS]
    for case in conv_plan_cases():
        xs, ks, kw = _conv_args(case)
        for dt in ("bfloat16", "float32"):
            q = kc.plan(xs, ks, dtype=DT[dt], **kw)
            out["kraken_conv2d_direct"][f"{case[0]} {dt}"] = [
                q[x] for x in kc.PLAN_FIELDS]
    return out


@pytest.mark.parametrize("planner", ["kraken_gemm", "paged_decode_attention",
                                     "grouped_moe_gemm",
                                     "kraken_conv2d_direct"])
def test_plan_without_a_choice_is_todays_plan(planner):
    """Under the default mode every planner returns, field for field, the
    plan it returned before candidates and choices existed."""
    seed = json.loads(SEED_PLANS.read_text())[planner]
    now = _today()[planner]
    assert set(now) == set(seed)
    diff = [name for name in seed if seed[name] != now[name]]
    assert not diff, diff[:5]


# ---------------------------------------------------------------------------
# every candidate rebuilds a plan that fits and covers
# ---------------------------------------------------------------------------

def _gemm_covers(q):
    """kraken_gemm's tiles cover [M, N] once per split, and the splits are
    disjoint non-empty runs of K steps that together are all of K."""
    m, n = q["M"], q["N"]
    assert q["mtiles"] == ceil_div(m, q["BM"])
    assert q["ntiles"] == ceil_div(n, q["BN"])
    assert q["tiles"] == q["mtiles"] * q["ntiles"] * q["split"]
    assert (q["mtiles"] - 1) * q["BM"] < m and (q["ntiles"] - 1) * q["BN"] < n
    z = np.arange(q["split"])
    k0 = z * q["kps"]
    ks = np.minimum(q["kps"], q["nk"] - k0)
    if q["nk"]:
        assert ks.min() >= 1 and k0[0] == 0
        assert (k0[1:] == k0[:-1] + ks[:-1]).all()
        assert k0[-1] + ks[-1] == q["nk"]


@pytest.mark.parametrize("rows", gemm_cases.LM_ROWS + ("edge and conv",),
                         ids=lambda r: f"M{r}" if isinstance(r, int) else r)
def test_every_gemm_candidate_fits_and_covers(rows):
    cases = [c for c in gemm_plan_cases()
             if (c[0].endswith(f" M{rows}") if isinstance(rows, int)
                 else not c[0].split()[-1].startswith("M"))]
    assert cases
    for name, m, k, n in cases:
        cands = kg.candidates(m, k, n, sms=H100_SMS)
        pick = kg.plan(m, k, n, sms=H100_SMS)
        assert (pick["BM"], pick["BN"], pick["split"]) in {
            (c["BM"], c["BN"], c["split"]) for c in cands}, name
        best = min(cands, key=lambda c: c["est"])
        for c in cands:
            q = kg.plan(m, k, n, sms=H100_SMS,
                        choice=(c["BM"], c["BN"], c["split"]))
            assert (q["BM"], q["BN"], q["split"]) == (c["BM"], c["BN"],
                                                      c["split"])
            assert q["smem"] <= SMEM_BUDGET and 2 <= q["stages"] <= 5
            if q["split"] > 1:
                assert q["mtiles"] * q["ntiles"] < H100_SMS
            _gemm_covers(q)
        assert best["est"] <= next(c["est"] for c in cands
                                   if (c["BM"], c["BN"], c["split"])
                                   == (pick["BM"], pick["BN"], pick["split"]))
    assert kg.candidates(4, 4096, 4096, dtype=torch.float32) == []


def test_every_paged_candidate_fits_and_covers():
    for name, b, h, kv, d, ps, mp, dt in paged_plan_cases():
        cands = pa.candidates(b, h, kv, d, ps, mp, DT[dt], sms=H100_SMS)
        splits = [c["splits"] for c in cands]
        pick = pa.plan(b, h, kv, d, ps, mp, DT[dt], sms=H100_SMS)["splits"]
        powers = [s for s in (1, 2, 4, 8, 16, 32, 64) if s <= mp]
        assert set(splits) <= set(powers) | {mp, pick}, name
        assert pick in splits and mp in splits or mp == 0
        for s in splits:
            q = pa.plan(b, h, kv, d, ps, mp, DT[dt], sms=H100_SMS,
                        choice=(s,))
            assert q["splits"] == s and q["share"] == math.ceil(max(mp, 1)
                                                                / s)
            assert q["blocks"] == b * kv * s
            assert q["smem"] == pa.smem_bytes(q) <= SMEM_BUDGET
            for qp in (-1, 0, ps - 1, ps, mp * ps // 2, mp * ps - 1,
                       2 * mp * ps):
                n_live = 0 if qp < 0 else min(mp, qp // ps + 1)
                got = pa.shares(q, qp)
                assert [j for lo, hi in got for j in range(lo, hi)] == list(
                    range(n_live))
                assert all(hi - lo <= q["share"] for lo, hi in got)
    with pytest.raises(ValueError, match="not a candidate"):
        pa.plan(4, 32, 4, 128, 16, 32, choice=(33,))


def test_every_moe_candidate_fits_and_covers():
    tried = 0
    for name, e, c, d, f, sizes in moe_plan_cases():
        cands = mg.candidates(e, c, d, f, sms=H100_SMS)
        q0 = mg.plan(e, c, d, f, sms=H100_SMS)
        if q0["path"] == mg.PATH_TILE:
            assert cands == []
            continue
        assert (q0["BM"], q0["split"]) in {(x["BM"], x["split"])
                                           for x in cands}, name
        for cand in cands:
            q = mg.plan(e, c, d, f, sms=H100_SMS,
                        choice=(cand["BM"], cand["split"]))
            tried += 1
            assert q["BN"] == mg.TILES[q["BM"]]
            assert q["smem"] <= SMEM_BUDGET and 2 <= q["stages"] <= 5
            assert q["mtiles"] == ceil_div(c, q["BM"])
            assert q["split"] * e * c * f * 4 <= mg.PART_MAX_BYTES \
                or q["split"] == 1
            items, split = paged_moe_items(q, sizes)
            seen = {}
            for ie, m0, n0, z, k0, ks in items:
                assert m0 < min(max(sizes[ie], 0), c) and n0 < f
                seen.setdefault((ie, m0, n0), []).append((k0, ks))
            live = {(i, mt * q["BM"], nt * q["BN"])
                    for i, s in enumerate(sizes)
                    for mt in range(ceil_div(min(max(s, 0), c), q["BM"]))
                    for nt in range(q["ntiles"])}
            assert set(seen) == live
            for runs in seen.values():
                runs.sort()
                assert len(runs) == split and runs[0][0] == 0
                assert runs[-1][0] + runs[-1][1] == q["nk"]
                assert all(a[0] + a[1] == b[0] for a, b in zip(runs,
                                                                runs[1:]))
    assert tried > 20
    with pytest.raises(ValueError, match="not a candidate"):
        mg.plan(8, 1, 6144, 16384, choice=(96, 1))


def paged_moe_items(q, sizes):
    """The work items of a grouped call (``test_torch_moe_plan.py``'s
    ``work_items``, vectorized over items)."""
    bm = q["BM"]
    cnt = [ceil_div(min(max(int(s), 0), q["C"]), bm) for s in sizes]
    pre = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    live = int(pre[-1])
    split = mg.live_split(q, live * q["ntiles"])
    kps = ceil_div(q["nk"], split)
    t = np.arange(live * q["ntiles"] * split)
    lt, rest = t % max(live, 1), t // max(live, 1)
    e = np.searchsorted(pre[:-1], lt, side="right") - 1
    z = rest // q["ntiles"]
    k0 = z * kps
    return (list(zip(e.tolist(), ((lt - pre[e]) * bm).tolist(),
                     ((rest % q["ntiles"]) * q["BN"]).tolist(), z.tolist(),
                     k0.tolist(), np.minimum(kps, q["nk"] - k0).tolist())),
            split)


def _conv_covers(p):
    """kraken_conv2d_direct's pixel tiles cover every (image, row, column)
    once, its c_o tiles every channel once, and the split's chunks all of
    C_i once, non-empty (the tile index is their product)."""
    n, oh, ow, co = p["N"], p["OH"], p["OW"], p["C_o"]
    per = p["TR"] * p["TC"]
    slot = np.arange(p["G"] * per)
    g, rem = np.divmod(slot, per)
    r, c = np.divmod(rem, p["TC"])
    pt = np.arange(p["ptiles"])
    group, pr = np.divmod(pt, p["rts"] * p["cts"])
    nn = (group * p["G"])[:, None] + g[None, :]
    hh = ((pr // p["cts"]) * p["TR"])[:, None] + r[None, :]
    ww = ((pr % p["cts"]) * p["TC"])[:, None] + c[None, :]
    live = (nn < n) & (hh < oh) & (ww < ow)
    cover = np.zeros(n * oh * ow, np.int64)
    np.add.at(cover, ((nn * oh + hh) * ow + ww)[live], 1)
    assert (cover == 1).all()
    assert p["ctiles"] == ceil_div(co, p["BN"])
    assert p["tiles"] == p["ptiles"] * p["ctiles"] * p["split"]
    chunks = [list(range(z * p["cps"], min(p["nchunks"], (z + 1) * p["cps"])))
              for z in range(p["split"])]
    assert all(chunks) and sum(chunks, []) == list(range(p["nchunks"]))
    assert p["grid"] == min(p["tiles"], H100_SMS)


@pytest.mark.parametrize("which", ["alexnet", "vgg16", "resnet50", "edge"])
def test_every_conv_candidate_fits_and_covers(which):
    cases = [c for c in conv_plan_cases() if c[0].split()[0] == which]
    assert cases
    for case in cases:
        xs, ks, kw = _conv_args(case)
        cands = kc.candidates(xs, ks, **kw, sms=H100_SMS)
        pick = kc.plan(xs, ks, **kw, sms=H100_SMS)
        assert (pick["BN"], pick["split"]) in {(c["BN"], c["split"])
                                               for c in cands}, case[0]
        for cand in cands:
            p = kc.plan(xs, ks, **kw, sms=H100_SMS,
                        choice=(cand["BN"], cand["split"]))
            assert (p["BN"], p["split"]) == (cand["BN"], cand["split"])
            assert p["path"] == 1 and p["smem"] <= SMEM_BUDGET
            assert p["smem"] >= (p["NB"] * p["band_bytes"]
                                 + p["NW"] * p["BN"] * 128 + 1024)
            assert p["BR"] <= 256 and p["BW"] <= 256
            assert p["G"] * p["TR"] * p["TC"] <= kc.SLOTS
            _conv_covers(p)


def test_conv_bco_is_the_c_o_tile():
    """``bco`` 64 or 128 is taken as BN with the planner's split for it;
    any other value is refused, naming the card's tiles."""
    xs, ks = (1, 14, 14, 512), (3, 3, 512, 512)
    kw = dict(stride=(1, 1), padding=((1, 1), (1, 1)), R=7, sms=H100_SMS)
    for bco in kc.BCO:
        p = kc.plan(xs, ks, choice=(bco, None), **kw)
        assert p["BN"] == bco and p["tiles"] >= H100_SMS
        _conv_covers(p)
    for bad in (32, 96, 256):
        with pytest.raises(ValueError, match="output-channel tiles 64 and "
                                             "128"):
            kc.check_args(xs, ks, stride=(1, 1), padding=((1, 1), (1, 1)),
                          R=7, bco=bad)
    with pytest.raises(ValueError, match="not a candidate"):
        kc.plan(xs, ks, choice=(96, 1), **kw)


def test_emulated_gemm_at_a_non_default_split():
    """The numpy kraken_gemm emulation on a candidate the planner does not
    pick (another split of K), against the plain version."""
    m, k, n = 4, 2000, 200
    pick = kg.plan(m, k, n, sms=8)
    other = next(c for c in kg.candidates(m, k, n, sms=8)
                 if c["split"] not in (1, pick["split"])
                 and (c["BM"], c["BN"]) == (pick["BM"], pick["BN"]))
    q = kg.plan(m, k, n, sms=8, choice=(other["BM"], other["BN"],
                                        other["split"]))
    assert q["split"] > 1 and q["split"] != pick["split"]
    rng = np.random.default_rng(0)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    want = ref.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      bias=torch.from_numpy(bias), activation="silu").numpy()
    got = gemm_plan.emulate(a, b, bias, "silu", q)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_emulated_paged_at_a_non_default_split():
    """The numpy paged_decode_attention emulation on a split count the
    planner does not pick, against the plain version."""
    case = paged_plan.CASES["ring wrap in every slot"]
    x, pick = paged_plan._inputs(case, "float32")
    _, b, h, kv, d, ps, mp, *_ = case
    other = next(c["splits"] for c in pa.candidates(b, h, kv, d, ps, mp,
                                                    torch.float32)
                 if c["splits"] not in (1, pick["splits"]))
    q = pa.plan(b, h, kv, d, ps, mp, torch.float32, choice=(other,))
    window = case[8]
    got = paged_plan.emulate(x, window, q)
    np.testing.assert_allclose(got, paged_plan._plain(x, window), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the cache file
# ---------------------------------------------------------------------------

YI_DECODE = (4, 4096, 4096)


def _fake_timer(fastest):
    """A clock under which ``fastest`` takes 1 us and every other choice
    more, by its distance from it."""
    def timer(choice):
        return 1.0 + sum(abs(a - b) for a, b in zip(choice, fastest))
    return timer


def _non_default_gemm(m, k, n):
    """A shortlisted kraken_gemm candidate that is not the planner's pick."""
    q = kg.plan(m, k, n)
    pick = (q["BM"], q["BN"], q["split"])
    return next(c for c in (
        (c["BM"], c["BN"], c["split"])
        for c in search.shortlist(kg.candidates(m, k, n), kg.CHOICE,
                                  keep=pick)) if c != pick)


def test_jax_cache_loads_in_the_port_and_never_hits(tmp_path):
    path = str(tmp_path / "jax.json")
    jc = jcache.TileCache(path)
    jkey = jcache.cache_key("gemm", *YI_DECODE, "bfloat16",
                            jtuning.backend_name())
    jc.put(jkey, TileConfig(128, 4096, 512, "weight_stationary", 0.5, 1, 1),
           measured_us=3.0)
    # a JAX entry under the port's own key: JAX's fields, no choice
    jc.put(tcache.cache_key("gemm", *YI_DECODE, "bfloat16"),
           TileConfig(8, 4096, 128, "output_stationary", 0.5, 1, 1))
    jc.save()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cache = tcache.TileCache(path)
    assert len(cache) == 2
    with pytest.warns(UserWarning, match="no BM/BN/split choice"):
        hit = search.lookup("gemm", YI_DECODE, dtype_name="bfloat16",
                            sms=H100_SMS, cache=cache)
    assert hit is None and cache.misses == 1 and cache.hits == 0


def test_port_cache_loads_in_jax_and_never_hits(tmp_path):
    path = str(tmp_path / "port.json")
    cache = tcache.TileCache(path)
    search.autotune("gemm", YI_DECODE, dtype_name="bfloat16", sms=H100_SMS,
                    cache=cache, timer=_fake_timer(_non_default_gemm(
                        *YI_DECODE)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jc = jcache.TileCache(path)
    assert len(jc) == 1
    key = jcache.cache_key("gemm", *YI_DECODE, "bfloat16",
                           jtuning.backend_name())
    assert jc.get(key) is None and jc.hits == 0
    # even read under its own key, the port's entry is no JAX plan
    [pkey] = jc.entries
    with pytest.warns(UserWarning, match="malformed"):
        assert jc.get(pkey) is None


def test_entries_survive_the_round_trip(tmp_path):
    path = str(tmp_path / "plans.json")
    cache = tcache.TileCache(path)
    want = _non_default_gemm(*YI_DECODE)
    got = search.autotune("gemm", YI_DECODE, dtype_name="bfloat16",
                          sms=H100_SMS, cache=cache,
                          timer=_fake_timer(want))
    assert got == want
    again = tcache.TileCache(path)
    assert again.entries == cache.entries
    assert search.lookup("gemm", YI_DECODE, dtype_name="bfloat16",
                         sms=H100_SMS, cache=again) == want
    blob = json.loads(Path(path).read_text())
    assert blob["version"] == tcache.CACHE_VERSION
    [(key, entry)] = blob["entries"].items()
    assert key == "gemm:m4:k4096:n4096:bfloat16:cuda"
    assert (entry["BM"], entry["BN"], entry["split"]) == want
    assert entry["agrees_with_model"] is False
    pick = kg.plan(*YI_DECODE)
    assert (entry["model_pick"]["BM"], entry["model_pick"]["BN"],
            entry["model_pick"]["split"]) == (pick["BM"], pick["BN"],
                                              pick["split"])
    assert entry["measured_us"] == 1.0
    assert entry["model_pick"]["measured_us"] > 1.0
    assert {"est", "candidates_timed"} <= set(entry)


@pytest.mark.parametrize("blob,match", [
    ("{not json", "unreadable"),
    (json.dumps({"version": 99, "entries": {}}), "version 99"),
    (json.dumps({"version": 1, "entries": []}), "malformed"),
])
def test_bad_files_warn_and_start_empty(tmp_path, blob, match):
    path = tmp_path / "plans.json"
    path.write_text(blob)
    with pytest.warns(UserWarning, match=match):
        cache = tcache.TileCache(str(path))
    assert len(cache) == 0
    assert search.lookup("gemm", YI_DECODE, dtype_name="bfloat16",
                         sms=H100_SMS, cache=cache) is None


@pytest.mark.parametrize("op_kind,shape,entry", [
    ("gemm", YI_DECODE, {"BM": 96, "BN": 128, "split": 1}),
    ("gemm", YI_DECODE, {"BM": 64, "BN": 128, "split": 33}),
    ("paged_decode", (4, 32, 4, 128, 16, 32),
     {"splits": 64, "page_size": 16, "heads": [32, 4]}),
    ("moe_gemm", (8, 1, 6144, 16384), {"BM": 256, "split": 1,
                                       "experts": 8}),
    ("conv_direct", ((1, 14, 14, 512), (3, 3, 512, 512), (1, 1),
                     ((1, 1), (1, 1)), 7),
     {"BN": 128, "split": 5}),
])
def test_an_entry_outside_the_candidates_is_a_warned_miss(op_kind, shape,
                                                          entry):
    cache = tcache.TileCache(path=None)
    key = search.key_of(op_kind, shape, "bfloat16")
    guards = search._op(op_kind).guards(shape)
    cache.put(key, {**guards, **entry})
    with pytest.warns(UserWarning, match="not among the planner's candidates"):
        hit = search.lookup(op_kind, shape, dtype_name="bfloat16",
                            sms=H100_SMS, cache=cache)
    assert hit is None
    # the policy hands the kernel the planner's pick: no choice at all
    tuning.set_tile_cache(cache)
    with pytest.warns(UserWarning, match="not among"):
        assert elastic.choose_tiles(op_kind, shape, dtype_name="bfloat16",
                                    sms=H100_SMS, mode="cached") is None


def test_paged_page_size_guard_as_jax():
    """An entry tuned at another page size is a miss (counted), as JAX's
    ``lookup_paged_decode``; at its own it hits."""
    cache = tcache.TileCache(path=None)
    got = search.autotune_paged_decode(4, 512, 128, page_size=16, kv_heads=4,
                                       q_heads=32, cache=cache,
                                       timer=_fake_timer((4,)))
    assert got == 4
    kw = dict(slots=4, heads=32, kv_heads=4, head_dim=128, max_pages=32)
    assert tuning.lookup_paged_decode(cache, page_size=16, **kw) == 4
    key = search.key_of("paged_decode", (4, 32, 4, 128, 16, 32), "bfloat16")
    cache.entries[key]["page_size"] = 8
    before = cache.misses
    assert tuning.lookup_paged_decode(cache, page_size=16, **kw) is None
    assert cache.misses == before + 1
    assert tuning.lookup_paged_decode(cache, page_size=16, count=False,
                                      **kw) is None
    assert cache.misses == before + 1
    # the JAX function keys on the same (slots, logical, head_dim) identity
    jc = jcache.TileCache(path=None)
    jkey = jcache.cache_key("paged_decode", 4, 512, 128, "bfloat16",
                            "cpu-interpret")
    jc.put(jkey, TileConfig(8, 512, 4, "output_stationary", 1.0, 1, 1),
           extra={"page_size": 8})
    from repro.tuning.search import lookup_paged_decode as jlookup
    assert jlookup(jc, jkey, page_size=16, max_pages=32) is None
    assert jlookup(jc, jkey, page_size=8, max_pages=32) == 4
    assert key.split(":")[:4] == jkey.split(":")[:4]


def test_moe_experts_guard_as_jax():
    cache = tcache.TileCache(path=None)
    cands = mg.candidates(8, 1, 6144, 16384)
    fastest = (cands[-1]["BM"], cands[-1]["split"])
    got = search.autotune_moe_gemm(8, 8, 6144, 16384, cache=cache,
                                   timer=_fake_timer(fastest))
    assert got == fastest
    kw = dict(capacity=1, d=6144, f=16384)
    assert tuning.lookup_moe_gemm(cache, experts=8, **kw) == fastest
    key = search.key_of("moe_gemm", (8, 1, 6144, 16384), "bfloat16")
    assert key == "moe_gemm:m8:k6144:n16384:bfloat16:cuda"
    cache.entries[key]["experts"] = 4
    assert tuning.lookup_moe_gemm(cache, experts=8, **kw) is None


# ---------------------------------------------------------------------------
# the search and the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op_kind,shape", [
    ("gemm", (256, 4096, 11008)),
    ("gemm", (4, 2560, 160)),
    ("paged_decode", (4, 32, 32, 64, 16, 32)),
    ("moe_gemm", (8, 80, 6144, 16384)),
    ("conv_direct", ((32, 56, 56, 256), (3, 3, 256, 256), (1, 1),
                     ((1, 1), (1, 1)), 7)),
])
def test_search_picks_the_fastest_and_records_the_model(op_kind, shape):
    cache = tcache.TileCache(path=None)
    fields = search._op(op_kind).fields
    cands = search.candidates_of(op_kind, shape, dtype_name="bfloat16",
                                 sms=H100_SMS)
    pick = search.model_pick(op_kind, shape, dtype_name="bfloat16",
                             sms=H100_SMS)
    timed = []

    def timer(choice):
        timed.append(choice)
        return 1.0 + sum(abs(a - b) for a, b in zip(choice, fastest))
    # the fastest of the timed set: the last candidate not the pick
    fastest = next(tuple(c[f] for f in fields) for c in reversed(
        search.shortlist(cands, fields, keep=pick) if op_kind == "gemm"
        else cands) if tuple(c[f] for f in fields) != pick)
    logs = []
    got = search.autotune(op_kind, shape, dtype_name="bfloat16",
                          sms=H100_SMS, cache=cache, timer=timer,
                          log=logs.append)
    assert got == fastest and pick in timed
    assert len(timed) == len(set(timed))
    if op_kind == "gemm":
        assert len(timed) < len(cands)        # the shortlist, not them all
    else:
        assert len(timed) == len(cands)
    [entry] = cache.entries.values()
    assert entry["agrees_with_model"] is False
    assert tuple(entry["model_pick"][f] for f in fields) == pick
    assert entry["candidates_timed"] == len(timed)
    assert "overruled" in logs[0]
    # a second call is a hit: nothing is timed
    timed.clear()
    assert search.autotune(op_kind, shape, dtype_name="bfloat16",
                           sms=H100_SMS, cache=cache, timer=timer) == got
    assert timed == [] and cache.hits == 1


def test_search_agrees_when_the_model_is_fastest():
    cache = tcache.TileCache(path=None)
    pick = search.model_pick("gemm", YI_DECODE, dtype_name="bfloat16",
                             sms=H100_SMS)
    assert search.autotune("gemm", YI_DECODE, dtype_name="bfloat16",
                           sms=H100_SMS, cache=cache,
                           timer=_fake_timer(pick)) == pick
    [entry] = cache.entries.values()
    assert entry["agrees_with_model"] is True


def test_shortlist_keeps_the_top_n_of_each_tile_and_the_pick():
    cands = kg.candidates(4, 4096, 4096)
    pick = search.model_pick("gemm", (4, 4096, 4096), dtype_name="bfloat16",
                             sms=H100_SMS)
    short = search.shortlist(cands, kg.CHOICE, top_n=2, keep=pick)
    tiles = {(c["BM"], c["BN"]) for c in cands}
    assert {(c["BM"], c["BN"]) for c in short} == tiles
    for t in tiles:
        mine = sorted(c["est"] for c in cands if (c["BM"], c["BN"]) == t)
        got = sorted(c["est"] for c in short if (c["BM"], c["BN"]) == t)
        assert got[:2] == mine[:2]
    assert pick in {(c["BM"], c["BN"], c["split"]) for c in short}


def test_measuring_on_the_cpu_raises_and_names_the_card():
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        search.autotune("gemm", YI_DECODE, dtype_name="bfloat16",
                        sms=H100_SMS, cache=tcache.TileCache(path=None))


def test_warm_up_reports_tuned_then_hit(tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.core.unified import serving_cells
    from repro_torch.launch.serve import warm_tile_cache
    from repro_torch.models.model import Model
    from repro_torch.serving import PagedEngine
    cfg = get_arch("yi-6b")
    geoms = PagedEngine.pool_geoms(Model(cfg), slots=4, page_size=16,
                                   max_len=512)
    assert geoms == [(4, 512, 128, 0)]
    path = str(tmp_path / "plans.json")
    kw = dict(slots=4, prompt_lens=[64], cache_len=512, autotune=True,
              prefill_batch=4, paged_geoms=geoms, page_size=16,
              timer=lambda choice: 1.0 + choice[-1])
    lines = []
    tuning.set_tile_cache(path)
    first = warm_tile_cache(cfg, log=lines.append, **kw)
    n_cells = len(serving_cells(cfg, slots=4, prompt_len=64, cache_len=512,
                                prefill_batch=4))
    assert n_cells == 10
    assert first == ["tuned"] * (n_cells + 1)
    assert tuning.get_tile_mode() == "cached"
    assert lines[-1] == (f"tile-cache: 0/{n_cells + 1} cells hit "
                         f"({n_cells + 1} tuned, 0 skipped this run)")
    tuning.set_tile_cache(path)        # a second server: the file alone
    lines.clear()
    second = warm_tile_cache(cfg, log=lines.append, **kw)
    assert second == ["hit"] * (n_cells + 1)
    assert lines[-1] == (f"tile-cache: {n_cells + 1}/{n_cells + 1} cells "
                         "hit — fully warm")
    assert sum("tile-cache hit" in ln for ln in lines) == n_cells + 1


def test_moe_warm_up_covers_both_widths_and_directions():
    from repro_torch.configs import get_arch
    cfg = get_arch("mixtral-8x22b")
    cache = tcache.TileCache(path=None)
    st = tuning.warm_moe_gemm(cfg, [4, 256], cache=cache,
                              timer=lambda c: 1.0 + c[1])
    assert st == ["tuned"] * 4
    keys = sorted(cache.entries)
    assert keys == sorted(
        f"moe_gemm:m{8 * cap}:k{k}:n{n}:bfloat16:cuda"
        for cap in (1, 80) for k, n in ((6144, 16384), (16384, 6144)))
    assert all(e["split"] == 1 for e in cache.entries.values())


def test_policy_modes_and_memo():
    pick = search.model_pick("gemm", YI_DECODE, dtype_name="bfloat16",
                             sms=H100_SMS)
    other = _non_default_gemm(*YI_DECODE)
    choose = lambda mode=None: elastic.choose_tiles(  # noqa: E731
        "gemm", YI_DECODE, dtype_name="bfloat16", sms=H100_SMS, mode=mode)
    assert tuning.get_tile_mode() == "model" and choose() is None
    cache = tuning.get_tile_cache()
    assert choose("cached") is None and cache.misses == 1
    search.autotune("gemm", YI_DECODE, dtype_name="bfloat16", sms=H100_SMS,
                    cache=cache, timer=_fake_timer(other))
    tuning.set_tile_mode("cached")
    assert choose() == other != pick and cache.hits == 1
    for _ in range(5):                 # memoized: one lookup counted
        assert choose() == other
    assert cache.hits == 1
    # a plan the kernel would run is the one plan(choice=...) rebuilds
    q = kg.plan(*YI_DECODE, choice=choose())
    assert (q["BM"], q["BN"], q["split"]) == other
    with pytest.raises(ValueError):
        tuning.set_tile_mode("fastest")
    with pytest.raises(ValueError):
        choose("fastest")


def test_launch_plans_are_kept_per_choice(monkeypatch):
    """Each wrapper's ``_launch_plan`` keys on the resolved choice, so a
    plan kept under ``model`` never outlives a later ``--tile-cache``: the
    same call shape with a cached choice gets that choice's plan."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    shapes = {"gemm": (YI_DECODE, kg, lambda c: (*YI_DECODE, torch.bfloat16,
                                                 0, 16, 16, c)),
              "paged_decode": ((4, 32, 32, 64, 16, 32), pa,
                               lambda c: (4, 32, 32, 64, 16, 32,
                                          torch.bfloat16, True, 0, c)),
              "moe_gemm": ((8, 1, 6144, 16384), mg,
                           lambda c: (8, 1, 6144, 16384, torch.bfloat16, 0,
                                      16, 16, c))}
    try:
        for op_kind, (shape, mod, args) in shapes.items():
            fields = search._op(op_kind).fields
            pick = search.model_pick(op_kind, shape, dtype_name="bfloat16",
                                     sms=H100_SMS)
            other = next(tuple(c[f] for f in fields)
                         for c in search.candidates_of(
                             op_kind, shape, dtype_name="bfloat16",
                             sms=H100_SMS)
                         if tuple(c[f] for f in fields) != pick)
            q0, _ = mod._launch_plan(*args(None))
            q1, c_fields = mod._launch_plan(*args(other))
            assert tuple(q0[f] for f in fields) == pick
            assert tuple(q1[f] for f in fields) == other
            assert list(c_fields) == [q1[f] for f in mod.PLAN_FIELDS]
            assert mod._launch_plan(*args(None))[0] is q0
        xs, ks = (1, 14, 14, 512), (3, 3, 512, 512)
        conv = lambda c: kc._launch_plan(  # noqa: E731
            xs, ks, (1, 1), ((1, 1), (1, 1)), 7, torch.bfloat16,
            torch.bfloat16, H100_SMS, 16, 16, c)
        bn = conv(None)[0]["BN"]
        assert conv((192 - bn, None))[0]["BN"] == 192 - bn
    finally:
        for mod in (kg, pa, mg, kc):
            mod._launch_plan.cache_clear()


def test_policy_env(monkeypatch, tmp_path):
    monkeypatch.setenv("KRAKEN_TILE_MODE", "cached")
    assert tuning.get_tile_mode() == "cached"
    monkeypatch.setenv("KRAKEN_TILE_MODE", "bogus")
    assert tuning.get_tile_mode() == "model"
    path = str(tmp_path / "env.json")
    monkeypatch.setenv("KRAKEN_TILE_CACHE", path)
    assert tuning.set_tile_cache(None).path == path


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_cli_cpu_tile_cache_loads_and_serves(tmp_path, capsys):
    from repro_torch.launch import serve
    path = tmp_path / "plans.json"
    cache = tcache.TileCache(str(path))
    search.autotune("gemm", YI_DECODE, dtype_name="bfloat16", sms=H100_SMS,
                    cache=cache, timer=_fake_timer(_non_default_gemm(
                        *YI_DECODE)))
    rc = serve.main(["--smoke", "--device", "cpu", "--tile-cache", str(path),
                     "--requests", "2", "--max-new", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"tile-cache: loaded 1 entries from {path}" in out
    assert "served 2/2 requests" in out
    assert tuning.get_tile_mode() == "cached"


def test_cli_cpu_autotune_fails(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as exc:
        serve.main(["--smoke", "--device", "cpu", "--autotune"])
    assert exc.value.code != 0
    assert "no kernel runs to measure" in capsys.readouterr().err
