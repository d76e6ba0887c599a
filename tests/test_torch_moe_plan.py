"""The bf16 ``grouped_moe_gemm`` kernel's plan and addressing, on the CPU (the
kernel itself has no CPU mode).

* :func:`repro_torch.kernels.kraken_moe_gemm.plan` for every case of
  :mod:`repro_torch.core.moe_cases` (which ``chip_smoke.py`` and the card
  tests run on the card), for mixtral's and llama4's decode and mixed steps
  at 1, 4 and 64 slots (their capacities as ``moe.expert_capacity`` gives
  them, with routed, one-live and all-empty sizes) and for the smoke
  configs: the plan fits the card's 227 KB of shared memory, its work items
  (as the kernel walks them from ``sizes``) cover every live tile once per
  split, its splits are disjoint runs of d that together are all of it, the
  kernel splits only when the live tiles fall under the H100's 132 SMs, and
  the route is ``wgmma`` exactly where TMA takes both operands.
* A numpy emulation of ``csrc/grouped_moe_gemm.cu``: the live table built
  from ``sizes``, the work items, the 3-D TMA boxes (rows past C arrive as
  zeros, not the next expert's), the 128-byte swizzle, the K-major A and
  MN-major B descriptor reads, the epilogue's mask, the dead tiles' zero
  fill and the split's fixed-order sum.  Held against ``ref.grouped_moe_gemm``
  and JAX's ``reference_grouped_gemm`` and Pallas ``grouped_moe_gemm`` in
  interpret mode, with garbage and Inf in dead rows, an empty expert, an
  all-empty call and sizes past C and below 0; a dropped split, an unmasked
  dead row, B one swizzle chunk off, the expert one off and the last d step
  not drained must fail it.
* The plan's field order: ``PLAN_FIELDS`` against the kernel source's
  ``GROUPED_MOE_GEMM_PLAN`` list (the library also reports it when loaded).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import kraken_moe_gemm as JMG  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.core import moe_cases  # noqa: E402
from repro_torch.core.elastic import ceil_div  # noqa: E402
from repro_torch.kernels import kraken_moe_gemm as mg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.moe import expert_capacity  # noqa: E402
from test_torch_gemm_plan import ROW, read_a, read_b, tma_box  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

H100_SMS = 132
SMEM_MAX = 227 * 1024


def _routed(e, tokens, k, seed):
    """Per-expert sizes of ``tokens`` tokens routed top-``k`` at random."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(e, k, replace=False) for _ in range(tokens)])
    return np.bincount(ids.ravel(), minlength=e).tolist()


def _model_cases():
    """mixtral's and llama4's grouped GEMMs at the decode and mixed steps of
    1, 4 and 64 slots (chunk 64), and the smoke configs' at 4 slots."""
    out = []
    archs = [(a, get_arch(a)) for a in ("mixtral-8x22b",
                                        "llama4-maverick-400b-a17b")]
    archs += [(a + " smoke", smoke_config(cfg)) for a, cfg in archs]
    for name, cfg in archs:
        e, k = cfg.num_experts, cfg.experts_per_token
        widths = [("gate|up", cfg.d_model, cfg.moe_d_ff),
                  ("down", cfg.moe_d_ff, cfg.d_model)]
        slots = (4,) if "smoke" in name else (1, 4, 64)
        for s in slots:
            for step, tokens in (("decode", s), ("mixed", s * 64)):
                c = expert_capacity(tokens, cfg)
                for wname, d, f in widths:
                    for sname, sizes in (
                            ("routed", _routed(e, tokens, k, s)),
                            ("one live", [0] * (e - 1) + [min(tokens, c)]),
                            ("all empty", [0] * e)):
                        out.append((f"{name} {wname} {step} {s} slots "
                                    f"{sname}", e, c, d, f, sizes))
    return out


PLAN_CASES = ([(n, e, c, d, f, moe_cases.moe_sizes(s, e))
               for n, e, c, d, f, s, _ in moe_cases.MOE_CASES]
              + [(n, e, c, d, f, s)
                 for n, e, c, d, f, s, _ in moe_cases.MOE_EDGE]
              + _model_cases())


def work_items(q, sizes):
    """Every work item of a wgmma call, as every block builds its live table
    from ``sizes`` and decodes item t (live m tile fastest, then n tile,
    then split z): (e, m0, n0, z, k0, ksteps), and the split taken."""
    bm = q["BM"]
    cnt = [ceil_div(min(max(int(s), 0), q["C"]), bm) for s in sizes]
    pre = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    live = int(pre[-1])
    split = mg.live_split(q, live * q["ntiles"])
    kps = ceil_div(q["nk"], split)
    items = []
    for t in range(live * q["ntiles"] * split):
        lt, rest = t % live, t // live
        e = int(np.searchsorted(pre[:-1], lt, side="right") - 1)
        z = rest // q["ntiles"]
        k0 = z * kps
        items.append((e, int(lt - pre[e]) * bm, (rest % q["ntiles"]) * q["BN"],
                      z, k0, min(kps, q["nk"] - k0)))
    return items, split


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_fits_covers_and_splits_only_when_under_filled(case):
    _, e, c, d, f, sizes = case
    q = mg.plan(e, c, d, f, sms=H100_SMS)
    assert (q["E"], q["C"], q["d"], q["f"]) == (e, c, d, f)
    # the wgmma route exactly where TMA takes both operands
    assert (q["path"] == mg.PATH_WGMMA) == (d % 8 == 0 and f % 8 == 0
                                           and e <= mg.EMAX)
    if q["path"] == mg.PATH_TILE:
        assert all(q[k] == 0 for k in mg.PLAN_FIELDS[6:])
        return
    # 64 x 256 at decode, 128 x 128 where C > 64; a ring of 2-5 stages in
    # 227 KB
    assert q["BM"] == (64 if c <= 64 else 128)
    assert q["BN"] == mg.TILES[q["BM"]]
    assert 2 <= q["stages"] <= mg.STAGES_MAX
    assert q["smem"] == q["stages"] * (q["BM"] + q["BN"]) * ROW + mg.RESERVED
    assert q["smem"] <= SMEM_MAX
    assert q["nk"] == ceil_div(d, mg.KB)
    assert (q["mtiles"], q["ntiles"]) == (ceil_div(c, q["BM"]),
                                         ceil_div(f, q["BN"]))
    assert q["blocks"] == H100_SMS and 1 <= q["split"] <= max(1, q["nk"])
    # the work items cover every live tile once per split; the splits are
    # disjoint non-empty runs of k-steps that together are all of d
    items, split = work_items(q, sizes)
    live = {(i, mt) for i, s in enumerate(sizes)
            for mt in range(ceil_div(min(max(s, 0), c), q["BM"]))}
    seen = {}
    for ie, m0, n0, z, k0, ks in items:
        assert m0 < min(max(sizes[ie], 0), c) and n0 < f
        seen.setdefault((ie, m0 // q["BM"], n0 // q["BN"]), []).append(
            (k0, ks))
    assert set(seen) == {(i, mt, nt) for i, mt in live
                         for nt in range(q["ntiles"])}
    for runs in seen.values():
        runs.sort()
        assert len(runs) == split
        assert runs[0][0] == 0 and runs[-1][0] + runs[-1][1] == q["nk"]
        assert all(a[0] + a[1] == b[0] for a, b in zip(runs, runs[1:]))
        assert all(ks >= 1 for _, ks in runs) or q["nk"] == 0
    # the kernel splits only when the live tiles alone leave SMs idle, and
    # the partials it may write fit the plan's buffer
    tiles = len(live) * q["ntiles"]
    if split > 1:
        assert tiles < H100_SMS and split <= q["split"]
    assert q["split"] == 1 or q["split"] * e * c * f * 4 <= mg.PART_MAX_BYTES


def test_the_served_shapes_take_the_wgmma_route():
    """Every mixtral and llama4 shape (full width and smoke) is planned on
    wgmma, and mixtral's decode step is not split with 6 of 8 experts
    live, but is with one."""
    for name, e, c, d, f, _ in _model_cases():
        assert mg.plan(e, c, d, f)["path"] == mg.PATH_WGMMA, name
    q = mg.plan(8, 1, 16384, 6144)
    assert mg.live_split(q, mg.live_tiles(q, [1, 0, 1, 1, 0, 1, 1, 1])) == 1
    assert mg.live_split(q, mg.live_tiles(q, [0, 0, 0, 1, 0, 0, 0, 0])) > 1


def test_plan_refuses_what_the_kernel_cannot_take():
    for bad in ((0, 1, 64, 64), (4, 0, 64, 64), (4, 1, -1, 64),
                (4, 1, 64, 0)):
        with pytest.raises(ValueError):
            mg.plan(*bad)
    with pytest.raises(ValueError):
        mg.plan(4, 1, 64, 64, torch.float16)


@pytest.mark.parametrize("dtype,path,route", [
    (torch.float32, mg.PATH_TILE, "tile"), (torch.int8, mg.PATH_TILE, "tile"),
    (torch.bfloat16, mg.PATH_WGMMA, "wgmma")])
def test_routes_are_planned_from_the_shapes(dtype, path, route):
    """float32 and int8 keep the tile loop; bf16 takes wgmma unless TMA
    refuses a row stride, a base or the table; ``describe`` names it."""
    q = mg.plan(8, 80, 6144, 16384, dtype)
    assert q["path"] == path
    assert mg.describe(q).startswith(route)
    for d, f, e, align in ((13, 16, 2, 16), (16, 9, 2, 16), (24, 40, 2, 8),
                           (64, 64, mg.EMAX + 1, 16)):
        q = mg.plan(e, 4, d, f, torch.bfloat16, x_align=align)
        assert q["path"] == mg.PATH_TILE
        assert "TMA refuses" in mg.describe(q)


# ---------------------------------------------------------------------------
# a numpy emulation of the kernel
# ---------------------------------------------------------------------------

def emulate(xs, w, sizes, q, *, shift=0, drop=None, unmasked=False,
            expert_off=0, undrained=False):
    """The wgmma kernel over a plan ``q``: each work item's stages as the
    3-D TMA boxes lay them down (an A box [BM, 64] of xs[e], whose rows past
    C are zeros, and BN/64 B boxes [64, 64] of w[e]), the products of each
    consumer warpgroup through the descriptors at k16 steps (A +32 bytes, B
    +2048), float64 sums; the epilogue (rows at or past the size written as
    zeros, or with a split only the live rows' partials); the dead tiles
    zero-filled; a split's partials summed in order z = 0, 1, ... with
    zeros for the dead rows.  Unwritten outputs stay NaN.  ``shift``,
    ``drop``, ``unmasked``, ``expert_off`` and ``undrained`` plant faults:
    B's swizzle off by chunks, a split left out of the sum, no epilogue
    mask, the weights of expert e + 1, the last k-step of each item not
    consumed."""
    e_, c, _ = xs.shape
    f = w.shape[2]
    bm, bn = q["BM"], q["BN"]
    a_bytes = bm * ROW
    rows_of = [min(max(int(s), 0), c) for s in sizes]
    items, split = work_items(q, sizes)
    out = np.full((e_, c, f), np.nan)
    part = np.full((split, e_, c, f), np.nan)
    with np.errstate(invalid="ignore", over="ignore"):
        for e, m0, n0, z, k0, ks in items:
            acc = np.zeros((bm, bn))
            for i in range(ks - (1 if undrained else 0)):
                kk0 = (k0 + i) * mg.KB
                sa = tma_box(xs[e], m0, kk0, bm)
                we = w[(e + expert_off) % e_]
                sb = np.concatenate([tma_box(we, kk0, n0 + 64 * nb, mg.KB,
                                             shift)
                                     for nb in range(bn // 64)])
                smem = np.concatenate([sa, sb])
                for wg in range(bm // 64):
                    for k16 in range(mg.KB // 16):
                        ta = read_a(smem, wg * 64 * ROW + 32 * k16)
                        tb = read_b(smem, a_bytes + 2048 * k16, bn,
                                    mg.KB * ROW)
                        acc[wg * 64:(wg + 1) * 64] += ta @ tb
            nr, nc = min(bm, c - m0), min(bn, f - n0)
            tile = acc[:nr, :nc]
            live = (m0 + np.arange(nr) < rows_of[e])[:, None]
            if split > 1:
                part[z, e, m0:m0 + nr, n0:n0 + nc] = np.where(
                    live, tile, part[z, e, m0:m0 + nr, n0:n0 + nc])
            else:
                out[e, m0:m0 + nr, n0:n0 + nc] = (tile if unmasked else
                                                  np.where(live, tile, 0))
        if split == 1:
            for e in range(e_):
                for m0 in range(0, c, bm):
                    if m0 >= rows_of[e]:
                        out[e, m0:m0 + bm] = 0
        else:
            if drop is not None:
                part[drop] = 0
            total = part[0].copy()
            for z in range(1, split):
                total += part[z]
            live = np.arange(c)[None, :, None] < np.asarray(rows_of)[:,
                                                                     None,
                                                                     None]
            out = np.where(live, total, 0)
    return out.astype(np.float32)


# (name, E, C, d, f, sizes, dead-row fill, sms): small shapes whose plans
# reach both tiles (one and two consumer warpgroups), f under and over BN, a
# split at run time and none, two m tiles, d under one step and d = 0
EMULATED = [
    ("decode, one live expert: split 3", 4, 1, 768, 128, [0, 1, 0, 0],
     99.0, 8),
    ("two m tiles, sizes past C and below 0, Inf", 3, 130, 136, 200,
     [130, 200, -2], np.inf, 4),
    ("mixed, an empty expert, Inf: split 2", 4, 70, 512, 96, [70, 3, 0, 64],
     np.inf, 16),
    ("all empty", 3, 8, 64, 64, [0, 0, 0], 99.0, 8),
    ("d 24, f 40: under one tile", 4, 8, 24, 40, [8, 0, 3, 9], 99.0, 8),
    ("BM 64, BN 256", 2, 64, 128, 512, [64, 20], 99.0, 1),
    ("BM 128, f 64 under BN 128", 2, 100, 192, 64, [100, 20], 99.0, 2),
    ("BM 64, f 128 under BN 256", 3, 16, 256, 128, [16, 5, 0], 99.0, 2),
    ("d 0", 2, 4, 0, 64, [4, 1], 99.0, 4),
]


def _inputs(case, seed=0):
    _, e, c, d, f, sizes, fill, sms = case
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(e, c, d)).astype(np.float32)
    w = (rng.normal(size=(e, d, f)) / np.sqrt(max(d, 1))).astype(np.float32)
    for i, s in enumerate(sizes):
        xs[i, min(max(s, 0), c):] = fill
    q = mg.plan(e, c, d, f, sms=sms)
    want = ref.grouped_moe_gemm(torch.from_numpy(xs), torch.from_numpy(w),
                                torch.tensor(sizes, dtype=torch.int32))
    return xs, w, sizes, q, want.numpy()


@pytest.mark.parametrize("case", EMULATED, ids=[c[0] for c in EMULATED])
def test_emulated_kernel_matches_plain_and_jax(case):
    xs, w, sizes, q, want = _inputs(case)
    got = emulate(xs, w, sizes, q)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for i, s in enumerate(sizes):   # dead rows exactly zero
        assert not got[i, min(max(s, 0), xs.shape[1]):].any()
    jsz = jnp.asarray(sizes, jnp.int32)
    jref = np.asarray(JMG.reference_grouped_gemm(jnp.asarray(xs),
                                                 jnp.asarray(w), jsz))
    # JAX's per-expert loop multiplies the masked rows, so Inf there is NaN
    finite = np.isfinite(xs).all(-1)[..., None]
    np.testing.assert_allclose(np.where(finite, got, 0),
                               np.where(finite, jref, 0), rtol=1e-4, atol=1e-4)
    if xs.shape[2]:
        pallas = np.asarray(JMG.grouped_moe_gemm(
            jnp.asarray(xs), jnp.asarray(w), jsz, interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)


def test_emulated_cases_reach_every_path():
    plans = [_inputs(c)[3] for c in EMULATED]
    assert {(q["BM"], q["BN"]) for q in plans} == set(mg.TILES.items())
    for bm in mg.TILES:   # each tile with f under and over its width
        assert {q["f"] < q["BN"] for q in plans if q["BM"] == bm} == {True,
                                                                     False}
    splits = [work_items(q, c[5])[1] for q, c in zip(plans, EMULATED)]
    assert max(splits) == 3 and 2 in splits and 1 in splits
    assert any(q["mtiles"] > 1 for q in plans)


@pytest.mark.parametrize("fault", ["one split dropped", "dead rows unmasked",
                                   "B one swizzle chunk off",
                                   "expert offset off by one",
                                   "last d step not drained"])
def test_emulated_faults_fail(fault):
    """What the kernel must not do shows: a split left out of the sum, the
    epilogue writing dead rows' products (garbage there), B's swizzle one
    chunk off, the weights of the next expert, the last k-step of each item
    left in the ring."""
    case = EMULATED[0] if fault == "one split dropped" else EMULATED[2]
    xs, w, sizes, q, want = _inputs(case)
    if fault == "dead rows unmasked":
        xs, w, sizes, q, want = _inputs(EMULATED[5])
    kw = {"one split dropped": dict(drop=1),
          "dead rows unmasked": dict(unmasked=True),
          "B one swizzle chunk off": dict(shift=1),
          "expert offset off by one": dict(expert_off=1),
          "last d step not drained": dict(undrained=True)}[fault]
    np.testing.assert_allclose(emulate(xs, w, sizes, q), want, rtol=1e-4,
                               atol=1e-4)
    got = emulate(xs, w, sizes, q, **kw)
    assert not np.allclose(got, want, rtol=1e-2, atol=1e-2)


def test_moe_cases_match_the_configs():
    """The case tables are the models' own widths, and each case's
    capacity the one ``expert_capacity`` gives at 4 slots."""
    mix, l4 = get_arch("mixtral-8x22b"), get_arch("llama4-maverick-400b-a17b")
    for name, e, c, d, f, spec, uses in moe_cases.MOE_CASES:
        cfg = mix if name.startswith("mixtral") else l4
        assert e == cfg.num_experts
        assert {d, f} == {cfg.d_model, cfg.moe_d_ff}
        tokens = 4 if "decode" in name or "empty" in name else 256
        assert c == expert_capacity(tokens, cfg)
        assert len(moe_cases.moe_sizes(spec, e)) == e
    # gate and up (2 calls) and down (1) per MoE layer at decode
    assert sum(u for *_, u in moe_cases.MOE_CASES) == 3
    assert sum(moe_cases.MIXED_USES.values()) == 3


def test_plan_fields_match_the_kernel_source():
    """``PLAN_FIELDS`` is the order of ``GROUPED_MOE_GEMM_PLAN`` in the .cu,
    the list struct Plan and the library's reported names are made from;
    the live table and the reserved bytes agree."""
    src = (ROOT / "src/repro_torch/csrc/grouped_moe_gemm.cu").read_text()
    m = re.search(r"#define GROUPED_MOE_GEMM_PLAN\(X\)((?:.*\\\n)*.*\n)", src)
    assert m, "GROUPED_MOE_GEMM_PLAN not found"
    assert tuple(re.findall(r"X\((\w+)\)", m.group(1))) == mg.PLAN_FIELDS
    assert "struct Plan {\n  GROUPED_MOE_GEMM_PLAN(PLAN_DECL)\n};" in src
    for name, value in (("RESERVED", mg.RESERVED), ("EMAX", mg.EMAX),
                        ("STAGES_MAX", mg.STAGES_MAX), ("KB", mg.KB)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
