"""The port's cross-attention family, llama-3.2-vision-11b, against the JAX
package, on the CPU.

Smoke width, float32: both models run the same parameters, ``repro``'s own
``Model(cfg).init(jax.random.key(0))`` bridged to torch, on the same
numpy-seeded tokens and image patches (``[B, 8, d_model]``: the smoke
config keeps 8 of the 1601 patches).  One period of the stack, so four
self-attention layers and the cross layer.

* Unmasked ``_gqa_sdpa`` and the cross slot (no RoPE, no mask; without a
  cache, into a cache, and over frozen rows) against JAX's functions.
* ``forward`` with the patches, and ``prefill`` + ``decode_step`` with them:
  logits and every cache leaf, the cross layer's frozen K/V rows included,
  within ``rtol = atol = 1e-4`` (float32; the packages differ only in the
  order of their sums).
* Text-only serving, as JAX's engine serves: the engine's greedy tokens
  equal JAX's ``PagedEngine`` and the port's sequential path at chunk 4
  and 8 (three slots, four requests: a slot freed and refilled), and every
  slot's cross rows are exactly zero after every step, so a cross layer
  adds an exact zero; with int8 pools the tokens equal JAX's int8 engine
  (its Pallas kernel in interpret mode); preemption and speculation equal
  JAX's engine with the same feature on.
* The cross rows through the serving hooks: a swap round trip and a
  speculation snapshot restore them bit for bit, a reset zeroes one slot's,
  and the prefix cache never serves the model (hit rate 0, as JAX's).

``tests/test_torch_audio.py`` reuses the helpers below for musicgen.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.llama32_vision_11b import CONFIG as JCONFIG  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serving import CacheConfig as JCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedEngine as JPagedEngine  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.llama32_vision_11b import CONFIG  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import _flatten  # noqa: E402
from repro_torch.serving import (CacheConfig, EngineConfig,  # noqa: E402
                                 PagedEngine, SlotRowState, build_state_tree)

from test_torch_dense_cache import sequential_greedy, setup_pair  # noqa: E402
from test_torch_features import (check_clean, engines, programs,  # noqa: E402
                                 prompts, replay)
from test_torch_recurrent import _assert_caches_match  # noqa: E402

ARCH = "llama-3.2-vision-11b"
TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# helpers (tests/test_torch_audio.py uses them too)
# ---------------------------------------------------------------------------

def jax_paths(jparams) -> dict:
    """{port path: shape} of a JAX parameter tree (``stack/slots[0]/x``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = ""
        for k in path:
            if isinstance(k, jax.tree_util.DictKey):
                key += ("/" if key else "") + str(k.key)
            else:
                key += f"[{k.idx}]"
        out[key] = tuple(np.asarray(leaf).shape)
    return out


def check_config_and_params(arch, jconfig, config, leaves):
    """The port's config module equals JAX's field for field with the same
    parameter count; the bridged smoke parameters have JAX's paths and
    shapes, ``leaves`` among them, and nothing else."""
    assert dataclasses.asdict(config) == dataclasses.asdict(jconfig)
    assert config == get_arch(arch)
    assert config.param_count() == jconfig.param_count() \
        == jget_arch(arch).param_count()
    jmodel, jparams, model, params = setup_pair(arch)
    want = jax_paths(jparams)
    got = {p: tuple(t.shape) for p, t in _flatten(params)}
    assert got == want
    assert {p: n for p, n in model.param_numels()} == {
        p: int(np.prod(s)) for p, s in want.items()}
    assert set(leaves) <= set(got)


def frontend(cfg, b, n, seed):
    """Seeded patch or frame embeddings [b, n, d_model] (float32)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)


def tokens(shape, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def forward_pair(arch, toks, fe):
    """(port logits, JAX logits) of ``forward`` with ``fe`` (or none)."""
    jmodel, jparams, model, params = setup_pair(arch)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    if fe is not None:
        jb["frontend"], tb["frontend"] = jnp.asarray(fe), torch.from_numpy(fe)
    want, _, _ = jmodel.forward(jparams, jb)
    got, _, _ = model.forward(params, tb)
    return got.numpy(), np.asarray(want)


def prefill_decode_pair(arch, fe_prefill, fe_steps, s=6, steps=3):
    """Two rows prefill ``s`` tokens with ``fe_prefill`` (or none), then
    decode ``steps`` tokens at their own positions with ``fe_steps[i]``:
    logits and every cache leaf agree with JAX's after each step.  Returns
    the port's caches."""
    jmodel, jparams, model, params = setup_pair(arch)
    jc = jmodel.init_caches(2, 16, flat=True)
    tc = model.init_caches(2, 16, device="cpu")
    _assert_caches_match(jc, tc)
    toks = tokens((2, s), 1)
    pos = np.arange(s, dtype=np.int32)
    jb = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}
    tb = {"tokens": torch.from_numpy(toks), "positions": torch.from_numpy(pos)}
    if fe_prefill is not None:
        jb["frontend"] = jnp.asarray(fe_prefill)
        tb["frontend"] = torch.from_numpy(fe_prefill)
    want, jc = jmodel.prefill(jparams, jb, jc)
    got, tc = model.prefill(params, tb, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches_match(jc, tc)
    for step in range(steps):
        tok = tokens((2, 1), 10 + step)
        p = np.asarray([s + step, s + step + 3], np.int32)
        fe = fe_steps[step] if fe_steps is not None else None
        want, jc = jmodel.decode_step(
            jparams, jc, jnp.asarray(tok), jnp.asarray(p),
            frontend=None if fe is None else jnp.asarray(fe))
        got, tc = model.decode_step(
            params, tc, torch.from_numpy(tok), torch.from_numpy(p),
            frontend=None if fe is None else torch.from_numpy(fe))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_caches_match(jc, tc)
    return tc


def engine_pair(arch, chunk, kv="", jax_kernel=None, slots=3):
    """The JAX and the port engine on ``arch``'s float32 smoke pair."""
    jmodel, jparams, model, params = setup_pair(arch, kv)
    jeng = JPagedEngine(jmodel, jparams, config=JEngineConfig(
        slots=slots, chunk=chunk, decode_kernel=jax_kernel,
        cache=JCacheConfig(page_size=4, max_len=32)))
    teng = PagedEngine(model, params, config=EngineConfig(
        slots=slots, chunk=chunk, cache=CacheConfig(page_size=4, max_len=32)))
    return jeng, teng


def serve_cli(arch) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "3", "--repeat",
                         "2", "--chunk", "8", "--prompt-lens", "3,9,17"])
    text = out.getvalue()
    assert rc == 0, text
    assert "pass 2: prefill retraces=0 decode retraces=0" in text
    assert "served 6/6 requests" in text
    return text


def cross_rows(eng_or_tree, pools):
    """The device leaf ``{"k", "v"}`` of every cross-attention layer."""
    tree = getattr(eng_or_tree, "state", eng_or_tree)
    flat = [c for col in pools["slots"] for c in col] + list(pools["tail"])
    leaves = [leaf for st, leaf in zip(tree.leaves(), flat)
              if isinstance(st, SlotRowState) and st.slot.kind == "cross"]
    assert leaves
    return leaves


def all_zero(leaves) -> bool:
    return all(not leaf[k].any() for leaf in leaves for k in ("k", "v"))


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

def test_config_and_param_tree_match():
    check_config_and_params(ARCH, JCONFIG, CONFIG, [
        "stack/slots[4]/cross_kv_norm_gamma", "stack/slots[4]/attn_wq",
        "stack/slots[4]/attn_wk", "stack/slots[4]/attn_wv",
        "stack/slots[4]/attn_wo", "stack/slots[4]/mlp_wi_gate"])
    _, _, model, _ = setup_pair(ARCH)
    assert [s.kind for s in model.stack.pattern] == ["attn"] * 4 + ["cross"]


@pytest.mark.parametrize("sq", [5, 2048])
def test_unmasked_gqa_sdpa_matches_jax(sq, monkeypatch):
    """Every key is visible; at 2048 queries the unmasked mode stays on the
    direct form, as JAX's dispatch keeps it."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    qp, kp = np.arange(sq, dtype=np.int32), np.arange(9, dtype=np.int32)
    want = JL._gqa_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        mask_mode="none", window=0, q_pos=jnp.asarray(qp),
                        kv_pos=jnp.asarray(kp))

    def refuse(*a, **kw):
        raise AssertionError("the unmasked mode took the chunked form")

    monkeypatch.setattr(TL, "_gqa_sdpa_chunked", refuse)
    got = TL._gqa_sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), window=0,
                       q_pos=torch.from_numpy(qp), kv_pos=torch.from_numpy(kp),
                       mask_mode="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["forward", "prefill", "decode",
                                  "text-only"])
def test_cross_slot_matches_jax(mode):
    """The cross slot (``apply_slot``: norm, ``_cross``, the MLP) against
    JAX's: with the patches and no cache (``forward``), with the patches
    into a zero cache (``prefill``: the frozen K/V rows too), and over
    seeded rows in decode and in a text-only prefill (no RoPE, no mask)."""
    from repro.models import transformer as JT
    jmodel, jparams, model, params = setup_pair(ARCH)
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["slots"][4])
    tp = {k: w[0] for k, w in params["stack"]["slots"][4].items()}
    cfg = model.cfg
    b, n = 2, cfg.num_frontend_tokens
    seq = 1 if mode == "decode" else 6
    x = frontend(cfg, b, seq, 3)
    pos = (np.full((b, 1), 9, np.int32) if mode == "decode"
           else np.arange(seq, dtype=np.int32))
    fe = frontend(cfg, b, n, 4) if mode in ("forward", "prefill") else None
    rows = None
    if mode != "forward":
        shape = (b, cfg.num_kv_heads, n, cfg.head_dim)
        rng = np.random.default_rng(5)
        rows = {name: (np.zeros(shape, np.float32) if mode == "prefill"
                       else rng.standard_normal(shape).astype(np.float32))
                for name in ("k", "v")}
    jmode = "train" if mode == "forward" else (
        "decode" if mode == "decode" else "prefill")
    jctx = JT.Ctx(jmode, jnp.asarray(pos),
                  None if fe is None else jnp.asarray(fe), None)
    want, wcache, _ = JT.apply_slot(
        jmodel.cfg, JT.Slot("cross", "mlp"), jp, jnp.asarray(x),
        None if rows is None else jax.tree.map(jnp.asarray, rows), jctx)
    tctx = T.Ctx(jmode, torch.from_numpy(pos),
                 None if fe is None else torch.from_numpy(fe))
    tcache = (None if rows is None
              else {k: torch.from_numpy(a.copy()) for k, a in rows.items()})
    got, gcache, _ = T.apply_slot(cfg, T.Slot("cross", "mlp"), tp,
                                  torch.from_numpy(x), tcache, tctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if rows is None:
        assert gcache is None and wcache is None
        return
    for name in ("k", "v"):
        np.testing.assert_allclose(gcache[name].numpy(),
                                   np.asarray(wcache[name]), **TOL)
    if mode != "prefill":
        np.testing.assert_array_equal(gcache["k"].numpy(), rows["k"])


def test_cross_layer_over_zero_rows_adds_exact_zero():
    """Text-only serving: over all-zero K/V rows the weights are uniform,
    the values zero and ``attn_wo`` has no bias, so the layer's output is
    exactly zero and the residual passes unchanged."""
    _, _, model, params = setup_pair(ARCH)
    tp = {k: w[0] for k, w in params["stack"]["slots"][4].items()}
    cfg = model.cfg
    cache = T.slot_cache(cfg, T.Slot("cross", "mlp"), 3, 1, torch.float32,
                         device="cpu")
    assert cache["k"].shape == (3, cfg.num_kv_heads, 8, cfg.head_dim)
    h = torch.from_numpy(frontend(cfg, 3, 5, 5))
    y = T._cross_from_cache(cfg, tp, h, cache, TL.DEFAULT_KERNELS)
    assert y.shape == h.shape and not y.any()


@pytest.mark.parametrize("seq", [7, 16])
def test_forward_with_image_patches_matches_jax(seq):
    cfg = setup_pair(ARCH)[2].cfg
    fe = frontend(cfg, 2, cfg.num_frontend_tokens, seq)
    got, want = forward_pair(ARCH, tokens((2, seq), seq), fe)
    np.testing.assert_allclose(got, want, **TOL)
    # the patches reach the output (other patches: ``cross_kv_norm``
    # would normalize a scaled copy away)
    other, _ = forward_pair(ARCH, tokens((2, seq), seq),
                            frontend(cfg, 2, cfg.num_frontend_tokens, 99))
    assert np.abs(other - got).max() > 1e-3


def test_prefill_and_decode_with_image_patches_match():
    """The prefill projects the patches' K/V into the cross rows (non-zero,
    equal to JAX's); decode reads them frozen and ignores a frontend."""
    cfg = setup_pair(ARCH)[2].cfg
    fe = frontend(cfg, 2, cfg.num_frontend_tokens, 2)
    tc = prefill_decode_pair(ARCH, fe, [fe, None, fe])
    cross = tc["slots"][4][0]
    assert cross["k"].any() and cross["v"].any()


def test_text_only_prefill_and_decode_match_with_zero_rows():
    tc = prefill_decode_pair(ARCH, None, None)
    assert all_zero([tc["slots"][4][0]])


# ---------------------------------------------------------------------------
# the engine: text-only serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 8])
def test_engine_token_identical_to_jax_with_zero_cross_rows(chunk):
    jeng, teng = engine_pair(ARCH, chunk)
    work = prompts([3, 5, 9, 12])
    for p in work:
        jeng.submit(p, 5)
        teng.submit(p, 5)
    want = jeng.run_until_idle()
    steps = 0
    while not teng.sched.idle:
        teng.step()
        steps += 1
        assert all_zero(cross_rows(teng, teng.pools)), steps
    got = {r.rid: list(r.out) for r in teng.sched.done}
    assert len(got) == 4 and got == want
    _, _, model, params = setup_pair(ARCH)
    assert [got[i] for i in range(4)] == [
        sequential_greedy(model, params, p, 5) for p in work]
    assert programs(teng) == (1, 1, 1) and teng.state.has_rows
    assert teng.stats()["max_decode_stall"] == 0
    check_clean(teng)


def test_int8_pools_token_identical_to_jax_int8_engine():
    jeng, teng = engine_pair(ARCH, 4, kv="int8", jax_kernel="interpret",
                             slots=2)
    pool = teng.pools["slots"][0][0]
    assert pool.quantized and pool.k.dtype == torch.int8
    work = prompts([3, 5, 9, 12], seed=13)
    for p in work:
        jeng.submit(p, 4)
        teng.submit(p, 4)
    want, got = jeng.run_until_idle(), teng.run_until_idle()
    assert len(got) == 4 and got == want
    assert all_zero(cross_rows(teng, teng.pools))
    check_clean(teng)


def test_preemption_matches_jax():
    """A RUNNING slot swapped out to host and back: the snapshot carries
    its cross rows with its pages; tokens equal JAX's and the replay's."""
    jeng, eng = engines(ARCH, preempt=True)
    subs = [(i, p, 6, 0) for i, p in enumerate(prompts([5, 9]))]
    outs = []
    for e in (jeng, eng):
        for rid, p, mn, _ in subs:
            e.submit(p, mn, rid=rid)
        for _ in range(3):
            e.step()
        slot = next(i for i, r in enumerate(e.active)
                    if r is not None and r.state == "running")
        e.preempt(slot)
        outs.append(e.run_until_idle())
    assert outs[1] == outs[0] == replay(eng, subs)
    assert eng.stats()["preemptions"] == eng.stats()["resumes"] == 1
    assert programs(eng) == (1, 1, 1)
    check_clean(eng)


@pytest.mark.parametrize("drafter", ["ngram", "junk"])
def test_speculation_matches_jax(drafter):
    from test_torch_speculative import JunkDrafter
    from repro_torch.serving import NGramDrafter
    make = {"ngram": NGramDrafter, "junk": JunkDrafter}[drafter]
    jeng, eng = engines(ARCH, speculate=4, drafter=make())
    work = prompts([5, 9, 12])
    subs = [(i, p, 8, 0) for i, p in enumerate(work)]
    for e in (jeng, eng):
        for rid, p, mn, _ in subs:
            e.submit(p, mn, rid=rid)
    want, got = jeng.run_until_idle(), eng.run_until_idle()
    assert got == want == replay(eng, subs)
    s, js = eng.stats(), jeng.stats()
    for key in ("spec_steps", "spec_drafted", "spec_accepted",
                "decode_steps", "steps"):
        assert s[key] == js[key], key
    if drafter == "junk":
        assert s["spec_drafted"] > 0 and s["spec_accepted"] == 0
    assert all_zero(cross_rows(eng, eng.pools))
    check_clean(eng)


def test_prefix_cache_never_serves_the_model():
    """Cross rows are whole-row states: the model opts out of the prefix
    cache, and the engine reports a hit rate of 0, as JAX's does."""
    jeng, eng = engines(ARCH, chunk=8, prefix_cache=True)
    shared = prompts([16], seed=5)[0]
    work = [np.concatenate([shared, p]) for p in prompts([3, 5, 7])]
    for e in (jeng, eng):
        for p in work:
            e.submit(p, 4)
    want, got = jeng.run_until_idle(), eng.run_until_idle()
    assert got == want
    assert eng.prefix_cache is None and jeng.prefix_cache is None
    assert eng.stats()["prefix_hit_rate"] == jeng.stats()["prefix_hit_rate"] \
        == 0.0
    check_clean(eng)


def test_cross_rows_through_swap_snapshot_truncate_and_reset():
    _, _, model, _ = setup_pair(ARCH)
    tree = build_state_tree(model, slots=3, page_size=4, max_len=16,
                            device="cpu")
    for s in range(3):
        tree.admit(s)
    pools = tree.push_tables(tree.init_device())
    leaves = cross_rows(tree, pools)
    assert all_zero(leaves)
    g = torch.Generator().manual_seed(0)
    for leaf in leaves:
        for t in leaf.values():
            t.copy_(torch.randn(t.shape, generator=g))
    before = [{k: t.clone() for k, t in leaf.items()} for leaf in leaves]

    def same():
        return all(torch.equal(leaf[k], b[k]) for leaf, b in
                   zip(leaves, before) for k in ("k", "v"))

    snap = tree.swap_out(pools, 1)
    for leaf in leaves:
        for t in leaf.values():
            t[1].zero_()
    assert not same()
    pools = tree.swap_in(pools, 1, snap)
    assert same()
    spec = tree.spec_snapshot(pools, 2)
    pools = tree.truncate(pools, 2, 3, snap=spec)
    assert same()
    pools = tree.reset(pools, torch.tensor([0, -1, -1]))
    assert all(not leaf[k][0].any() and torch.equal(leaf[k][1:], b[k][1:])
               for leaf, b in zip(leaves, before) for k in ("k", "v"))
    assert {st.geometry().kind for st in tree.leaves()} == {"slot_rows",
                                                            "paged_kv"}


def test_serve_cli_on_cpu():
    serve_cli(ARCH)
