"""The port's recurrent families, rwkv6-3b and zamba2-1.2b, against the
JAX package, on the CPU.

Smoke width: both models are built from the same float32 parameters,
``repro``'s own ``Model(cfg).init(jax.random.key(0))`` bridged to torch.
The forward's logits, and the logits and every cache leaf (the RWKV and
Mamba state rows, zamba2's shared-block KV caches) of ``prefill`` and
``decode_step`` agree with JAX's within ``rtol = atol = 1e-4``: float32
throughout, and the two packages differ only in the order of their sums
and in the form of the chunked recurrence (below).  The engine's greedy
tokens are identical to JAX's ``PagedEngine`` and to the port's own
sequential path at chunk 4 and 8, with three slots for four requests (a
slot freed and refilled, slots idle at the end); the reset zeroes a slot's
rows and nothing else; a row with no token keeps its state bit for bit
through the mixed and the decode program; the serve CLI runs both at
smoke width with no new signature on its warm pass.

Full width, one layer of each mixer in float32 with the reference's init
(the ``recurrence`` phase of ``chip_smoke.py`` does the same on the card):
the reference's chunked mix overflows float32 there (``ssm.py:181-182``
for RWKV, ``:399`` for Mamba; its output is NaN at 130 tokens), and the
port's chunked mix is written so that it does not.  So the port is held
to JAX's chunked mix where that is finite (32 tokens for rwkv6-3b, 64 for
zamba2-1.2b), and at 130 tokens, across a chunk edge, to a loop of JAX's
per-token ``rwkv_step`` / ``mamba_step``, with two rows of different
lengths.  The outputs agree within ``1e-4 * max |want|`` (the largest
difference seen is 6e-6 of it, at 130 tokens of rwkv6-3b) and the final
states within ``1e-5 * max |state|`` (seen: 1.3e-6).  A synthetic decay
far past float32's range checks the same on the bare scans, and a
profiler run that the scans run inside the range the card's traces
group.
"""

import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.layers import init_param as jinit_param  # noqa: E402
from repro.serving import CacheConfig as JCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedEngine as JPagedEngine  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.layers import KVCache  # noqa: E402
from repro_torch.serving import (CacheConfig, EngineConfig,  # noqa: E402
                                 PagedEngine, SlotRowState, build_state_tree)

from test_torch_dense_cache import sequential_greedy, setup_pair  # noqa: E402

ARCHS = ["rwkv6-3b", "zamba2-1.2b"]
TOL = dict(rtol=1e-4, atol=1e-4)
# full width: output within Y_TOL * max|want|, states within S_TOL * max|state|
Y_TOL, S_TOL = 1e-4, 1e-5


def _port_leaves(tree):
    """The port's cache tensors in ``jax.tree.leaves`` order (dicts by
    sorted key; KVCache fields k, v, pos)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, KVCache):
        return [tree.k, tree.v, tree.pos]
    return [x for c in tree for x in _port_leaves(c)]   # list, NamedTuple


def _assert_caches_match(jcaches, tcaches):
    want, got = jax.tree.leaves(jcaches), _port_leaves(tcaches)
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape and str(g.dtype).endswith(str(w.dtype))
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, **TOL)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# smoke width: the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_trees_match(arch):
    jmodel, jparams, model, params = setup_pair(arch)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jmodel.cfg)
    assert get_arch(arch).param_count() == jget_arch(arch).param_count()
    want = {jax.tree_util.keystr(p): np.asarray(x).shape
            for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert len(list(model.param_numels())) == len(want)
    cfg = model.cfg
    assert (cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel) == (
        jmodel.cfg.ssm_state, jmodel.cfg.ssm_heads, jmodel.cfg.conv_kernel)
    if arch == "zamba2-1.2b":
        assert cfg.mamba_per_shared_attn == 2 and model.stack.has_shared
        assert tuple(params["stack"]["shared"]["shared_attn_wq"].shape) == \
            want["['stack']['shared']['shared_attn_wq']"]


@pytest.mark.parametrize("seq", [7, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch, seq):
    jmodel, jparams, model, params = setup_pair(arch)
    tokens = _tokens((2, seq), seq)
    want, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    got, _, _ = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_with_their_states(arch):
    """Two rows prefill 6 tokens, then decode three steps at their own
    positions: logits and every state row and KV cache agree after each."""
    jmodel, jparams, model, params = setup_pair(arch)
    jc = jmodel.init_caches(2, 16, flat=True)
    tc = model.init_caches(2, 16, device="cpu")
    _assert_caches_match(jc, tc)
    tokens = _tokens((2, 6), 1)
    pos = np.arange(6, dtype=np.int32)
    want, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                        "positions": jnp.asarray(pos)}, jc)
    got, tc = model.prefill(params, {"tokens": torch.from_numpy(tokens),
                                     "positions": torch.from_numpy(pos)}, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches_match(jc, tc)
    for step in range(3):
        tok = _tokens((2, 1), 10 + step)
        p = np.asarray([6 + step, 6 + step], np.int32)
        want, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok),
                                      jnp.asarray(p))
        got, tc = model.decode_step(params, tc, torch.from_numpy(tok),
                                    torch.from_numpy(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_caches_match(jc, tc)


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_token_identical_to_jax(arch, chunk):
    jmodel, jparams, model, params = setup_pair(arch)
    prompts = [_tokens((n,), 7 + n) for n in (3, 5, 9, 12)]
    jeng = JPagedEngine(jmodel, jparams, config=JEngineConfig(
        slots=3, chunk=chunk, cache=JCacheConfig(page_size=4, max_len=32)))
    teng = PagedEngine(model, params, config=EngineConfig(
        slots=3, chunk=chunk, cache=CacheConfig(page_size=4, max_len=32)))
    for p in prompts:
        jeng.submit(p, 5)
        teng.submit(p, 5)
    want, got = jeng.run_until_idle(), teng.run_until_idle()
    assert len(got) == 4 and got == want
    seq = [sequential_greedy(model, params, p, 5) for p in prompts]
    assert [got[i] for i in range(4)] == seq
    assert teng.state.has_rows
    kinds = {type(st) for st in teng.state.leaves()}
    assert SlotRowState in kinds
    # the three programs, one signature each; zamba2's shared block holds
    # the only pages, and every one is back
    for prog in (teng._prefill, teng._decode, teng._reset):
        assert prog.retraces == 1
    assert len(teng.allocators) == (1 if arch == "zamba2-1.2b" else 0)
    for alloc in teng.allocators.values():
        assert alloc.free_pages == alloc.n_pages
        alloc.check()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "3", "--repeat",
                         "2", "--chunk", "8", "--prompt-lens", "3,9,17"])
    text = out.getvalue()
    assert rc == 0, text
    assert "pass 2: prefill retraces=0 decode retraces=0" in text
    assert "served 6/6 requests" in text


def _row_leaves(tree, pools):
    """The device leaf of every recurrent layer, in ``tree.leaves()``
    order."""
    flat = ([c for col in pools["slots"] for c in col] + list(pools["tail"])
            + list(pools.get("shared", [])))
    return [leaf for st, leaf in zip(tree.leaves(), flat)
            if isinstance(st, SlotRowState)]


def _rows(tree, pools, slot):
    """Clones of every recurrent row tensor of ``slot``."""
    return [t[slot].clone() for leaf in _row_leaves(tree, pools)
            for t in _port_leaves(leaf)]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_idle_rows_untouched_and_reset_zeroes_rows(arch):
    """Slots 0-2 hold random rows.  A mixed step with lengths [3, 0, 1] and
    a decode step with live [1, 0, 0] leave slot 1's rows (and in the
    decode step slot 2's) bit-identical and change the others; a reset of
    slot 2 zeroes its rows alone."""
    _, _, model, params = setup_pair(arch)
    tree = build_state_tree(model, slots=3, page_size=4, max_len=16,
                            device="cpu")
    for s in range(3):
        tree.admit(s)
    pools = tree.push_tables(tree.init_device())
    g = torch.Generator().manual_seed(0)
    for leaf in _row_leaves(tree, pools):
        for t in _port_leaves(leaf):
            t.copy_(torch.randn(t.shape, generator=g))
    before = [_rows(tree, pools, s) for s in range(3)]
    tokens = torch.from_numpy(_tokens((3, 4), 2))
    positions = torch.arange(4, dtype=torch.int32).repeat(3, 1)
    lengths = torch.tensor([3, 0, 1], dtype=torch.int32)
    _, pools = model.chunk_step(params, pools, tokens, positions, lengths)
    after = [_rows(tree, pools, s) for s in range(3)]
    assert _same(before[1], after[1])
    assert not _same(before[0], after[0]) and not _same(before[2], after[2])

    live = torch.tensor([1, 0, 0], dtype=torch.int32)
    _, pools = model.decode_step(
        params, pools, torch.from_numpy(_tokens((3, 1), 3)),
        torch.tensor([3, 0, 1], dtype=torch.int32), lengths=live)
    again = [_rows(tree, pools, s) for s in range(3)]
    assert _same(after[1], again[1]) and _same(after[2], again[2])
    assert not _same(after[0], again[0])

    pools = tree.reset(pools, torch.tensor([2, -1, -1]))
    reset = [_rows(tree, pools, s) for s in range(3)]
    assert all((t == 0).all() for t in reset[2])
    assert _same(again[0], reset[0]) and _same(again[1], reset[1])
    assert {st.geometry().kind for st in tree.leaves()} == (
        {"slot_rows", "paged_kv"} if arch == "zamba2-1.2b" else {"slot_rows"})


# ---------------------------------------------------------------------------
# full width: one layer of each mixer
# ---------------------------------------------------------------------------

_LAYERS: dict = {}
MIXERS = {"rwkv6-3b": ("rwkv", JSSM.rwkv_specs, JSSM.rwkv_mix,
                       JSSM.rwkv_step, JSSM.rwkv_state_init, SSM.rwkv_mix),
          "zamba2-1.2b": ("mamba", JSSM.mamba_specs, JSSM.mamba_mix,
                          JSSM.mamba_step, JSSM.mamba_state_init,
                          SSM.mamba_mix)}


def full_layer(arch):
    """(jax cfg, jax params, port cfg, port params, input [2, 130, d]) of
    one full-width float32 layer with the reference's init."""
    if arch not in _LAYERS:
        prefix, specs, *_ = MIXERS[arch]
        jcfg = dataclasses.replace(jget_arch(arch), dtype="float32")
        cfg = dataclasses.replace(get_arch(arch), dtype="float32")
        spec = specs(jcfg, prefix)
        keys = jax.random.split(jax.random.key(0), len(spec))
        jp = {n: jinit_param(k, s, jnp.float32)
              for k, (n, s) in zip(keys, sorted(spec.items()))}
        tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
        x = jax.random.normal(jax.random.key(1), (2, 130, jcfg.d_model))
        _LAYERS[arch] = (jcfg, jp, cfg, tp, x)
    return _LAYERS[arch]


def _close_to(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_mix_matches_jax_mix_where_it_is_finite(arch):
    jcfg, jp, cfg, tp, x = full_layer(arch)
    prefix, _, jmix, _, _, mix = MIXERS[arch]
    s = 32 if arch == "rwkv6-3b" else 64
    want, wst = jmix(jcfg, jp, prefix, x[:1, :s])
    got, st = mix(cfg, tp, prefix, torch.from_numpy(np.array(x[:1, :s])))
    assert np.isfinite(np.asarray(want)).all()
    _close_to(got, want, Y_TOL)
    for a, b in zip(st, wst):
        _close_to(a, b, S_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_mix_matches_jax_steps_where_jax_mix_overflows(arch):
    """130 tokens (three chunks of the port's 64), rows of 130 and 97:
    JAX's chunked mix is NaN; the port's is finite and matches JAX's
    per-token steps, outputs and final states, the short row's state
    taken after its 97th token."""
    jcfg, jp, cfg, tp, x = full_layer(arch)
    prefix, _, jmix, jstep, jinit, mix = MIXERS[arch]
    lengths = np.asarray([130, 97], np.int32)
    jy, _ = jmix(jcfg, jp, prefix, x[:1])
    assert not np.isfinite(np.asarray(jy)).all()
    step = jax.jit(functools.partial(jstep, jcfg, jp, prefix))
    st = jinit(jcfg, 2, jnp.float32)
    ys, short = [], None
    for t in range(130):
        y, st = step(x[:, t:t + 1], st)
        ys.append(np.asarray(y))
        if t + 1 == lengths[1]:
            short = [np.asarray(a)[1] for a in st]
    want = np.concatenate(ys, axis=1)
    got, tst = mix(cfg, tp, prefix, torch.from_numpy(np.array(x)),
                   lengths=torch.from_numpy(lengths))
    _close_to(got[0], want[0], Y_TOL)
    _close_to(got[1, :97], want[1, :97], Y_TOL)
    for a, w0, w1 in zip(tst, st, short):
        _close_to(a[0], np.asarray(w0)[0], S_TOL)
        _close_to(a[1], w1, S_TOL)


def test_chunked_recurrences_never_take_exp_of_a_positive_number():
    """A decay far below float32's range inside one chunk (log-decay -100
    a token for RWKV, dt 100 for Mamba): the port's within-chunk terms stay
    finite and match a per-token loop of its own steps."""
    g = torch.Generator().manual_seed(0)
    b, s, h, dh, n = 1, 40, 2, 4, 3
    r, k, v = (torch.randn((b, s, h, dh), generator=g) for _ in range(3))
    w = torch.full((b, s, h, dh), float(np.exp(-100.0)))
    u = torch.randn((h, dh), generator=g)
    y, state = SSM._rwkv_scan(r, k, v, w, u, torch.zeros(b, h, dh, dh))
    want, st = [], torch.zeros(b, h, dh, dh)
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        want.append((r[:, t, :, None, :] @ (st + u[None, :, :, None] * kv))[:, :, 0])
        st = w[:, t, :, :, None] * st + kv
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, torch.stack(want, 1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state, st, rtol=1e-5, atol=1e-5)

    x = torch.randn((b, s, h, dh), generator=g)
    bm, cm = (torch.randn((b, s, n), generator=g) for _ in range(2))
    dt = torch.full((b, s, h), 100.0)
    y, state = SSM._mamba_scan(x, bm, cm, dt, -dt, torch.zeros(b, h, dh, n))
    want, st = [], torch.zeros(b, h, dh, n)
    for t in range(s):
        st = (torch.exp(-dt[:, t])[..., None, None] * st
              + (x[:, t] * dt[:, t, :, None])[..., None] * bm[:, t, None, None, :])
        want.append((st @ cm[:, t, None, :, None])[..., 0])
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, torch.stack(want, 1), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(state, st, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrences_run_inside_the_profiler_range(arch):
    """While a profiler records, each recurrent layer's scan (mix and step)
    runs inside ``record_function("recurrence")``, which the card's traces
    group."""
    _, _, model, params = setup_pair(arch)
    caches = model.init_caches(1, 16, device="cpu")
    tokens = torch.from_numpy(_tokens((1, 5), 4))
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        model.prefill(params, {"tokens": tokens,
                               "positions": torch.arange(5, dtype=torch.int32)},
                      caches)
        model.decode_step(params, caches, tokens[:, :1],
                          torch.tensor([5], dtype=torch.int32))
    spans = [e for e in prof.events() if e.name == "recurrence"]
    n_rec = sum(s.kind in ("rwkv", "mamba") for s in model.stack.pattern)
    layers = n_rec * model.stack.n_periods + model.stack.n_tail
    assert len(spans) == 2 * layers
    assert "aten::cumsum" in {c.name for s in spans for c in s.cpu_children}
