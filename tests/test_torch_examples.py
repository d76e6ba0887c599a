"""The port's last modules against the JAX package's, on the CPU: the
examples (``repro_torch.examples``), the serving state protocol's
whole-prompt scatter (``StateTree.scatter_prefill``), the pool layout and
the traffic models.

Both packages run the same float32 smoke parameters (JAX's own init,
bridged) on the same seeded inputs.  Tolerances: logits within ``1e-4 *
max |logit|`` and losses within ``1e-4`` relative (XLA and PyTorch sum each
product in another order, about 1e-6 relative in float32); greedy tokens
identical; cache and pool leaves within ``1e-5`` (positions and tables
exactly); the traffic models' integers exactly.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as J  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.kernels import kraken_moe_gemm as jmg  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402

import repro_torch.serving as S  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.configs import registry as R  # noqa: E402
from repro_torch.core.moe_cases import MOE_CASES, moe_sizes  # noqa: E402
from repro_torch.examples import (kraken_paper, long_context,  # noqa: E402
                                  quickstart, serve_lm, train_lm)
from repro_torch.kernels import kraken_moe_gemm as mg  # noqa: E402
from repro_torch.models.layers import POS_EMPTY  # noqa: E402
from repro_torch.models.layers import PagedKVCache  # noqa: E402
from repro_torch.serving.state import tensor_leaves  # noqa: E402

from test_torch_dense_cache import setup_pair  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LOGIT_TOL = 1e-4     # of max |logit|
LEAF_TOL = 1e-5      # cache and pool leaves, float32


def _close_logits(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max(), err


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def test_examples_import_neither_jax_nor_repro():
    """The examples are the port's: no module imports ``jax`` or the JAX
    package."""
    mods = sorted((ROOT / "src" / "repro_torch" / "examples").glob("*.py"))
    assert len(mods) == 6
    for path in mods:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


@pytest.mark.parametrize("mod", [kraken_paper, quickstart, long_context,
                                 serve_lm, train_lm])
def test_examples_refuse_the_cpu_unless_asked(mod, monkeypatch):
    """Without ``--device cpu`` an example asks for CUDA and raises where
    there is none, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(R.ARCHS, "yi-100m", train_lm.config())
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        mod.main([])


def test_kraken_paper_prints_what_jax_prints(capsys):
    _jax_example("kraken_paper").main()
    want = capsys.readouterr().out
    assert kraken_paper.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert want.count("\n") > 20


def test_quickstart_matches_jax():
    """The forward's logits, the three AdamW losses and the 9 greedy
    tokens, float32 smoke yi-6b."""
    jmodel, jparams, model, params = setup_pair("yi-6b")
    params = T.map_leaves(lambda t: t.clone(), params)   # updated in place
    lines = []
    got = quickstart.run(model, params, device="cpu", log=lines.append)

    cfg = jmodel.cfg
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 32)),
                            jnp.int32) for k in ("tokens", "labels")}
    logits, _, _ = jmodel.forward(jparams, batch)
    opt = JAdamW(lr=1e-3)
    state = opt.init(jparams)

    @jax.jit
    def step(p, st):
        (loss, _), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            p, batch)
        p, st, _ = opt.update(grads, st, p)
        return p, st, loss

    p, losses = jparams, []
    for _ in range(3):
        p, state, loss = step(p, state)
        losses.append(float(loss))
    caches = jmodel.init_caches(1, 64)
    last, caches = jmodel.prefill(p, {
        "tokens": batch["tokens"][:1, :8],
        "positions": jnp.arange(8, dtype=jnp.int32)}, caches)
    tok = jnp.argmax(last[:, -1], axis=-1)[:, None]
    out = [int(tok[0, 0])]
    for t in range(8, 16):
        last, caches = jmodel.decode_step(p, caches, tok,
                                          jnp.full((1,), t, jnp.int32))
        tok = jnp.argmax(last, axis=-1)[:, None]
        out.append(int(tok[0, 0]))

    _close_logits(got["logits"].numpy(), logits)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    assert got["losses"][2] < got["losses"][0]
    assert got["tokens"] == out
    assert lines[-1] == f"decoded tokens: {out}"
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
    assert got["params"] == n


def _jax_long_context(jmodel, jparams, *, cache_len, horizon, batch):
    """JAX's ``examples/long_context.py`` loop, returning what it decodes."""
    cfg = jmodel.cfg
    caches = jmodel.init_caches(batch, cache_len, flat=True)
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (batch, 8)),
                         jnp.int32)
    logits, caches = jmodel.prefill(
        jparams, {"tokens": prompt,
                  "positions": jnp.arange(8, dtype=jnp.int32)}, caches)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    tokens = [np.asarray(tok[:, 0]).tolist()]
    decode = jax.jit(jmodel.decode_step, donate_argnums=(1,))
    for pos in range(8, 8 + horizon):
        logits, caches = decode(jparams, caches, tok,
                                jnp.full((batch,), pos, jnp.int32))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok[:, 0]).tolist())
    return tokens, np.asarray(logits)


@pytest.mark.parametrize("arch", long_context.ARCHS)
def test_long_context_matches_jax(arch):
    """Decoding past the 32-entry ring (horizon 40, float32 smoke): the
    tokens at every step, the last logits, and a state that does not
    grow."""
    jmodel, jparams, model, params = setup_pair(arch)
    lines = []
    got = long_context.run(model, params, cache_len=32, horizon=40,
                           device="cpu", log=lines.append)
    want, logits = _jax_long_context(jmodel, jparams, cache_len=32,
                                     horizon=40, batch=2)
    assert got["tokens"] == want
    _close_logits(got["last_logits"].numpy(), logits)
    assert got["cache_bytes_first"] == got["cache_bytes_last"] > 0
    assert got["allocated_first"] is None
    assert "decoded to position 48 with a 32-slot cache" in lines[0]


def test_long_context_refuses_non_finite_logits(monkeypatch):
    _, _, model, params = setup_pair("rwkv6-3b")
    real = model.decode_step

    def nan_step(*a, **kw):
        logits, caches = real(*a, **kw)
        return logits * float("nan"), caches

    monkeypatch.setattr(model, "decode_step", nan_step)
    with pytest.raises(AssertionError, match="not finite at position 8"):
        long_context.run(model, params, horizon=2, device="cpu",
                         log=lambda _: None)


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-3b"])
def test_serve_lm_warm_pass_adds_no_signature(arch, capsys):
    assert serve_lm.main(["--device", "cpu", "--repeat", "2",
                          "--arch", arch]) == 0
    out = capsys.readouterr().out
    assert f"# {arch} on cpu" in out
    assert "pass 1: prefill retraces=1 decode retraces=1" in out
    assert "pass 2: prefill retraces=0 decode retraces=0" in out
    assert "served 12/12 requests" in out


def test_train_lm_config_and_arguments_match_jax(monkeypatch):
    """JAX's example run with its launcher stubbed: the same config field
    by field, the same parameter count and the same launcher arguments."""
    seen = {}
    monkeypatch.setattr(JT, "main", lambda argv: seen.setdefault("a", argv)
                        and 0)
    monkeypatch.setitem(JR.ARCHS, "yi-100m", None)   # restored afterwards
    _jax_example("train_lm").main(["--ckpt-dir", "D"])
    jcfg = JR.ARCHS["yi-100m"]
    cfg = train_lm.config()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.param_count() == jcfg.param_count()
    assert train_lm.launcher_args(300, "D") == seen["a"]
    assert math.isclose(train_lm.START_LOSS, math.log(cfg.vocab_size))


def test_train_lm_takes_a_launcher_step(tmp_path, capsys):
    """One step of the example through the launcher on the CPU (its config
    under ``--smoke``, batch 2 x 32); the registry is restored after."""
    with pytest.MonkeyPatch.context() as m:
        m.setitem(R.ARCHS, "yi-100m", None)
        assert train_lm.main(["--steps", "1", "--device", "cpu", "--smoke",
                              "--batch", "2", "--seq", "32",
                              "--ckpt-dir", str(tmp_path)]) == 0
        assert R.ARCHS["yi-100m"] == train_lm.config()
    assert "yi-100m" not in R.ARCHS
    out = capsys.readouterr().out
    assert "training yi-100m: 100.1M params, 1 steps" in out
    loss = re.search(r"step +0 loss (\S+) ce \S+ gnorm (\S+)", out)
    assert loss and math.isfinite(float(loss[1])) and \
        math.isfinite(float(loss[2]))
    assert "done: 1 steps" in out and "(0 restarts" in out


# ---------------------------------------------------------------------------
# the pool layout and the traffic models
# ---------------------------------------------------------------------------

def _pool_pair(cfg, jcfg, **geom):
    jpool = J.make_pool(jcfg, dtype=jnp.float32, **geom)
    tpool = S.make_pool(cfg, dtype=torch.float32, device="cpu", **geom)
    return jpool, tpool


@pytest.mark.parametrize("kv", ["", "int8"])
def test_pool_layout_and_decode_bytes_match_jax(kv):
    jcfg = dataclasses.replace(jsmoke(jget_arch("yi-6b")), kv_cache_dtype=kv)
    cfg = dataclasses.replace(smoke_config(get_arch("yi-6b")),
                              kv_cache_dtype=kv)
    jpool, tpool = _pool_pair(cfg, jcfg, n_pages=24, page_size=8,
                              max_pages=8, n_slots=3)
    lay = S.pool_layout(tpool)
    assert isinstance(lay, S.PoolLayout)
    assert tuple(lay) == tuple(J.pool_layout(jpool))
    assert lay.itemsize == (1 if kv else 4)
    assert S.modeled_decode_bytes(lay) == J.modeled_decode_bytes(
        J.pool_layout(jpool))


def test_pool_layout_of_the_shared_group_matches_jax():
    """zamba2-1.2b's shared-block pools, built by both state trees."""
    jmodel, _, model, _ = setup_pair("zamba2-1.2b")
    geom = dict(slots=3, page_size=8, max_len=64)
    jtree = J.build_state_tree(jmodel, **geom)
    tree = S.build_state_tree(model, device="cpu", **geom)
    jlay = J.pool_layout(jtree.states["shared"][0].init_device())
    lay = S.pool_layout(tree.states["shared"][0].init_device())
    assert lay == jlay
    assert S.modeled_decode_bytes(lay) == J.modeled_decode_bytes(jlay)


def test_table_array():
    alloc = S.PageAllocator(n_pages=6, pages_per_slot=2, n_slots=3)
    alloc.alloc(1)
    got = alloc.table_array(device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), alloc.table)


# mixtral's and llama4's decode and mixed cases, then empty and
# past-capacity sizes
FFN_CASES = [(name, e, c, d, f, moe_sizes(sizes, e))
             for name, e, c, d, f, sizes, _ in MOE_CASES] + [
    ("empty", 8, 80, 512, 256, [0] * 8),
    ("past capacity", 4, 70, 512, 256, [71, 200, 0, 1]),
]


@pytest.mark.parametrize("dtype_name, itemsize",
                         [("bfloat16", 2), ("float32", 4), ("int8", 1)])
@pytest.mark.parametrize("case", FFN_CASES, ids=lambda c: c[0])
def test_modeled_ffn_bytes_matches_jax(case, dtype_name, itemsize):
    _, e, c, d, f, sizes = case
    for block_rows in (8, 16, 128):
        kw = dict(capacity=c, d=d, f=f, itemsize=itemsize,
                  block_rows=block_rows, dtype_name=dtype_name)
        assert mg.modeled_ffn_bytes(sizes, **kw) == \
            jmg.modeled_ffn_bytes(sizes, **kw)


# ---------------------------------------------------------------------------
# the whole-prompt scatter
# ---------------------------------------------------------------------------

SCATTER_ARCHS = ["yi-6b", "mixtral-8x22b", "rwkv6-3b", "zamba2-1.2b"]


def _device_nodes(tree):
    """(path, node) of every per-layer state of a flat cache tree."""
    for key in ("slots", "tail", "shared"):
        for i, node in enumerate(tree.get(key, [])):
            if key == "slots":
                for j, leaf in enumerate(node):
                    yield (key, i, j), leaf
            else:
                yield (key, i), node


def _sorted_leaves(node):
    """A state's tensors in ``jax.tree.leaves``'s order (dict keys
    sorted)."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _sorted_leaves(node[k])
    else:
        yield from tensor_leaves(node)


def _assert_tree_close(ttree, jtree):
    got = list(_device_nodes(ttree))
    want = list(_device_nodes(jtree))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, j) in zip(got, want):
        if isinstance(t, PagedKVCache):
            n = t.n_pages
            np.testing.assert_array_equal(t.pos[:n].numpy(),
                                          np.asarray(j.pos), err_msg=path)
            np.testing.assert_array_equal(t.page_table.numpy(),
                                          np.asarray(j.page_table))
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    getattr(t, name)[:n].numpy(),
                    np.asarray(getattr(j, name)), rtol=LEAF_TOL,
                    atol=LEAF_TOL, err_msg=(path, name))
            continue
        jl = jax.tree.leaves(j)
        tl = list(_sorted_leaves(t))
        assert len(jl) == len(tl), path
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=LEAF_TOL, atol=LEAF_TOL,
                                       err_msg=path)


def _prompts(cfg, bp, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (bp, s)).astype(np.int32)


def _scatter_pair(arch, slot_ids, lengths, starts, s=12):
    """Both packages: a whole-prompt prefill of ``len(slot_ids)`` prompts of
    ``s`` tokens (rows of ``lengths`` tokens) into ``clamp_window=False``
    caches, scattered into slots 0 and 2 of 3 (page 4, max_len 16)."""
    jmodel, jparams, model, params = setup_pair(arch)
    geom = dict(slots=3, page_size=4, max_len=16)
    jtree = J.build_state_tree(jmodel, **geom)
    tree = S.build_state_tree(model, device="cpu", **geom)
    jpools, pools = jtree.init_device(), tree.init_device()
    for slot in (0, 2):
        jtree.admit(slot)
        tree.admit(slot)
    jpools = jtree.push_tables(jpools)
    pools = tree.push_tables(pools)

    toks = _prompts(jmodel.cfg, len(slot_ids), s)
    bp = len(slot_ids)
    jdense = jmodel.init_caches(bp, s, flat=True, clamp_window=False)
    _, jdense, _ = jmodel.forward(jparams, {
        "tokens": jnp.asarray(toks),
        "positions": jnp.arange(s, dtype=jnp.int32),
        "lengths": jnp.asarray(lengths, jnp.int32)},
        mode="prefill", caches=jdense)
    dense = model.init_caches(bp, s, device="cpu", clamp_window=False)
    with torch.no_grad():
        _, dense, _ = model.forward(params, {
            "tokens": torch.as_tensor(toks),
            "positions": torch.arange(s, dtype=torch.int32),
            "lengths": torch.as_tensor(lengths, dtype=torch.int32)},
            mode="prefill", caches=dense)
    jstarts = None if starts is None else jnp.asarray(starts, jnp.int32)
    tstarts = None if starts is None else torch.as_tensor(starts,
                                                          dtype=torch.int32)
    jpools = jtree.scatter_prefill(jpools, jdense,
                                   jnp.asarray(slot_ids, jnp.int32),
                                   jnp.asarray(lengths, jnp.int32),
                                   starts=jstarts)
    out = tree.scatter_prefill(pools, dense,
                               torch.as_tensor(slot_ids, dtype=torch.int32),
                               torch.as_tensor(lengths, dtype=torch.int32),
                               starts=tstarts)
    return tree, out, pools, jpools


@pytest.mark.parametrize("starts", [None, [0, 3, 7]])
@pytest.mark.parametrize("arch", SCATTER_ARCHS)
def test_scatter_prefill_matches_jax(arch, starts):
    """Rows to slots 2 and 0 and a padding row (-1) that writes nothing,
    with and without ``starts`` offsets (the ring of 16 wraps at start 7):
    every pool and row leaf as JAX's ``scatter_prefill`` leaves it."""
    tree, out, pools, jpools = _scatter_pair(arch, [2, -1, 0], [12, 12, 9],
                                             starts)
    assert out is not None
    _assert_tree_close(pools, jpools)     # updated in place
    rows = [t for st, (_, t) in zip(tree.leaves(), _device_nodes(pools))
            if isinstance(st, S.SlotRowState)]
    for t in rows:          # slot 1 took no row: the padding row dropped
        for leaf in tensor_leaves(t):
            assert leaf[1].abs().max() == 0
            assert leaf[0].abs().max() > 0 and leaf[2].abs().max() > 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_rows_are_zeroed_after_release_and_reset(arch):
    """JAX's ``test_recurrent_state_reset_on_slot_refill`` on the port: a
    scattered slot's recurrent rows are zero after release, re-admission
    and reset, and its pages' positions are empty."""
    _, _, model, params = setup_pair(arch)
    tree = S.build_state_tree(model, slots=2, page_size=4, max_len=16,
                              device="cpu")
    pools = tree.init_device()
    s = 8
    dense = model.init_caches(2, s, device="cpu", clamp_window=False)
    with torch.no_grad():
        _, dense, _ = model.forward(params, {
            "tokens": torch.as_tensor(_prompts(model.cfg, 2, s)),
            "positions": torch.arange(s, dtype=torch.int32),
            "lengths": torch.tensor([s, s], dtype=torch.int32)},
            mode="prefill", caches=dense)
    tree.admit(0)
    pools = tree.push_tables(pools)
    ids = torch.tensor([0, -1], dtype=torch.int32)
    pools = tree.scatter_prefill(pools, dense, ids,
                                 torch.tensor([s, 0], dtype=torch.int32))

    def slot0_rows():
        return sum(float(leaf[0].abs().sum())
                   for st, (_, t) in zip(tree.leaves(),
                                         _device_nodes(pools))
                   if isinstance(st, S.SlotRowState)
                   for leaf in tensor_leaves(t))

    assert slot0_rows() > 0
    tree.release(0)
    tree.admit(0)
    pools = tree.push_tables(pools)
    pools = tree.reset(pools, ids)
    assert slot0_rows() == 0.0
    for _, t in _device_nodes(pools):
        if isinstance(t, PagedKVCache):
            assert (t.pos[t.page_table[0].long()] == POS_EMPTY).all()


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-12b", "zamba2-1.2b"])
def test_chunked_step_writes_what_the_scatter_writes(arch):
    """Prompts of 11, 7 and 16 tokens into slots 0, 1 and 2: through the
    chunked mixed step (chunks of 4, ``Model.chunk_step``) and through a
    whole-prompt prefill scattered by ``StateTree.scatter_prefill``.  Every
    live position (every page entry the scatter filled) holds the same
    position and K/V, and every recurrent row the same state.  (An MoE arch
    is left out: its capacity is per step, so routing drops differ between
    a 4-token and a 16-token step.)"""
    _, _, model, params = setup_pair(arch)
    lens = [11, 7, 16]
    toks = _prompts(model.cfg, 3, 16, seed=3)
    geom = dict(slots=3, page_size=4, max_len=16)

    def fresh():
        tree = S.build_state_tree(model, device="cpu", **geom)
        pools = tree.init_device()
        for slot in range(3):
            tree.admit(slot)
        return tree, tree.push_tables(pools)

    tree, whole = fresh()
    dense = model.init_caches(3, 16, device="cpu", clamp_window=False)
    with torch.no_grad():
        _, dense, _ = model.forward(params, {
            "tokens": torch.as_tensor(toks),
            "positions": torch.arange(16, dtype=torch.int32),
            "lengths": torch.as_tensor(lens, dtype=torch.int32)},
            mode="prefill", caches=dense)
    whole = tree.scatter_prefill(whole, dense,
                                 torch.arange(3, dtype=torch.int32),
                                 torch.as_tensor(lens, dtype=torch.int32))

    _, chunked = fresh()
    w = 4
    for start in range(0, 16, w):
        n = [max(0, min(w, ln - start)) for ln in lens]
        tok = np.zeros((3, w), np.int32)
        for b in range(3):
            tok[b, :n[b]] = toks[b, start:start + n[b]]
        pos = np.broadcast_to(start + np.arange(w, dtype=np.int32), (3, w))
        model.chunk_step(params, chunked, torch.as_tensor(tok),
                         torch.as_tensor(np.ascontiguousarray(pos)),
                         torch.as_tensor(n, dtype=torch.int32))

    pairs = list(zip(_device_nodes(whole), _device_nodes(chunked)))
    live_entries = 0
    for (path, a), (_, b) in pairs:
        if isinstance(a, PagedKVCache):
            n = a.n_pages            # the trash page is never read
            live = a.pos[:n] != POS_EMPTY
            live_entries += int(live.sum())
            assert torch.equal(a.pos[:n][live], b.pos[:n][live]), path
            for name in ("k", "v"):
                ga, gb = getattr(a, name)[:n], getattr(b, name)[:n]
                np.testing.assert_allclose(
                    ga.permute(0, 2, 1, 3)[live].numpy(),
                    gb.permute(0, 2, 1, 3)[live].numpy(),
                    rtol=LEAF_TOL, atol=LEAF_TOL, err_msg=(path, name))
        else:
            for x, y in zip(tensor_leaves(a), tensor_leaves(b)):
                np.testing.assert_allclose(x.numpy(), y.numpy(),
                                           rtol=LEAF_TOL, atol=LEAF_TOL,
                                           err_msg=path)
    assert live_entries > 0


def test_init_caches_clamp_window():
    """The default keeps a window's ring; ``clamp_window=False`` the whole
    ``cache_len``, as JAX's.  ``cache_len_for`` is the identity."""
    jmodel, _, model, _ = setup_pair("mixtral-8x22b")
    window = model.cfg.sliding_window
    big = 4 * window
    for clamp in (True, False):
        got = model.init_caches(1, big, device="cpu", clamp_window=clamp)
        want = jmodel.init_caches(1, big, flat=True, clamp_window=clamp)
        assert [t.shape for t in tensor_leaves(got)] == [
            tuple(a.shape) for a in jax.tree.leaves(want)]
    assert got["slots"][0][0].k.shape[2] == big
    assert model.cache_len_for(77) == jmodel.cache_len_for(77) == 77
