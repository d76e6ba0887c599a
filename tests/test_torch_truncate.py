"""The port's rollback and swap primitives against the JAX package's, on
the CPU, below the engine (``tests/test_truncate.py``'s cases, and the new
``paged_kv`` and ``state`` functions held leaf by leaf to JAX's on the same
pools).

* ``truncate_pages``: after a scatter of ``base`` committed tokens and a
  draft chunk, truncating back to ``base`` leaves the pool as one that never
  saw the drafts (drafts inside the ring, the engine's clamp); at any cut,
  mid-page or behind a ring wrap, exactly the positions ``>= n`` vanish, and
  the pool equals JAX's after the same calls.
* A slot's truncate leaves shared (prefix-cache) pages alone.
* ``swap_out_pages`` / ``swap_in_pages`` / ``gather_pages`` equal JAX's on
  float32 and int8 pools; ``snapshot_digest`` sees one flipped byte of a
  bf16 leaf, a truncated leaf, and a missing leaf.
* Recurrent rows: ``spec_snapshot`` is a copy that the in-place programs do
  not reach; ``truncate`` restores it and refuses to rewind without one;
  ``StateTree.truncate`` and ``swap_out``/``swap_in`` over yi-6b, rwkv6-3b
  and zamba2-1.2b (whose ``"shared"`` pools swap and truncate with its rows,
  in one snapshot) equal JAX's leaf by leaf.
* A damaged snapshot -- a flipped byte, a truncated leaf, no digest -- is
  rejected before any device write: every pool tensor bit-identical.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import assume, given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as J  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serving.state import build_state_tree as jbuild  # noqa: E402

import repro_torch.serving as S  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.layers import POS_EMPTY  # noqa: E402
from repro_torch.serving.state import map_tensors, tensor_leaves  # noqa: E402

from test_torch_dense_cache import setup_pair  # noqa: E402

CFG = SimpleNamespace(num_kv_heads=2, head_dim=4)
CFG8 = SimpleNamespace(num_kv_heads=2, head_dim=4, kv_cache_dtype="int8")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair_pool(n_slots, page_size, max_pages, *, rng=None, cfg=CFG,
               n_pages=None):
    """A JAX pool and its port twin over one allocator with every slot
    admitted; with ``rng`` the pages hold random values and positions."""
    alloc = S.PageAllocator(n_pages=n_pages or n_slots * max_pages,
                            pages_per_slot=max_pages, n_slots=n_slots)
    for s in range(n_slots):
        alloc.alloc(s)
    n = alloc.n_pages
    tpool = S.make_pool(cfg, n_pages=n, page_size=page_size,
                        max_pages=max_pages, n_slots=n_slots,
                        dtype=torch.float32, device="cpu")
    tpool.page_table.copy_(_t(alloc.table))
    if rng is not None:
        for name in ("k", "v", "k_scale", "v_scale"):
            t = getattr(tpool, name)
            if t is None:
                continue
            if t.dtype == torch.int8:
                t[:n] = _t(rng.integers(-127, 128, t[:n].shape)
                           .astype(np.int8))
            else:
                t[:n] = _t(rng.normal(size=t[:n].shape).astype(np.float32))
        tpool.pos[:n] = _t(rng.integers(0, 4 * page_size * max_pages,
                                        (n, page_size)).astype(np.int32))
    return to_jax_pool(tpool), tpool, alloc


def to_jax_pool(tpool):
    n = tpool.n_pages
    sc = {name: jnp.asarray(getattr(tpool, name)[:n].numpy())
          for name in ("k_scale", "v_scale")
          if getattr(tpool, name) is not None}
    return JL.PagedKVCache(k=jnp.asarray(tpool.k[:n].numpy()),
                           v=jnp.asarray(tpool.v[:n].numpy()),
                           pos=jnp.asarray(tpool.pos[:n].numpy()),
                           page_table=jnp.asarray(tpool.page_table.numpy()),
                           **sc)


def assert_pool_equal(jpool, tpool):
    n = tpool.n_pages
    for name in ("k", "v", "pos", "page_table", "k_scale", "v_scale"):
        got = getattr(tpool, name)
        if got is None:
            assert getattr(jpool, name) is None
            continue
        got = got if name == "page_table" else got[:n]
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jpool, name)),
                                      err_msg=name)


def _dense(rng, s):
    k = rng.normal(size=(1, 2, s, 4)).astype(np.float32)
    v = rng.normal(size=(1, 2, s, 4)).astype(np.float32)
    return (JL.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                       pos=jnp.arange(s, dtype=jnp.int32)),
            TL.KVCache(k=_t(k), v=_t(v), pos=torch.arange(s,
                                                          dtype=torch.int32)))


def _scatter(jpool, tpool, jd, td, length):
    jpool = J.scatter_prefill(jpool, jd, jnp.asarray([0], jnp.int32),
                              jnp.asarray([length], jnp.int32))
    S.scatter_prefill(tpool, td, torch.tensor([0], dtype=torch.int32),
                      torch.tensor([length], dtype=torch.int32))
    return jpool


# ---------------------------------------------------------------------------
# truncate_pages
# ---------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(page_size=st.integers(min_value=1, max_value=4),
       max_pages=st.integers(min_value=1, max_value=3),
       seed=st.integers(min_value=0, max_value=99))
def test_truncate_after_scatter_equals_never_scattered(page_size, max_pages,
                                                       seed):
    rng = np.random.default_rng(seed)
    logical = page_size * max_pages
    base = int(rng.integers(0, logical + 1))
    d = int(rng.integers(1, max(logical - base, 0) + 2))
    assume(base + d <= logical)
    _, td = _dense(rng, base + d)

    _, ref, _ = _pair_pool(1, page_size, max_pages)
    S.scatter_prefill(ref, td, torch.tensor([0], dtype=torch.int32),
                      torch.tensor([base], dtype=torch.int32))
    _, spec, _ = _pair_pool(1, page_size, max_pages)
    S.scatter_prefill(spec, td, torch.tensor([0], dtype=torch.int32),
                      torch.tensor([base + d], dtype=torch.int32))
    S.truncate_pages(spec, list(range(max_pages)), base)

    k_r, v_r, pos_r = S.gather_pages(ref)
    k_s, v_s, pos_s = S.gather_pages(spec)
    assert torch.equal(pos_s, pos_r)
    live = pos_r[0] >= 0
    assert torch.equal(k_s[0][:, live], k_r[0][:, live])
    assert torch.equal(v_s[0][:, live], v_r[0][:, live])


@settings(max_examples=12, deadline=None)
@given(page_size=st.integers(min_value=2, max_value=4),
       max_pages=st.integers(min_value=1, max_value=3),
       seed=st.integers(min_value=0, max_value=99))
def test_truncate_midpage_and_ring_wrap(page_size, max_pages, seed):
    rng = np.random.default_rng(seed)
    logical = page_size * max_pages
    total = int(rng.integers(1, 3 * logical + 1))
    n = int(rng.integers(0, total + 1))
    jpool, pool, _ = _pair_pool(1, page_size, max_pages)
    jpool = _scatter(jpool, pool, *_dense(rng, total), total)
    S.truncate_pages(pool, list(range(max_pages)), n)
    jpool = J.truncate_pages(jpool, list(range(max_pages)), n)
    assert_pool_equal(jpool, pool)
    pos = S.gather_pages(pool)[2]
    expect = {j % logical: j
              for j in range(max(0, total - logical), total) if j < n}
    for li in range(logical):
        assert pos[0, li] == expect.get(li, POS_EMPTY), (li, pos[0])
    again = pool.pos.clone()
    S.truncate_pages(pool, list(range(max_pages)), n)
    assert torch.equal(again, pool.pos)           # idempotent


def test_truncate_leaves_shared_cow_pages_untouched():
    page_size, max_pages = 2, 3
    alloc = S.PageAllocator(n_pages=8, pages_per_slot=max_pages, n_slots=2)
    cached = alloc.alloc(0)[:1]
    for p in cached:
        alloc.incref(p)                 # the prefix cache's reference
    alloc.free(0)
    pages = alloc.alloc(1, shared=cached)
    assert set(cached) == alloc.shared_pages(1)
    pool = S.make_pool(CFG, n_pages=alloc.n_pages, page_size=page_size,
                       max_pages=max_pages, n_slots=2, dtype=torch.float32,
                       device="cpu")
    pool.pos.fill_(7)                   # past the cut, trash page included
    state = S.PagedKVState(CFG, alloc, page_size=page_size,
                           ring_len=page_size * max_pages, window=0,
                           device="cpu")
    state.truncate(pool, 1, 2)
    for p in range(alloc.n_pages + 1):
        want = POS_EMPTY if p in pages and p not in cached else 7
        assert (pool.pos[p] == want).all(), p


@settings(max_examples=8, deadline=None)
@given(page_size=st.integers(min_value=1, max_value=4),
       max_pages=st.integers(min_value=1, max_value=3),
       seed=st.integers(min_value=0, max_value=99))
def test_swap_round_trip_after_truncate_keeps_digests_valid(page_size,
                                                            max_pages, seed):
    rng = np.random.default_rng(seed)
    logical = page_size * max_pages
    base = int(rng.integers(0, logical + 1))
    d = int(rng.integers(1, max(logical - base, 0) + 2))
    assume(base + d <= logical)
    jd, td = _dense(rng, base + d)
    _, pool, alloc = _pair_pool(1, page_size, max_pages)
    state = S.PagedKVState(CFG, alloc, page_size=page_size,
                           ring_len=logical, window=0, device="cpu")
    S.scatter_prefill(pool, td, torch.tensor([0], dtype=torch.int32),
                      torch.tensor([base + d], dtype=torch.int32))
    state.truncate(pool, 0, base)
    blob = state.swap_out(pool, 0)
    digest = S.snapshot_digest(blob)
    state.swap_in(pool, 0, blob)
    assert S.snapshot_digest(state.swap_out(pool, 0)) == digest
    _, ref, _ = _pair_pool(1, page_size, max_pages)
    S.scatter_prefill(ref, td, torch.tensor([0], dtype=torch.int32),
                      torch.tensor([base], dtype=torch.int32))
    assert torch.equal(S.gather_pages(pool)[2], S.gather_pages(ref)[2])


# ---------------------------------------------------------------------------
# swap and gather, leaf by leaf against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [CFG, CFG8], ids=["float32", "int8"])
def test_swap_pages_match_jax(cfg):
    rng = np.random.default_rng(11)
    jpool, pool, alloc = _pair_pool(3, 4, 2, rng=rng, cfg=cfg, n_pages=7)
    pages = alloc.slot_pages(1)
    jblob = J.swap_out_pages(jpool, pages)
    blob = S.swap_out_pages(pool, pages)
    assert list(blob) == list(jblob)
    for name in jblob:
        assert blob[name].device.type == "cpu"
        np.testing.assert_array_equal(blob[name].numpy(), jblob[name])
    # the snapshot is a copy: the pool may change under it
    before = {n: t.clone() for n, t in blob.items()}
    pool.k.zero_()
    pool.pos.fill_(3)
    jpool = to_jax_pool(pool)
    assert all(torch.equal(before[n], blob[n]) for n in blob)
    # restore into other physical pages (a resumed slot's fresh row)
    dst = [alloc.slot_pages(2)[1], alloc.slot_pages(0)[0]]
    jpool = J.swap_in_pages(jpool, dst, jblob)
    S.swap_in_pages(pool, dst, blob)
    assert_pool_equal(jpool, pool)


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(12)
    jpool, pool, alloc = _pair_pool(3, 4, 2, rng=rng, n_pages=7)
    alloc.free(1)                       # a slot with no live page
    pool.page_table.copy_(_t(alloc.table))
    jpool = to_jax_pool(pool)
    jk, jv, jpos = J.gather_pages(jpool)
    k, v, pos = S.gather_pages(pool)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    for s in (0, 2):                    # live slots: the same pages
        np.testing.assert_array_equal(k[s].numpy(), np.asarray(jk[s]))
        np.testing.assert_array_equal(v[s].numpy(), np.asarray(jv[s]))
    assert (pos[1] == POS_EMPTY).all()


def test_snapshot_digest_sees_every_byte():
    """bf16 leaves hash as their bits: one flipped byte, a truncated leaf or
    a missing leaf changes the digest; an equal copy does not."""
    g = torch.Generator().manual_seed(0)
    blobs = {"a": torch.randn((3, 4), generator=g).bfloat16(),
             "b": [torch.arange(6, dtype=torch.int8),
                   torch.randn((2,), generator=g)]}
    d = S.snapshot_digest(blobs)
    assert d == S.snapshot_digest(map_tensors(torch.clone, blobs))
    flipped = map_tensors(torch.clone, blobs)
    flipped["a"].reshape(-1).view(torch.uint8)[5] ^= 1
    assert S.snapshot_digest(flipped) != d
    short = map_tensors(torch.clone, blobs)
    short["a"] = short["a"][:, :3]
    assert S.snapshot_digest(short) != d
    missing = {"a": blobs["a"], "b": blobs["b"][:1]}
    assert S.snapshot_digest(missing) != d
    # the dtype is part of the identity, not only the bytes
    same_bits = {"a": blobs["a"].view(torch.int16), "b": blobs["b"]}
    assert S.snapshot_digest(same_bits) != d


# ---------------------------------------------------------------------------
# recurrent rows and the zipped tree, against JAX
# ---------------------------------------------------------------------------

def _trees(arch, slots=3, page_size=2, max_len=8, seed=0):
    """JAX's and the port's state trees of ``arch`` with slots 0 and 1
    admitted, and device trees holding the same random contents."""
    jmodel, _, model, _ = setup_pair(arch)
    jtree = jbuild(jmodel, slots=slots, page_size=page_size, max_len=max_len)
    tree = S.build_state_tree(model, slots=slots, page_size=page_size,
                              max_len=max_len, device="cpu")
    for s in (0, 1):
        jtree.admit(s)
        tree.admit(s)
    pools = tree.push_tables(tree.init_device())
    rng = np.random.default_rng(seed)

    def fill(st, leaf):
        if isinstance(st, S.PagedKVState):
            n = leaf.n_pages
            leaf.k[:n] = _t(rng.normal(size=leaf.k[:n].shape)
                            .astype(np.float32))
            leaf.v[:n] = _t(rng.normal(size=leaf.v[:n].shape)
                            .astype(np.float32))
            leaf.pos[:n] = _t(rng.integers(0, max_len, leaf.pos[:n].shape)
                              .astype(np.int32))
        else:
            for t in tensor_leaves(leaf):
                t.copy_(_t(rng.normal(size=t.shape).astype(np.float32)))
        return leaf

    pools = tree.map_device(fill, pools)
    return jtree, tree, to_jax_tree(jtree, pools), pools


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def to_jax_tree(jtree, pools):
    """JAX's device tree with the port pools' contents (JAX's own types:
    ``jax.tree.leaves`` orders both trees alike)."""
    def conv(st, template, leaf):
        if isinstance(leaf, TL.PagedKVCache):
            return to_jax_pool(leaf)
        return jax.tree.unflatten(
            jax.tree.structure(template),
            [jnp.asarray(t.numpy())
             for t in jax.tree.leaves(leaf, is_leaf=_is_tensor)])
    return jtree.map_device(conv, jtree.init_device(), pools)


def assert_trees_equal(jtree, jpools, pools):
    def check(st, jleaf, leaf):
        if isinstance(leaf, TL.PagedKVCache):
            assert_pool_equal(jleaf, leaf)
        else:
            want = jax.tree.leaves(jleaf)
            got = jax.tree.leaves(
                leaf, is_leaf=lambda x: isinstance(x, torch.Tensor))
            assert len(got) == len(want) > 0
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jtree.map_device(check, jpools, pools)


def _first_dict(tree):
    """The first dict of tensors in a snapshot tree (a paged blob)."""
    if isinstance(tree, dict) and tree and all(
            isinstance(v, torch.Tensor) for v in tree.values()):
        return tree
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, list)):
            found = _first_dict(v)
            if found is not None:
                return found
    return None


def _snap_leaves(snap):
    return [x for x in jax.tree.leaves(
        snap, is_leaf=lambda x: isinstance(x, torch.Tensor))]


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-3b", "zamba2-1.2b"])
def test_state_tree_swap_matches_jax(arch):
    """Slot 1 swapped out and back into slot 2 (another page row): the
    snapshot's leaves and the pools after swap-in equal JAX's."""
    jtree, tree, jpools, pools = _trees(arch)
    jsnap = jtree.swap_out(jpools, 1)
    snap = tree.swap_out(pools, 1)
    if arch == "zamba2-1.2b":
        assert snap["blobs"]["shared"]   # the shared block's pools ride along
    want, got = jax.tree.leaves(jsnap["blobs"]), _snap_leaves(snap["blobs"])
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for t in (jtree, tree):
        t.release(1)
        t.admit(2)
    pools = tree.push_tables(pools)
    jpools = jtree.push_tables(jpools)
    jpools = jtree.swap_in(jpools, 2, jsnap)
    pools = tree.swap_in(pools, 2, snap)
    assert_trees_equal(jtree, jpools, pools)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_spec_snapshot_survives_in_place_programs(arch):
    """The pre-verify snapshot is a device copy equal to JAX's: a mixed step
    that advances the rows in place does not reach it, and ``truncate``
    (rows restored, the shared block's pages re-masked) leaves the tree as
    JAX's ``truncate`` leaves the same post-step tree."""
    _, _, model, params = setup_pair(arch)
    jtree, tree, jpools, pools = _trees(arch, max_len=16)
    snap = tree.spec_snapshot(pools, 0)
    jsnap = jtree.spec_snapshot(jpools, 0)
    want = jax.tree.leaves(jsnap)
    assert len(want) == len(_snap_leaves(snap)) > 0
    for t, w in zip(_snap_leaves(snap), want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    frozen = [t.clone() for t in _snap_leaves(snap)]
    tokens = np.random.default_rng(1).integers(0, 256, (3, 4)).astype(
        np.int32)
    positions = np.tile(np.arange(4, dtype=np.int32) + 4, (3, 1))
    _, pools = model.chunk_step(params, pools, _t(tokens), _t(positions),
                                _t(np.asarray([4, 2, 0], np.int32)))
    assert all(torch.equal(a, b) for a, b in zip(frozen, _snap_leaves(snap)))
    assert not all(torch.equal(a, b) for a, b in zip(
        frozen, _snap_leaves(tree.spec_snapshot(pools, 0))))
    jpools = to_jax_tree(jtree, pools)
    pools = tree.truncate(pools, 0, 4, snap=snap)
    jpools = jtree.truncate(jpools, 0, 4, snap=jsnap)
    assert_trees_equal(jtree, jpools, pools)
    assert all(torch.equal(a, b) for a, b in zip(
        frozen, _snap_leaves(tree.spec_snapshot(pools, 0))))
    with pytest.raises(ValueError, match="snapshot"):
        tree.truncate(pools, 0, 4)


def test_slot_rows_refuse_truncate_without_snapshot():
    _, _, model, _ = setup_pair("rwkv6-3b")
    state = S.SlotRowState(model.cfg, model.stack.pattern[0], n_slots=2,
                           device="cpu")
    with pytest.raises(ValueError, match="snapshot"):
        state.truncate(state.init_device(), 0, 3)


@pytest.mark.parametrize("damage", ["flipped byte", "truncated leaf",
                                    "no digest", "no blobs"])
@pytest.mark.parametrize("arch, kv", [("yi-6b", ""), ("yi-6b", "int8"),
                                      ("zamba2-1.2b", "")])
def test_damaged_snapshot_is_rejected_before_any_write(arch, kv, damage):
    """A snapshot damaged while parked is refused by ``swap_in`` with every
    pool tensor (pages, scales, rows, tables) bit-identical; the same
    snapshot intact restores."""
    _, _, model, _ = setup_pair(arch, kv)
    cfg = dataclasses.replace(model.cfg, dtype="bfloat16")
    tree = S.build_state_tree(type(model)(cfg), slots=2, page_size=2,
                              max_len=8, device="cpu")
    tree.admit(0)
    pools = tree.push_tables(tree.init_device())
    g = torch.Generator().manual_seed(3)
    for t in tensor_leaves(pools):
        if t.dtype.is_floating_point:
            t.copy_(torch.randn(t.shape, generator=g))
        elif t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
    snap = tree.swap_out(pools, 0)
    tree.release(0)
    tree.admit(1)
    pools = tree.push_tables(pools)
    if damage == "flipped byte":
        plan = S.FaultPlan([S.FaultEvent(tick=0, kind="swap_corrupt")])
        plan.on_tick(SimpleNamespace(ticks=0, allocators={}))
        clean = S.snapshot_digest(snap["blobs"])
        snap = plan.maybe_corrupt(snap)
        assert plan.corrupted == 1 and S.snapshot_digest(snap["blobs"]) != \
            clean
    elif damage == "truncated leaf":
        blob = _first_dict(snap["blobs"])
        key = next(iter(blob))
        blob[key] = blob[key][..., :-1]
    elif damage == "no digest":
        snap = {"blobs": snap["blobs"]}
    else:
        snap = {"digest": snap["digest"]}
    before = [t.clone() for t in tensor_leaves(pools)]
    with pytest.raises(S.SwapIntegrityError):
        tree.swap_in(pools, 1, snap)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tensor_leaves(pools)))


@pytest.mark.parametrize("arch, want", [("yi-6b", True),
                                        ("mixtral-8x22b", False),
                                        ("rwkv6-3b", False),
                                        ("zamba2-1.2b", False)])
def test_cacheable_group_and_geoms_match_jax(arch, want):
    """Full-attention paged stacks cache; a windowed ring or a recurrent row
    opts the model out.  The paged geometries (the draft ring) agree."""
    jtree = jbuild(JModel(jsmoke(jget_arch(arch))), slots=2, page_size=4,
                   max_len=32)
    tree = S.build_state_tree(Model(smoke_config(get_arch(arch))), slots=2,
                              page_size=4, max_len=32, device="cpu")
    assert tree.cacheable_group() == jtree.cacheable_group()
    assert (tree.cacheable_group() is not None) == want
    assert tree.paged_geoms() == jtree.paged_geoms()
    assert tree.has_rows == jtree.has_rows
