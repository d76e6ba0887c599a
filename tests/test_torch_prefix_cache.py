"""The port's prefix cache against the JAX package's, on the CPU
(``tests/test_prefix_cache.py``'s cases).

* Refcount/CoW property: random submit (match, alloc, maybe fork) /
  finish (insert, free) / evict sequences run in lockstep on the port's
  ``PageAllocator`` + ``PrefixCache`` and JAX's: the same hits, forks,
  evictions and refcounts after every operation, and both oracles green.
* Fork isolation on the port's pools: the source page's bytes and
  positions are untouched by the fork and by the forking request's append.
* Serving: a shared-prefix batch served twice through a cache-on engine is
  token-identical to the JAX cache-on engine (with the same hit, fork and
  prefill counts) and to the port's cache-off engine; recurrent archs build
  no cache and report a hit rate of 0; a cached prefix admits under page
  pressure on physical-page accounting, as in JAX.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro.serving as J  # noqa: E402

import repro_torch.serving as S  # noqa: E402
from repro_torch.models.layers import POS_EMPTY, KVCache  # noqa: E402

from test_torch_features import (check_clean, engines, port_engine,  # noqa: E402
                                 programs, prompts)
from test_torch_truncate import CFG, _t  # noqa: E402


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 999), pps=st.integers(2, 4),
       page_size=st.integers(2, 4), spare=st.integers(0, 5))
def test_refcount_cow_invariants_match_jax(seed, pps, page_size, spare):
    rng = np.random.default_rng(seed)
    n_slots = 3
    n_pages = (n_slots - 1) * pps + 1 + spare
    allocs = [m.PageAllocator(n_pages=n_pages, pages_per_slot=pps,
                              n_slots=n_slots) for m in (S, J)]
    caches = [m.PrefixCache(a, page_size=page_size)
              for m, a in zip((S, J), allocs)]
    base = rng.integers(0, 4, size=(pps * page_size,)).astype(np.int32)
    live: dict[int, np.ndarray] = {}

    def both(fn):
        out = [fn(a, c) for a, c in zip(allocs, caches)]
        assert out[0] == out[1], out
        return out[0]

    for _ in range(60):
        op = rng.choice(["submit", "submit", "finish", "evict"])
        if op == "submit":
            free_slots = [s for s in range(n_slots) if s not in live]
            if not free_slots:
                continue
            slot = free_slots[0]
            plen = int(rng.integers(1, pps * page_size + 1))
            prompt = base[:plen].copy()
            if rng.random() < 0.5:          # divergent suffix
                cut = int(rng.integers(0, plen))
                prompt[cut:] = rng.integers(4, 8, size=plen - cut)
            hits = [c.match(prompt) for c in caches]
            assert [(h.pages, h.tokens, h.resume, h.fork_logical)
                    for h in hits][0] == [(h.pages, h.tokens, h.resume,
                                           h.fork_logical) for h in hits][1]
            hit = hits[0]
            kept = len(hit.pages) - (1 if hit.fork_logical is not None else 0)
            if allocs[0].free_pages < pps - kept:
                both(lambda a, c: c.evict(pps - kept,
                                          protect=frozenset(hit.pages)))
            if not both(lambda a, c: a.can_alloc(shared=kept)):
                continue
            both(lambda a, c: a.alloc(slot, shared=hit.pages))
            if hit.fork_logical is not None:
                rc = allocs[0].refcount.copy()
                src, dst = both(lambda a, c: a.cow_fork(slot,
                                                        hit.fork_logical))
                assert allocs[0].refcount[src] == rc[src] - 1 >= 1
                assert allocs[0].refcount[dst] == 1
            for c, h in zip(caches, hits):
                c.record(plen, h)
            live[slot] = prompt
        elif op == "finish" and live:
            slot = int(rng.choice(list(live)))
            prompt = live.pop(slot)
            both(lambda a, c: c.insert(prompt, a.slot_pages(slot)))
            both(lambda a, c: a.free(slot))
        elif op == "evict":
            need = allocs[0].free_pages + int(rng.integers(1, 4))
            both(lambda a, c: c.evict(need))
        for a, c in zip(allocs, caches):
            a.check()
            c.check()
            assert a.free_pages == a.n_pages - a.referenced_pages
        np.testing.assert_array_equal(allocs[0].refcount, allocs[1].refcount)
        np.testing.assert_array_equal(allocs[0].table, allocs[1].table)
        both(lambda a, c: (c.stats(), c.page_refs().tolist()))

    for slot in list(live):
        prompt = live.pop(slot)
        both(lambda a, c: c.insert(prompt, a.slot_pages(slot)))
        both(lambda a, c: a.free(slot))
    both(lambda a, c: c.evict(a.n_pages))
    assert caches[0].cached_pages == 0
    assert allocs[0].free_pages == allocs[0].n_pages


def test_shared_page_never_reclaimed_and_decref_guards():
    alloc = S.PageAllocator(n_pages=4, pages_per_slot=2, n_slots=2)
    cache = S.PrefixCache(alloc, page_size=2)
    prompt = np.asarray([1, 2, 3, 4], np.int32)
    pages = alloc.alloc(0)
    cache.insert(prompt, pages)
    assert alloc.free(0) == []              # cache still references them
    assert alloc.free_pages == 2
    with pytest.raises(ValueError):
        alloc.decref(alloc._free[0])        # decref of a free page
    hit = cache.match(prompt)
    assert hit.fork_logical == 1            # full aligned hit
    alloc.alloc(1, shared=hit.pages)
    assert cache.evict(alloc.n_pages) == 0  # refcount > 1 everywhere
    alloc.free(1)
    assert cache.evict(alloc.n_pages) == 2  # leaf first, then its parent
    assert alloc.free_pages == alloc.n_pages


def test_can_alloc_counts_physical_pages():
    alloc = S.PageAllocator(n_pages=3, pages_per_slot=3, n_slots=2)
    pages = alloc.alloc(0)
    for p in pages[:2]:
        alloc.incref(p)                     # cache holds two of them
    alloc.free(0)
    assert alloc.free_pages == 1
    assert not alloc.can_alloc()            # logical accounting: rejected
    assert alloc.can_alloc(shared=2)        # physical: 1 fresh page needed
    alloc.alloc(1, shared=pages[:2])
    assert alloc.free_pages == 0
    alloc.check()


def test_cow_fork_isolates_divergent_suffixes():
    """Fork a shared page on the port's pool and land the forking request's
    append: the source page's k/v and positions never change, the fork
    keeps the shared positions below the resume point and takes the
    divergent write privately; the trash page absorbs nothing real."""
    ps, pps = 4, 2
    alloc = S.PageAllocator(n_pages=5, pages_per_slot=pps, n_slots=2)
    rng = np.random.default_rng(7)
    pages_a = alloc.alloc(0)
    pool = S.make_pool(CFG, n_pages=alloc.n_pages, page_size=ps,
                       max_pages=pps, n_slots=2, dtype=torch.float32,
                       device="cpu")
    pool.page_table.copy_(_t(alloc.table))
    dense = KVCache(k=_t(rng.normal(size=(1, 2, 8, 4)).astype(np.float32)),
                    v=_t(rng.normal(size=(1, 2, 8, 4)).astype(np.float32)),
                    pos=torch.arange(8, dtype=torch.int32))
    S.scatter_prefill(pool, dense, torch.tensor([0]), torch.tensor([8]))
    for p in pages_a:
        alloc.incref(p)                     # the cache's holds
    alloc.free(0)
    alloc.alloc(1, shared=pages_a)
    src, dst = alloc.cow_fork(1, 1)         # last shared page, resume at 7
    pool.page_table.copy_(_t(alloc.table))
    before_k, before_pos = pool.k[src].clone(), pool.pos[src].clone()
    one = [torch.tensor([x], dtype=torch.int32) for x in (src, dst, 7)]
    S.copy_page(pool, *one)
    assert pool.pos[dst].tolist() == [4, 5, 6, POS_EMPTY]
    assert torch.equal(pool.k[dst, :, :3], before_k[:, :3])
    div = KVCache(k=_t(rng.normal(size=(1, 2, 1, 4)).astype(np.float32)),
                  v=_t(rng.normal(size=(1, 2, 1, 4)).astype(np.float32)),
                  pos=torch.zeros((1, 1), dtype=torch.int32))
    S.scatter_prefill(pool, div, torch.tensor([1]), torch.tensor([1]),
                      starts=torch.tensor([7]))
    assert torch.equal(pool.k[src], before_k)
    assert torch.equal(pool.pos[src], before_pos)
    assert int(pool.pos[dst, 3]) == 7
    assert torch.equal(pool.k[dst, :, 3], div.k[0, :, 0])
    alloc.check()


def test_copy_page_sentinel_is_noop():
    pool = S.make_pool(CFG, n_pages=4, page_size=2, max_pages=2, n_slots=2,
                       dtype=torch.float32, device="cpu")
    pool.k.copy_(torch.randn(pool.k.shape, generator=torch.Generator()
                             .manual_seed(0)))
    pool.pos[:4] = 3
    k, pos = pool.k[:4].clone(), pool.pos[:4].clone()
    none = torch.tensor([S.COPY_NONE], dtype=torch.int32)
    S.copy_page(pool, none, none, torch.tensor([0], dtype=torch.int32))
    assert torch.equal(pool.k[:4], k) and torch.equal(pool.pos[:4], pos)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_recurrent_archs_hit_rate_zero(arch):
    """The flag on a recurrent arch builds no cache: identical prompts are
    served with a structural hit rate of 0, as in JAX, with JAX's tokens."""
    jeng, eng = engines(arch, prefix_cache=True)
    assert eng.prefix_cache_requested and eng.prefix_cache is None
    assert jeng.prefix_cache is None
    p = prompts([8], seed=2)[0]
    for e in (jeng, eng):
        for rid in range(3):                # identical prompts: bait
            e.submit(p, 3, rid=rid)
    want, got = jeng.run_until_idle(), eng.run_until_idle()
    assert got == want and got[0] == got[1] == got[2]
    s = eng.stats()
    assert s["prefix_hit_rate"] == 0.0 and s["prefix_lookups"] == 0
    assert s["cached_prefill_tokens"] == 0 and s["cow_forks"] == 0
    check_clean(eng)


def _shared_prefix_batch(seed=17):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, (8,)).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, 256, (n,))
                            .astype(np.int32)]) for n in (3, 5, 4, 6)]


@pytest.mark.parametrize("chunk", [None, 4])
def test_cached_serving_token_identical(chunk):
    """One 8-token prefix, divergent suffixes (the 4-token one makes the
    prompt page-aligned: a full hit and a CoW fork on the warm pass), served
    twice: the port's cache-on engine equals JAX's cache-on engine token for
    token and in its cache counters, and the port's cache-off engine."""
    work = _shared_prefix_batch()
    jeng, eng = engines("yi-6b", chunk=chunk, prefix_cache=True)
    off = port_engine("yi-6b", chunk=chunk)
    outs = []
    for e in (jeng, eng, off):
        out = {}
        for rep in range(2):                # pass 2 hits pass 1's chains
            for i, p in enumerate(work):
                e.submit(p, 4, rid=rep * 10 + i)
            out.update(e.run_until_idle())
        outs.append(out)
    assert outs[1] == outs[0] == outs[2]
    s, js = eng.stats(), jeng.stats()
    for key in ("prefix_lookups", "prefix_hits", "prefix_hit_rate",
                "prefill_tokens", "cached_prefill_tokens", "cow_forks",
                "cache_pages", "cache_evictions", "max_decode_stall"):
        assert s[key] == js[key], key
    assert s["prefix_hit_rate"] > 0 and s["cow_forks"] >= 1
    assert s["prefill_tokens"] < sum(len(p) for p in work) * 2
    assert programs(eng) == (1, 1, 1)        # the fork rides the reset
    alloc = eng._cache_alloc
    assert alloc.free_pages == alloc.n_pages - eng.prefix_cache.cached_pages
    check_clean(eng)


def test_shared_prefix_request_admits_under_page_pressure():
    """Pool of 5 pages, rows of 4: after the first request's pages enter
    the cache (3 free), a repeat of the prompt needs only 3 fresh pages (1
    kept, 1 fork, 2 private) and admits with no eviction, as in JAX."""
    jeng, eng = engines("yi-6b", max_len=16, overcommit=0.625,
                        prefix_cache=True)
    assert eng._cache_alloc.n_pages == 5
    p = prompts([8], seed=23)[0]
    outs = []
    for e in (jeng, eng):
        a = e.submit(p, 2, rid=0)
        first = e.run_until_idle()
        assert e.prefix_cache.cached_pages == 2
        assert e._cache_alloc.free_pages == 3
        b = e.submit(p, 2, rid=1)
        second = e.run_until_idle()
        assert b.cached_tokens == 7 and a.cached_tokens == 0
        assert b.chunks_done == b.n_chunks == 1
        assert e.stats()["cow_forks"] == 1
        assert e.stats()["cache_evictions"] == 0
        assert second[1] == first[0]
        outs.append(second)
    assert outs[0] == outs[1]
    check_clean(eng)
