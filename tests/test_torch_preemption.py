"""The port's preempt-to-host against the JAX package's, on the CPU
(``tests/test_preemption.py``'s engine cases; the scheduler is a copy of
the reference's, pinned by ``tests/test_torch_engine.py``).

A preempted request's output is token-identical to the JAX engine driven
the same way (forced swaps mid-decode and mid-prefill, scheduler-driven
two-class bursts) and to the port's own ``verify_reference()`` replay
(preemption off), for yi-6b, rwkv6-3b and zamba2-1.2b (whose snapshot
carries the shared block's pages with the Mamba rows) and for int8 pools
under the prefix cache (JAX's int8 kernel in interpret mode), at no new
program signature; the preemption and resume counts equal JAX's.  Random
priority/length/arrival bursts drain completely and token-identically with
the allocator and prefix-cache oracles green.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.serving import (PREEMPTED, PREFILLING, REJECTED,  # noqa: E402
                                 RUNNING)

from test_torch_features import (check_clean, engines, port_engine,  # noqa: E402
                                 programs, prompts, replay)

ARCHS = ["yi-6b", "rwkv6-3b", "zamba2-1.2b"]


def test_empty_prompt_rejected():
    eng = port_engine("yi-6b")
    bad = eng.submit(np.array([], np.int32), 4)
    good = eng.submit(prompts([5])[0], 3)
    assert bad.state == REJECTED and bad.out == []
    done = eng.run_until_idle()
    assert bad.rid not in done and len(done[good.rid]) == 3
    check_clean(eng)


@pytest.mark.parametrize("max_new", [0, -3])
def test_nonpositive_max_new_rejected(max_new):
    eng = port_engine("yi-6b")
    bad = eng.submit(prompts([5])[0], max_new)
    assert bad.state == REJECTED
    assert eng.run_until_idle() == {} and bad.out == []
    check_clean(eng)


def _slot(eng, state):
    return next(i for i, r in enumerate(eng.active)
                if r is not None and r.state == state)


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_preempt_mid_decode_token_identity(arch):
    """Swap a RUNNING slot out to host and back in both engines: pages,
    positions and rows survive; tokens equal JAX's and the replay's."""
    jeng, eng = engines(arch, preempt=True)
    work = prompts([5, 9])
    subs = [(i, p, 6, 0) for i, p in enumerate(work)]
    outs = []
    for e in (jeng, eng):
        for rid, p, mn, _ in subs:
            e.submit(p, mn, rid=rid)
        for _ in range(3):
            e.step()
        e.preempt(_slot(e, RUNNING))
        outs.append(e.run_until_idle())
    assert outs[1] == outs[0] == replay(eng, subs)
    s = eng.stats()
    assert s["preemptions"] == s["resumes"] == 1
    assert programs(eng) == (1, 1, 1)     # resume reuses the one reset
    check_clean(eng)


def test_forced_preempt_mid_prefill_token_identity():
    """A victim caught mid-prefill resumes as PREFILLING(k/K) at its swap
    point."""
    jeng, eng = engines("yi-6b", chunk=4, preempt=True)
    work = prompts([20, 24], seed=3)
    outs = []
    for e in (jeng, eng):
        for i, p in enumerate(work):
            e.submit(p, 5, rid=i)
        e.step()
        e.step()
        r = e.active[_slot(e, PREFILLING)]
        assert 0 < r.prefill_pos < r.prompt_len
        k_at_swap = r.chunks_done
        e.preempt(r.slot)
        assert r.state == PREEMPTED and r.chunks_done == k_at_swap
        outs.append(e.run_until_idle())
        assert r.preemptions == 1 and r.n_chunks == -(-r.prompt_len // 4)
    assert outs[1] == outs[0] == replay(eng, [(i, p, 5, 0)
                                              for i, p in enumerate(work)])
    check_clean(eng)


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_driven_two_class_preemption(arch):
    """Class-1 requests fill both slots; a class-0 arrival preempts one.
    Tokens and the preemption counts equal JAX's; output equals the
    preempt-off replay; no new program."""
    jeng, eng = engines(arch, chunk=8, preempt=True)
    work = prompts([20, 24, 6], seed=3)
    subs = [(0, work[0], 6, 1), (1, work[1], 6, 1), (2, work[2], 5, 0)]
    outs = []
    for e in (jeng, eng):
        for rid, p, mn, prio in subs[:2]:
            e.submit(p, mn, rid=rid, priority=prio)
        for _ in range(5):
            e.step()                      # both class-1 slots live
        e.submit(work[2], 5, rid=2, priority=0)   # the urgent arrival
        outs.append(e.run_until_idle())
    assert outs[1] == outs[0] == replay(eng, subs)
    s, js = eng.stats(), jeng.stats()
    assert s["preemptions"] == js["preemptions"] >= 1
    assert s["resumes"] == s["preemptions"] == js["resumes"]
    assert programs(eng) == (1, 1, 1)
    assert set(s["slo"]) == {0, 1}
    check_clean(eng)


def test_preempt_survives_prefix_cache_round_trip():
    """Under prefix caching the resumed request claims all-private pages
    (its snapshot holds the shared content) and bypasses the match; tokens
    equal JAX's, both oracles green."""
    jeng, eng = engines("yi-6b", chunk=8, preempt=True, prefix_cache=True)
    base, tail1, tail2 = prompts([12, 6, 7], seed=3)
    p1, p2 = np.concatenate([base, tail1]), np.concatenate([base, tail2])
    outs = []
    for e in (jeng, eng):
        e.submit(p1, 5, rid=0)
        e.run_until_idle()                # seeds the cache with base pages
        e.submit(p2, 6, rid=1, priority=1)
        for _ in range(3):
            e.step()
        hits = e.prefix_cache.hits
        e.preempt(next(i for i, r in enumerate(e.active) if r is not None))
        outs.append(e.run_until_idle())
        assert e.prefix_cache.hits == hits     # resume bypasses match
        assert e.stats()["preemptions"] == 1
    assert outs[1] == outs[0]
    off = port_engine("yi-6b", chunk=8)
    off.submit(p1, 5, rid=0)
    off.run_until_idle()
    off.submit(p2, 6, rid=1)
    assert off.run_until_idle()[1] == outs[1][1]
    check_clean(eng)


def test_int8_pools_preempt_and_prefix_cache_match_jax():
    """int8 pools with their scales: a shared-prefix batch at chunk 4 with
    the prefix cache on (partial hits share int8 pages) and a forced swap
    of a decoding slot equals JAX's int8 engine (its Pallas kernel in
    interpret mode) and the preempt-off replay."""
    jeng, eng = engines("yi-6b", kv="int8", jax_decode_kernel="interpret",
                        chunk=4, preempt=True, prefix_cache=True)
    assert eng.pools["slots"][0][0].quantized
    base, *tails = prompts([8, 3, 6, 5], seed=11)
    work = [np.concatenate([base, t]) for t in tails]
    subs = [(i, p, 4, 0) for i, p in enumerate(work)]
    outs = []
    for e in (jeng, eng):
        for rid, p, mn, _ in subs:
            e.submit(p, mn, rid=rid)
        while not any(r is not None and r.state == RUNNING
                      for r in e.active):
            e.step()
        e.step()
        e.preempt(_slot(e, RUNNING))
        outs.append(e.run_until_idle())
        assert e.stats()["preemptions"] == 1
        assert e.stats()["prefix_hits"] >= 1
    assert outs[1] == outs[0] == replay(eng, subs)
    check_clean(eng)


def test_preempt_empty_slot_raises():
    eng = port_engine("yi-6b", preempt=True)
    with pytest.raises(ValueError, match="nothing preemptible"):
        eng.preempt(0)


@settings(max_examples=5, deadline=None, derandomize=True)
@given(seed=st.integers(min_value=0, max_value=10 ** 6),
       stagger=st.integers(min_value=0, max_value=6),
       cache=st.booleans())
def test_burst_no_starvation_and_identity(seed, stagger, cache):
    """Random priority/length/arrival bursts: every request completes
    within a bounded number of steps, token-identical to the preempt-off
    replay, with the oracles green after every swap round trip."""
    eng = port_engine("yi-6b", chunk=8, preempt=True, aging_s=0.05,
                      prefix_cache=cache)
    rng = np.random.default_rng(seed)
    subs = []
    for i in range(6):
        p = rng.integers(0, 256, (int(rng.integers(1, 24)),)).astype(np.int32)
        mn, prio = int(rng.integers(1, 6)), int(rng.integers(0, 3))
        r = eng.submit(p, mn, priority=prio)
        assert r.state != REJECTED
        subs.append((r.rid, p, mn, prio))
        for _ in range(stagger):
            eng.step()
    steps = 0
    while not eng.sched.idle and steps < 2000:
        eng.step()
        steps += 1
    assert eng.sched.idle, "starvation or livelock"
    done = {r.rid: list(r.out) for r in eng.sched.done}
    assert all(len(done[rid]) == mn for rid, _, mn, _ in subs)
    check_clean(eng)
    assert replay(eng, subs) == done
