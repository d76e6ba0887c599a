"""The port's speculative decoding against the JAX package's, on the CPU
(``tests/test_speculative.py``'s cases).

Greedy serving with ``speculate=4`` is token-identical to the JAX engine
speculating with the same drafter (with the same draft, accept and step
counts) and to the port's speculation-off ``verify_reference()`` replay,
for the n-gram drafter, an always-wrong drafter (every verify step rolls
back: paged masking, row restore, or both for zamba2-1.2b) and a
clairvoyant one (every draft accepted, strictly fewer decode steps).
Verify is the mixed program: a speculating engine runs no pure decode step,
adds no program and sees no new signature when warm.  Rejected drafts
never reach the prefix cache.  The n-gram drafter and the accept walk are
a copy of JAX's (``tests/test_torch_features.py``); their unit contracts
are checked here on the port's copy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving import NGramDrafter, greedy_accept  # noqa: E402

from test_torch_features import (check_clean, engines, port_engine,  # noqa: E402
                                 programs, prompts, replay)

ARCHS = ["yi-6b", "rwkv6-3b", "zamba2-1.2b"]


class JunkDrafter:
    """Adversarial: proposes one past each history token, so every verify
    step rolls back and still emits the greedy token."""

    def propose(self, history, k):
        h = np.asarray(history, np.int32)
        return (h[-k:] + 1) % 251 if len(h) >= k else np.zeros((0,), np.int32)


class OracleDrafter:
    """Clairvoyant: proposes the true greedy continuation."""

    def __init__(self, streams):
        self.streams = streams

    def propose(self, history, k):
        h = np.asarray(history, np.int32)
        for s in self.streams:
            if len(s) > len(h) and np.array_equal(s[:len(h)], h):
                return np.asarray(s[len(h):len(h) + k], np.int32)
        return np.zeros((0,), np.int32)


def _run(eng, work, max_new=8):
    subs = [(i, p, max_new, 0) for i, p in enumerate(work)]
    for rid, p, mn, _ in subs:
        eng.submit(p, mn, rid=rid)
    return subs, eng.run_until_idle()


# ---------------------------------------------------------------------------
# unit contracts
# ---------------------------------------------------------------------------

def test_ngram_drafter_proposes_most_recent_continuation():
    d = NGramDrafter(max_n=3)
    h = np.array([5, 6, 7, 9, 5, 6, 7, 8, 5, 6, 7], np.int32)
    np.testing.assert_array_equal(d.propose(h, 3), [8, 5, 6])
    np.testing.assert_array_equal(d.propose(h, 1), [8])
    assert d.propose(np.array([1, 2, 3, 4, 2, 9], np.int32), 4).size == 0
    np.testing.assert_array_equal(
        d.propose(np.array([1, 9, 3, 4, 9], np.int32), 2), [3, 4])
    assert d.propose(np.array([3], np.int32), 4).size == 0
    assert d.propose(np.array([1, 2], np.int32), 4).size == 0
    np.testing.assert_array_equal(
        d.propose(np.array([7, 1, 2, 7], np.int32), 8), [1, 2, 7])


def test_greedy_accept_walk():
    greedy = np.array([10, 11, 12, 13, 14], np.int32)
    assert greedy_accept([11, 12, 99], greedy, j0=1) == (2, [11, 12, 13])
    assert greedy_accept([99, 12], greedy, j0=1) == (0, [11])
    assert greedy_accept([11, 12, 13], greedy, j0=1) == (3, [11, 12, 13, 14])
    assert greedy_accept([], greedy, j0=1) == (0, [11])


# ---------------------------------------------------------------------------
# token identity across the state kinds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drafter", ["ngram", "junk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_speculation_is_token_identical(arch, drafter):
    make = {"ngram": NGramDrafter, "junk": JunkDrafter}[drafter]
    jeng, eng = engines(arch, speculate=4, drafter=make())
    work = prompts([5, 9, 12])
    subs, got = _run(eng, work)
    _, want = _run(jeng, work)
    assert got == want == replay(eng, subs)
    s, js = eng.stats(), jeng.stats()
    for key in ("spec_steps", "spec_drafted", "spec_accepted",
                "decode_steps", "steps", "max_decode_stall"):
        assert s[key] == js[key], key
    assert s["max_decode_stall"] == 0
    assert eng._decode.calls == 0      # verify rides the mixed program
    if drafter == "junk":
        assert s["spec_drafted"] > 0 and s["spec_accepted"] == 0
    check_clean(eng)


@pytest.mark.parametrize("arch", ARCHS)
def test_oracle_drafter_full_accepts_and_shrinks_steps(arch):
    base_eng = port_engine(arch)
    work = prompts([5, 9, 12])
    subs, base = _run(base_eng, work)
    streams = [np.concatenate([p, np.asarray(base[i], np.int32)])
               for i, p in enumerate(work)]
    jeng, eng = engines(arch, speculate=4, drafter=OracleDrafter(streams))
    _, got = _run(eng, work)
    _, want = _run(jeng, work)
    assert got == want == base
    s = eng.stats()
    assert s["spec_drafted"] == s["spec_accepted"] > 0
    assert s["decode_steps"] < base_eng.stats()["decode_steps"]
    assert s["spec_accepted_per_step"] > 1.0
    check_clean(eng)


def test_speculating_engine_runs_three_programs_and_never_retraces():
    eng = port_engine("yi-6b", chunk=8, speculate=4)
    _run(eng, prompts([3, 5, 9, 12], seed=1), 6)
    progs = programs(eng)
    assert progs[0] == 1 and progs[1] == 0 and progs[2] == 1
    for i, p in enumerate(prompts([2, 7, 11, 4], seed=9)):
        eng.submit(p, 6, rid=10 + i)
    eng.run_until_idle()
    assert programs(eng) == progs


def test_draft_ring_clamp_stops_drafting_at_the_ring():
    """Drafts are granted only while every fed position stays below the
    smallest paged ring: a request whose stream reaches ``max_len`` drafts
    nothing past it, and the output is still the replay's."""
    eng = port_engine("yi-6b", max_len=16, speculate=4, drafter=JunkDrafter())
    assert eng._draft_ring == 16
    work = prompts([6, 4])
    subs, got = _run(eng, work, 10)
    assert got == replay(eng, subs)
    assert max(r.drafted for r in eng.sched.done) > 0
    check_clean(eng)


def test_unaccepted_drafts_never_enter_prefix_cache():
    """A cache-on speculating engine with a hostile drafter only ever
    hashes committed prompt chunks; re-sent prompts hit without drift, as
    in JAX."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, (8,)).astype(np.int32)
    work = [np.concatenate([shared, rng.integers(0, 256, (n,))
                            .astype(np.int32)]) for n in (4, 7, 12)]
    base_eng = port_engine("yi-6b", prefix_cache=True, overcommit=2.0)
    _, base = _run(base_eng, work)
    jeng, eng = engines("yi-6b", prefix_cache=True, overcommit=2.0,
                        speculate=4, drafter=JunkDrafter())
    outs = []
    for e in (jeng, eng):
        for rep in range(2):
            for i, p in enumerate(work):
                e.submit(p, 8, rid=rep * 10 + i)
        outs.append(e.run_until_idle())
    assert outs[0] == outs[1]
    for rid, out in outs[1].items():
        assert out == base[rid % 10], rid
    cache = eng.prefix_cache
    legal = set()
    for p in work:
        legal.update(cache.chain(p))
    assert set(cache._entries) <= legal
    assert cache.stats()["hits"] > 0
    assert cache.stats() == jeng.prefix_cache.stats()
    check_clean(eng)
