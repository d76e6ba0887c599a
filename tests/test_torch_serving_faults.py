"""The port's fault-tolerant serving against the JAX package's, on the CPU
(``tests/test_serving_faults.py``'s cases).

* Deadlines (fake clock) end a request TIMEOUT queued, running or parked on
  host (its snapshot dropped); ``cancel`` works in every state, keeps the
  partial output and is idempotent.
* An injected step fault recovers through the preempt/requeue path: the
  survivors are token-identical to the JAX engine under the same fault plan
  and to the port's fault-free ``verify_reference()`` replay, for yi-6b,
  rwkv6-3b and zamba2-1.2b, also when the fault lands on a speculative
  verify step (paged rollback and row restore); no new program; retries
  exhaust into FAILED with backoff and quarantine keyed on ticks.
* A corrupted snapshot (one flipped byte) fails its request cleanly at
  resume, everyone else unaffected; a snapshot without its digest is
  refused by ``swap_in`` and failed by the engine.
* Transient page exhaustion waits and drains identically; a structurally
  unservable head fails fast; the watchdog's sweeps stay green and catch a
  leaked reference; the heartbeat and the straggler detector record.
* Seeded plans mixing every kind drain with no crash, survivors identical
  to the fault-free replay, every oracle green.
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro.serving as J  # noqa: E402

import repro_torch.serving as S  # noqa: E402
from repro_torch.serving import (CANCELLED, DONE, FAILED, PREEMPTED,  # noqa: E402
                                 QUEUED, TIMEOUT, summarize)

from test_torch_features import (check_clean, engines, port_engine,  # noqa: E402
                                 programs, prompts, replay)

ARCHS = ["yi-6b", "rwkv6-3b", "zamba2-1.2b"]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _plans(events):
    """The same plan for both engines: (JAX plan, port plan)."""
    return (J.FaultPlan([J.FaultEvent(tick=t, kind=k) for t, k in events]),
            S.FaultPlan([S.FaultEvent(tick=t, kind=k) for t, k in events]))


def _serve(eng, work, max_new):
    subs = [(eng.submit(p, max_new).rid, p, max_new, 0) for p in work]
    return subs, eng.run_until_idle()


# ---------------------------------------------------------------------------
# deadlines and cancellation
# ---------------------------------------------------------------------------

def test_deadline_expires_queued_and_running():
    eng = port_engine("yi-6b", chunk=8)
    clk = FakeClock()
    eng.sched.clock = clk
    work = prompts([5, 6, 7])
    slow = eng.submit(work[0], 20, deadline_s=0.5)
    ok = eng.submit(work[1], 4)
    parked = eng.submit(work[2], 4, deadline_s=9.0)
    for _ in range(4):
        eng.step()
    assert slow.state not in (TIMEOUT, DONE)
    clk.t = 1.0
    eng.step()
    assert slow.state == TIMEOUT and slow.slot == -1
    assert "deadline" in slow.error
    clk.t = 10.0
    done = eng.run_until_idle()
    assert parked.state == TIMEOUT
    assert slow.rid not in done and parked.rid not in done
    assert len(done[ok.rid]) == 4 and eng.timeouts == 2
    m = summarize(eng.sched.done + eng.sched.failed)
    assert m["timeout"] == 2 and m["done"] == 1
    check_clean(eng)


def test_deadline_expires_preempted_snapshot_dropped():
    eng = port_engine("yi-6b", chunk=8)
    clk = FakeClock()
    eng.sched.clock = clk
    req = eng.submit(prompts([6])[0], 10, deadline_s=5.0)
    for _ in range(3):
        eng.step()
    eng.preempt(req.slot)
    assert req.state == PREEMPTED and req.swap is not None
    clk.t = 6.0
    eng.step()
    assert req.state == TIMEOUT and req.swap is None
    assert eng.run_until_idle() == {}
    check_clean(eng)


def test_engine_default_deadline():
    eng = port_engine("yi-6b", deadline_s=2.0)
    clk = FakeClock()
    eng.sched.clock = clk
    req = eng.submit(prompts([5])[0], 8)
    assert req.deadline_s == 2.0
    clk.t = 3.0
    assert eng.run_until_idle() == {} and req.state == TIMEOUT
    check_clean(eng)


def test_cancel_every_state():
    eng = port_engine("yi-6b", chunk=8)
    work = prompts([5, 6, 7, 8])
    queued = eng.submit(work[0], 4)
    running = eng.submit(work[1], 12)
    parked = eng.submit(work[2], 12)
    survivor = eng.submit(work[3], 4)
    assert queued.state == QUEUED and eng.cancel(queued.rid)
    assert queued.state == CANCELLED
    for _ in range(4):
        eng.step()
    assert running.slot >= 0 and eng.cancel(running.rid)
    assert running.state == CANCELLED and running.slot == -1
    assert all(r is not running for r in eng.active)
    eng.preempt(parked.slot)
    assert parked.state == PREEMPTED and eng.cancel(parked.rid)
    assert parked.state == CANCELLED and parked.swap is None
    done = eng.run_until_idle()
    assert len(done[survivor.rid]) == 4 and running.rid not in done
    cancels = eng.cancels
    assert not eng.cancel(running.rid) and not eng.cancel(10_000)
    assert eng.cancels == cancels == 3
    check_clean(eng)


def test_cancel_keeps_partial_output():
    eng = port_engine("yi-6b")
    p = prompts([5])[0]
    req = eng.submit(p, 8)
    while len(req.out) < 3:
        eng.step()
    eng.cancel(req.rid)
    want = replay(eng, [(req.rid, p, 8, 0)])[req.rid]
    assert req.out and req.out == want[:len(req.out)]
    assert req.state == CANCELLED
    check_clean(eng)


# ---------------------------------------------------------------------------
# step-fault recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_step_fault_recovers_token_identical(arch):
    jeng, eng = engines(arch, chunk=8, watchdog=True)
    jeng.faults, eng.faults = _plans([(4, "step_exc")])
    work = prompts([6, 9])
    (subs, got), (_, want) = _serve(eng, work, 8), _serve(jeng, work, 8)
    assert eng.recovered == jeng.recovered == 1
    assert got == want == replay(eng, subs)
    assert eng.sched.failed == []
    check_clean(eng)
    progs = programs(eng)
    _, again = _serve(eng, work, 8)           # warm: no new program
    assert list(again.values())[-2:] == [got[0], got[1]]
    assert programs(eng) == progs


class WrongDrafter:
    """Always proposes tokens one past the history's: every verify step
    rolls back."""

    def propose(self, history, k):
        h = np.asarray(history, np.int32)
        return (h[-k:] + 1) % 251 if len(h) >= k else h[:0]


@pytest.mark.parametrize("arch", ARCHS)
def test_step_fault_mid_verify_recovers_token_identical(arch):
    """The fault fires on a verify step (drafts in flight; paged masking
    for yi-6b, row restore for rwkv6-3b, both for zamba2-1.2b): the state
    stays truncate-consistent, survivors equal JAX's under the same plan
    and the speculation-off fault-free replay; sweeps green."""
    jeng, eng = engines(arch, chunk=8, watchdog=True, speculate=4,
                        drafter=WrongDrafter())
    jeng.faults, eng.faults = _plans([(4, "step_exc")])
    work = prompts([6, 9])
    (subs, got), (_, want) = _serve(eng, work, 8), _serve(jeng, work, 8)
    assert eng.recovered == 1 and eng.spec_steps > 0
    assert eng.spec_steps == jeng.spec_steps
    assert got == want == replay(eng, subs)
    eng.watchdog.sweep()
    check_clean(eng)
    progs = programs(eng)
    _, again = _serve(eng, work, 8)
    assert list(again.values())[-2:] == [got[0], got[1]]
    assert programs(eng) == progs
    check_clean(eng)


def test_retries_exhaust_to_failed():
    wd = S.WatchdogConfig(cadence=4, max_retries=2, backoff_ticks=2,
                          quarantine_ticks=2)
    eng = port_engine("yi-6b", chunk=8, watchdog=wd)
    eng.faults = S.FaultPlan([S.FaultEvent(tick=t, kind="step_exc")
                              for t in range(3, 11)])
    work = prompts([6, 9])
    subs, done = _serve(eng, work, 6)
    failed = [r for r in eng.sched.failed if r.state == FAILED]
    assert failed and any("retries exhausted" in (r.error or "")
                          for r in failed)
    assert all(r.slot == -1 and r.swap is None for r in failed)
    ref = replay(eng, subs)
    assert all(done[rid] == ref[rid] for rid in done)
    assert eng.watchdog.stats()["watchdog_failures"] >= 1
    check_clean(eng)


def test_watchdog_quarantine_and_backoff_key_on_ticks():
    eng = port_engine("yi-6b", chunk=8, watchdog=True)
    eng.faults = S.FaultPlan([S.FaultEvent(tick=3, kind="step_exc")])
    p = prompts([6])[0]
    req = eng.submit(p, 6)
    for _ in range(64):
        eng.step()
        if req.state == DONE:
            break
    assert req.state == DONE and req.hold_until_tick > 0
    assert req.out == replay(eng, [(req.rid, p, 6, 0)])[req.rid]
    assert eng.recovered == 1
    check_clean(eng)


# ---------------------------------------------------------------------------
# snapshot integrity
# ---------------------------------------------------------------------------

def test_corrupt_swap_rejected_cleanly():
    jeng, eng = engines("yi-6b", chunk=8, watchdog=True)
    events = [(3, "swap_corrupt"), (4, "step_exc")]
    jeng.faults, eng.faults = _plans(events)
    work = prompts([6, 9])
    (subs, got), (_, want) = _serve(eng, work, 6), _serve(jeng, work, 6)
    assert eng.swap_rejects == jeng.swap_rejects == 1
    assert eng.faults.corrupted == 1
    victims = [r for r in eng.sched.failed if r.state == FAILED]
    assert len(victims) == 1 and "digest mismatch" in victims[0].error
    assert got == want and len(got) == 1
    ref = replay(eng, subs)
    assert all(got[rid] == ref[rid] for rid in got)
    check_clean(eng)


def test_snapshot_without_digest_rejected():
    eng = port_engine("yi-6b", chunk=8)
    req = eng.submit(prompts([6])[0], 8)
    for _ in range(3):
        eng.step()
    eng.preempt(req.slot)
    req.swap["state"] = {"blobs": req.swap["state"]["blobs"]}
    with pytest.raises(S.SwapIntegrityError):
        eng.state.swap_in(eng.pools, 0, req.swap["state"])
    assert eng.run_until_idle() == {}
    assert req.state == FAILED and eng.swap_rejects == 1
    check_clean(eng)


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

def test_alloc_exhaustion_is_transient_not_fatal():
    jeng, eng = engines("yi-6b", chunk=8, watchdog=True)
    events = [(1, "alloc_exhaust", 6), (9, "alloc_exhaust", 4)]
    jeng.faults = J.FaultPlan([J.FaultEvent(tick=t, kind=k, arg=a)
                               for t, k, a in events])
    eng.faults = S.FaultPlan([S.FaultEvent(tick=t, kind=k, arg=a)
                              for t, k, a in events])
    work = prompts([5, 9, 12])
    (subs, got), (_, want) = _serve(eng, work, 6), _serve(jeng, work, 6)
    assert got == want == replay(eng, subs)
    assert eng.ticks == jeng.ticks
    assert eng.unservable == 0 and eng.sched.failed == []
    assert eng.faults.stats()["injected"]["alloc_exhaust"] == 2
    check_clean(eng)


def test_unservable_head_fails_fast():
    eng = port_engine("yi-6b", pool_pages=4)      # < pages_per_slot = 8
    reqs = [eng.submit(p, 4) for p in prompts([5, 20])]
    assert eng.run_until_idle() == {} and eng.unservable == 2
    for r in reqs:
        assert r.state == FAILED and "unservable" in r.error and r.slot == -1
    check_clean(eng)


# ---------------------------------------------------------------------------
# watchdog, heartbeat, straggler
# ---------------------------------------------------------------------------

def test_watchdog_sweeps_green_on_healthy_engine():
    eng = port_engine("yi-6b", watchdog=S.WatchdogConfig(cadence=2))
    subs, done = _serve(eng, prompts([5, 9]), 4)
    assert set(done) == {rid for rid, *_ in subs}
    s = eng.watchdog.stats()
    assert s["sweeps"] >= 2 and s["recoveries"] == 0
    assert s["watchdog_failures"] == 0
    check_clean(eng)


def test_watchdog_detects_refcount_drift():
    eng = port_engine("yi-6b", watchdog=True)
    eng.submit(prompts([5])[0], 4)
    eng.step()
    alloc = next(iter(eng.allocators.values()))
    page = alloc._free.pop()
    alloc.incref(page)                  # held by nobody the oracle knows
    with pytest.raises(S.WatchdogError):
        eng.watchdog.sweep()
    alloc.decref(page)
    eng.run_until_idle()
    check_clean(eng)


def test_heartbeat_and_straggler_wiring(tmp_path):
    path = tmp_path / "engine.heartbeat"
    eng = port_engine("yi-6b", heartbeat=str(path))
    eng.heartbeat.interval = 0.0
    eng.faults = S.FaultPlan([S.FaultEvent(tick=2, kind="latency",
                                           arg=0.001)])
    _, done = _serve(eng, prompts([5, 9]), 4)
    assert len(done) == 2
    beat = json.loads(path.read_text())
    assert beat["step"] == eng.ticks and beat["done"] == 2
    assert eng.faults.stats()["injected"]["latency"] == 1
    assert eng.straggler.median > 0.0
    check_clean(eng)


def test_exactly_three_programs_under_faults():
    eng = port_engine("yi-6b", chunk=8, watchdog=True)
    eng.faults = S.FaultPlan.seeded(11, n_events=6, ticks=48)
    work = prompts([5, 9, 12, 6])
    _serve(eng, work, 6)
    progs = programs(eng)
    assert progs == (1, 1, 1)
    _serve(eng, work, 6)
    assert programs(eng) == progs
    check_clean(eng)


@settings(max_examples=5, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1))
def test_seeded_fault_plan_drains_clean(seed):
    eng = port_engine("yi-6b", chunk=8, watchdog=True)
    eng.faults = S.FaultPlan.seeded(seed, n_events=6, ticks=64,
                                    latency_s=0.0005)
    subs, done = _serve(eng, prompts([5, 9, 12, 6], seed=seed % 997), 6)
    ref = replay(eng, subs)
    assert all(done[rid] == ref[rid] for rid in done)
    for r in eng.sched.failed:
        assert r.state in (TIMEOUT, CANCELLED, FAILED)
        assert r.slot == -1 and r.swap is None
    assert len(done) + len(eng.sched.failed) == len(subs)
    assert eng.faults.stats()["held_hostage_groups"] == 0
    check_clean(eng)


@pytest.mark.parametrize("spec,n,kinds", [
    ("seed=0,n=4,ticks=32", 4, None),
    ("seed=7,n=3,ticks=16,kinds=step_exc+latency,latency_s=0.001", 3,
     {"step_exc", "latency"}),
])
def test_fault_plan_from_spec_matches_jax(spec, n, kinds):
    plan, jplan = S.FaultPlan.from_spec(spec), J.FaultPlan.from_spec(spec)
    assert [(e.tick, e.kind, e.arg) for e in plan.events] == \
        [(e.tick, e.kind, e.arg) for e in jplan.events]
    assert len(plan.events) == n
    if kinds is not None:
        assert {e.kind for e in plan.events} <= kinds
    with pytest.raises(ValueError):
        S.FaultPlan.from_spec("seed=0,bogus=1")
    with pytest.raises(ValueError):
        S.FaultEvent(tick=1, kind="not-a-kind")
