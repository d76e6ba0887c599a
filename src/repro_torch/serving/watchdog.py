"""Invariant watchdog + self-healing recovery policy (DESIGN.md §14).

The watchdog owns two things:

* **invariant sweeps** at a configurable tick cadence: every
  ``PageAllocator.check()`` and ``PrefixCache.check()`` oracle, a
  refcount reconciliation (each page's allocator refcount must equal
  slot-table ownership + the cache's holds — no leaked, no dangling
  reference), and scheduler/slot consistency (the scheduler's running
  map and the engine's ``active`` array must agree slot by slot, and
  every allocator must own exactly the active slots).  A sweep failure
  is a *bug*, not a fault — it raises :class:`WatchdogError` instead of
  papering over corrupted state.
* the **recovery policy** for step faults: how many times a faulting
  request is retried through the PREEMPTED swap-to-host path, how long
  its backoff holds it out of the queue head (exponential in engine
  ticks), and how long the slot it faulted on stays quarantined.  The
  *engine* executes the policy (it owns the swap/requeue mechanism);
  the watchdog only decides.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class WatchdogError(AssertionError):
    """An invariant sweep failed — engine state is corrupted."""


@dataclasses.dataclass
class WatchdogConfig:
    """Knobs for sweeps and recovery (defaults suit the test engines).

    ``cadence`` — run the invariant sweep every N engine ticks (0
    disables periodic sweeps; explicit :meth:`Watchdog.sweep` calls
    still work).  ``max_retries`` — step-faulted requests are requeued
    at most this many times before ``FAILED``.  ``backoff_ticks`` — the
    first retry waits this many ticks, doubling per retry
    (``backoff * 2**(retries-1)``).  ``quarantine_ticks`` — a slot that
    hosted a step fault is held out of admission this many ticks (the
    fault may be slot-correlated; give transients time to clear)."""

    cadence: int = 8
    max_retries: int = 2
    backoff_ticks: int = 4
    quarantine_ticks: int = 8


class Watchdog:
    """Sweeps + recovery bookkeeping for one :class:`PagedEngine`."""

    def __init__(self, engine, config: WatchdogConfig | None = None):
        self.engine = engine
        self.config = config or WatchdogConfig()
        self.sweeps = 0
        self.recoveries = 0     # step faults turned into retries
        self.failures = 0       # requests FAILED after retry exhaustion
        # slot -> tick at which it leaves quarantine
        self.quarantine: dict[int, int] = {}

    # ------------------------------------------------------------ recovery
    def on_step_fault(self, req, exc: Exception) -> str:
        """Decide a faulting request's fate: ``"retry"`` (requeue through
        the PREEMPTED path with backoff) or ``"fail"`` (retries
        exhausted).  Updates the request's retry/backoff fields and the
        slot quarantine either way."""
        cfg = self.config
        tick = self.engine.ticks
        if req.slot >= 0 and cfg.quarantine_ticks > 0:
            self.quarantine[req.slot] = tick + cfg.quarantine_ticks
        req.retries += 1
        req.error = f"{type(exc).__name__}: {exc}"
        if req.retries > cfg.max_retries:
            self.failures += 1
            return "fail"
        req.hold_until_tick = tick + cfg.backoff_ticks * 2 ** (req.retries - 1)
        req.recovering = True
        self.recoveries += 1
        return "retry"

    def usable_slots(self, free_slots: list[int]) -> list[int]:
        """Filter quarantined slots out of the admission candidates,
        expiring finished quarantines as a side effect."""
        tick = self.engine.ticks
        self.quarantine = {s: t for s, t in self.quarantine.items()
                           if t > tick}
        return [s for s in free_slots if s not in self.quarantine]

    # -------------------------------------------------------------- sweeps
    def maybe_sweep(self) -> None:
        cfg = self.config
        if cfg.cadence > 0 and self.engine.ticks % cfg.cadence == 0:
            self.sweep()

    def sweep(self) -> None:
        """Run every invariant oracle; raise :class:`WatchdogError` with
        the failing check named on the first violation."""
        eng = self.engine
        self.sweeps += 1
        try:
            for alloc in eng.allocators.values():
                alloc.check()
            if eng.prefix_cache is not None:
                eng.prefix_cache.check()
        except AssertionError as e:
            raise WatchdogError(f"allocator/cache oracle failed: {e}") from e
        self._check_refcounts()
        self._check_slots()

    def _check_refcounts(self) -> None:
        """Refcount reconciliation: every allocator page's refcount must
        equal (#slot-table rows owning it) + (cache holds on it) +
        (fault-plan hostage holds).  Catches both leaks (refcount too
        high: a release path forgot a decref) and dangles (too low: a
        page could return to the free list while still mapped)."""
        cache = getattr(self.engine, "prefix_cache", None)
        faults = getattr(self.engine, "faults", None)
        for alloc in self.engine.allocators.values():
            expect = alloc.owned_page_counts()
            if cache is not None and cache.alloc is alloc:
                expect = expect + cache.page_refs()
            if faults is not None:
                for _, a, pages in faults._hostages:
                    if a is alloc:
                        for p in pages:
                            expect[p] += 1
            got = np.asarray(alloc.refcount[:alloc.n_pages], dtype=np.int32)
            if not np.array_equal(got, expect):
                bad = np.nonzero(got != expect)[0][:8].tolist()
                raise WatchdogError(
                    f"refcount drift on pages {bad}: "
                    f"allocator={got[bad].tolist()} "
                    f"reconstructed={expect[bad].tolist()}")

    def _check_slots(self) -> None:
        """Scheduler/engine/allocator slot-ownership consistency."""
        eng = self.engine
        active = {i for i, r in enumerate(eng.active) if r is not None}
        sched = set(eng.sched.running)
        if active != sched:
            raise WatchdogError(
                f"scheduler/engine slot drift: engine active={sorted(active)} "
                f"scheduler running={sorted(sched)}")
        for i, r in enumerate(eng.active):
            if r is not None and r.slot != i:
                raise WatchdogError(
                    f"request rid={r.rid} thinks slot={r.slot}, "
                    f"engine holds it in slot {i}")
        for alloc in eng.allocators.values():
            owned = alloc.owned_slots()
            if owned != active:
                raise WatchdogError(
                    f"allocator slot drift: owned={sorted(owned)} "
                    f"active={sorted(active)}")

    def stats(self) -> dict:
        return {"sweeps": self.sweeps,
                "recoveries": self.recoveries,
                "watchdog_failures": self.failures,
                "quarantined_slots": len(self.quarantine)}
