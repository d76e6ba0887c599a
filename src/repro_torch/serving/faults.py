"""Deterministic fault injection for the serving engine (DESIGN.md §14).

A port of ``repro.serving.faults``: the same plans, seams and counts; the
swap-out seam walks the port's snapshot (host tensors) instead of a JAX
tree.

A :class:`FaultPlan` is a seeded, replayable schedule of fault events
keyed on the engine's *tick* counter (every ``step()`` call, whether or
not a program runs — the same clock the watchdog's retry backoff uses,
so a plan replays identically across runs of the same workload).  It
injects at the engine's **existing seams** — nothing inside the three
jitted programs is ever touched, so an injected fault can never add a
compiled-program shape:

* ``step_exc`` — arms an exception that :meth:`before_program` raises on
  the next step that would run a program, *after* slot selection but
  *before* the jitted call: the donated pools are still intact, so the
  watchdog can swap the offending slot out and retry it.
* ``alloc_exhaust`` — takes hostage pages off every allocator's free
  list (popped then increffed, so ``PageAllocator.check()`` stays green)
  and releases them ``hold`` ticks later: admission sees a transiently
  full pool and must wait, not fail.
* ``swap_corrupt`` — arms :meth:`maybe_corrupt`, which flips one element
  of the next swap-out snapshot *without* refreshing its digest: the
  engine's ``swap_in`` integrity check must reject the blob.
* ``latency`` — sleeps ``arg`` seconds at the top of the tick, modelling
  a straggling step for the Heartbeat/StragglerDetector path.

The plan is pure host bookkeeping with two hard rules: every injected
resource is returned (:meth:`drain` releases any hostages still held,
and the engine calls it at drain), and every event is counted
(:meth:`stats`) so tests and ``serving_bench --faults`` can assert what
actually fired.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.serving.paged_kv import snapshot_leaves

#: fault kinds a plan may schedule
KINDS = ("step_exc", "alloc_exhaust", "swap_corrupt", "latency")


class FaultInjected(RuntimeError):
    """The synthetic step exception ``step_exc`` events raise — a
    distinct type so tests can tell an injected fault from a real bug."""


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault: fires once, at the first tick >= ``tick``."""

    tick: int
    kind: str
    arg: float = 0.0        # latency seconds / alloc_exhaust hold ticks
    fired: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")


class FaultPlan:
    """A deterministic fault schedule (see module docstring)."""

    def __init__(self, events: list[FaultEvent]):
        self.events = sorted(events, key=lambda e: (e.tick, e.kind))
        self._armed_exc: str | None = None
        self._armed_corrupt = 0
        # hostage pages: allocator -> (release_tick, [pages]) entries
        self._hostages: list[tuple[int, object, list[int]]] = []
        self.injected = {k: 0 for k in KINDS}
        self.corrupted = 0      # snapshots actually mutated

    # ------------------------------------------------------------ builders
    @classmethod
    def seeded(cls, seed: int, *, n_events: int = 8, ticks: int = 64,
               kinds=KINDS, hold: int = 3,
               latency_s: float = 0.002) -> "FaultPlan":
        """A reproducible random plan: ``n_events`` faults uniform over
        ``[1, ticks]`` with kinds drawn round-robin-free from ``kinds``.
        Same seed, same plan — byte-identical across runs."""
        rng = np.random.default_rng(seed)
        kinds = tuple(kinds)
        events = []
        for _ in range(int(n_events)):
            kind = kinds[int(rng.integers(len(kinds)))]
            arg = {"alloc_exhaust": float(hold),
                   "latency": float(latency_s)}.get(kind, 0.0)
            events.append(FaultEvent(tick=int(rng.integers(1, ticks + 1)),
                                     kind=kind, arg=arg))
        return cls(events)

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse a CLI spec: ``seed=0,n=8,ticks=64,kinds=step_exc+latency,
        hold=3,latency_s=0.002`` — every field optional, kinds ``+`` (or
        ``|``) separated, defaulting to all four."""
        kw: dict = {}
        seed = 0
        for part in filter(None, (p.strip() for p in spec.split(","))):
            key, _, val = part.partition("=")
            key = key.strip()
            if key == "seed":
                seed = int(val)
            elif key in ("n", "n_events"):
                kw["n_events"] = int(val)
            elif key == "ticks":
                kw["ticks"] = int(val)
            elif key == "hold":
                kw["hold"] = int(val)
            elif key == "latency_s":
                kw["latency_s"] = float(val)
            elif key == "kinds":
                kw["kinds"] = tuple(
                    k for k in val.replace("|", "+").split("+") if k)
            else:
                raise ValueError(f"unknown --faults field {key!r}")
        return cls.seeded(seed, **kw)

    # --------------------------------------------------------------- seams
    def on_tick(self, engine) -> None:
        """The per-tick seam (top of ``PagedEngine.step``): fire every
        due event and release hostage pages whose hold expired."""
        tick = engine.ticks
        still = []
        for release_tick, alloc, pages in self._hostages:
            if tick >= release_tick:
                for p in pages:
                    alloc.decref(p)
            else:
                still.append((release_tick, alloc, pages))
        self._hostages = still
        for ev in self.events:
            if ev.fired or ev.tick > tick:
                continue
            ev.fired = True
            self.injected[ev.kind] += 1
            if ev.kind == "latency":
                time.sleep(ev.arg)
            elif ev.kind == "step_exc":
                self._armed_exc = f"injected step fault @ tick {tick}"
            elif ev.kind == "swap_corrupt":
                self._armed_corrupt += 1
            elif ev.kind == "alloc_exhaust":
                for alloc in engine.allocators.values():
                    taken = []
                    # hostage = popped off the free list *and* increffed:
                    # the allocator's check() sees a referenced, non-free
                    # page — indistinguishable from a cache hold
                    while alloc.free_pages > 0:
                        page = alloc._free.pop()
                        alloc.incref(page)
                        taken.append(page)
                    if taken:
                        self._hostages.append(
                            (tick + int(ev.arg), alloc, taken))

    def before_program(self, engine) -> None:
        """The pre-program seam: called after the step's slot selection,
        immediately before the jitted call — raising here leaves every
        pool donated-but-unconsumed, i.e. fully recoverable."""
        if self._armed_exc is not None:
            msg, self._armed_exc = self._armed_exc, None
            raise FaultInjected(msg)

    def maybe_corrupt(self, snap):
        """The swap-out seam: if a ``swap_corrupt`` event is armed, flip
        one byte of the snapshot's first non-empty leaf without refreshing
        the digest -- ``StateTree.swap_in`` must now reject it.  The
        snapshot's leaves are host tensors that belong to it alone, so the
        byte flips in place (bf16 and int8 leaves alike).  Returns the
        (possibly mutated) snapshot."""
        if self._armed_corrupt <= 0:
            return snap
        leaves = [lf for lf in snapshot_leaves(snap["blobs"])
                  if lf is not None and lf.numel() > 0]
        if not leaves:
            return snap
        self._armed_corrupt -= 1
        self.corrupted += 1
        raw = leaves[0].reshape(-1).view(torch.uint8)
        raw[0] ^= 0xFF          # one flipped byte, any dtype
        return snap

    # ------------------------------------------------------------ teardown
    def drain(self) -> None:
        """Release any hostage pages still held (engine drain / test
        teardown) — a finished plan must leave the allocators exactly as
        it found them."""
        for _, alloc, pages in self._hostages:
            for p in pages:
                alloc.decref(p)
        self._hostages = []

    @property
    def pending(self) -> int:
        return sum(not ev.fired for ev in self.events)

    def stats(self) -> dict:
        return {"injected": dict(self.injected),
                "corrupted_snapshots": self.corrupted,
                "pending_events": self.pending,
                "held_hostage_groups": len(self._hostages)}
