"""Serving engine: continuous batching with chunked prefill over paged KV
pools.

A port of ``repro.serving.engine`` for every architecture of the
registry: the attention families with a dense, gelu or MoE feed-forward
over float or int8 (``cfg.kv_cache_dtype == "int8"``) KV pools, the
recurrent families (rwkv6, and zamba2's Mamba2 blocks with their
weight-shared attention) and the cross-attention one (llama-3.2-vision).
Serving is text-only, as the reference's: no request carries a frontend,
so a cross layer attends over its frozen K/V rows, which stay zero and add
an exact zero.  One engine instance owns

* a **state tree** (:mod:`repro_torch.serving.state`): one page pool per
  attention layer (and per call of zamba2's shared block), sharing a page
  allocator per ring length, and one row per slot of each recurrent or
  cross-attention layer's state, zeroed when the slot is refilled;
* a **priority scheduler** with admission control, aging and per-request
  metrics (:mod:`repro_torch.serving.scheduler`): ``QUEUED ->
  PREFILLING(k/K chunks) -> RUNNING -> DONE``, pages claimed at the first
  chunk; with ``preempt=True`` a more urgent arrival may swap a
  lower-class victim out to the host (``StateTree.swap_out``) and the
  victim later resumes token-identically through the same admission gate;
* exactly **three programs**: one *mixed step* (``[slots, chunk]``: at most
  one prefill chunk fused with every live decode slot), one pure decode
  step (``[slots, 1]``, through the paged-attention kernel) and one slot
  reset.  PyTorch runs eagerly and compiles nothing, so
  :class:`ShapeCounter` stands in for ``JitCounter``: it counts the
  distinct argument shape signatures each program sees, and a warm engine
  sees no new one, whatever mix of request lengths arrives.

The budget accounts decode slots before granting the chunk, so decode
never stalls behind a long prompt.  Pools are updated in place.

Around the three programs, all host-side: the prefix cache (shared pages
mapped at admission, a CoW fork through the reset program), preempt-to-host,
deadlines, cancellation, injected faults with the watchdog's retry policy
(the fault seam sits before any program writes the pools), speculative
decoding (verify is the mixed step; rollback is ``StateTree.truncate``) and
seeded sampling on the device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.runtime.fault_tolerance import Heartbeat, StragglerDetector
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.paged_kv import COPY_NONE, SwapIntegrityError
from repro_torch.serving.prefix_cache import PrefixCache, PrefixHit
from repro_torch.serving.scheduler import (CANCELLED, FAILED, PREFILLING,
                                           RUNNING, TIMEOUT, FIFOScheduler,
                                           ServeRequest, slo_summary,
                                           summarize)
from repro_torch.serving.speculative import (Drafter, NGramDrafter,
                                             greedy_accept)
from repro_torch.serving.state import (build_state_tree, stack_is_stateable,
                                       tensor_leaves)
from repro_torch.serving.watchdog import Watchdog, WatchdogConfig


class ShapeCounter:
    """Wraps one engine program and counts the distinct (shape, dtype)
    signatures of its tensor arguments -- the port of ``JitCounter``,
    where a new signature meant a fresh trace and compile.  ``retraces``
    is what the zero-new-signatures-when-warm assertions key on."""

    def __init__(self, fn):
        self.fn = fn
        self.signatures: set = set()
        self.calls = 0

    def __call__(self, *args):
        self.signatures.add(tuple((tuple(t.shape), str(t.dtype))
                                  for t in tensor_leaves(args)))
        self.calls += 1
        with torch.no_grad():
            return self.fn(*args)

    @property
    def retraces(self) -> int:
        return len(self.signatures)


# ---------------------------------------------------------------------------
# Engine configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission, priority and SLO knobs (owned by the FIFOScheduler)."""
    max_queue: int = 64
    preempt: bool = False
    aging_s: float = 30.0
    slo_ttft_s: object = None         # seconds, scalar or per-class dict
    slo_e2e_s: object = None


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """KV layout and page-pool knobs (owned by the StateTree)."""
    page_size: int = 8
    max_len: int = 64
    pool_pages: int | None = None
    overcommit: float = 1.0
    prefix_cache: bool = False


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding (DESIGN.md §15)."""
    speculate: int = 0
    drafter: Drafter | None = None


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault tolerance (DESIGN.md §14): deadlines, injection, watchdog."""
    deadline_s: float | None = None
    watchdog: WatchdogConfig | bool | None = None
    plan: FaultPlan | None = None
    heartbeat: Heartbeat | str | None = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The whole PagedEngine surface as one frozen tree.  :meth:`validate`
    checks every invariant and returns the resolved copy (chunk clamped,
    step_budget defaulted) that the engine runs on."""
    slots: int = 4
    chunk: int | None = None          # prefill chunk width (None: max_len)
    step_budget: int | None = None    # tokens/step (None: slots + chunk)
    temperature: float = 0.0
    seed: int = 0                     # the sampler's generator seed
    sched: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    spec: SpecConfig = dataclasses.field(default_factory=SpecConfig)
    fault: FaultConfig = dataclasses.field(default_factory=FaultConfig)

    def validate(self) -> "EngineConfig":
        """Check every cross-field invariant and resolve the derived
        defaults; returns the resolved copy the engine runs on."""
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        max_len = self.cache.max_len
        chunk = int(self.chunk) if self.chunk is not None else max_len
        if chunk <= 0:
            raise ValueError("chunk must be positive")
        # admission caps prompts at max_len, so no chunk carries more
        chunk = min(chunk, max_len)
        step_budget = int(self.step_budget) if self.step_budget is not None \
            else self.slots + chunk
        if step_budget < max(chunk, self.slots):
            # below `chunk` a chunk could never issue; below `slots` a full
            # decode step would overrun the budget
            raise ValueError(
                f"step_budget {step_budget} < max(chunk={chunk}, "
                f"slots={self.slots}): the budget must fit one bare chunk "
                "and the full decode load")
        if self.spec.speculate < 0:
            raise ValueError("speculate must be >= 0")
        if self.spec.speculate and self.temperature > 0:
            raise ValueError(
                "speculative decoding is greedy-only: the accept rule "
                "matches drafts against the argmax chain, so speculate > 0 "
                "requires temperature == 0")
        if self.cache.pool_pages is not None and self.cache.pool_pages < 1:
            raise ValueError("pool_pages must be >= 1")
        return dataclasses.replace(self, chunk=chunk,
                                   step_budget=step_budget,
                                   spec=dataclasses.replace(
                                       self.spec,
                                       speculate=int(self.spec.speculate)))

    def verify_reference(self) -> "EngineConfig":
        """The matching reference config for A/B verify replays: the same
        shapes, with speculation, preemption and the whole fault surface
        (injection, deadlines, watchdog, heartbeat) off."""
        return dataclasses.replace(
            self,
            sched=dataclasses.replace(self.sched, preempt=False),
            spec=SpecConfig(),
            fault=FaultConfig())


class PagedEngine:
    """Chunked-prefill continuous-batching server over paged KV pools and
    recurrent rows.

    ``chunk`` is the prefill chunk width (default ``max_len``);
    ``step_budget`` the per-step token budget (default ``slots + chunk``):
    the scheduler accounts committed decode work first and grants the chunk
    (charged its real token count) only from the remainder; only leftover
    budget buys speculative drafts.  The engine runs on the device its
    parameters live on.
    """

    @staticmethod
    def supports(model: Model) -> bool:
        return stack_is_stateable(model)

    @staticmethod
    def pool_geoms(model: Model, *, slots: int, page_size: int,
                   max_len: int) -> list[tuple[int, int, int, int]]:
        """The distinct ``(slots, logical_len, head_dim, window)`` paged
        decode geometries an engine with these knobs runs (zamba2's shared
        pools included): what ``serve --autotune`` tunes
        ``paged_decode_attention`` for.  Read off the state tree itself,
        whose construction allocates nothing, so the warm-up cannot drift
        from what the decode program launches."""
        return build_state_tree(model, slots=slots, page_size=page_size,
                                max_len=max_len, device="cpu").paged_geoms()

    def __init__(self, model: Model, params, *,
                 config: EngineConfig | None = None):
        config = (config or EngineConfig()).validate()
        self.config = config
        self.model, self.params, self.cfg = model, params, model.cfg
        self.device = params["embed"].device
        slots, max_len = config.slots, config.cache.max_len
        self.slots, self.page_size = slots, config.cache.page_size
        self.max_len = max_len
        self.chunk = config.chunk
        self.step_budget = config.step_budget
        self.temperature = config.temperature
        # the sampler draws on the engine's device; only the [slots] token
        # ids go to the host
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        # --- speculative decoding: greedy only (validate() enforces it) ----
        self.speculate = config.spec.speculate
        self.drafter: Drafter | None = config.spec.drafter \
            if config.spec.drafter is not None \
            else (NGramDrafter() if self.speculate else None)
        # priority scheduling + preempt-to-host: the scheduler owns the
        # policy (aged priority order, victim choice), the engine the
        # mechanism (swap-out/swap-in through the state tree)
        self.preempt_enabled = bool(config.sched.preempt)
        self.slo_ttft_s = config.sched.slo_ttft_s
        self.slo_e2e_s = config.sched.slo_e2e_s
        self.sched = FIFOScheduler(max_queue=config.sched.max_queue,
                                   max_total_len=max_len,
                                   aging_s=config.sched.aging_s)
        self.state = build_state_tree(model, slots=slots,
                                      page_size=self.page_size,
                                      max_len=max_len,
                                      overcommit=config.cache.overcommit,
                                      pool_pages=config.cache.pool_pages,
                                      device=self.device)
        self.pools = self.state.init_device()
        # the draft-write ring clamp: a rejected draft that wrapped a ring
        # would already have overwritten history the rollback still needs,
        # so drafts are granted only while every fed position stays below
        # the smallest paged ring.  Row-only trees have no ring to protect.
        rings = [ring for (_, ring, _, _) in self.state.paged_geoms()]
        self._draft_ring = min(rings) if rings else None
        self._has_rows = self.state.has_rows

        # --- fault tolerance -------------------------------------------------
        # The watchdog always exists (it owns the step-fault recovery
        # policy); its periodic sweeps run only when the caller opted in.
        self.default_deadline_s = config.fault.deadline_s
        self.faults = config.fault.plan
        watchdog = config.fault.watchdog
        self.watchdog_enabled = bool(watchdog)
        cfg_wd = watchdog if isinstance(watchdog, WatchdogConfig) else \
            WatchdogConfig()
        if not self.watchdog_enabled:
            cfg_wd = WatchdogConfig(cadence=0,
                                    max_retries=cfg_wd.max_retries,
                                    backoff_ticks=cfg_wd.backoff_ticks,
                                    quarantine_ticks=cfg_wd.quarantine_ticks)
        self.watchdog = Watchdog(self, cfg_wd)
        self.heartbeat = Heartbeat(config.fault.heartbeat, interval_s=1.0) \
            if isinstance(config.fault.heartbeat, str) \
            else config.fault.heartbeat
        self.straggler = StragglerDetector()

        # --- prefix cache: only when every layer is a full-attention pool --
        self.prefix_cache_requested = bool(config.cache.prefix_cache)
        self.prefix_cache: PrefixCache | None = None
        self._cache_alloc = None
        if self.prefix_cache_requested:
            grp = self.state.cacheable_group()
            if grp is not None:
                self._cache_alloc = self.state.allocators[grp]
                self.prefix_cache = PrefixCache(self._cache_alloc,
                                                page_size=self.page_size)

        # --- the engine's three programs ----------------------------------
        def mixed_fn(params, pools, tokens, positions, lengths):
            # returns (last, greedy, pools): the per-column argmax chain is
            # what speculative verify accepts drafts against (verify *is*
            # the chunk program)
            view = self.state.decode_view(pools, positions[:, 0])
            return model.chunk_step(params, view, tokens, positions,
                                    lengths, return_greedy=True)

        def decode_fn(params, pools, tokens, pos, live):
            view = self.state.decode_view(pools, pos)
            return model.decode_step(params, view, tokens, pos, lengths=live)

        def reset_fn(pools, slot_ids, src, dst, resume):
            # freed-slot hygiene + the CoW content copy, one fixed-shape
            # program; sentinel (COPY_NONE) ids make the copy a no-op
            pools = self.state.reset(pools, slot_ids)
            return self.state.copy_pages(pools, src, dst, resume)

        # ``_prefill`` is the mixed-step program (the only one that ever
        # prefills); the names keep the stats/CLI surface of ``repro``
        self._prefill = ShapeCounter(mixed_fn)
        self._decode = ShapeCounter(decode_fn)
        self._reset = ShapeCounter(reset_fn)

        # --- per-slot host state ------------------------------------------
        self.active: list[ServeRequest | None] = [None] * slots
        self._cur = np.zeros((slots, 1), np.int32)
        self._pos = np.zeros((slots,), np.int32)
        self._emit_step = np.zeros((slots,), np.int64)
        self._rid = 0
        self.ticks = 0              # step() calls, program or not: the
        #                             clock faults, backoff and quarantine
        #                             key on
        self.steps = 0              # programs run (mixed + pure decode)
        self.decode_steps = 0       # steps that advanced >= 1 decode slot
        self._issued = 0            # real tokens issued across all steps
        self._max_stall = 0         # worst decode gap observed, in steps
        self._prefill_tok = 0       # prompt tokens prefilled
        self._cached_tok = 0        # prompt tokens skipped via cache hits
        self._cow_forks = 0         # copy-on-write page forks performed
        self.preemptions = 0        # slots swapped out to host
        self.resumes = 0            # preempted requests swapped back in
        self.recovered = 0          # step faults survived via requeue
        self.timeouts = 0           # requests expired past their deadline
        self.cancels = 0            # requests cancelled by their caller
        self.unservable = 0         # queue heads failed as never-admittable
        self.swap_rejects = 0       # corrupted snapshots rejected at swap-in
        self.spec_steps = 0         # verify steps that carried >= 1 draft
        self.spec_drafted = 0       # draft tokens fed through verify
        self.spec_accepted = 0      # drafts the argmax chain accepted
        self.spec_emitted = 0       # tokens emitted by draft-carrying steps

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # ---------------------------------------------------------------- API
    def submit(self, prompt, max_new: int, rid: int | None = None,
               priority: int = 0,
               deadline_s: float | None = None) -> ServeRequest:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if rid is None:
            # auto rids never collide with a live caller-supplied rid
            live = ({r.rid for r in self.sched.queue}
                    | {r.rid for r in self.sched.running.values()})
            while self._rid in live:
                self._rid += 1
            rid, self._rid = self._rid, self._rid + 1
        req = ServeRequest(rid=rid, prompt=prompt, max_new=int(max_new),
                           priority=int(priority),
                           deadline_s=deadline_s if deadline_s is not None
                           else self.default_deadline_s)
        # every rejection class goes through the scheduler's one reject path
        self.sched.submit(req)
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel request ``rid`` in any non-terminal state (queued,
        preempted, prefilling, running); every resource it held comes back
        and its partial output stays on the request.  False when ``rid`` is
        unknown or already terminal."""
        req = next((r for r in self.sched.queue if r.rid == rid), None)
        if req is None:
            req = next((r for r in self.active
                        if r is not None and r.rid == rid), None)
        if req is None:
            return False
        self._terminate(req, CANCELLED, "cancelled by caller")
        self.cancels += 1
        return True

    def run_until_idle(self, log=None) -> dict[int, list[int]]:
        while not self.sched.idle:
            self.step()
        if self.faults is not None:
            # a drained engine returns every injected resource
            self.faults.drain()
        if self.watchdog_enabled:
            self.watchdog.sweep()   # the at-drain invariant oracle
        if log is not None:
            log(self.report())
        return {r.rid: list(r.out) for r in self.sched.done}

    # ------------------------------------------------------------- engine
    def step(self) -> None:
        """One scheduler iteration: expire deadlines, admit the queue head
        into a free slot (page claim at first chunk), then issue one
        fixed-shape program -- the mixed step (committed decode work + at
        most one prefill chunk, decode accounted first) when a chunk fits
        or a slot speculates, the pure decode step otherwise.  A fault
        injected at the seam before the program goes to the watchdog's
        recovery policy instead of crashing the batch."""
        self.ticks += 1
        if self.faults is not None:
            self.faults.on_tick(self)
        self._expire()
        self.watchdog.maybe_sweep()
        self._admit()
        dec = [i for i, r in enumerate(self.active)
               if r is not None and r.state == RUNNING]
        pf = next((i for i, r in enumerate(self.active)
                   if r is not None and r.state == PREFILLING), None)
        # committed decode work first -- one token a slot, or a slot's whole
        # pending tail under speculation -- then the chunk from the rest
        committed = sum(self._n_pending(i) for i in dec) if self.speculate \
            else len(dec)
        if pf is not None:
            r = self.active[pf]
            remaining = min(self.chunk, r.prompt_len - r.prefill_pos)
            if committed + remaining > self.step_budget:
                pf = None
        if not dec and pf is None:
            return
        if self.faults is not None:
            # the pre-program seam: slots are selected and nothing has
            # written the pools yet, so a fault raised here is recoverable
            try:
                self.faults.before_program(self)
            except Exception as e:   # noqa: BLE001 -- any injected fault
                self._recover(e, dec, pf)
                return
        t0 = time.perf_counter()
        self.steps += 1
        if pf is not None or (self.speculate and dec):
            # with speculation on, decode rides the mixed program (a
            # speculating slot is a multi-token chunk): still three programs
            self._mixed_step(dec, pf)
        else:
            self._decode_step(dec)
        self.straggler.record(time.perf_counter() - t0)
        if self.heartbeat is not None:
            self.heartbeat.beat(self.ticks, steps=self.steps,
                                queued=len(self.sched.queue),
                                running=len(self.sched.running),
                                done=len(self.sched.done))

    # ------------------------------------------------------ failure edges
    def _expire(self) -> None:
        """Terminate every request past its wall-clock deadline, queued
        (a preempted one drops its snapshot) or live in a slot."""
        now = self.sched.clock()
        stale = [r for r in list(self.sched.queue)
                 + [r for r in self.active if r is not None]
                 if r.deadline_s is not None
                 and now - r.t_submit > r.deadline_s]
        for req in stale:
            self._terminate(req, TIMEOUT,
                            f"deadline {req.deadline_s:g}s exceeded")
            self.timeouts += 1

    def _terminate(self, req: ServeRequest, status: str,
                   error: str | None = None) -> None:
        """The one reclamation path of every abnormal end: release the
        slot's pages and rows if the request holds one, then hand the
        bookkeeping to the scheduler."""
        slot = req.slot
        if slot >= 0 and self.active[slot] is req:
            self.active[slot] = None
            self.state.release(slot)
            self._push_tables()
        self.sched.terminate(req, status, error)

    def _recover(self, exc: Exception, dec: list[int],
                 pf: int | None) -> None:
        """The step-fault handler: the watchdog decides retry or fail for
        the offending slot's request (the prefilling slot if one was
        selected, else the first decode slot).  A retry is a preemption
        with a backoff hold and the slot quarantined; exhausted retries
        end FAILED."""
        slot = pf if pf is not None else dec[0]
        req = self.active[slot]
        verdict = self.watchdog.on_step_fault(req, exc)
        if verdict == "retry":
            self.preempt(slot)
            self.recovered += 1
        else:
            self._terminate(req, FAILED,
                            f"retries exhausted after {req.retries - 1} "
                            f"recoveries ({req.error})")

    def _admit(self) -> None:
        # Chunks issue one per step, so at most one request prefills at a
        # time.  The candidate is the scheduler's priority head; with
        # preemption on, a head of a strictly higher class than some active
        # request may swap a victim out rather than wait behind it.
        head = self.sched.head(self.ticks)
        if head is None:
            return
        if self.preempt_enabled and self._blocked(head):
            victim = self.sched.pick_victim(
                head, [r for r in self.active if r is not None])
            if victim is not None:
                self.preempt(victim.slot)
        if any(r is not None and r.state == PREFILLING for r in self.active):
            return
        free = self.watchdog.usable_slots(
            [i for i, a in enumerate(self.active) if a is None])
        if not free:
            return
        head = self.sched.head(self.ticks)  # the preempted victim may lead
        if head is None:
            return
        if head.swap is not None:
            # a preempted request resumes through the same gate with an
            # all-private claim, bypassing the prefix-cache match (its
            # snapshot holds everything a hit could offer); eviction still
            # runs so cached idle pages never starve a resume
            if not self._can_admit_head(None):
                return
            self.sched.pop(head, free[0])
            try:
                self._resume(head)
            except SwapIntegrityError as e:
                # rejected before any device write: undo the claim and fail
                slot = head.slot
                self.active[slot] = None
                self.state.release(slot)
                self._push_tables()
                self.sched.terminate(head, FAILED, str(e))
                self.swap_rejects += 1
            return
        # one cache lookup per admission attempt, on the head only; match
        # takes no references, so a rejected admission drops it
        hit: PrefixHit | None = None
        if self.prefix_cache is not None:
            h = self.prefix_cache.match(head.prompt)
            hit = h if h.is_hit else None
        kept = 0
        if hit is not None:
            kept = len(hit.pages) - (1 if hit.fork_logical is not None else 0)
        if not self.state.can_ever_admit(shared=kept):
            # structurally unservable: waiting can never help
            self._terminate(head, FAILED,
                            "unservable: the request needs more pages than "
                            "the pool can ever supply")
            self.unservable += 1
            return
        if not self._can_admit_head(hit):
            return
        req = self.sched.pop(head, free[0])
        # a hit admits straight to PREFILLING(k/K): the shared pages map
        # into the slot's leading logical rows and prefill resumes at the
        # page boundary (a full hit recomputes its last token in a
        # CoW-forked copy of the last shared page)
        if self.prefix_cache is not None:
            self.prefix_cache.record(req.prompt_len, hit)
        req.cached_tokens = hit.resume if hit else 0
        req.prefill_pos = req.cached_tokens
        req.n_chunks = -(-req.prompt_len // self.chunk)
        remaining = -(-(req.prompt_len - req.prefill_pos) // self.chunk)
        req.chunks_done = req.n_chunks - remaining
        self.active[req.slot] = req
        self.state.admit(req.slot, shared=hit.pages if hit else ())
        src = dst = int(COPY_NONE)
        resume = 0
        if hit is not None and hit.fork_logical is not None:
            src, dst = self._cache_alloc.cow_fork(req.slot, hit.fork_logical)
            resume = hit.resume
            self._cow_forks += 1
        self._cached_tok += req.cached_tokens
        # freed-state hygiene before any new writes, one fixed-shape reset
        # (slot ids padded with -1): run against the staged table, whose
        # cache-shared entries are sentineled so their positions survive;
        # the CoW copy rides the same program
        self.pools = self.state.push_tables(self.pools,
                                            private_only_slot=req.slot)
        ids = np.full((self.slots,), -1, np.int32)
        ids[0] = req.slot
        self.pools = self._reset(
            self.pools, self._tensor(ids),
            self._tensor(np.asarray([src], np.int32)),
            self._tensor(np.asarray([dst], np.int32)),
            self._tensor(np.asarray([resume], np.int32)))
        self._push_tables()

    def _can_admit_head(self, hit: PrefixHit | None) -> bool:
        """Physical-page admission: the ``kept`` shared pages are already
        resident, so the head needs ``pages_per_slot - kept`` fresh pages;
        refcount-aware LRU eviction runs first if the free list is short,
        pinning the pages this hit is about to map."""
        kept = 0
        if hit is not None:
            kept = len(hit.pages) - (1 if hit.fork_logical is not None else 0)
        if self.prefix_cache is not None:
            a = self._cache_alloc
            need = a.pages_per_slot - kept
            if a.free_pages < need:
                self.prefix_cache.evict(
                    need, protect=frozenset(hit.pages if hit else ()))
        return self.state.can_admit(shared=kept)

    # -------------------------------------------------- preempt-to-host
    def _blocked(self, head: ServeRequest) -> bool:
        """Whether the head cannot be admitted as the engine stands: every
        slot occupied, or the page claim does not fit even after
        prefix-cache eviction (preemption is the last resort)."""
        if all(r is not None for r in self.active):
            return True
        return not self._can_admit_head(None)

    def preempt(self, slot: int) -> ServeRequest:
        """Swap ``slot`` out to host and requeue its request as PREEMPTED.
        The snapshot (page contents + positions + recurrent rows) and the
        host decode cursor are everything a token-identical resume needs;
        the snapshot is on the host before the slot's pages are released.
        Eager work only: the engine still runs three programs."""
        req = self.active[slot]
        if req is None or req.state not in (PREFILLING, RUNNING):
            raise ValueError(f"slot {slot} holds nothing preemptible")
        snap = self.state.swap_out(self.pools, slot)
        if self.faults is not None:
            # the swap_corrupt seam: an armed event flips one byte of this
            # snapshot (digest left stale) -- resume must reject it
            snap = self.faults.maybe_corrupt(snap)
        req.swap = {
            "state": snap,
            "cur": int(self._cur[slot, 0]),
            "pos": int(self._pos[slot]),
            "running": req.state == RUNNING,
        }
        req.preemptions += 1
        self.active[slot] = None
        self.state.release(slot)
        self._push_tables()
        self.sched.requeue(req)
        self.preemptions += 1
        return req

    def _resume(self, req: ServeRequest) -> None:
        """Swap a preempted request back in: claim an all-private row, run
        the one reset program (sentinel CoW ids), restore the snapshot and
        re-enter the lifecycle where it left off -- PREFILLING(k/K) at the
        swap point, or RUNNING with its decode cursor."""
        slot = req.slot
        self.active[slot] = req
        self.state.admit(slot)
        self.pools = self.state.push_tables(self.pools)
        ids = np.full((self.slots,), -1, np.int32)
        ids[0] = slot
        none = self._tensor(np.asarray([COPY_NONE], np.int32))
        self.pools = self._reset(self.pools, self._tensor(ids), none, none,
                                 self._tensor(np.zeros((1,), np.int32)))
        self.pools = self.state.swap_in(self.pools, slot, req.swap["state"])
        self._push_tables()
        if req.swap["running"]:
            req.state = RUNNING
            self._cur[slot, 0] = req.swap["cur"]
            self._pos[slot] = req.swap["pos"]
            self._emit_step[slot] = self.steps   # swap gap is not a stall
        req.swap = None
        req.recovering = False   # a watchdog retry that made it back in
        self.resumes += 1

    def _mixed_step(self, dec: list[int], pf: int | None) -> None:
        w = self.chunk
        req = None
        n = 0
        if pf is not None:
            req = self.active[pf]
            n = min(w, req.prompt_len - req.prefill_pos)
        tokens = np.zeros((self.slots, w), np.int32)
        positions = np.zeros((self.slots, w), np.int32)
        lengths = np.zeros((self.slots,), np.int32)
        ar = np.arange(w, dtype=np.int32)
        meta: dict[int, tuple[int, np.ndarray]] = {}
        snaps: dict[int, object] = {}
        if self.speculate and dec:
            # verify as a chunk: each speculating slot's row carries its
            # committed pending tail, then drafts from the leftover budget
            budget = self.step_budget - n \
                - sum(self._n_pending(i) for i in dec)
            for i in dec:
                pend = self._pending(i)
                drafts = self._draft_for(i, len(pend), budget)
                budget -= len(drafts)
                if len(drafts) and self._has_rows:
                    # the program advances rows in place: copy the
                    # last-accepted rows before it runs
                    snaps[i] = self.state.spec_snapshot(self.pools, i)
                row = np.concatenate([pend, drafts]) \
                    if len(drafts) else pend
                tokens[i, :len(row)] = row
                positions[i] = self._pos[i] + ar
                lengths[i] = len(row)
                meta[i] = (len(pend), drafts)
        else:
            for i in dec:
                tokens[i, 0] = self._cur[i, 0]
                positions[i] = self._pos[i] + ar
                lengths[i] = 1
        if pf is not None:
            start = req.prefill_pos
            tokens[pf, :n] = req.prompt[start:start + n]
            positions[pf] = start + ar
            lengths[pf] = n
        last, greedy, self.pools = self._prefill(
            self.params, self.pools, self._tensor(tokens),
            self._tensor(positions), self._tensor(lengths))
        self._issued += int(sum(lengths[i] for i in dec)) + n
        self._prefill_tok += n
        nxt = self._sample(last)
        if meta:
            finished = self._advance_speculative(
                dec, greedy.cpu().numpy(), meta, snaps)
        else:
            finished = self._advance_decode(dec, nxt)
        if pf is not None:
            req.prefill_pos += n
            req.chunks_done += 1
            if req.prefill_pos >= req.prompt_len:
                # prefill complete: register the prompt's full pages under
                # the cache chain (only committed prompt tokens ever reach
                # it -- drafts live in decode rows)
                if self.prefix_cache is not None:
                    self.prefix_cache.insert(
                        req.prompt, self._cache_alloc.slot_pages(req.slot))
                # last chunk: its top-row logits give the first token
                req.state = RUNNING
                req.out.append(int(nxt[pf]))
                req.t_first = self.sched.clock()
                self._cur[pf, 0] = int(nxt[pf])
                self._pos[pf] = req.prompt_len
                self._emit_step[pf] = self.steps
                if len(req.out) >= req.max_new:  # max_new=1: done at prefill
                    self._finish(pf)
                    finished += 1
        if finished:
            self._push_tables()

    # ------------------------------------------- speculative decode (§15)
    def _n_pending(self, i: int) -> int:
        """Committed tokens not yet in slot ``i``'s device state: 1 in
        plain decode, more after a recurrent rollback re-queued an accepted
        run for re-feeding."""
        req = self.active[i]
        return req.prompt_len + len(req.out) - int(self._pos[i])

    def _pending(self, i: int) -> np.ndarray:
        """The committed tokens slot ``i`` must feed next, in stream order
        (``pending[0]`` lands at position ``_pos[i]``)."""
        req = self.active[i]
        stream = np.concatenate(
            [req.prompt, np.asarray(req.out, np.int32)])
        return stream[int(self._pos[i]):].astype(np.int32)

    def _draft_for(self, i: int, n_pend: int, budget: int) -> np.ndarray:
        """Drafts for slot ``i`` under every clamp: the chunk width, the
        leftover budget, the request's remaining output and the ring."""
        req = self.active[i]
        k = min(self.speculate, self.chunk - n_pend, budget,
                req.max_new - len(req.out) - 1)
        if self._draft_ring is not None:
            k = min(k, self._draft_ring - (int(self._pos[i]) + n_pend))
        if k <= 0:
            return np.zeros((0,), np.int32)
        hist = np.concatenate([req.prompt, np.asarray(req.out, np.int32)])
        drafts = np.asarray(self.drafter.propose(hist, k),
                            np.int32).reshape(-1)
        return drafts[:k]

    def _advance_speculative(self, dec: list[int], greedy: np.ndarray,
                             meta: dict, snaps: dict) -> int:
        """The accept/rollback walk of every verified slot: accept the
        longest draft prefix that matches the argmax chain plus the first
        correction token -- the stream plain greedy decode emits.  On a
        rejection, pure-paged trees keep the accepted positions and mask
        the rest; row-bearing trees restore the pre-verify snapshot and
        re-feed the newly committed run next chunk."""
        if dec:
            self.decode_steps += 1
        finished = 0
        for i in dec:
            req = self.active[i]
            n_pend, drafts = meta[i]
            k = len(drafts)
            a, toks = greedy_accept(drafts, greedy[i], n_pend - 1)
            toks = toks[:req.max_new - len(req.out)]
            base = int(self._pos[i])
            if a == k:
                # full accept (plain decode is k == 0): the state advances
                self._pos[i] = base + n_pend + k
            elif self._has_rows:
                self.pools = self.state.truncate(self.pools, i, base,
                                                 snap=snaps[i])
            else:
                new_pos = base + n_pend + a
                self.pools = self.state.truncate(self.pools, i, new_pos)
                self._pos[i] = new_pos
            req.out.extend(toks)
            self._cur[i, 0] = int(req.out[-1])
            if k > 0:
                self.spec_steps += 1
                self.spec_drafted += k
                self.spec_accepted += a
                self.spec_emitted += len(toks)
                req.drafted += k
                req.accepted += a
            self._max_stall = max(self._max_stall,
                                  int(self.steps - self._emit_step[i] - 1))
            self._emit_step[i] = self.steps
            if len(req.out) >= req.max_new:
                self._finish(i)
                finished += 1
        return finished

    def _decode_step(self, dec: list[int]) -> None:
        live = np.zeros((self.slots,), np.int32)
        live[dec] = 1
        logits, self.pools = self._decode(
            self.params, self.pools, self._tensor(self._cur),
            self._tensor(self._pos), self._tensor(live))
        self._issued += len(dec)
        nxt = self._sample(logits)
        if self._advance_decode(dec, nxt):
            # sentinel the freed table rows before the next step: an idle
            # slot's writes must go to the trash page, not to pages a later
            # request may own
            self._push_tables()

    def _advance_decode(self, dec: list[int], nxt: np.ndarray) -> int:
        """Emit one token for every live decode slot; returns #finished."""
        if dec:
            self.decode_steps += 1
        finished = 0
        for i in dec:
            req = self.active[i]
            req.out.append(int(nxt[i]))
            self._cur[i, 0] = int(nxt[i])
            self._pos[i] += 1
            self._max_stall = max(self._max_stall,
                                  int(self.steps - self._emit_step[i] - 1))
            self._emit_step[i] = self.steps
            if len(req.out) >= req.max_new:
                self._finish(i)
                finished += 1
        return finished

    def _finish(self, slot: int) -> None:
        """Retire a slot (host bookkeeping; the caller pushes the tables)."""
        req = self.active[slot]
        self.active[slot] = None
        self.sched.complete(req)
        self.state.release(slot)

    def _push_tables(self) -> None:
        self.pools = self.state.push_tables(self.pools)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """One token a row: the argmax (greedy), or a draw from
        ``softmax(logits / T)`` in float32 on the logits' device from the
        engine's seeded generator.  Only the ids go to the host."""
        if self.temperature > 0:
            probs = torch.softmax(logits.float() / self.temperature, dim=-1)
            ids = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        else:
            ids = torch.argmax(logits, dim=-1)
        return ids.cpu().numpy()

    # ------------------------------------------------------------ metrics
    @property
    def allocators(self):
        return self.state.allocators

    @property
    def moe_gemm(self) -> str | None:
        """Which expert FFN the MoE layers run: ``"kernel"`` (the
        hand-written ``grouped_moe_gemm``, on CUDA) or ``"plain"``; None
        without MoE layers."""
        if not self.cfg.num_experts:
            return None
        kernel = (self.device.type == "cuda"
                  and self.model.kernels.moe_ffn is ops.grouped_expert_ffn)
        return "kernel" if kernel else "plain"

    def stats(self) -> dict:
        cache = self.prefix_cache
        return {
            "prefill_calls": self._prefill.calls,
            "prefill_retraces": self._prefill.retraces,
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "decode_calls": self._decode.calls,
            "decode_retraces": self._decode.retraces,
            "moe_gemm": self.moe_gemm,
            "reset_calls": self._reset.calls,
            "reset_retraces": self._reset.retraces,
            "chunk": self.chunk,
            "step_budget": self.step_budget,
            "budget_util": self._issued / max(1, self.steps * self.step_budget),
            "max_decode_stall": self._max_stall,
            "free_pages": self.state.free_pages,
            "prefix_cache": cache is not None,
            "prefix_lookups": cache.lookups if cache else 0,
            "prefix_hits": cache.hits if cache else 0,
            "prefix_hit_rate": round(cache.hit_rate, 4) if cache else 0.0,
            "prefill_tokens": self._prefill_tok,
            "cached_prefill_tokens": self._cached_tok,
            "cow_forks": self._cow_forks,
            "cache_pages": cache.cached_pages if cache else 0,
            "cache_evictions": cache.evictions if cache else 0,
            "speculate": self.speculate,
            "spec_steps": self.spec_steps,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": round(
                self.spec_accepted / self.spec_drafted, 4)
            if self.spec_drafted else 0.0,
            "spec_accepted_per_step": round(
                self.spec_emitted / self.spec_steps, 4)
            if self.spec_steps else 0.0,
            "preempt": self.preempt_enabled,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "ticks": self.ticks,
            "recovered": self.recovered,
            "timeouts": self.timeouts,
            "cancels": self.cancels,
            "unservable": self.unservable,
            "swap_rejects": self.swap_rejects,
            "failed_total": len(self.sched.failed),
            "straggler_steps": self.straggler.flagged,
            "watchdog": self.watchdog.stats() if self.watchdog_enabled
            else None,
            "faults": self.faults.stats() if self.faults is not None
            else None,
            "slo": self.slo(),
        }

    def slo(self) -> dict:
        """Per-priority-class TTFT/e2e distribution (p50/p99) with
        attainment against the configured targets."""
        return slo_summary(self.sched.done, ttft_target_s=self.slo_ttft_s,
                           e2e_target_s=self.slo_e2e_s)

    def report(self) -> str:
        s = self.stats()
        m = summarize(self.sched.done + self.sched.rejected
                      + self.sched.failed)
        cache = ""
        if s["prefix_cache"]:
            cache = (f"| prefix hit rate={s['prefix_hit_rate'] * 100:.1f}% "
                     f"({s['cached_prefill_tokens']} tok cached, "
                     f"{s['cow_forks']} cow forks) ")
        spec = ""
        if self.speculate:
            spec = (f"| speculate k={s['speculate']}: "
                    f"accept rate={s['spec_accept_rate'] * 100:.1f}% "
                    f"accepted/step={s['spec_accepted_per_step']:.2f} "
                    f"({s['spec_accepted']}/{s['spec_drafted']} drafts) ")
        pre = ""
        if self.preempt_enabled:
            pre = (f"| preemptions={s['preemptions']} "
                   f"(resumes={s['resumes']}) ")
        ft = ""
        if (self.faults is not None or self.watchdog_enabled
                or s["failed_total"] or s["timeouts"] or s["cancels"]):
            ft = (f"| faults: recovered={s['recovered']} "
                  f"timeout={s['timeouts']} cancelled={s['cancels']} "
                  f"failed={s['failed_total'] - s['timeouts'] - s['cancels']} ")
        slo = ""
        for cls, ent in sorted(s["slo"].items()):
            seg = (f"p{cls}: ttft p50/p99="
                   f"{ent['ttft_p50_s'] * 1e3:.0f}/"
                   f"{ent['ttft_p99_s'] * 1e3:.0f} ms")
            if "ttft_attained" in ent:
                seg += (f" ({ent['ttft_attained'] * 100:.0f}% <= "
                        f"{ent['ttft_target_s'] * 1e3:.0f} ms)")
            if "e2e_attained" in ent:
                seg += (f", e2e {ent['e2e_attained'] * 100:.0f}% <= "
                        f"{ent['e2e_target_s'] * 1e3:.0f} ms")
            slo += f"| slo {seg} "
        return (f"served {m.get('done', 0)} req "
                f"({m.get('rejected', 0)} rejected), "
                f"{m.get('tokens', 0)} tok @ {m.get('tok_s', 0.0):.1f} tok/s "
                f"| ttft mean {m.get('ttft_mean_s', 0.0) * 1e3:.0f} ms "
                f"| prefill retraces={s['prefill_retraces']} "
                f"decode retraces={s['decode_retraces']} "
                f"| max decode stall={s['max_decode_stall']} steps "
                f"{cache}{spec}{pre}{ft}{slo}"
                f"| budget util={s['budget_util'] * 100:.1f}% "
                f"(chunk={s['chunk']}, budget={s['step_budget']})")
