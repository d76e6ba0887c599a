"""Serving engine: continuous batching with chunked prefill over paged KV
pools.

A port of ``repro.serving.engine`` for the attention families with a dense
or MoE feed-forward, over float or int8 (``cfg.kv_cache_dtype == "int8"``)
KV pools, and for the recurrent families (rwkv6, and zamba2's Mamba2
blocks with their weight-shared attention).  One engine instance owns

* a **state tree** (:mod:`repro_torch.serving.state`): one page pool per
  attention layer (and per call of zamba2's shared block), sharing a page
  allocator per ring length, and one row per slot of each recurrent
  layer's state, zeroed when the slot is refilled;
* a **priority scheduler** with admission control and per-request metrics
  (:mod:`repro_torch.serving.scheduler`): ``QUEUED -> PREFILLING(k/K
  chunks) -> RUNNING -> DONE``, pages claimed at the first chunk;
* exactly **three programs**: one *mixed step* (``[slots, chunk]``: at most
  one prefill chunk fused with every live decode slot), one pure decode
  step (``[slots, 1]``, through the paged-attention kernel) and one slot
  reset.  PyTorch runs eagerly and compiles nothing, so
  :class:`ShapeCounter` stands in for ``JitCounter``: it counts the
  distinct argument shape signatures each program sees, and a warm engine
  sees no new one, whatever mix of request lengths arrives.

The budget accounts decode slots before granting the chunk, so decode
never stalls behind a long prompt.  Pools are updated in place.

Not ported yet, and refused by :meth:`EngineConfig.validate` with the
ROADMAP item that brings each: prefix caching, preemption, deadlines and
faults, speculative decoding, and sampling (``temperature > 0``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.serving.paged_kv import COPY_NONE
from repro_torch.serving.scheduler import (FAILED, PREFILLING, RUNNING,
                                           FIFOScheduler, ServeRequest,
                                           slo_summary, summarize)
from repro_torch.serving.state import (build_state_tree, stack_is_stateable,
                                       tensor_leaves)


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
    """Speculative decoding."""
    speculate: int = 0
    drafter: object = None


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault tolerance: deadlines, injection, watchdog, heartbeat."""
    deadline_s: float | None = None
    watchdog: object = None
    plan: object = None
    heartbeat: object = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The whole PagedEngine surface as one frozen tree.  :meth:`validate`
    checks every invariant and returns the resolved copy (chunk clamped,
    step_budget defaulted) that the engine runs on."""
    slots: int = 4
    chunk: int | None = None          # prefill chunk width (None: max_len)
    step_budget: int | None = None    # tokens/step (None: slots + chunk)
    temperature: float = 0.0
    sched: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    spec: SpecConfig = dataclasses.field(default_factory=SpecConfig)
    fault: FaultConfig = dataclasses.field(default_factory=FaultConfig)

    def _refuse_unported(self) -> None:
        f = self.fault
        unported = [
            (self.cache.prefix_cache, "prefix caching", "9b"),
            (self.sched.preempt, "preemption", "9c"),
            (f.deadline_s is not None or bool(f.watchdog)
             or f.plan is not None or f.heartbeat is not None,
             "deadlines, fault injection, watchdog and heartbeat", "9d"),
            (self.spec.speculate > 0 or self.spec.drafter is not None,
             "speculative decoding", "9e"),
            (self.temperature > 0, "sampling (temperature > 0)", "9f"),
        ]
        for on, what, item in unported:
            if on:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP Queue 1 item {item})")

    def validate(self) -> "EngineConfig":
        """Check every cross-field invariant and resolve the derived
        defaults; returns the resolved copy the engine runs on."""
        self._refuse_unported()
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
        if self.cache.pool_pages is not None and self.cache.pool_pages < 1:
            raise ValueError("pool_pages must be >= 1")
        return dataclasses.replace(self, chunk=chunk, step_budget=step_budget)


class PagedEngine:
    """Chunked-prefill continuous-batching server over paged KV pools.

    ``chunk`` is the prefill chunk width (default ``max_len``);
    ``step_budget`` the per-step token budget (default ``slots + chunk``):
    the scheduler accounts one token per live decode slot first and grants
    the chunk (charged its real token count) only from the remainder.  The
    engine runs on the device its parameters live on.
    """

    @staticmethod
    def supports(model: Model) -> bool:
        return stack_is_stateable(model)

    def __init__(self, model: Model, params, *,
                 config: EngineConfig | None = None):
        config = (config or EngineConfig()).validate()
        self.config = config
        if not self.supports(model):
            raise NotImplementedError(
                "a stack slot of this model has no ported state "
                "(repro_torch.serving.state); ROADMAP Queue 1 item 8")
        self.model, self.params, self.cfg = model, params, model.cfg
        self.device = params["embed"].device
        slots, max_len = config.slots, config.cache.max_len
        self.slots, self.page_size = slots, config.cache.page_size
        self.max_len = max_len
        self.chunk = config.chunk
        self.step_budget = config.step_budget
        self.sched = FIFOScheduler(max_queue=config.sched.max_queue,
                                   max_total_len=max_len,
                                   aging_s=config.sched.aging_s)
        self.slo_ttft_s = config.sched.slo_ttft_s
        self.slo_e2e_s = config.sched.slo_e2e_s
        self.state = build_state_tree(model, slots=slots,
                                      page_size=self.page_size,
                                      max_len=max_len,
                                      overcommit=config.cache.overcommit,
                                      pool_pages=config.cache.pool_pages,
                                      device=self.device)
        self.pools = self.state.init_device()

        # --- the engine's three programs ----------------------------------
        def mixed_fn(params, pools, tokens, positions, lengths):
            # returns (last, greedy, pools): the per-column argmax chain
            # keeps one mixed program shape (it is what speculative verify
            # will accept drafts against)
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
        self.ticks = 0              # step() calls, program or not
        self.steps = 0              # programs run (mixed + pure decode)
        self.decode_steps = 0       # steps that advanced >= 1 decode slot
        self._issued = 0            # real tokens issued across all steps
        self._max_stall = 0         # worst decode gap observed, in steps
        self._prefill_tok = 0       # prompt tokens prefilled
        self.unservable = 0         # queue heads failed as never-admittable

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # ---------------------------------------------------------------- API
    def submit(self, prompt, max_new: int, rid: int | None = None,
               priority: int = 0) -> ServeRequest:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if rid is None:
            # auto rids never collide with a live caller-supplied rid
            live = ({r.rid for r in self.sched.queue}
                    | {r.rid for r in self.sched.running.values()})
            while self._rid in live:
                self._rid += 1
            rid, self._rid = self._rid, self._rid + 1
        req = ServeRequest(rid=rid, prompt=prompt, max_new=int(max_new),
                           priority=int(priority))
        # every rejection class goes through the scheduler's one reject path
        self.sched.submit(req)
        return req

    def run_until_idle(self, log=None) -> dict[int, list[int]]:
        while not self.sched.idle:
            self.step()
        if log is not None:
            log(self.report())
        return {r.rid: list(r.out) for r in self.sched.done}

    # ------------------------------------------------------------- engine
    def step(self) -> None:
        """One scheduler iteration: admit the queue head into a free slot
        (page claim at first chunk), then issue one fixed-shape program --
        the mixed step (every live decode slot + at most one prefill chunk,
        decode accounted against the budget first) when a chunk fits, the
        pure decode step otherwise."""
        self.ticks += 1
        self._admit()
        dec = [i for i, r in enumerate(self.active)
               if r is not None and r.state == RUNNING]
        pf = next((i for i, r in enumerate(self.active)
                   if r is not None and r.state == PREFILLING), None)
        if pf is not None:
            # the chunk is charged its real token count
            r = self.active[pf]
            remaining = min(self.chunk, r.prompt_len - r.prefill_pos)
            if len(dec) + remaining > self.step_budget:
                pf = None
        if not dec and pf is None:
            return
        self.steps += 1
        if pf is not None:
            self._mixed_step(dec, pf)
        else:
            self._decode_step(dec)

    def _admit(self) -> None:
        # chunks issue one per step, so at most one request prefills at a
        # time; admission == page claim at first chunk
        head = self.sched.head(self.ticks)
        if head is None:
            return
        if any(r is not None and r.state == PREFILLING for r in self.active):
            return
        free = [i for i, a in enumerate(self.active) if a is None]
        if not free:
            return
        if not self.state.can_ever_admit():
            # structurally unservable: waiting can never help
            self.sched.terminate(head, FAILED,
                                 "unservable: the request needs more pages "
                                 "than the pool can ever supply")
            self.unservable += 1
            return
        if not self.state.can_admit():
            return
        req = self.sched.pop(head, free[0])
        req.prefill_pos = 0
        req.n_chunks = -(-req.prompt_len // self.chunk)
        req.chunks_done = 0
        self.active[req.slot] = req
        self.state.admit(req.slot)
        # freed-state hygiene before any new writes: one fixed-shape reset
        # (slot ids padded with -1) invalidates the pages the slot now owns
        self.pools = self.state.push_tables(self.pools,
                                            private_only_slot=req.slot)
        ids = np.full((self.slots,), -1, np.int32)
        ids[0] = req.slot
        none = np.asarray([COPY_NONE], np.int32)
        self.pools = self._reset(self.pools, self._tensor(ids),
                                 self._tensor(none), self._tensor(none),
                                 self._tensor(np.zeros((1,), np.int32)))
        self._push_tables()

    def _mixed_step(self, dec: list[int], pf: int) -> None:
        w = self.chunk
        req = self.active[pf]
        n = min(w, req.prompt_len - req.prefill_pos)
        tokens = np.zeros((self.slots, w), np.int32)
        positions = np.zeros((self.slots, w), np.int32)
        lengths = np.zeros((self.slots,), np.int32)
        ar = np.arange(w, dtype=np.int32)
        for i in dec:
            tokens[i, 0] = self._cur[i, 0]
            positions[i] = self._pos[i] + ar
            lengths[i] = 1
        start = req.prefill_pos
        tokens[pf, :n] = req.prompt[start:start + n]
        positions[pf] = start + ar
        lengths[pf] = n
        last, _greedy, self.pools = self._prefill(
            self.params, self.pools, self._tensor(tokens),
            self._tensor(positions), self._tensor(lengths))
        self._issued += len(dec) + n
        self._prefill_tok += n
        nxt = self._sample(last)
        finished = self._advance_decode(dec, nxt)
        req.prefill_pos += n
        req.chunks_done += 1
        if req.prefill_pos >= req.prompt_len:
            # last chunk: its top-row logits give the first token
            req.state = RUNNING
            req.out.append(int(nxt[pf]))
            req.t_first = self.sched.clock()
            self._cur[pf, 0] = int(nxt[pf])
            self._pos[pf] = req.prompt_len
            self._emit_step[pf] = self.steps
            if len(req.out) >= req.max_new:   # max_new=1: done at prefill
                self._finish(pf)
                finished += 1
        if finished:
            self._push_tables()

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
        """Greedy: the argmax of every row, on the host."""
        return torch.argmax(logits, dim=-1).cpu().numpy()

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
            "prefill_tokens": self._prefill_tok,
            "unservable": self.unservable,
            "failed_total": len(self.sched.failed),
            "slo": self.slo(),
        }

    def slo(self) -> dict:
        """Per-priority-class TTFT/e2e distribution (p50/p99)."""
        return slo_summary(self.sched.done, ttft_target_s=self.slo_ttft_s,
                           e2e_target_s=self.slo_e2e_s)

    def report(self) -> str:
        s = self.stats()
        m = summarize(self.sched.done + self.sched.rejected
                      + self.sched.failed)
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
                f"{slo}"
                f"| budget util={s['budget_util'] * 100:.1f}% "
                f"(chunk={s['chunk']}, budget={s['step_budget']})")
