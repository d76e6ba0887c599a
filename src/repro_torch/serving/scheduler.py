"""Priority scheduler with admission control, aging, preemption support
and per-request serving metrics (SLO tracking included).

Request lifecycle::

    submit() -> QUEUED -> (admit: page claim at first chunk)
                PREFILLING(k/K chunks) -> RUNNING -> DONE
             -> REJECTED   (queue full / empty prompt / max_new < 1 /
                            prompt exceeds capacity)
    RUNNING/PREFILLING -> PREEMPTED -> (re-admit: swap-in) -> ... -> DONE
    any non-terminal state -> TIMEOUT   (deadline_s exceeded)
                           -> CANCELLED (engine.cancel(rid))
                           -> FAILED    (watchdog retries exhausted /
                                         corrupted swap / unservable head)

Admission is **priority-ordered with aging**: every request carries a
priority class (0 = most urgent; any small non-negative int), and the
queue head is the request minimizing the *effective* priority

    priority - (now - t_submit) / aging_s

so a request that has waited ``aging_s`` seconds is as urgent as the
class above it — low-priority traffic ages toward the front and can
never starve, while fresh high-priority arrivals still jump the line.
Within a class, FIFO.  With one class this is exactly the old FIFO
scheduler (``FIFOScheduler`` remains the exported name).

Preemption is the engine's move (swap-to-host, DESIGN.md §13); the
scheduler owns the *policy*: :meth:`pick_victim` chooses the least
urgent active request of a strictly lower class than the blocked head
(static classes, not aged ones — aging must promote queued work, never
destabilize running work), and :meth:`requeue` returns the victim to the
queue as ``PREEMPTED`` (bypassing the capacity bound: the request was
already admitted once and holds swapped host state).

Metrics are wall-clock host timestamps: queue wait, TTFT (submit ->
first token), end-to-end latency, and decode throughput, aggregated by
:func:`summarize`; :func:`slo_summary` buckets TTFT/e2e per priority
class (p50/p99 + attainment against configurable targets).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable

QUEUED = "queued"
PREFILLING = "prefilling"
RUNNING = "running"
PREEMPTED = "preempted"
DONE = "done"
REJECTED = "rejected"
# terminal failure states (DESIGN.md §14): a request that ran out of
# wall-clock budget, was cancelled by its caller, or exhausted the
# watchdog's retry budget — all three reclaim every resource the request
# held (pages, prefix-cache refs, slot) and park it on `failed`
TIMEOUT = "timeout"
CANCELLED = "cancelled"
FAILED = "failed"

#: the abnormal-terminal set `FIFOScheduler.terminate` may stamp
TERMINAL_FAILURES = (TIMEOUT, CANCELLED, FAILED)


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: object                    # np.ndarray [S] int32
    max_new: int
    priority: int = 0                 # class, 0 = most urgent
    state: str = QUEUED
    slot: int = -1
    out: list = dataclasses.field(default_factory=list)
    # chunked-prefill progress (engine-maintained while PREFILLING)
    prefill_pos: int = 0              # prompt tokens already chunked in
    chunks_done: int = 0
    n_chunks: int = 0                 # total planned (the K of "k/K")
    cached_tokens: int = 0            # prompt tokens served by the prefix
    #                                   cache (admitted at k > 0: prefill
    #                                   resumes past the cached prefix)
    # preempt-to-host round trip (engine-maintained; DESIGN.md §13)
    swap: object = None               # host snapshot while PREEMPTED
    preemptions: int = 0              # times swapped out to host
    # speculative decoding accounting (engine-maintained; DESIGN.md §15)
    drafted: int = 0                  # draft tokens verified for this request
    accepted: int = 0                 # drafts the argmax chain accepted
    # fault tolerance (engine-maintained; DESIGN.md §14)
    deadline_s: float | None = None   # wall-clock budget from t_submit
    retries: int = 0                  # watchdog requeues after step faults
    recovering: bool = False          # requeued by the watchdog, not admitted yet
    hold_until_tick: int = 0          # retry backoff: ineligible before this
    #                                   engine tick (head() skips it)
    error: str | None = None          # human-readable failure reason
    # metrics (host wall-clock seconds)
    t_submit: float = 0.0
    t_admit: float = 0.0              # first admission (queue wait anchor)
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def ttft(self) -> float:
        return max(0.0, self.t_first - self.t_submit)

    @property
    def e2e(self) -> float:
        return max(0.0, self.t_done - self.t_submit)

    @property
    def queue_wait(self) -> float:
        return max(0.0, self.t_admit - self.t_submit)

    @property
    def decode_tok_s(self) -> float:
        dt = self.t_done - self.t_first
        n = max(0, len(self.out) - 1)   # first token comes from prefill
        return n / dt if dt > 0 else 0.0

    @property
    def accept_rate(self) -> float:
        """Fraction of this request's verified drafts the argmax chain
        accepted (0.0 when it never speculated)."""
        return self.accepted / self.drafted if self.drafted else 0.0


class FIFOScheduler:
    """Bounded priority queue: ``submit`` applies admission control,
    ``head``/``pop`` hand the most urgent request to free slots,
    ``pick_victim``/``requeue`` are the preemption policy.  One priority
    class degenerates to strict FIFO (the class keeps its historical
    name)."""

    def __init__(self, *, max_queue: int = 64, max_total_len: int | None = None,
                 clock=time.monotonic, aging_s: float = 30.0):
        self.max_queue = max_queue
        self.max_total_len = max_total_len
        self.clock = clock
        self.aging_s = float(aging_s)
        self.queue: deque[ServeRequest] = deque()
        self.rejected: list[ServeRequest] = []
        self.running: dict[int, ServeRequest] = {}   # slot -> request
        self.done: list[ServeRequest] = []
        self.failed: list[ServeRequest] = []   # TIMEOUT/CANCELLED/FAILED

    def submit(self, req: ServeRequest) -> bool:
        """Queue ``req``; False (state=REJECTED) when the queue is at
        capacity, the request could never fit the KV budget, the prompt is
        empty, ``max_new < 1``, or ``req.rid`` collides with a live request.

        Empty prompts are *rejected*, not served: a length-0 prompt has no
        last-token logits — it would reach the mixed step as a length-0
        identity row and emit a garbage first token.  ``max_new < 1`` is
        likewise rejected (not clamped): the first token falls out of the
        last prefill chunk unconditionally, so a cap below 1 cannot be
        honored — the caller asked for nothing and gets a clean reject
        instead of one surprise token.  A duplicate rid is rejected, not
        served: two live requests under one rid would silently overwrite
        each other in every rid-keyed surface (``run_until_idle``'s output
        dict, ``cancel``, metrics) — the caller gets a clean reject with
        the reason on ``req.error``."""
        req.t_submit = self.clock()
        too_long = (self.max_total_len is not None
                    and req.prompt_len + req.max_new > self.max_total_len)
        dup = (any(r.rid == req.rid for r in self.queue)
               or any(r.rid == req.rid for r in self.running.values()))
        bad = (too_long or req.prompt_len == 0 or req.max_new < 1
               or len(self.queue) >= self.max_queue or dup)
        if bad:
            if dup:
                req.error = (f"duplicate rid {req.rid}: collides with a "
                             "live request")
            req.state = REJECTED
            self.rejected.append(req)
            return False
        self.queue.append(req)
        return True

    # ---------------------------------------------------------- selection
    def effective_priority(self, req: ServeRequest, now: float) -> float:
        """Aged priority: waiting ``aging_s`` seconds promotes a request by
        one full class, so no class can starve behind sustained
        higher-priority traffic."""
        if self.aging_s <= 0:
            return float(req.priority)
        return req.priority - (now - req.t_submit) / self.aging_s

    def head(self, tick: int | None = None) -> ServeRequest | None:
        """The most urgent queued request (lowest effective priority;
        FIFO within a class) — the one admission candidate.  O(queue),
        which is fine at serving queue depths.  ``tick`` (the engine's
        step-attempt counter) filters out requests still inside their
        watchdog retry backoff (``hold_until_tick``), so a faulting
        request backs off without blocking the queue behind it."""
        cands = [r for r in self.queue
                 if tick is None or r.hold_until_tick <= tick]
        if not cands:
            return None
        now = self.clock()
        return min(cands,
                   key=lambda r: (self.effective_priority(r, now),
                                  r.t_submit, r.rid))

    def pop(self, req: ServeRequest, slot: int,
            state: str = PREFILLING) -> ServeRequest:
        """Dequeue ``req`` (typically :meth:`head`) into ``slot``.
        ``t_admit`` is stamped only on the *first* admission so
        ``queue_wait`` measures submit -> first slot, preemption round
        trips notwithstanding."""
        self.queue.remove(req)
        req.state = state
        req.slot = slot
        if req.t_admit == 0.0:
            req.t_admit = self.clock()
        self.running[slot] = req
        return req

    def admit(self, free_slots: Iterable[int], can_alloc,
              state: str = PREFILLING) -> list[ServeRequest]:
        """Priority-admit queued requests into ``free_slots`` while
        ``can_alloc()`` grants pages.  ``can_alloc`` must count *physical*
        pages: with prefix caching, a shared-prefix request needs only its
        non-cached remainder (``StateTree.can_admit(shared=...)``)."""
        admitted = []
        for slot in free_slots:
            req = self.head()
            if req is None or not can_alloc():
                break
            admitted.append(self.pop(req, slot, state))
        return admitted

    # --------------------------------------------------------- preemption
    def pick_victim(self, candidate: ServeRequest,
                    active: Iterable[ServeRequest]) -> ServeRequest | None:
        """The preemption policy: among active requests of a *strictly*
        lower static class than ``candidate``, the least urgent — lowest
        class first, latest-admitted within it (least progress lost).
        Static classes, not aged ones: aging promotes queued work toward
        admission but must never destabilize running work into a
        preempt/resume ping-pong.  None when nothing qualifies (equal or
        higher classes are never preempted)."""
        victims = [r for r in active
                   if r is not None and r.state in (PREFILLING, RUNNING)
                   and r.priority > candidate.priority]
        if not victims:
            return None
        return max(victims, key=lambda r: (r.priority, r.t_admit, r.rid))

    def requeue(self, req: ServeRequest) -> None:
        """A preempted request back onto the queue (state=PREEMPTED).
        Bypasses ``max_queue``: the request was already admitted once and
        holds swapped host state — bouncing it would lose work."""
        self.running.pop(req.slot, None)
        req.state = PREEMPTED
        req.slot = -1
        self.queue.append(req)

    def complete(self, req: ServeRequest) -> None:
        req.state = DONE
        req.t_done = self.clock()
        self.running.pop(req.slot, None)
        req.slot = -1
        self.done.append(req)

    def terminate(self, req: ServeRequest, status: str,
                  error: str | None = None) -> None:
        """Abnormal completion (DESIGN.md §14): stamp ``status`` (one of
        ``TIMEOUT``/``CANCELLED``/``FAILED``) and remove the request from
        wherever it currently lives — the queue (QUEUED or PREEMPTED) or
        the running map — dropping any host swap snapshot.  The *engine*
        owns releasing device-side resources (pages/rows) before calling
        this; the scheduler only owns the bookkeeping."""
        if status not in TERMINAL_FAILURES:
            raise ValueError(f"not a terminal failure status: {status!r}")
        if req in self.queue:
            self.queue.remove(req)
        self.running.pop(req.slot, None)
        req.state = status
        req.error = error
        req.swap = None               # a dropped snapshot frees its host copy
        req.t_done = self.clock()
        req.slot = -1
        self.failed.append(req)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.running


#: ``FIFOScheduler`` grew into the priority scheduler; both names refer
#: to the same class (priority defaults to one class == strict FIFO).
PriorityScheduler = FIFOScheduler


def _percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile (small-sample friendly: p99 of 10 samples
    is the max, not an extrapolation)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _target_for(target, cls: int):
    """Targets are a scalar (every class) or a {class: seconds} mapping
    (missing classes untracked)."""
    if target is None:
        return None
    if isinstance(target, dict):
        return target.get(cls)
    return target


def slo_summary(requests: list[ServeRequest], *, ttft_target_s=None,
                e2e_target_s=None) -> dict:
    """Per-priority-class latency distribution + SLO attainment.

    Returns ``{class: {n, ttft_p50_s, ttft_p99_s, e2e_p50_s, e2e_p99_s
    [, ttft_target_s, ttft_attained, e2e_target_s, e2e_attained]}}`` over
    completed requests.  Targets are seconds — a scalar for every class
    or a ``{class: seconds}`` mapping; attainment is the fraction of the
    class meeting its target."""
    done = [r for r in requests if r.state == DONE]
    out: dict = {}
    for cls in sorted({r.priority for r in done}):
        rs = [r for r in done if r.priority == cls]
        ttfts = [r.ttft for r in rs]
        e2es = [r.e2e for r in rs]
        ent = {
            "n": len(rs),
            "ttft_p50_s": _percentile(ttfts, 0.50),
            "ttft_p99_s": _percentile(ttfts, 0.99),
            "e2e_p50_s": _percentile(e2es, 0.50),
            "e2e_p99_s": _percentile(e2es, 0.99),
        }
        tt = _target_for(ttft_target_s, cls)
        if tt is not None:
            ent["ttft_target_s"] = float(tt)
            ent["ttft_attained"] = sum(t <= tt for t in ttfts) / len(rs)
        te = _target_for(e2e_target_s, cls)
        if te is not None:
            ent["e2e_target_s"] = float(te)
            ent["e2e_attained"] = sum(t <= te for t in e2es) / len(rs)
        out[cls] = ent
    return out


def _failure_counts(requests: list[ServeRequest]) -> dict:
    return {
        "rejected": sum(r.state == REJECTED for r in requests),
        "timeout": sum(r.state == TIMEOUT for r in requests),
        "cancelled": sum(r.state == CANCELLED for r in requests),
        "failed": sum(r.state == FAILED for r in requests),
    }


def summarize(requests: list[ServeRequest]) -> dict:
    """Aggregate per-request metrics into an engine-level report."""
    done = [r for r in requests if r.state == DONE]
    if not done:
        return {"done": 0, **_failure_counts(requests)}
    t0 = min(r.t_submit for r in done)
    t1 = max(r.t_done for r in done)
    toks = sum(len(r.out) for r in done)
    # zero-decode requests (max_new=1: the one token falls out of prefill)
    # have no decode phase at all — averaging their 0.0 in would silently
    # deflate the reported decode throughput
    dec = [r.decode_tok_s for r in done if len(r.out) > 1]
    drafted = sum(r.drafted for r in done)
    return {
        "done": len(done),
        **_failure_counts(requests),
        "preemptions": sum(r.preemptions for r in done),
        "drafted": drafted,
        "accepted": sum(r.accepted for r in done),
        "accept_rate": (sum(r.accepted for r in done) / drafted
                        if drafted else 0.0),
        "tokens": toks,
        "wall_s": t1 - t0,
        "tok_s": toks / (t1 - t0) if t1 > t0 else 0.0,
        "ttft_mean_s": sum(r.ttft for r in done) / len(done),
        "ttft_max_s": max(r.ttft for r in done),
        "queue_wait_mean_s": sum(r.queue_wait for r in done) / len(done),
        "decode_tok_s_mean": sum(dec) / len(dec) if dec else 0.0,
    }
