"""Host-side prefix cache over the physical page pools (DESIGN.md §12).

Production traffic is dominated by shared prompt prefixes — system
prompts, few-shot templates, chat history re-sent every turn.  The page-
table indirection already in place makes reusing their KV nearly free:
this module keys **page-aligned token chunks** by a rolling hash chain
and maps a new request's longest cached prefix straight into its table
row, so those chunks are never prefilled again (the serving-side analog
of the paper's weight/input/output reuse — redundant prefill compute is
eliminated the way the PE array eliminates redundant DRAM fetches).

The cache is pure host bookkeeping: it stores *physical page ids* (valid
across every layer's pool of the group, since all layers share one
:class:`~repro_torch.serving.paged_kv.PageAllocator` table) plus hash-chain
metadata, and holds one allocator reference per cached page so a cached
page survives its writer's lifetime.  Sharing and reclamation are
entirely the allocator's refcounts:

* **match** walks the chain ``h_i = H(h_{i-1} || tokens[i*ps:(i+1)*ps])``
  and returns the longest cached page run; the engine increfs those pages
  into the new slot's row (``PageAllocator.alloc(shared=...)``).
* a **full hit** must still produce first-token logits, so the last
  prompt token is recomputed — an in-chunk append into the final shared
  page, which therefore **CoW-forks** first (``PrefixHit.fork_logical``;
  ``PageAllocator.cow_fork`` + ``paged_kv.copy_page``).
* **insert** registers a finished prefill's full pages under the chain
  (increffing them); chunks already cached are only LRU-touched.
* **eviction** is refcount-aware LRU over chain *leaves*: only entries
  whose page nothing else references (refcount == 1 — the cache's own
  hold) and with no cached children are evictable, so a chain never
  breaks mid-prefix and a page mapped by a live request is never
  reclaimed.

Recurrent/windowed architectures opt out one level up:
``StateTree.cacheable_group()`` is None when any layer state is a
``SlotRowState`` (RWKV/Mamba rows, frozen cross-KV — whole-row states
with no per-chunk page identity) or a windowed pool (ring wrap would
overwrite shared pages), and the engine then never matches or inserts —
rwkv6/zamba2/vlm report a structural hit rate of 0.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.serving.paged_kv import PageAllocator


@dataclasses.dataclass
class PrefixHit:
    """One admission's cache verdict: ``pages`` (physical ids, logical
    order) cover ``tokens`` prompt tokens; prefill resumes at ``resume``
    (< prompt length — at least one token is always recomputed for the
    first-token logits).  ``fork_logical`` is set when the resume point
    lands *inside* the last shared page (a full, page-aligned hit): that
    page must CoW-fork before the recompute chunk's append lands."""

    pages: list[int]
    tokens: int
    resume: int
    fork_logical: int | None = None

    @property
    def is_hit(self) -> bool:
        return bool(self.pages)


@dataclasses.dataclass
class _Entry:
    key: bytes              # chain hash of chunks [0..i]
    parent: bytes | None    # chain hash of chunks [0..i-1] (None for i=0)
    page: int               # physical page id holding this chunk's KV
    children: int = 0       # cached continuations (eviction must be leaf-first)
    tick: int = 0           # LRU clock


class PrefixCache:
    """Prefix cache for one page-pool group (see module docstring)."""

    def __init__(self, allocator: PageAllocator, *, page_size: int):
        self.alloc = allocator
        self.page_size = page_size
        self._entries: dict[bytes, _Entry] = {}
        self._tick = 0
        # request-level and token-level telemetry
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.inserted_pages = 0
        self.evictions = 0

    # ------------------------------------------------------------- hashing
    @staticmethod
    def _link(parent: bytes | None, chunk: np.ndarray) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(parent or b"\x00" * 16)
        h.update(np.ascontiguousarray(chunk, dtype=np.int32).tobytes())
        return h.digest()

    def chain(self, prompt: np.ndarray) -> list[bytes]:
        """The rolling hash chain over the prompt's full page chunks."""
        ps = self.page_size
        keys, parent = [], None
        for i in range(len(prompt) // ps):
            parent = self._link(parent, prompt[i * ps:(i + 1) * ps])
            keys.append(parent)
        return keys

    # ----------------------------------------------------------------- API
    @property
    def cached_pages(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        """Token-level hit rate over every admission lookup."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0

    def match(self, prompt) -> PrefixHit:
        """Longest cached page-aligned prefix of ``prompt``; touches the
        matched entries' LRU ticks.  Takes no references and records no
        telemetry — the caller maps the pages (incref) and calls
        :meth:`record` on a successful admission, or drops the hit (a
        blocked queue head re-matches every engine step; only the
        admission that lands counts)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pages: list[int] = []
        self._tick += 1
        for key in self.chain(prompt):
            ent = self._entries.get(key)
            if ent is None:
                break
            ent.tick = self._tick
            pages.append(ent.page)
        tokens = len(pages) * self.page_size
        if not pages:
            return PrefixHit(pages=[], tokens=0, resume=0)
        if tokens < len(prompt):
            # partial hit: the suffix (>= 1 token) resumes at the page
            # boundary and only ever writes fresh pages — no fork
            return PrefixHit(pages=pages, tokens=tokens, resume=tokens)
        # full page-aligned hit: recompute just the last token for its
        # logits; its append lands inside the last shared page -> CoW
        return PrefixHit(pages=pages, tokens=tokens, resume=tokens - 1,
                         fork_logical=len(pages) - 1)

    def record(self, prompt_len: int, hit: PrefixHit | None) -> None:
        """Count one admitted request's lookup in the hit-rate telemetry
        (token-level: ``hit_rate = hit_tokens / lookup_tokens``)."""
        self.lookups += 1
        self.lookup_tokens += int(prompt_len)
        if hit is not None and hit.is_hit:
            self.hits += 1
            self.hit_tokens += hit.tokens

    def insert(self, prompt, slot_pages: list[int]) -> int:
        """Register a finished prefill's full page chunks; ``slot_pages``
        is the slot's table row in logical order.  Already-cached chunks
        are LRU-touched (their physical page may be this request's private
        re-prefill or CoW fork — the cache keeps the original); new chunks
        take one cache reference on their page.  Returns #pages inserted."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._tick += 1
        added = 0
        parent: _Entry | None = None
        for i, key in enumerate(self.chain(prompt)):
            ent = self._entries.get(key)
            if ent is None:
                ent = _Entry(key=key, parent=parent.key if parent else None,
                             page=slot_pages[i], tick=self._tick)
                self.alloc.incref(ent.page)
                self._entries[key] = ent
                if parent is not None:
                    parent.children += 1
                added += 1
            else:
                ent.tick = self._tick
            parent = ent
        self.inserted_pages += added
        return added

    def evict(self, need_free: int, protect=frozenset()) -> int:
        """Refcount-aware LRU eviction: release cache references until the
        allocator has ``need_free`` free pages, or nothing more is
        evictable.  Only chain *leaves* whose page carries no reference
        beyond the cache's own (refcount == 1) are candidates; ``protect``
        pins pages about to be mapped by the admission in flight.  Returns
        the number of entries evicted."""
        evicted = 0
        while self.alloc.free_pages < need_free:
            victim = None
            for ent in self._entries.values():
                if (ent.children == 0 and ent.page not in protect
                        and self.alloc.refcount[ent.page] == 1
                        and (victim is None or ent.tick < victim.tick)):
                    victim = ent
            if victim is None:
                break
            del self._entries[victim.key]
            if victim.parent is not None:
                parent = self._entries.get(victim.parent)
                if parent is not None:
                    parent.children -= 1
            self.alloc.decref(victim.page)
            self.evictions += 1
            evicted += 1
        return evicted

    def page_refs(self) -> np.ndarray:
        """Per-physical-page count of references *the cache itself* holds
        (0 or 1 per page — the cache takes at most one hold per page).
        The watchdog's refcount oracle subtracts these from the
        allocator's refcounts to reconcile against slot-table ownership."""
        refs = np.zeros(self.alloc.n_pages, dtype=np.int32)
        for ent in self._entries.values():
            refs[ent.page] += 1
        return refs

    def check(self) -> None:
        """Cache-side structural invariants (the property suite's oracle):
        every cached page is live in the allocator, chains are closed under
        parents (no orphaned continuations), and children counts agree."""
        kids: dict[bytes, int] = {}
        for ent in self._entries.values():
            assert self.alloc.refcount[ent.page] >= 1, "cached page freed"
            if ent.parent is not None:
                assert ent.parent in self._entries, "broken chain"
                kids[ent.parent] = kids.get(ent.parent, 0) + 1
        for ent in self._entries.values():
            assert ent.children == kids.get(ent.key, 0), "children drift"

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "hit_rate": round(self.hit_rate, 4),
            "cached_pages": self.cached_pages,
            "evictions": self.evictions,
        }
