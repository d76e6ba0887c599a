"""Block/paged KV-cache plumbing for the serving engine.

A port of ``repro.serving.paged_kv`` for float and int8 pools.  The device-side
cache type (:class:`~repro_torch.models.layers.PagedKVCache`) lives in
``models/layers.py``; this module owns what surrounds it:

* :class:`PageAllocator` -- host-side (numpy) page bookkeeping: fixed-size
  refcounted pages, per-slot page tables, admission control, ``check()``;
* :func:`make_pool` -- a fresh pool with its trash page and an
  all-sentinel table; :func:`pool_layout` its geometry and
  :func:`modeled_decode_bytes` the decode paths' modeled traffic over it;
* :func:`scatter_prefill`, :func:`reset_pages`, :func:`copy_page`,
  :func:`truncate_pages` -- the device writes, **in place**;
* :func:`swap_out_pages` / :func:`swap_in_pages` -- the preempt-to-host
  round trip of a slot's pages (values, positions, int8 scales), with
  :func:`snapshot_digest` to reject a damaged snapshot before any write;
* :func:`gather_pages` -- a per-slot contiguous view of a pool (tests).

Out-of-range page ids (the sentinel ``n_pages``, ``COPY_NONE``) are the
writes JAX drops: here they land in the trash page at index ``n_pages``,
which nothing reads.  Gathers through a table clamp to ``n_pages - 1``.

Ring semantics: token position ``p`` of a slot lives at logical index
``p % logical_len`` where ``logical_len = max_pages * page_size``.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models.layers import KVCache, PagedKVCache, POS_EMPTY


def ceil_pages(length: int, page_size: int) -> int:
    return -(-int(length) // int(page_size))


def make_pool(cfg, *, n_pages: int, page_size: int, max_pages: int,
              n_slots: int, dtype, device) -> PagedKVCache:
    """A fresh page pool (``n_pages`` + the trash page) and an all-sentinel
    table for one attention layer.  ``cfg.kv_cache_dtype == "int8"`` builds
    an int8 pool (``dtype`` is then ignored) with f32 per-(page, head,
    offset) scales, the trash page included."""
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    scales = {}
    if getattr(cfg, "kv_cache_dtype", "") == "int8":
        dtype = torch.int8
        scales = {name: torch.zeros((n_pages + 1, kvh, page_size),
                                    dtype=torch.float32, device=device)
                  for name in ("k_scale", "v_scale")}
    return PagedKVCache(
        k=torch.zeros((n_pages + 1, kvh, page_size, hd), dtype=dtype,
                      device=device),
        v=torch.zeros((n_pages + 1, kvh, page_size, hd), dtype=dtype,
                      device=device),
        pos=torch.full((n_pages + 1, page_size), POS_EMPTY, dtype=torch.int32,
                       device=device),
        page_table=torch.full((n_slots, max_pages), n_pages,
                              dtype=torch.int32, device=device),
        **scales,
    )


class PoolLayout(NamedTuple):
    """The pool-geometry constants the paged kernel's planner, the tuner's
    warmers and the traffic models need, derived once."""
    n_pages: int
    kv_heads: int
    page_size: int
    head_dim: int
    n_slots: int
    max_pages: int
    logical_len: int
    itemsize: int


def pool_layout(pool: PagedKVCache) -> PoolLayout:
    """``pool``'s geometry, as JAX's: ``n_pages`` counts the pages a table
    can name (the trash page is not one of them) and ``itemsize`` is the
    pool element's size (1 for an int8 pool)."""
    _, kvh, ps, hd = pool.k.shape
    n_slots, mp = pool.page_table.shape
    return PoolLayout(n_pages=pool.n_pages, kv_heads=kvh, page_size=ps,
                      head_dim=hd, n_slots=n_slots, max_pages=mp,
                      logical_len=mp * ps, itemsize=pool.k.element_size())


def modeled_decode_bytes(lay: PoolLayout) -> tuple[int, int]:
    """Modeled attention bytes a decode token moves over one pool, for
    both decode paths: ``(gather_bytes, fused_bytes)`` (the reference's
    model, unchanged).

    Gather + flash materializes every slot's pages as a dense
    [B, KV, L, D] copy each token -- read the pool, write the copy, read
    it in attention: 3x the slot-resident K/V and position bytes.  The
    fused kernel reads each page once, plus the table and position rows.
    """
    slot_kv = 2 * (lay.n_slots * lay.kv_heads * lay.logical_len
                   * lay.head_dim * lay.itemsize)
    pos_bytes = lay.n_slots * lay.logical_len * 4
    tbl_bytes = lay.n_slots * lay.max_pages * 4
    return (3 * (slot_kv + pos_bytes) + tbl_bytes,
            slot_kv + pos_bytes + tbl_bytes)


class PageAllocator:
    """Host-side page bookkeeping for one pool geometry.

    ``n_pages`` physical pages; every admitted slot claims exactly
    ``pages_per_slot`` pages for its whole lifetime.  Unallocated table rows
    hold the sentinel ``n_pages``.  Pages are refcounted so that a cached
    prefix could share physical pages across requests: ``alloc(shared=)``
    maps them into the leading logical indices with an extra reference
    instead of a fresh claim; a page returns to the free list exactly when
    its refcount reaches 0.  :meth:`cow_fork` swaps one shared table entry
    for a fresh private page.
    """

    def __init__(self, *, n_pages: int, pages_per_slot: int, n_slots: int):
        if pages_per_slot <= 0:
            raise ValueError("pages_per_slot must be positive")
        self.n_pages = n_pages
        self.pages_per_slot = pages_per_slot
        self.n_slots = n_slots
        self._free: list[int] = list(range(n_pages))
        self._owned: dict[int, list[int]] = {}
        self._shared: dict[int, set[int]] = {}   # slot -> shared page ids
        self.refcount = np.zeros((n_pages,), np.int32)
        self.table = np.full((n_slots, pages_per_slot), n_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def referenced_pages(self) -> int:
        return int((self.refcount > 0).sum())

    def can_alloc(self, *, shared: int = 0) -> bool:
        """Whether a slot claim fits, given ``shared`` of its pages come
        from a cached prefix (free of charge)."""
        return len(self._free) >= max(0, self.pages_per_slot - shared)

    def can_ever_alloc(self, *, shared: int = 0) -> bool:
        """Whether a slot claim could fit even with the whole pool free:
        False means the claim is unservable, whatever drains."""
        return self.pages_per_slot - shared <= self.n_pages

    def owned_slots(self) -> set[int]:
        return set(self._owned)

    def owned_page_counts(self) -> np.ndarray:
        """Per-page count of slot-row mappings."""
        counts = np.zeros((self.n_pages,), np.int32)
        for pages in self._owned.values():
            for p in pages:
                counts[p] += 1
        return counts

    def alloc(self, slot: int, shared=()) -> list[int]:
        """Claim pages for ``slot``; raises if the slot is live or the pool
        is exhausted.  ``shared`` pages (logical order) occupy the leading
        table entries and are increffed rather than claimed."""
        shared = list(shared)
        if slot in self._owned:
            raise ValueError(f"slot {slot} already holds pages")
        if not self.can_alloc(shared=len(shared)):
            raise RuntimeError("page pool exhausted")
        for p in shared:
            if self.refcount[p] <= 0:
                raise ValueError(f"shared page {p} is not live")
            self.refcount[p] += 1
        fresh = [self._free.pop()
                 for _ in range(self.pages_per_slot - len(shared))]
        for p in fresh:
            self.refcount[p] = 1
        pages = shared + fresh
        self._owned[slot] = pages
        self._shared[slot] = set(shared)
        self.table[slot] = pages
        return pages

    def free(self, slot: int) -> list[int]:
        """Drop ``slot``'s references (no-op for a slot that holds none);
        returns the pages that went back to the free list."""
        pages = self._owned.pop(slot, [])
        self._shared.pop(slot, None)
        freed = [p for p in pages if self.decref(p) == 0]
        self.table[slot] = self.n_pages
        return freed

    def incref(self, page: int) -> int:
        if page < 0 or page >= self.n_pages:
            raise ValueError(f"page {page} out of range")
        self.refcount[page] += 1
        return int(self.refcount[page])

    def decref(self, page: int) -> int:
        """Drop one reference; a page reaching 0 returns to the free list."""
        if self.refcount[page] <= 0:
            raise ValueError(f"decref of free page {page}")
        self.refcount[page] -= 1
        rc = int(self.refcount[page])
        if rc == 0:
            self._free.append(page)
        return rc

    def cow_fork(self, slot: int, logical_idx: int) -> tuple[int, int]:
        """Replace the shared page at ``logical_idx`` of ``slot``'s row with
        a fresh private page; returns ``(src, dst)`` for :func:`copy_page`."""
        row = self._owned[slot]
        src = row[logical_idx]
        if src not in self._shared.get(slot, ()):
            raise ValueError(f"page {src} at logical {logical_idx} of slot "
                             f"{slot} is not shared — nothing to fork")
        if not self._free:
            raise RuntimeError("page pool exhausted at CoW fork")
        dst = self._free.pop()
        self.refcount[dst] = 1
        self.decref(src)        # the slot's share moves to the fork
        row[logical_idx] = dst
        self._shared[slot].discard(src)
        self.table[slot, logical_idx] = dst
        return src, dst

    def slot_pages(self, slot: int) -> list[int]:
        """The slot's current table row (logical order), [] when not live."""
        return list(self._owned.get(slot, ()))

    def shared_pages(self, slot: int) -> set[int]:
        return set(self._shared.get(slot, ()))

    def device_table(self, private_only_slot: int | None = None) -> np.ndarray:
        """The table to push to the device; with ``private_only_slot`` that
        slot's shared entries are masked to the sentinel (the staged view
        the admission reset runs against)."""
        if private_only_slot is None:
            return self.table
        t = self.table.copy()
        shared = self._shared.get(private_only_slot, ())
        if shared:
            row = t[private_only_slot]
            t[private_only_slot] = np.where(
                np.isin(row, list(shared)), self.n_pages, row)
        return t

    def table_array(self, device=None) -> torch.Tensor:
        """The host table as an int32 tensor on ``device`` (default
        ``cuda``)."""
        return torch.as_tensor(self.table, dtype=torch.int32,
                               device=_device.resolve(device))

    def check(self) -> None:
        """Assert the accounting invariants: refcounts never negative, the
        free list holds exactly the unreferenced pages, every live slot
        row is fully referenced and matches the table."""
        assert (self.refcount >= 0).all(), "negative refcount"
        free = set(self._free)
        assert len(free) == len(self._free), "free-list duplicate"
        ref = {p for p in range(self.n_pages) if self.refcount[p] > 0}
        assert free.isdisjoint(ref), "referenced page on the free list"
        assert len(free) + len(ref) == self.n_pages, "page leak"
        for slot, pages in self._owned.items():
            assert len(pages) == self.pages_per_slot
            assert all(self.refcount[p] > 0 for p in pages)
            assert (self.table[slot] == pages).all()


# ---------------------------------------------------------------------------
# Device writes (fixed shapes; out-of-range ids go to the trash page)
# ---------------------------------------------------------------------------

def _trash_out_of_range(ids: torch.Tensor, n_pages: int) -> torch.Tensor:
    ids = ids.long()
    return torch.where((ids >= 0) & (ids < n_pages), ids,
                       torch.full_like(ids, n_pages))


def scatter_prefill(pool: PagedKVCache, dense: KVCache, slot_ids: torch.Tensor,
                    lengths: torch.Tensor,
                    starts: torch.Tensor | None = None) -> PagedKVCache:
    """Write a (chunk of a) dense prefill block into the slot pages, in
    place.

    ``dense`` is in position-identity layout: row ``j`` holds position
    ``starts[b] + j`` (``starts=None``: position ``j``).  For row ``b`` only
    offsets ``j < lengths[b]`` whose position the ring would still hold
    after the chunk (``j >= lengths[b] - logical_len``) are written; rows
    with ``slot_ids[b] < 0`` write nothing.  A write lands at logical index
    ``(starts[b] + j) % logical_len`` with the global position recorded.
    """
    n_pages = pool.n_pages
    n_slots, mp = pool.page_table.shape
    ps = pool.page_size
    logical = mp * ps
    bp, kvh, s, hd = dense.k.shape
    dev = pool.k.device

    j = torch.arange(s, dtype=torch.int32, device=dev)             # offsets
    lengths = lengths.to(torch.int32)[:, None]                     # [Bp, 1]
    if starts is None:
        starts = torch.zeros((bp,), dtype=torch.int32, device=dev)
    gpos = starts.to(torch.int32)[:, None] + j[None, :]            # [Bp, S]
    valid = (j[None, :] < lengths) & (j[None, :] >= lengths - logical)
    valid = valid & (slot_ids[:, None] >= 0)

    li = gpos % logical
    rows = pool.page_table[slot_ids.long().clamp(0, n_slots - 1)]  # [Bp, MP]
    pp = torch.gather(rows, 1, (li // ps).long()).long()           # [Bp, S]
    pp = torch.where(valid, _trash_out_of_range(pp, n_pages),
                     torch.full_like(pp, n_pages))
    off = (li % ps).long()

    ppf, offf = pp.reshape(-1), off.reshape(-1)
    pool.k[ppf, :, offf] = dense.k.transpose(1, 2).reshape(
        bp * s, kvh, hd).to(pool.k.dtype)
    pool.v[ppf, :, offf] = dense.v.transpose(1, 2).reshape(
        bp * s, kvh, hd).to(pool.v.dtype)
    pool.pos[ppf, offf] = gpos.reshape(-1)
    if pool.quantized:
        # the int8 block carries [Bp, KV, S] scales: scatter them alongside
        pool.k_scale[ppf, :, offf] = dense.k_scale.transpose(1, 2).reshape(
            bp * s, kvh)
        pool.v_scale[ppf, :, offf] = dense.v_scale.transpose(1, 2).reshape(
            bp * s, kvh)
    return pool


def reset_pages(pool: PagedKVCache, page_ids: torch.Tensor) -> PagedKVCache:
    """Mark ``page_ids``'s entries empty, in place (freed-slot hygiene: a
    refilled slot must never attend to its predecessor's tokens).
    Sentinel ids go to the trash page.  K/V and scales stay: an empty
    position is never read."""
    pool.pos[_trash_out_of_range(page_ids, pool.n_pages)] = POS_EMPTY
    return pool


#: out-of-range page id for :func:`copy_page` -- larger than any pool, so a
#: sentinel (src, dst) pair changes nothing that is read
COPY_NONE = np.int32(2 ** 30)


def copy_page(pool: PagedKVCache, src: torch.Tensor, dst: torch.Tensor,
              resume: torch.Tensor) -> PagedKVCache:
    """Copy-on-write content copy, in place: duplicate physical page
    ``src`` into ``dst`` (k/v, scales and positions), masking positions ``>=
    resume`` to empty.  ``src``/``dst``/``resume`` are shape-[1] int32;
    ``COPY_NONE`` ids make the copy land in the trash page."""
    n_pages = pool.n_pages
    src = src.long()
    s = src.clamp(0, n_pages - 1)
    d = torch.where(src < n_pages, _trash_out_of_range(dst, n_pages),
                    torch.full_like(src, n_pages))
    prow = pool.pos[s]                                           # [1, ps]
    prow = torch.where(prow < resume.to(torch.int32)[:, None], prow,
                       torch.full_like(prow, POS_EMPTY))
    pool.k[d] = pool.k[s]
    pool.v[d] = pool.v[s]
    if pool.quantized:
        pool.k_scale[d] = pool.k_scale[s]
        pool.v_scale[d] = pool.v_scale[s]
    pool.pos[d] = prow
    return pool


def truncate_pages(pool: PagedKVCache, pages, n: int) -> PagedKVCache:
    """Rewind ``pages`` (a slot's pages, any order) to logical length ``n``,
    in place: every entry holding a position ``>= n`` is re-masked to
    ``POS_EMPTY`` -- speculative decoding's rollback of rejected drafts.
    The position mask already hides such an entry until it is rewritten,
    so this is hygiene: it keeps swap digests and :func:`gather_pages`
    views functions of the committed stream.  Idempotent."""
    if len(pages) == 0:
        return pool
    idx = _trash_out_of_range(
        torch.as_tensor(np.asarray(pages, np.int64), device=pool.pos.device),
        pool.n_pages)
    rows = pool.pos[idx]
    pool.pos[idx] = torch.where(rows >= n, torch.full_like(rows, POS_EMPTY),
                                rows)
    return pool


def _pool_fields(pool: PagedKVCache) -> tuple[str, ...]:
    return ("k", "v", "pos") + (("k_scale", "v_scale") if pool.quantized
                                else ())


def swap_out_pages(pool: PagedKVCache, pages) -> dict:
    """Host snapshot of physical ``pages`` (a slot's table row in logical
    order): k/v values, positions and, for int8 pools, the scales -- the
    preempt-to-host payload.  Each field is one blocking device-to-host
    copy, so the snapshot is complete before the caller releases the
    pages to the next admission.  bf16 and int8 leaves stay torch tensors:
    their bits are kept as they are."""
    idx = _trash_out_of_range(
        torch.as_tensor(np.asarray(pages, np.int64), device=pool.pos.device),
        pool.n_pages)
    return {name: getattr(pool, name)[idx].to("cpu", copy=True)
            for name in _pool_fields(pool)}


def swap_in_pages(pool: PagedKVCache, pages, blob: dict) -> PagedKVCache:
    """Restore a :func:`swap_out_pages` snapshot into ``pages`` (the
    resumed slot's freshly claimed row, logical order), in place.
    Physical ids may differ from the swap-out row: position ``p`` maps to
    logical index ``p % logical_len`` either way."""
    idx = _trash_out_of_range(
        torch.as_tensor(np.asarray(pages, np.int64), device=pool.pos.device),
        pool.n_pages)
    for name in _pool_fields(pool):
        dst = getattr(pool, name)
        dst[idx] = blob[name].to(dst.device)
    return pool


class SwapIntegrityError(RuntimeError):
    """A preempt-to-host snapshot failed validation at swap-in: its
    content digest does not match what swap-out recorded (bit corruption,
    truncation, or a structurally different snapshot).  Raised before any
    device write, so the pools and the allocators are as they were."""


def snapshot_leaves(tree):
    """The leaves of a host snapshot tree in order: dicts by insertion,
    lists and tuples (the recurrent NamedTuples) by position."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from snapshot_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from snapshot_leaves(v)
    else:
        yield tree


def snapshot_digest(blobs) -> bytes:
    """Content digest of a swap snapshot tree: blake2b over every leaf's
    shape, dtype name and raw bytes, in tree order.  A flipped byte, a
    truncated tensor or a missing or extra leaf changes it.  Leaves are
    torch tensors (bf16 hashed as its bits) or numpy arrays."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in snapshot_leaves(blobs):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu").contiguous()
            shape, dtype = tuple(t.shape), str(t.dtype)
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        else:
            a = np.ascontiguousarray(np.asarray(leaf))
            shape, dtype, raw = a.shape, str(a.dtype), a.tobytes()
        h.update(repr((shape, dtype)).encode())
        h.update(raw)
    return h.digest()


def gather_pages(pool: PagedKVCache):
    """Contiguous per-slot view: (k [N, KV, L, D], v likewise, pos [N, L]).
    A slot with no live page reads the trash page under an all-empty
    position row."""
    n_slots, mp = pool.page_table.shape
    _, kvh, ps, hd = pool.k.shape
    table = _trash_out_of_range(pool.page_table, pool.n_pages)
    k = pool.k[table].transpose(1, 2).reshape(n_slots, kvh, mp * ps, hd)
    v = pool.v[table].transpose(1, 2).reshape(n_slots, kvh, mp * ps, hd)
    pos = pool.pos[table].reshape(n_slots, mp * ps)
    live = (pool.page_table < pool.n_pages).any(dim=1)
    pos = torch.where(live[:, None], pos, torch.full_like(pos, POS_EMPTY))
    return k, v, pos
