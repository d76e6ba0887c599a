"""The per-layer decode-state protocol: paged KV pools and recurrent rows.

A port of ``repro.serving.state`` for attention, RWKV and Mamba layers: a
:class:`PagedKVState` is the host-side handle of one layer's page pool
(allocator hooks and the device transforms), a :class:`SlotRowState` that
of one recurrent layer's fixed-size row per slot, and a :class:`StateTree`
zips the handles with the model's flat cache layout ``{"slots": [[state per
period] per pattern slot], "tail": [...], "shared": [...]}`` and owns
admission over the shared allocators, the table pushes, prefix-cache
eligibility and the engine's eager round trips: preempt-to-host
(``swap_out`` / ``swap_in``, digest-checked before any write) and
speculation's rollback (``spec_snapshot`` / ``truncate``).  Device
transforms update the states in place and return them.

The chunked mixed step writes a prompt into the states inside the model
(attention appends each chunk to its pages, the recurrences advance their
rows), so ``scatter_prefill`` -- a whole-prompt dense prefill written into
slot pages and rows -- is the offline entry point and the oracle the
chunked writes are held to.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import transformer as T
from repro_torch.models.layers import PagedKVCache
from repro_torch.serving.paged_kv import (PageAllocator, SwapIntegrityError,
                                          ceil_pages, copy_page, make_pool,
                                          reset_pages, scatter_prefill,
                                          snapshot_digest, swap_in_pages,
                                          swap_out_pages, truncate_pages)


def tensor_leaves(obj):
    """Every tensor of a state tree: dicts, lists, tuples (the recurrent
    NamedTuples) and dataclasses (the caches)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensor_leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensor_leaves(v)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tensor_leaves(getattr(obj, f.name))


def map_tensors(fn, obj):
    """``obj`` with ``fn`` applied to every tensor, its structure kept:
    dicts, lists, tuples and the recurrent NamedTuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(fn, v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    raise TypeError(f"no tensors to map in {type(obj).__name__}")


class StateGeometry(NamedTuple):
    """One layer's state described on the host, without its tensors (the
    reference's ``StateGeometry``)."""
    kind: str               # 'paged_kv' | 'slot_rows'
    slots: int
    ring_len: int = 0       # paged_kv: logical ring length (pages * size)
    head_dim: int = 0       # paged_kv
    window: int = 0         # paged_kv: masking protocol (0 = full)
    pages_per_slot: int = 0


class PagedKVState:
    """The state of one attention layer: a page pool.  Layers with the same
    ring length share a :class:`PageAllocator` (one admission budget per
    pool geometry)."""

    kind = "paged_kv"

    def __init__(self, cfg, allocator: PageAllocator, *, page_size: int,
                 ring_len: int, window: int, device):
        self.cfg = cfg
        self.alloc_ = allocator
        self.page_size = page_size
        self.ring_len = ring_len
        self.window = window
        self.device = device

    @property
    def cacheable(self) -> bool:
        """Whether this layer's pages may enter the prefix cache: full
        attention only -- a windowed ring wraps inside a long prompt, so a
        shared page could be overwritten by its reader."""
        return self.window == 0

    # ---- host admission ----------------------------------------------------
    def can_alloc(self, *, shared: int = 0) -> bool:
        return self.alloc_.can_alloc(shared=shared)

    def alloc(self, slot: int, shared=()) -> None:
        if self.alloc_.table[slot][0] == self.alloc_.n_pages:
            # shared allocator: the first layer of the group claims, the
            # rest observe the claim through the shared table
            self.alloc_.alloc(slot, shared=shared)

    def free(self, slot: int) -> None:
        self.alloc_.free(slot)

    # ---- device ------------------------------------------------------------
    def init_device(self) -> PagedKVCache:
        """The layer's pool: in ``cfg.dtype``, or int8 with f32 scales when
        ``cfg.kv_cache_dtype == "int8"``."""
        return make_pool(self.cfg, n_pages=self.alloc_.n_pages,
                         page_size=self.page_size,
                         max_pages=self.alloc_.pages_per_slot,
                         n_slots=self.alloc_.n_slots,
                         dtype=getattr(torch, self.cfg.dtype),
                         device=self.device)

    def prefill_scatter(self, leaf: PagedKVCache, dense, slot_ids, lengths,
                        starts=None) -> PagedKVCache:
        """Write a dense prefill (position-identity rows, see
        :func:`~repro_torch.serving.paged_kv.scatter_prefill`) into the
        slots' pages, in place; ids < 0 write nothing."""
        return scatter_prefill(leaf, dense, slot_ids, lengths, starts=starts)

    def decode_view(self, leaf: PagedKVCache, pos) -> PagedKVCache:
        return leaf   # attention consumes the pool natively

    def reset(self, leaf: PagedKVCache, slot_ids) -> PagedKVCache:
        """Invalidate the pages the given slots own now (the caller pushes
        tables before resetting); ids < 0 are padding."""
        n_slots, _ = leaf.page_table.shape
        rows = leaf.page_table[slot_ids.long().clamp(0, n_slots - 1)]
        rows = torch.where((slot_ids >= 0)[:, None], rows,
                           torch.full_like(rows, leaf.n_pages))
        return reset_pages(leaf, rows.reshape(-1))

    def copy_page(self, leaf: PagedKVCache, src, dst, resume) -> PagedKVCache:
        return copy_page(leaf, src, dst, resume)

    # ---- preempt-to-host ---------------------------------------------------
    def swap_out(self, leaf: PagedKVCache, slot: int) -> dict:
        """Host snapshot of the slot's logical KV ring; the slot must still
        hold its pages (swap out *before* release).  Shared prefix-cache
        pages snapshot like private ones: the restored slot owns a private
        copy, the cache keeps the original."""
        pages = self.alloc_.slot_pages(slot)
        if not pages:
            raise ValueError(f"slot {slot} holds no pages to swap out")
        return swap_out_pages(leaf, pages)

    def swap_in(self, leaf: PagedKVCache, slot: int, blob: dict) -> PagedKVCache:
        """Restore a snapshot into the slot's freshly claimed row (swap in
        *after* alloc; the physical ids may differ)."""
        return swap_in_pages(leaf, self.alloc_.slot_pages(slot), blob)

    # ---- speculative accept/rollback ---------------------------------------
    def spec_snapshot(self, leaf: PagedKVCache, slot: int):
        """Paged pools rewind by position masking alone, so the pre-verify
        snapshot is free (None)."""
        return None

    def truncate(self, leaf: PagedKVCache, slot: int, n: int,
                 snap=None) -> PagedKVCache:
        """Rewind the slot to ``n`` committed tokens: entries at positions
        ``>= n`` on its *private* pages are re-masked empty.  Shared
        prefix-cache pages hold only committed prompt positions and may be
        mapped by other slots or the cache, so they are left alone."""
        shared = self.alloc_.shared_pages(slot)
        pages = [p for p in self.alloc_.slot_pages(slot) if p not in shared]
        return truncate_pages(leaf, pages, n)

    def push_table(self, leaf: PagedKVCache,
                   private_only_slot: int | None = None) -> PagedKVCache:
        table = self.alloc_.device_table(private_only_slot)
        leaf.page_table.copy_(torch.from_numpy(np.ascontiguousarray(table)))
        return leaf

    def geometry(self) -> StateGeometry:
        return StateGeometry(
            kind=self.kind, slots=self.alloc_.n_slots,
            ring_len=self.alloc_.pages_per_slot * self.page_size,
            head_dim=self.cfg.head_dim, window=self.window,
            pages_per_slot=self.alloc_.pages_per_slot)


class SlotRowState:
    """The state of one recurrent layer (RWKV's wkv state and token
    shifts, Mamba's SSM state and conv window) or one cross-attention
    layer (its frozen K/V rows).  Each is a fixed-size row per slot, so
    the ``[n_slots, ...]`` tensors *are* the pool: no page indirection, no
    allocator, and admission is gated by the KV pools alone.  The mixed
    step advances a slot's recurrent rows in place through the
    length-masked recurrence (a row with no token keeps its state), the
    decode step through the live-masked per-token step; no step writes
    cross rows (serving is text-only, so they stay zero).  :meth:`reset`
    zeroes a refilled slot's rows."""

    kind = "slot_rows"

    #: a row is the whole state of a slot: there is no per-chunk page to
    #: share, so recurrent and cross layers are never prefix-cacheable
    cacheable = False

    def __init__(self, cfg, slot: T.Slot, *, n_slots: int, device):
        self.cfg = cfg
        self.slot = slot
        self.n_slots = n_slots
        self.device = device

    # ---- host admission (no per-layer capacity to claim) --------------------
    def can_alloc(self, *, shared: int = 0) -> bool:
        return True

    def alloc(self, slot: int, shared=()) -> None:
        pass

    def free(self, slot: int) -> None:
        pass

    # ---- device ------------------------------------------------------------
    def init_device(self):
        return T.slot_cache(self.cfg, self.slot, self.n_slots, 1,
                            getattr(torch, self.cfg.dtype),
                            device=self.device)

    def prefill_scatter(self, leaf, dense, slot_ids, lengths, starts=None):
        """Copy each prefill row ``b`` (the state after its tokens) into
        slot ``slot_ids[b]``'s row, in place.  A row holds the whole state,
        so ``lengths`` and ``starts`` change nothing that is written; ids
        outside ``[0, n_slots)`` write nothing (JAX drops them).  One
        fixed-shape select per tensor, so nothing syncs with the host; of
        two rows naming one slot the later wins."""
        hit = slot_ids.long()[:, None] == torch.arange(
            self.n_slots, device=slot_ids.device)[None, :]    # [Bp, n_slots]
        written = hit.any(0)
        order = torch.arange(1, hit.shape[0] + 1, device=slot_ids.device)
        src = (hit * order[:, None]).argmax(0)                 # last writer
        for full, rows in zip(tensor_leaves(leaf), tensor_leaves(dense)):
            keep = written.reshape(-1, *[1] * (full.dim() - 1))
            full.copy_(torch.where(keep, rows[src].to(full.dtype), full))
        return leaf

    def decode_view(self, leaf, pos):
        return leaf

    def reset(self, leaf, slot_ids):
        """Zero the rows of the given slots, in place; ids < 0 are
        padding.  One fixed-shape mask, so nothing syncs with the host."""
        hit = (slot_ids.long()[:, None] == torch.arange(
            self.n_slots, device=slot_ids.device)[None, :]).any(0)
        for t in tensor_leaves(leaf):
            t.masked_fill_(hit.reshape(-1, *[1] * (t.dim() - 1)), 0)
        return leaf

    def copy_page(self, leaf, src, dst, resume):
        return leaf   # no page identity: copy-on-write is a pool concern

    # ---- preempt-to-host: a row *is* the whole state -----------------------
    def swap_out(self, leaf, slot: int):
        """Host copy of the slot's rows (one blocking copy per tensor): the
        row holds the exact state after the slot's tokens, so copying it
        out and back in is the whole round trip."""
        return map_tensors(lambda a: a[slot].to("cpu", copy=True), leaf)

    def swap_in(self, leaf, slot: int, blob):
        for a, b in zip(tensor_leaves(leaf), tensor_leaves(blob)):
            a[slot].copy_(b)
        return leaf

    # ---- speculative accept/rollback ---------------------------------------
    def spec_snapshot(self, leaf, slot: int):
        """A device copy of the slot's rows *before* a verify chunk runs.
        The programs advance the rows in place, so a rejected draft can
        only be undone by restoring this copy."""
        return map_tensors(lambda a: a[slot].clone(), leaf)

    def truncate(self, leaf, slot: int, n: int, snap=None):
        """Rewind by restoring the pre-verify snapshot; a row has no
        per-position identity to mask, so ``n`` is implied by it."""
        if snap is None:
            raise ValueError(
                "recurrent rows cannot rewind without a pre-verify "
                "snapshot (spec_snapshot) -- rows hold only the state "
                "after every token fed, including rejected drafts")
        return self.swap_in(leaf, slot, snap)

    def push_table(self, leaf, private_only_slot: int | None = None):
        return leaf

    def geometry(self) -> StateGeometry:
        return StateGeometry(kind=self.kind, slots=self.n_slots)


@dataclasses.dataclass
class StateTree:
    """State handles mirroring the model's flat cache layout exactly."""

    states: dict[str, Any]
    allocators: dict[int, PageAllocator]

    def map_device(self, fn, *trees):
        def at(t, key, *ix):
            node = t[key]
            for i in ix:
                node = node[i]
            return node

        out = {
            "slots": [
                [fn(st, *(at(t, "slots", s, i) for t in trees))
                 for i, st in enumerate(col)]
                for s, col in enumerate(self.states["slots"])],
            "tail": [fn(st, *(at(t, "tail", i) for t in trees))
                     for i, st in enumerate(self.states["tail"])],
        }
        if "shared" in self.states:
            out["shared"] = [fn(st, *(at(t, "shared", i) for t in trees))
                             for i, st in enumerate(self.states["shared"])]
        return out

    def leaves(self):
        for col in self.states["slots"]:
            yield from col
        yield from self.states["tail"]
        yield from self.states.get("shared", [])

    @property
    def has_rows(self) -> bool:
        """Whether any layer's state is a row (recurrent or cross)."""
        return any(isinstance(st, SlotRowState) for st in self.leaves())

    # ---- engine touchpoints --------------------------------------------------
    def init_device(self):
        return self.map_device(lambda st: st.init_device())

    def scatter_prefill(self, pools, dense, slot_ids, lengths, starts=None):
        """Write a whole-prompt dense prefill (``dense``: the caches of
        ``Model.init_caches(Bp, L, clamp_window=False)`` after ``prefill``
        over ``Bp`` prompts) into the slots ``slot_ids`` [Bp], in place:
        each pool gets rows ``j < lengths[b]`` at position ``starts[b] +
        j``, each recurrent row the state after the prompt.  Ids < 0 are
        padding and write nothing."""
        return self.map_device(
            lambda st, pl, dn: st.prefill_scatter(pl, dn, slot_ids, lengths,
                                                  starts=starts),
            pools, dense)

    def decode_view(self, pools, pos):
        return self.map_device(lambda st, pl: st.decode_view(pl, pos), pools)

    def reset(self, pools, slot_ids):
        return self.map_device(lambda st, pl: st.reset(pl, slot_ids), pools)

    def copy_pages(self, pools, src, dst, resume):
        """CoW content copy across every pool; sentinel ids (``COPY_NONE``)
        change nothing that is read, so every admission runs it."""
        return self.map_device(
            lambda st, pl: st.copy_page(pl, src, dst, resume), pools)

    def push_tables(self, pools, private_only_slot: int | None = None):
        return self.map_device(
            lambda st, pl: st.push_table(
                pl, private_only_slot=private_only_slot), pools)

    # ---- preempt-to-host: one geometry for every state kind -----------------
    def swap_out(self, pools, slot: int):
        """Host snapshot of ``slot`` across every layer state (zamba2's
        ``"shared"`` pools included), structured like the device tree, with
        a content digest.  Call *before* releasing the slot."""
        blobs = self.map_device(lambda st, pl: st.swap_out(pl, slot), pools)
        return {"blobs": blobs, "digest": snapshot_digest(blobs)}

    def swap_in(self, pools, slot: int, snap):
        """Restore a :meth:`swap_out` snapshot into ``slot``'s freshly
        claimed pages and rows (call *after* ``admit``).  The digest is
        checked before any device write: a mismatch raises
        :class:`SwapIntegrityError` with the pools untouched."""
        if not isinstance(snap, dict) or "blobs" not in snap:
            raise SwapIntegrityError(
                "swap snapshot is structurally invalid (no blobs)")
        if snap.get("digest") != snapshot_digest(snap["blobs"]):
            raise SwapIntegrityError(
                "swap snapshot digest mismatch -- the snapshot was "
                "corrupted or truncated while parked on the host")
        return self.map_device(
            lambda st, pl, b: st.swap_in(pl, slot, b), pools, snap["blobs"])

    # ---- speculative accept/rollback -----------------------------------------
    def spec_snapshot(self, pools, slot: int):
        """Pre-verify snapshot of ``slot``: device row copies for recurrent
        states, None for paged pools (they rewind by position masking)."""
        return self.map_device(
            lambda st, pl: st.spec_snapshot(pl, slot), pools)

    def truncate(self, pools, slot: int, n: int, snap=None):
        """Rewind ``slot`` to ``n`` committed tokens after a rejected verify
        chunk: paged leaves re-mask positions ``>= n`` (shared pages
        untouched), recurrent rows restore ``snap``."""
        if snap is None:
            snap = self.map_device(lambda st: None)
        return self.map_device(
            lambda st, pl, b: st.truncate(pl, slot, n, snap=b), pools, snap)

    # ---- admission -----------------------------------------------------------
    def can_admit(self, *, shared: int = 0) -> bool:
        return all(st.can_alloc(shared=shared) for st in self.leaves())

    def can_ever_admit(self, *, shared: int = 0) -> bool:
        """Whether an otherwise empty engine could ever grant a claim (pool
        geometry only, never transient free counts)."""
        return all(a.can_ever_alloc(shared=shared)
                   for a in self.allocators.values())

    def admit(self, slot: int, shared=()) -> None:
        for st in self.leaves():
            st.alloc(slot, shared=shared)

    def release(self, slot: int) -> None:
        for st in self.leaves():
            st.free(slot)

    @property
    def free_pages(self) -> dict[int, int]:
        return {g: a.free_pages for g, a in self.allocators.items()}

    def cacheable_group(self) -> int | None:
        """The pool group (pages_per_slot) the prefix cache may serve, or
        None unless every layer is a full-attention paged pool (a
        recurrent row or a windowed ring anywhere opts the model out)."""
        groups = set()
        for st in self.leaves():
            if not getattr(st, "cacheable", False):
                return None
            groups.add(st.alloc_.pages_per_slot)
        return groups.pop() if len(groups) == 1 else None

    def paged_geoms(self) -> list[tuple[int, int, int, int]]:
        """The distinct ``(slots, logical_len, head_dim, window)`` of the
        paged pools, zamba2's shared-block pools included."""
        geoms = {
            (g.slots, g.ring_len, g.head_dim, g.window)
            for st in self.leaves()
            for g in [st.geometry()] if g.kind == "paged_kv"}
        return sorted(geoms)


def _ring_len(window: int, max_len: int) -> int:
    """A layer's ring length: its sliding window, capped at (or defaulting
    to) the engine's max context."""
    return min(window, max_len) if window else max_len


def stack_is_stateable(model) -> bool:
    """True when every stack slot's kind has a state (JAX's
    ``PagedEngine.supports`` predicate): a kind of ``T.SLOT_KINDS``."""
    return all(s.kind in T.SLOT_KINDS for s in model.stack.pattern)


def build_state_tree(model, *, slots: int, page_size: int, max_len: int,
                     overcommit: float = 1.0, pool_pages: int | None = None,
                     device=None) -> StateTree:
    """One state per layer of the flat stack (a PagedKVState per
    attention layer and shared-block call, a SlotRowState per recurrent
    or cross-attention layer), the paged ones sharing a
    :class:`PageAllocator` per distinct ring length, on ``device``
    (default ``cuda``).  ``pool_pages`` hard-caps every allocator's pool
    size."""
    cfg = model.cfg
    stack = model.stack
    device = _device.resolve(device)
    attn_windows = [s.window for s in stack.pattern if s.kind == "attn"]
    if stack.has_shared:
        attn_windows.append(0)   # zamba2's shared block: full attention
    group_pps = sorted({ceil_pages(_ring_len(w, max_len), page_size)
                        for w in attn_windows})

    def _pool_size(pps: int) -> int:
        n = max(pps, int(np.ceil(slots * pps * overcommit)))
        return min(n, pool_pages) if pool_pages is not None else n

    allocators = {pps: PageAllocator(n_pages=_pool_size(pps),
                                     pages_per_slot=pps, n_slots=slots)
                  for pps in group_pps}

    def state_for(slot: T.Slot):
        if slot.kind != "attn":
            return SlotRowState(cfg, slot, n_slots=slots, device=device)
        ring = _ring_len(slot.window, max_len)
        return PagedKVState(cfg, allocators[ceil_pages(ring, page_size)],
                            page_size=page_size, ring_len=ring,
                            window=slot.window, device=device)

    states: dict[str, Any] = {
        "slots": [[state_for(s) for _ in range(stack.n_periods)]
                  for s in stack.pattern],
        "tail": [state_for(stack.pattern[i]) for i in range(stack.n_tail)],
    }
    if stack.has_shared:
        states["shared"] = [state_for(T.Slot("attn", "none"))
                            for _ in range(stack.n_periods)]
    return StateTree(states=states, allocators=allocators)
