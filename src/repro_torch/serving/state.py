"""The per-layer decode-state protocol, for paged KV pools.

A port of ``repro.serving.state`` restricted to attention layers: a
:class:`PagedKVState` is the host-side handle of one layer's page pool
(allocator hooks and the device transforms), and a
:class:`StateTree` zips the handles with the model's flat cache layout
``{"slots": [[state per period] per pattern slot], "tail": [...]}`` and
owns admission over the shared allocators and the table pushes.  Device
transforms update the pools in place and return them.  Recurrent and
frozen slot-row states (``SlotRowState``) come with the recurrent families
(ROADMAP Queue 1 item 9a).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import transformer as T
from repro_torch.models.layers import PagedKVCache
from repro_torch.serving.paged_kv import (PageAllocator, ceil_pages, copy_page,
                                          make_pool, reset_pages)


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

    def push_table(self, leaf: PagedKVCache,
                   private_only_slot: int | None = None) -> PagedKVCache:
        table = self.alloc_.device_table(private_only_slot)
        leaf.page_table.copy_(torch.from_numpy(np.ascontiguousarray(table)))
        return leaf


def stack_is_stateable(model) -> bool:
    """True when every stack slot has a ported state and layer kind."""
    return (not model.stack.has_shared
            and all(T.slot_is_ported(model.cfg, s)
                    for s in model.stack.pattern))


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

        return {
            "slots": [
                [fn(st, *(at(t, "slots", s, i) for t in trees))
                 for i, st in enumerate(col)]
                for s, col in enumerate(self.states["slots"])],
            "tail": [fn(st, *(at(t, "tail", i) for t in trees))
                     for i, st in enumerate(self.states["tail"])],
        }

    def leaves(self):
        for col in self.states["slots"]:
            yield from col
        yield from self.states["tail"]

    # ---- engine touchpoints --------------------------------------------------
    def init_device(self):
        return self.map_device(lambda st: st.init_device())

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


def _ring_len(window: int, max_len: int) -> int:
    """A layer's ring length: its sliding window, capped at (or defaulting
    to) the engine's max context."""
    return min(window, max_len) if window else max_len


def build_state_tree(model, *, slots: int, page_size: int, max_len: int,
                     overcommit: float = 1.0, pool_pages: int | None = None,
                     device=None) -> StateTree:
    """One PagedKVState per layer of the flat stack, sharing a
    :class:`PageAllocator` per distinct ring length, with pools on
    ``device`` (default ``cuda``).  ``pool_pages`` hard-caps every
    allocator's pool size."""
    cfg = model.cfg
    stack = model.stack
    device = _device.resolve(device)
    if not stack_is_stateable(model):
        raise NotImplementedError(
            f"no ported state for the slots {stack.pattern}: recurrent and "
            "frozen slot-row states (SlotRowState) are ROADMAP Queue 1 item "
            "9a")
    group_pps = sorted({ceil_pages(_ring_len(s.window, max_len), page_size)
                        for s in stack.pattern})

    def _pool_size(pps: int) -> int:
        n = max(pps, int(np.ceil(slots * pps * overcommit)))
        return min(n, pool_pages) if pool_pages is not None else n

    allocators = {pps: PageAllocator(n_pages=_pool_size(pps),
                                     pages_per_slot=pps, n_slots=slots)
                  for pps in group_pps}

    def state_for(slot: T.Slot):
        ring = _ring_len(slot.window, max_len)
        return PagedKVState(cfg, allocators[ceil_pages(ring, page_size)],
                            page_size=page_size, ring_len=ring,
                            window=slot.window, device=device)

    states: dict[str, Any] = {
        "slots": [[state_for(s) for _ in range(stack.n_periods)]
                  for s in stack.pattern],
        "tail": [state_for(stack.pattern[i]) for i in range(stack.n_tail)],
    }
    return StateTree(states=states, allocators=allocators)
