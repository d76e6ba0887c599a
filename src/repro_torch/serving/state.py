"""The per-layer decode-state protocol: paged KV pools and recurrent rows.

A port of ``repro.serving.state`` for attention, RWKV and Mamba layers: a
:class:`PagedKVState` is the host-side handle of one layer's page pool
(allocator hooks and the device transforms), a :class:`SlotRowState` that
of one recurrent layer's fixed-size row per slot, and a :class:`StateTree`
zips the handles with the model's flat cache layout ``{"slots": [[state per
period] per pattern slot], "tail": [...], "shared": [...]}`` and owns
admission over the shared allocators and the table pushes.  Device
transforms update the states in place and return them.  Frozen
cross-attention rows come with cross attention (ROADMAP Queue 1 item 8);
swap-out and speculation's snapshots with items 9c and 9e.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import transformer as T
from repro_torch.models.layers import PagedKVCache
from repro_torch.serving.paged_kv import (PageAllocator, ceil_pages, copy_page,
                                          make_pool, reset_pages)


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

    def geometry(self) -> StateGeometry:
        return StateGeometry(
            kind=self.kind, slots=self.alloc_.n_slots,
            ring_len=self.alloc_.pages_per_slot * self.page_size,
            head_dim=self.cfg.head_dim, window=self.window,
            pages_per_slot=self.alloc_.pages_per_slot)


class SlotRowState:
    """The state of one recurrent layer: RWKV's wkv state and token shifts,
    or Mamba's SSM state and conv window.  Each is a fixed-size row per
    slot, so the ``[n_slots, ...]`` tensors *are* the pool: no page
    indirection, no allocator, and admission is gated by the KV pools
    alone.  The mixed step advances a slot's rows in place through the
    length-masked recurrence (a row with no token keeps its state), the
    decode step through the live-masked per-token step, and :meth:`reset`
    zeroes a refilled slot's rows."""

    kind = "slot_rows"

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

    def push_table(self, leaf, private_only_slot: int | None = None):
        return leaf

    def geometry(self) -> StateGeometry:
        return StateGeometry(kind=self.kind, slots=self.n_slots)


def stack_is_stateable(model) -> bool:
    """True when every stack slot has a ported layer and state kind."""
    return all(T.slot_is_ported(model.cfg, s) for s in model.stack.pattern)


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
        """Whether any layer's state is a recurrent row."""
        return any(isinstance(st, SlotRowState) for st in self.leaves())

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
    """One state per layer of the flat stack (a PagedKVState per
    attention layer and shared-block call, a SlotRowState per recurrent
    layer), the paged ones sharing a :class:`PageAllocator` per distinct
    ring length, on ``device`` (default ``cuda``).  ``pool_pages``
    hard-caps every allocator's pool size."""
    cfg = model.cfg
    stack = model.stack
    device = _device.resolve(device)
    if not stack_is_stateable(model):
        raise NotImplementedError(
            f"no ported state for the slots {stack.pattern} of {cfg.name}: "
            "cross attention, layernorm, gelu, sinusoidal positions and "
            "frontends come with ROADMAP Queue 1 item 8")
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
