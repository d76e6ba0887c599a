"""Serving subsystem of the port: paged KV pools, the per-layer state
tree, the priority scheduler with preempt-to-host, the prefix cache,
speculative decoding, fault injection with the watchdog, and the
chunked-prefill continuous-batching
:class:`~repro_torch.serving.engine.PagedEngine`."""

from repro_torch.serving.engine import (CacheConfig, EngineConfig, FaultConfig,
                                        PagedEngine, SchedulerConfig,
                                        ShapeCounter, SpecConfig)
from repro_torch.serving.faults import FaultEvent, FaultInjected, FaultPlan
from repro_torch.serving.paged_kv import (COPY_NONE, PageAllocator,
                                          PoolLayout, SwapIntegrityError,
                                          ceil_pages, copy_page, gather_pages,
                                          make_pool, modeled_decode_bytes,
                                          pool_layout, reset_pages,
                                          scatter_prefill, snapshot_digest,
                                          swap_in_pages, swap_out_pages,
                                          truncate_pages)
from repro_torch.serving.prefix_cache import PrefixCache, PrefixHit
from repro_torch.serving.scheduler import (CANCELLED, DONE, FAILED, PREEMPTED,
                                           PREFILLING, QUEUED, REJECTED,
                                           RUNNING, TIMEOUT, FIFOScheduler,
                                           PriorityScheduler, ServeRequest,
                                           slo_summary, summarize)
from repro_torch.serving.speculative import (Drafter, NGramDrafter,
                                             greedy_accept)
from repro_torch.serving.state import (PagedKVState, SlotRowState,
                                       StateGeometry, StateTree,
                                       build_state_tree, stack_is_stateable)
from repro_torch.serving.watchdog import (Watchdog, WatchdogConfig,
                                          WatchdogError)

__all__ = [
    "PagedEngine", "EngineConfig", "SchedulerConfig", "CacheConfig",
    "SpecConfig", "FaultConfig",
    "ShapeCounter", "PageAllocator", "FIFOScheduler",
    "PriorityScheduler", "ServeRequest", "summarize", "slo_summary",
    "ceil_pages", "make_pool", "scatter_prefill",
    "reset_pages", "gather_pages", "copy_page", "COPY_NONE", "PoolLayout",
    "pool_layout", "modeled_decode_bytes", "swap_out_pages", "swap_in_pages",
    "SwapIntegrityError", "snapshot_digest", "truncate_pages",
    "PrefixCache", "PrefixHit",
    "Drafter", "NGramDrafter", "greedy_accept",
    "PagedKVState", "SlotRowState", "StateGeometry", "StateTree",
    "build_state_tree", "stack_is_stateable",
    "FaultPlan", "FaultEvent", "FaultInjected",
    "Watchdog", "WatchdogConfig", "WatchdogError",
    "QUEUED", "PREFILLING", "RUNNING", "PREEMPTED", "DONE", "REJECTED",
    "TIMEOUT", "CANCELLED", "FAILED",
]
