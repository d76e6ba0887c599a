"""Serving subsystem of the port: paged KV pools, the per-layer state
tree, the priority scheduler and the chunked-prefill continuous-batching
:class:`~repro_torch.serving.engine.PagedEngine`."""

from repro_torch.serving.engine import (CacheConfig, EngineConfig, FaultConfig,
                                        PagedEngine, SchedulerConfig,
                                        ShapeCounter, SpecConfig)
from repro_torch.serving.paged_kv import (COPY_NONE, PageAllocator, ceil_pages,
                                          copy_page, make_pool, reset_pages,
                                          scatter_prefill)
from repro_torch.serving.scheduler import (DONE, FAILED, PREFILLING, QUEUED,
                                           REJECTED, RUNNING, FIFOScheduler,
                                           ServeRequest, summarize)
from repro_torch.serving.state import (PagedKVState, SlotRowState, StateTree,
                                       build_state_tree, stack_is_stateable)

__all__ = [
    "PagedEngine", "EngineConfig", "SchedulerConfig", "CacheConfig",
    "SpecConfig", "FaultConfig", "ShapeCounter", "COPY_NONE",
    "PageAllocator", "ceil_pages", "copy_page", "make_pool", "reset_pages",
    "scatter_prefill", "FIFOScheduler", "ServeRequest", "summarize",
    "QUEUED", "PREFILLING", "RUNNING", "DONE", "REJECTED", "FAILED",
    "PagedKVState", "SlotRowState", "StateTree", "build_state_tree",
    "stack_is_stateable",
]
