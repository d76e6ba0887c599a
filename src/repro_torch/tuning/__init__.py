"""Empirical tile-plan tuning on the card: measure, persist, replay.

The port of ``repro.tuning``.  The paper reconfigures the engine per layer
from a precomputed configuration word; the model that chooses the word is
offline.  Here each kernel's planner is that model, and this package the
measured alternative:

* :mod:`repro_torch.tuning.search` -- time a planner's candidate plans on
  the kernel, each held against its plain version first,
* :mod:`repro_torch.tuning.cache` -- the versioned JSON store of winners,
  keyed ``(op_kind, m, k, n, dtype, backend)``,
* this module -- the process-wide policy (``model`` | ``cached`` |
  ``autotune``) that :func:`repro_torch.core.elastic.choose_tiles` defers
  to, and the warm-up of a server's cells.

Wiring: ``launch/serve.py --autotune --tile-cache plans.json`` warms the
cache once on the card; later runs pass ``--tile-cache`` alone and replay
the measured winners at no measurement cost.  ``KRAKEN_TILE_MODE`` and
``KRAKEN_TILE_CACHE`` set the same knobs for the environment.
"""

from __future__ import annotations

import os

from repro_torch.core.elastic import TILE_MODES
from repro_torch.tuning import search
from repro_torch.tuning.cache import (BACKEND, CACHE_PATH_ENV, CACHE_VERSION,
                                      TileCache, cache_key,
                                      default_cache_path)
from repro_torch.tuning.search import (autotune, autotune_conv,
                                       autotune_gemm, autotune_moe_gemm,
                                       autotune_paged_decode, backend_name,
                                       benchmark_candidates, conv_cache_key,
                                       lookup, lookup_moe_gemm,
                                       lookup_paged_decode, shortlist,
                                       skewed_group_sizes, steady_state_pool)

__all__ = [
    "TileCache", "CACHE_VERSION", "CACHE_PATH_ENV", "BACKEND", "cache_key",
    "default_cache_path", "autotune", "autotune_gemm", "autotune_conv",
    "autotune_paged_decode", "autotune_moe_gemm", "lookup",
    "lookup_paged_decode", "lookup_moe_gemm", "conv_cache_key",
    "steady_state_pool", "skewed_group_sizes", "shortlist",
    "benchmark_candidates", "backend_name", "get_tile_mode", "set_tile_mode",
    "get_tile_cache", "set_tile_cache", "resolve_tiles", "autotune_cells",
    "warm_cells", "warm_paged_decode", "warm_moe_gemm", "summarize",
    "card_sms",
]

TILE_MODE_ENV = "KRAKEN_TILE_MODE"

_mode: str | None = None          # resolved lazily so env changes apply
_cache: TileCache | None = None   # the process's cache instance


def get_tile_mode() -> str:
    """The process-wide tile-selection mode (see the module docstring)."""
    if _mode is not None:
        return _mode
    env = os.environ.get(TILE_MODE_ENV, "model")
    return env if env in TILE_MODES else "model"


def set_tile_mode(mode: str | None) -> None:
    """Set (or with ``None``, reset to the environment's or the default)
    the process-wide mode."""
    global _mode
    if mode is not None and mode not in TILE_MODES:
        raise ValueError(f"tile mode must be one of {TILE_MODES}, "
                         f"got {mode!r}")
    _mode = mode


def get_tile_cache() -> TileCache:
    """The process-wide cache instance (made once; honors
    ``KRAKEN_TILE_CACHE``)."""
    global _cache
    if _cache is None:
        _cache = TileCache()
    return _cache


def set_tile_cache(path_or_cache: str | TileCache | None) -> TileCache:
    """Point the process at a cache file (or instance; ``None``: the
    environment's); returns it."""
    global _cache
    if isinstance(path_or_cache, TileCache):
        _cache = path_or_cache
    else:
        _cache = TileCache(path=path_or_cache)
    return _cache


def resolve_tiles(op_kind: str, shape: tuple, *, dtype_name: str, sms: int,
                  mode: str) -> tuple | None:
    """Back end of ``choose_tiles(mode="cached"|"autotune")``: the choice
    of a call, memoized per cache (``TileCache.resolved``) so that a warm
    call costs one dict lookup.

    ``cached``: a validated hit, else None (the planner's pick; the miss is
    counted).  ``autotune``: a miss is measured on the card and persisted
    (:func:`repro_torch.tuning.search.autotune`)."""
    cache = get_tile_cache()
    memo = (op_kind, shape, dtype_name, sms)
    if memo in cache.resolved:
        return cache.resolved[memo]
    if mode == "autotune":
        choice = autotune(op_kind, shape, dtype_name=dtype_name, sms=sms,
                          cache=cache)
    else:
        choice = lookup(op_kind, shape, dtype_name=dtype_name, sms=sms,
                        cache=cache)
    cache.resolved[memo] = choice
    return choice


def card_sms(sms: int | None = None) -> int:
    """``sms``, else the current CUDA device's SM count, else the H100's."""
    if sms is not None:
        return sms
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.kraken_gemm import SMS
    if torch.cuda.is_available():
        return _build.sm_count(torch.cuda.current_device())
    return SMS


def _warm(op_kind: str, shape, *, dtype_name: str, sms: int, cache, timer,
          extra=None, **kw):
    """One cell through :func:`autotune`: (choice, status), status ``hit``
    (the cache held it), ``tuned`` (measured and persisted now) or
    ``skipped`` (the kernel has no choice at this shape)."""
    if lookup(op_kind, shape, dtype_name=dtype_name, sms=sms, cache=cache,
              count=False) is not None:
        status = "hit"
    elif not search.candidates_of(op_kind, shape, dtype_name=dtype_name,
                                  sms=sms):
        status = "skipped"
    else:
        status = "tuned"
    choice = autotune(op_kind, shape, dtype_name=dtype_name, sms=sms,
                      cache=cache, timer=timer, extra=extra, **kw)
    return choice, status


def autotune_cells(cells, *, cache: TileCache | None = None,
                   dtype_name: str = "bfloat16", sms: int | None = None,
                   top_n: int = 4, timer=None, log=None):
    """Warm the cache for a list of :class:`repro_torch.core.unified.
    GemmCell`; returns ``[(cell, choice, status)]`` (status as
    :func:`_warm`: a second run of a warmed server reports all hits).

    Every GEMM-shaped cell kind (conv-as-im2col, fc, matmul) runs the same
    ``kraken_gemm`` kernel, so they share the ``gemm`` key namespace;
    ``timer`` replaces the card's measurement (the tests' fake clock)."""
    cache = get_tile_cache() if cache is None else cache
    sms = card_sms(sms)
    return [(cell, *_warm("gemm", (cell.m, cell.k, cell.n),
                          dtype_name=dtype_name, sms=sms, cache=cache,
                          timer=timer, top_n=top_n, log=log))
            for cell in cells]


def summarize(statuses, label: str = "cells") -> str:
    """The warm-up's closing line: ``tile-cache: H/N <label> hit`` and
    ``— fully warm`` when every cell hit."""
    n = len(statuses)
    hits = sum(s == "hit" for s in statuses)
    skipped = sum(s == "skipped" for s in statuses)
    return (f"tile-cache: {hits}/{n} {label} hit"
            + (" — fully warm" if hits == n else
               f" ({n - hits - skipped} tuned, {skipped} skipped this run)"))


def _cell_line(status: str, name: str, m: int, k: int, n: int,
               what: str) -> str:
    return (f"tile-cache {status:<7} {name:<18} m={m:<6} k={k:<6} n={n:<6} "
            f"-> {what}")


def warm_cells(cells, *, dtype_name: str = "bfloat16",
               cache: TileCache | None = None, log=None,
               verbose: bool = True, label: str = "cells", timer=None):
    """:func:`autotune_cells` and its report, one line a cell (with
    ``verbose``) and :func:`summarize`'s; returns the results."""
    from repro_torch.kernels.kraken_gemm import CHOICE
    results = autotune_cells(cells, cache=cache, dtype_name=dtype_name,
                             timer=timer, log=log)
    if log is not None:
        if verbose:
            for cell, choice, status in results:
                log(_cell_line(status, cell.name, cell.m, cell.k, cell.n,
                               str(dict(zip(CHOICE, choice)))))
        log(summarize([s for _, _, s in results], label))
    return results


def warm_paged_decode(cfg, geoms, *, page_size: int,
                      cache: TileCache | None = None, sms: int | None = None,
                      timer=None, log=None) -> list[str]:
    """Tune ``paged_decode_attention``'s ``splits`` for every pool geometry
    ``(slots, logical_len, head_dim, window)`` of a server of ``cfg``
    (``PagedEngine.pool_geoms``), keyed on the pool dtype (int8 pools warm
    int8 entries); returns the statuses."""
    cache = get_tile_cache() if cache is None else cache
    sms = card_sms(sms)
    pool = ("int8" if getattr(cfg, "kv_cache_dtype", "") == "int8"
            else cfg.dtype)
    out = []
    for slots, logical, head_dim, window in geoms:
        shape = (slots, cfg.num_heads, cfg.num_kv_heads, head_dim, page_size,
                 max(1, -(-logical // page_size)))
        (splits,), status = _warm("paged_decode", shape, dtype_name=pool,
                                  sms=sms, cache=cache, timer=timer,
                                  extra={"window": window}, log=log)
        out.append(status)
        if log is not None:
            log(_cell_line(status, "paged_decode", slots, logical, head_dim,
                           f"splits={splits}"))
    return out


def warm_moe_gemm(cfg, token_widths, *, cache: TileCache | None = None,
                  sms: int | None = None, timer=None, log=None) -> list[str]:
    """Tune ``grouped_moe_gemm``'s ``(BM, split)`` at each token width the
    engine runs (its mixed step's ``slots * chunk`` and its decode step's
    ``slots``), in both directions of the expert FFN (d -> f for gate and
    up, f -> d for down); returns the statuses."""
    from repro_torch.kernels.kraken_moe_gemm import CHOICE
    from repro_torch.models.moe import expert_capacity
    cache = get_tile_cache() if cache is None else cache
    sms = card_sms(sms)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    out = []
    for tokens in sorted(set(token_widths)):
        cap = expert_capacity(tokens, cfg)
        for kk, nn in ((d, f), (f, d)):
            choice, status = _warm("moe_gemm", (e, cap, kk, nn),
                                   dtype_name=cfg.dtype, sms=sms,
                                   cache=cache, timer=timer, log=log)
            out.append(status)
            if log is not None:
                log(_cell_line(status, "moe_gemm", e * cap, kk, nn,
                               str(dict(zip(CHOICE, choice)))))
    return out
