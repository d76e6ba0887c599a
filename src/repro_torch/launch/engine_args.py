"""The engine flag surface: ``add_engine_args`` / ``engine_config_from_args``.

A port of ``repro.launch.engine_args``.  The flags of the JAX launcher
parse, so command lines carry over; the features this port does not run
yet are refused by :meth:`~repro_torch.serving.EngineConfig.validate` with
the ROADMAP item that brings them.  Two flags are not declared:
``--paged-kernel`` and ``--moe-gemm`` chose among Pallas modes, and the port
has one path per kernel, chosen by the device -- the hand-written kernel on
CUDA tensors, its plain version on CPU tensors.  ``PagedEngine.stats()``
reports which expert FFN ran as ``moe_gemm`` (``"kernel"`` or
``"plain"``).
"""

from __future__ import annotations

import argparse


def add_engine_args(parser: argparse.ArgumentParser,
                    exclude: tuple[str, ...] = ()) -> None:
    """Declare the PagedEngine flags on ``parser`` (one argument group);
    ``exclude`` names flags (without the dashes) the caller keeps."""
    g = parser.add_argument_group("engine")

    def arg(name, *a, **kw):
        if name.lstrip("-") not in exclude:
            g.add_argument(name, *a, **kw)

    arg("--slots", type=int, default=4)
    arg("--cache-len", type=int, default=64,
        help="per-slot KV budget (the engine's max_len): admission caps "
             "prompt + max_new at this many tokens")
    arg("--page-size", type=int, default=8)
    arg("--chunk", type=int, default=None,
        help="prefill chunk width: prompts stream in CHUNK tokens per "
             "mixed step, fused with the batched decode step (default: "
             "cache-len, whole-prompt chunks)")
    arg("--step-budget", type=int, default=None,
        help="per-step token budget; decode slots are accounted first "
             "(default: slots + chunk)")
    arg("--max-queue", type=int, default=64,
        help="admission-control queue depth")
    arg("--temperature", type=float, default=0.0,
        help="sampling temperature; only 0 (greedy) is ported")
    arg("--prefix-cache", action="store_true", help="not ported yet")
    arg("--preempt", action="store_true", help="not ported yet")
    arg("--slo-ttft-ms", type=float, default=None,
        help="TTFT SLO target in ms (per-class attainment per pass)")
    arg("--slo-e2e-ms", type=float, default=None,
        help="end-to-end latency SLO target in ms")
    arg("--speculate", type=int, default=0, metavar="K",
        help="not ported yet")
    arg("--deadline-s", type=float, default=None, help="not ported yet")
    arg("--watchdog", action="store_true", help="not ported yet")
    arg("--faults", default=None, metavar="SPEC", help="not ported yet")
    arg("--heartbeat", default=None, metavar="PATH", help="not ported yet")


def engine_config_from_args(args: argparse.Namespace):
    """Fold a parsed namespace into an
    :class:`~repro_torch.serving.EngineConfig`; excluded flags fall back to
    the config defaults."""
    from repro_torch.serving import (CacheConfig, EngineConfig, FaultConfig,
                                     SchedulerConfig, SpecConfig)

    def get(name, default=None):
        return getattr(args, name, default)

    slo_ttft = get("slo_ttft_ms")
    slo_e2e = get("slo_e2e_ms")
    return EngineConfig(
        slots=get("slots", 4),
        chunk=get("chunk"),
        step_budget=get("step_budget"),
        temperature=get("temperature", 0.0),
        sched=SchedulerConfig(
            max_queue=get("max_queue", 64),
            preempt=bool(get("preempt", False)),
            slo_ttft_s=slo_ttft / 1e3 if slo_ttft else None,
            slo_e2e_s=slo_e2e / 1e3 if slo_e2e else None),
        cache=CacheConfig(
            page_size=get("page_size", 8),
            max_len=get("cache_len", 64),
            prefix_cache=bool(get("prefix_cache", False))),
        spec=SpecConfig(speculate=int(get("speculate", 0) or 0)),
        fault=FaultConfig(
            deadline_s=get("deadline_s"),
            watchdog=bool(get("watchdog", False)) or None,
            plan=get("faults"),
            heartbeat=get("heartbeat")))
