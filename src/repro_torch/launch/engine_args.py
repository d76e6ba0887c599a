"""The engine flag surface: ``add_engine_args`` / ``engine_config_from_args``.

A port of ``repro.launch.engine_args``: the flags of the JAX launcher, so
command lines carry over.  Two flags are not declared:
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
        help="sampling temperature (0: greedy); above 0 the engine draws "
             "from softmax(logits / T) on the device with a generator "
             "seeded from the frontend's --seed")
    arg("--prefix-cache", action="store_true",
        help="share KV pages of cached prompt prefixes across requests "
             "(copy-on-write; DESIGN.md §12).  Only full-attention paged "
             "architectures can cache -- recurrent/windowed archs report "
             "hit rate 0")
    arg("--preempt", action="store_true",
        help="allow an urgent arrival to swap a lower-class victim slot "
             "out to host and resume it later token-identically "
             "(DESIGN.md §13)")
    arg("--slo-ttft-ms", type=float, default=None,
        help="TTFT SLO target in ms (per-class attainment per pass)")
    arg("--slo-e2e-ms", type=float, default=None,
        help="end-to-end latency SLO target in ms")
    arg("--speculate", type=int, default=0, metavar="K",
        help="draft up to K tokens per decoding slot from the request's "
             "committed history (n-gram prompt lookup) and verify them in "
             "the mixed chunk step; greedy only (DESIGN.md §15)")
    arg("--deadline-s", type=float, default=None,
        help="per-request wall-clock deadline in seconds; a request still "
             "unfinished past it ends TIMEOUT with all resources "
             "reclaimed (DESIGN.md §14)")
    arg("--watchdog", action="store_true",
        help="run periodic invariant sweeps (allocator/cache oracles, "
             "refcount reconciliation, slot consistency) and the at-drain "
             "sweep")
    arg("--faults", default=None, metavar="SPEC",
        help="inject a seeded deterministic fault plan, e.g. "
             "'seed=0,n=8,ticks=64,kinds=step_exc+alloc_exhaust"
             "+swap_corrupt+latency' -- step faults recover through the "
             "PREEMPTED retry path (DESIGN.md §14)")
    arg("--heartbeat", default=None, metavar="PATH",
        help="write a throttled JSON liveness file every step so a wedged "
             "serve process is detectable from outside")


def engine_config_from_args(args: argparse.Namespace):
    """Fold a parsed namespace into an
    :class:`~repro_torch.serving.EngineConfig` (``FaultPlan.from_spec`` for
    ``--faults``, ms -> s for the SLO targets, the frontend's ``--seed``,
    if it has one, for the sampler); excluded flags fall back to the
    config defaults."""
    from repro_torch.serving import (CacheConfig, EngineConfig, FaultConfig,
                                     FaultPlan, SchedulerConfig, SpecConfig)

    def get(name, default=None):
        return getattr(args, name, default)

    faults = get("faults")
    plan = FaultPlan.from_spec(faults) if isinstance(faults, str) else None
    slo_ttft = get("slo_ttft_ms")
    slo_e2e = get("slo_e2e_ms")
    return EngineConfig(
        slots=get("slots", 4),
        chunk=get("chunk"),
        step_budget=get("step_budget"),
        temperature=get("temperature", 0.0),
        seed=get("seed", 0),
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
            plan=plan,
            heartbeat=get("heartbeat")))
