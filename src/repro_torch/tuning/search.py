"""Empirical tile search on the card: time a kernel's candidate plans, keep
the measured winner.

The port of ``repro.tuning.search``.  Each planner of the port is a cost
model in SM cycles (``kernels/kraken_gemm.py``, ``paged_attention.py``,
``kraken_moe_gemm.py``, ``kraken_conv.py``), and analytical rankings drift
from measured ones once a real memory system is involved.  So this module
takes a planner's candidates (:func:`shortlist` of ``kraken_gemm``'s;
every one of the others'), runs each through the kernel with that choice,
holds its output against the kernel's plain version within the kernel's
tolerance, times it, and persists the fastest with the planner's own pick
beside it.

The kernels run only on the card: there is no interpret mode, and on the
CPU the plain versions have no plan, so a measurement there raises.  The
timing is device time: ``calls`` consecutive calls captured in one CUDA
graph, replayed after a warm-up and timed with CUDA events, the median of
the repetitions.  The operands rotate through sets whose bytes together
exceed the 50 MB L2 (``ROTATE_BYTES``), as a step's distinct layer weights
do, so a byte-bound decode cell is not crowned on an L2-warm operand.  The
search takes the timing function as a parameter (``timer``: a choice ->
microseconds), so the CPU tests drive it with a timer of their own.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import warnings

import numpy as np

from repro_torch.tuning import cache as tcache

#: the bytes the operand sets of one measurement span together (more than
#: twice the H100's 50 MB L2), at most ``ROTATE_MAX`` sets
ROTATE_BYTES = 128 << 20
ROTATE_MAX = 32
#: calls captured in one timed graph, at least
GRAPH_CALLS = 16


def backend_name() -> str:
    """The backend of every key the port writes: ``cuda``."""
    return tcache.BACKEND


@dataclasses.dataclass(frozen=True)
class Timing:
    choice: tuple
    us: float              # median device microseconds per call


# ---------------------------------------------------------------------------
# the kernels' choices
# ---------------------------------------------------------------------------

def _dtype(name: str):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "int8": torch.int8}[name]


def conv_cache_key(x_shape, k_shape, stride=(1, 1),
                   padding=((0, 0), (0, 0)),
                   dtype_name: str = "bfloat16") -> tuple[str, int, int, int]:
    """The ``conv_direct`` cache key of a conv geometry, by its
    im2col-equivalent GEMM (``repro.tuning.search.conv_cache_key``, which
    takes the input pre-padded).  Returns ``(key, m_eq, k_eq, c_o)``."""
    n, h, w, c_i = x_shape
    k_h, k_w, _, c_o = k_shape
    (pt, pb), (pl, pr) = padding
    oh = (h + pt + pb - k_h) // stride[0] + 1
    ow = (w + pl + pr - k_w) // stride[1] + 1
    m_eq, k_eq = n * oh * ow, c_i * k_h * k_w
    key = tcache.cache_key("conv_direct", m_eq, k_eq, c_o, dtype_name)
    return key, m_eq, k_eq, c_o


@dataclasses.dataclass(frozen=True)
class _Op:
    """One kernel as the tuner sees it.  ``shape`` is the planner's: gemm
    ``(m, k, n)``; paged_decode ``(B, H, KV, D, page_size, MP)``; moe_gemm
    ``(E, C, d, f)``; conv_direct ``(x_shape, k_shape, stride, padding,
    R)``."""
    kind: str
    fields: tuple          # the choice's fields, as the planner names them
    dims: object           # shape -> the key's (m, k, n)
    guards: object         # shape -> the entry fields a hit must match
    candidates: object     # (shape, dtype, sms) -> [dict(fields, est)]
    plan: object           # (shape, dtype, sms, choice) -> plan


def _gemm_op():
    from repro_torch.kernels import kraken_gemm as kg
    return _Op("gemm", kg.CHOICE, lambda s: s, lambda s: {},
               lambda s, dt, sms: kg.candidates(*s, dtype=dt, sms=sms),
               lambda s, dt, sms, c: kg.plan(*s, dtype=dt, sms=sms,
                                             choice=c))


def _paged_op():
    from repro_torch.kernels import paged_attention as pa
    return _Op("paged_decode", pa.CHOICE,
               lambda s: (s[0], s[4] * s[5], s[3]),
               lambda s: {"page_size": s[4], "heads": [s[1], s[2]]},
               lambda s, dt, sms: pa.candidates(*s, dtype=dt, sms=sms),
               lambda s, dt, sms, c: pa.plan(*s, dtype=dt, sms=sms,
                                             choice=c))


def _moe_op():
    from repro_torch.kernels import kraken_moe_gemm as mg
    return _Op("moe_gemm", mg.CHOICE,
               lambda s: (s[0] * s[1], s[2], s[3]),
               lambda s: {"experts": s[0]},
               lambda s, dt, sms: mg.candidates(*s, dtype=dt, sms=sms),
               lambda s, dt, sms, c: mg.plan(*s, dtype=dt, sms=sms,
                                             choice=c))


def _conv_op():
    from repro_torch.kernels import kraken_conv as kc

    def kw(s, dt, sms):
        return dict(stride=s[2], padding=s[3], R=s[4], dtype=dt, sms=sms)
    return _Op("conv_direct", kc.CHOICE,
               lambda s: conv_cache_key(s[0], s[1], s[2], s[3])[1:],
               lambda s: {"geometry": [list(s[0]), list(s[1]),
                                       list(s[2]), [list(p) for p in s[3]],
                                       s[4]]},
               lambda s, dt, sms: kc.candidates(s[0], s[1], **kw(s, dt, sms)),
               lambda s, dt, sms, c: kc.plan(s[0], s[1], choice=c,
                                             **kw(s, dt, sms)))


_OPS = {"gemm": _gemm_op, "paged_decode": _paged_op, "moe_gemm": _moe_op,
        "conv_direct": _conv_op}


def _op(op_kind: str) -> _Op:
    if op_kind not in _OPS:
        raise ValueError(f"unknown op kind {op_kind!r}: one of "
                         f"{sorted(_OPS)}")
    return _OPS[op_kind]()


def key_of(op_kind: str, shape, dtype_name: str) -> str:
    """The cache key of a call of ``op_kind`` at ``shape``."""
    return tcache.cache_key(op_kind, *_op(op_kind).dims(shape), dtype_name)


def candidates_of(op_kind: str, shape, *, dtype_name: str,
                  sms: int) -> list[dict]:
    """The planner's candidates: each its choice fields and ``est``."""
    return _op(op_kind).candidates(shape, _dtype(dtype_name), sms)


def model_pick(op_kind: str, shape, *, dtype_name: str, sms: int) -> tuple:
    """The planner's own choice for ``shape``."""
    op = _op(op_kind)
    q = op.plan(shape, _dtype(dtype_name), sms, None)
    return tuple(q[f] for f in op.fields)


def lookup(op_kind: str, shape, *, dtype_name: str, sms: int,
           cache: tcache.TileCache, count: bool = True) -> tuple | None:
    """A validated cache hit for a call at ``shape``, or None.

    A hit must match the entry's guards (``page_size`` and the heads of a
    ``paged_decode`` entry, ``experts`` of a ``moe_gemm`` one, the whole
    geometry of a ``conv_direct`` one; a mismatch is a miss, as in JAX's
    ``lookup_*``), and its choice must be one of the planner's candidates
    for ``shape``: an entry that names any other choice, or that lacks its
    fields, is a miss with a warning and never reaches a kernel.
    ``count=False`` leaves the hit/miss counters alone."""
    op = _op(op_kind)
    key = key_of(op_kind, shape, dtype_name)
    entry = cache.peek(key)
    choice = None
    if entry is not None and all(entry.get(f) == v
                                 for f, v in op.guards(shape).items()):
        try:
            choice = tuple(int(entry[f]) for f in op.fields)
        except (KeyError, TypeError, ValueError):
            warnings.warn(f"tile cache entry {key!r} has no "
                          f"{'/'.join(op.fields)} choice; ignoring it",
                          stacklevel=2)
        else:
            allowed = {tuple(c[f] for f in op.fields)
                       for c in op.candidates(shape, _dtype(dtype_name), sms)}
            if choice not in allowed:
                warnings.warn(
                    f"tile cache entry {key!r} names {dict(zip(op.fields, choice))}, "
                    f"which is not among the planner's candidates for "
                    f"{shape}; ignoring it", stacklevel=2)
                choice = None
    if count:
        if choice is None:
            cache.misses += 1
        else:
            cache.hits += 1
    return choice


def lookup_paged_decode(cache: tcache.TileCache, *, slots: int, heads: int,
                        kv_heads: int, head_dim: int, page_size: int,
                        max_pages: int, dtype_name: str = "bfloat16",
                        sms: int = 132, count: bool = True) -> int | None:
    """A validated ``paged_decode`` hit (its ``splits``), or None:
    ``repro.tuning.search.lookup_paged_decode``'s ``page_size`` guard, on
    the port's key."""
    hit = lookup("paged_decode", (slots, heads, kv_heads, head_dim,
                                  page_size, max_pages),
                 dtype_name=dtype_name, sms=sms, cache=cache, count=count)
    return None if hit is None else hit[0]


def lookup_moe_gemm(cache: tcache.TileCache, *, experts: int, capacity: int,
                    d: int, f: int, dtype_name: str = "bfloat16",
                    sms: int = 132, count: bool = True) -> tuple | None:
    """A validated ``moe_gemm`` hit (its ``(BM, split)``), or None:
    ``repro.tuning.search.lookup_moe_gemm``'s ``experts`` guard, on the
    port's key."""
    return lookup("moe_gemm", (experts, capacity, d, f),
                  dtype_name=dtype_name, sms=sms, cache=cache, count=count)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def shortlist(cands: list[dict], fields: tuple, top_n: int = 4,
              keep: tuple | None = None) -> list[dict]:
    """The planner's best ``top_n`` candidates of each tile, by estimate
    (``repro.tuning.search.shortlist`` takes the top N of each schedule),
    and ``keep`` (the planner's pick) whatever its rank; in the planner's
    order.  A candidate's tile is every choice field but the split."""
    tile = [f for f in fields if f not in ("split", "splits")]
    ranked = sorted(range(len(cands)), key=lambda i: cands[i]["est"])
    chosen, per_tile = set(), {}
    for i in ranked:
        t = tuple(cands[i][f] for f in tile)
        if per_tile.get(t, 0) < top_n:
            per_tile[t] = per_tile.get(t, 0) + 1
            chosen.add(i)
    return [c for i, c in enumerate(cands)
            if i in chosen or tuple(c[f] for f in fields) == keep]


def benchmark_candidates(choices, time_choice) -> list[Timing]:
    """Time every choice with ``time_choice(choice) -> microseconds``;
    fastest first (a tie keeps the earlier choice)."""
    timings = [Timing(tuple(c), float(time_choice(tuple(c))))
               for c in choices]
    return sorted(timings, key=lambda t: t.us)


def graph_us(fn, calls: int, *, reps: int = 5, warmup: int = 2) -> float:
    """Median device microseconds of one call of ``fn(i)``: ``calls``
    consecutive calls (i = 0, 1, ...) captured in one CUDA graph, replayed
    ``warmup`` times, then ``reps`` times each between two CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    for _ in range(max(1, warmup)):
        graph.replay()
    samples = []
    for _ in range(max(1, reps)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) * 1e3 / calls)
    del graph
    return statistics.median(samples)


def _sets(nbytes: int) -> int:
    return max(1, min(ROTATE_MAX, -(-ROTATE_BYTES // max(1, nbytes))))


def steady_state_pool(slots: int, logical_len: int, head_dim: int, *,
                      page_size: int, kv_heads: int = 1,
                      q_heads: int | None = None,
                      dtype_name: str = "bfloat16", seed: int = 0,
                      device="cuda"):
    """A page pool at serving steady state (``repro.tuning.search.
    steady_state_pool``): every slot full (``q_pos = logical_len - 1``),
    shuffled physical pages, position-exact rows, and the trash page past
    the pool that the port's tables use as their sentinel.

    Returns ``(q, k, v, pos_pages, page_table, q_pos, k_scale, v_scale)``
    as tensors on ``device``; the scales are None unless ``dtype_name`` is
    ``int8`` (and then q is bfloat16, as the engine serves int8 pools)."""
    import torch
    q_heads = q_heads or kv_heads
    max_pages = max(1, -(-logical_len // max(1, page_size)))
    rng = np.random.default_rng(seed)
    n_pages = slots * max_pages
    table = rng.permutation(n_pages).reshape(slots, max_pages)
    shape = (n_pages, kv_heads, page_size, head_dim)
    vals_k, vals_v = rng.normal(size=shape), rng.normal(size=shape)
    put = lambda a, dt: torch.as_tensor(a, device=device).to(dt)  # noqa: E731
    ksc = vsc = None
    if dtype_name == "int8":
        k = put(np.clip(np.round(vals_k * 40), -127, 127), torch.int8)
        v = put(np.clip(np.round(vals_v * 40), -127, 127), torch.int8)
        ksc = put(rng.uniform(0.01, 0.1, shape[:3]), torch.float32)
        vsc = put(rng.uniform(0.01, 0.1, shape[:3]), torch.float32)
        q_dt = torch.bfloat16
    else:
        q_dt = _dtype(dtype_name)
        k, v = put(vals_k, q_dt), put(vals_v, q_dt)
    pos = np.full((n_pages, page_size), -(2 ** 30), np.int32)
    idx = np.arange(logical_len)
    for b in range(slots):
        pos[table[b, idx // page_size], idx % page_size] = idx
    q = put(rng.normal(size=(slots, q_heads, head_dim)), q_dt)
    q_pos = torch.full((slots,), logical_len - 1, dtype=torch.int32,
                       device=device)
    return (q, k, v, put(pos, torch.int32), put(table, torch.int32), q_pos,
            ksc, vsc)


def skewed_group_sizes(experts: int, rows_per_group: int,
                       seed: int = 0) -> np.ndarray:
    """A decode-shaped group table: a few hot experts, some empty
    (``repro.tuning.search.skewed_group_sizes``, copied)."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.5, size=experts).astype(np.float64)
    sizes = np.minimum((raw / raw.max() * rows_per_group).astype(np.int32),
                       rows_per_group)
    sizes[rng.random(experts) < 0.25] = 0
    if sizes.max() == 0:
        sizes[0] = max(1, rows_per_group // 2)
    return sizes.astype(np.int32)


def _bench_gemm(shape, dtype_name, extra):
    import torch
    from repro_torch.core.gemm_cases import GEMM_TOL
    from repro_torch.kernels import kraken_gemm as kg
    from repro_torch.kernels import ref
    m, k, n = shape
    dt = _dtype(dtype_name)
    g = torch.Generator(device="cuda").manual_seed(0)
    sets = [(torch.randn((m, k), generator=g, device="cuda").to(dt),
             (torch.randn((k, n), generator=g, device="cuda")
              / math.sqrt(max(1, k))).to(dt))
            for _ in range(_sets(2 * (m * k + k * n)))]
    return (lambda c, i: kg.kraken_gemm(*sets[i % len(sets)], choice=c),
            len(sets), ref.matmul(*sets[0]), GEMM_TOL[dtype_name])


def _bench_paged(shape, dtype_name, extra):
    from repro_torch.core.attention_cases import ATTN_TOL
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    b, h, kv, d, ps, mp = shape
    window = int(extra.get("window", 0))
    pool_bytes = 2 * b * mp * kv * ps * d * pa._ISZ[_dtype(dtype_name)]
    sets = []
    for seed in range(_sets(pool_bytes)):
        q, k, v, pos, table, q_pos, ks, vs = steady_state_pool(
            b, mp * ps, d, page_size=ps, kv_heads=kv, q_heads=h,
            dtype_name=dtype_name, seed=seed)
        sets.append(((q, k, v), dict(pos_pages=pos, page_table=table,
                                     q_pos=q_pos, k_scale=ks, v_scale=vs,
                                     window=window)))
    args, kws = sets[0]
    return (lambda c, i: pa.paged_decode_attention(
                *sets[i % len(sets)][0], **sets[i % len(sets)][1], choice=c),
            len(sets), ref.paged_decode_attention(*args, **kws),
            ATTN_TOL[str(args[0].dtype).split(".")[-1]])


def _bench_moe(shape, dtype_name, extra):
    import torch
    from repro_torch.core.gemm_cases import GEMM_TOL
    from repro_torch.kernels import kraken_moe_gemm as mg
    from repro_torch.kernels import ref
    e, c, d, f = shape
    dt = _dtype(dtype_name)
    g = torch.Generator(device="cuda").manual_seed(0)
    sizes = torch.as_tensor(skewed_group_sizes(e, c), device="cuda")
    sets = [(torch.randn((e, c, d), generator=g, device="cuda").to(dt),
             (torch.randn((e, d, f), generator=g, device="cuda")
              / math.sqrt(max(1, d))).to(dt))
            for _ in range(_sets(2 * e * (c * d + d * f)))]
    return (lambda ch, i: mg.grouped_moe_gemm(*sets[i % len(sets)], sizes,
                                              choice=ch),
            len(sets), ref.grouped_moe_gemm(*sets[0], sizes),
            GEMM_TOL[dtype_name])


def _bench_conv(shape, dtype_name, extra):
    import torch
    from repro_torch.core.conv_cases import CONV_TOL
    from repro_torch.kernels import kraken_conv as kc
    from repro_torch.kernels import ref
    x_shape, k_shape, stride, padding, R = shape
    dt = _dtype(dtype_name)
    g = torch.Generator(device="cuda").manual_seed(0)
    fan_in = k_shape[0] * k_shape[1] * k_shape[2]
    sets = [(torch.randn(x_shape, generator=g, device="cuda").to(dt),
             (torch.randn(k_shape, generator=g, device="cuda")
              / math.sqrt(fan_in)).to(dt))
            for _ in range(_sets(2 * (math.prod(x_shape)
                                      + math.prod(k_shape))))]
    kw = dict(stride=stride, padding=padding, R=R)
    return (lambda c, i: kc.kraken_conv2d_direct(*sets[i % len(sets)],
                                                 choice=c, **kw),
            len(sets), ref.conv2d(*sets[0], stride=stride, padding=padding),
            CONV_TOL[dtype_name])


_BENCH = {"gemm": _bench_gemm, "paged_decode": _bench_paged,
          "moe_gemm": _bench_moe, "conv_direct": _bench_conv}


def card_timer(op_kind: str, shape, *, dtype_name: str, reps: int = 5,
               warmup: int = 2, extra: dict | None = None):
    """The default timer: ``choice -> microseconds`` of the kernel on the
    card at ``shape`` on rotating seeded operands (:func:`graph_us`).  Each
    choice's first call is held against the plain version within the
    kernel's tolerance (``GEMM_TOL``, ``ATTN_TOL``, ``CONV_TOL``) before it
    is timed: a plan that is fast but wrong raises.  Without a CUDA device
    this raises: the plain versions on the CPU have no plan to time."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"tile search for {op_kind} measures the hand-written kernels "
            "on an NVIDIA GPU (CUDA); no CUDA device is available here, and "
            "the plain versions the CPU runs have no plan to time")
    run, n_sets, want, (atol, rtol) = _BENCH[op_kind](shape, dtype_name,
                                                      extra or {})
    calls = max(GRAPH_CALLS, n_sets)

    def time_choice(choice):
        got = run(choice, 0).float()
        ref_ = want.float()
        err = (got - ref_).abs()
        if not torch.isfinite(got).all() or (err > atol + rtol
                                             * ref_.abs()).any():
            raise RuntimeError(
                f"{op_kind} {shape} choice {choice}: the kernel disagrees "
                f"with its plain version (max |err| "
                f"{err.max().item():.3e}, atol {atol}, rtol {rtol})")
        return graph_us(lambda i: run(choice, i), calls, reps=reps,
                        warmup=warmup)
    return time_choice


def autotune(op_kind: str, shape, *, dtype_name: str, sms: int,
             cache: tcache.TileCache | None = None, top_n: int = 4,
             reps: int = 5, warmup: int = 2, timer=None,
             extra: dict | None = None, log=None) -> tuple:
    """Measured choice for one call shape, with cache write-through.

    A validated hit (:func:`lookup`) returns at once.  A miss times the
    planner's candidates (``kraken_gemm``'s :func:`shortlist` of ``top_n``
    a tile, every other planner's all), each held against the plain
    version first (:func:`card_timer`, or ``timer``), persists the fastest
    with the planner's own pick (``model_pick``, ``agrees_with_model``),
    and returns it.  A kernel with no choice at ``shape`` (float32, the
    tile routes) returns its planner's pick unmeasured and persists
    nothing."""
    op = _op(op_kind)
    if cache is None:
        cache = tcache.TileCache(path=None)
    hit = lookup(op_kind, shape, dtype_name=dtype_name, sms=sms, cache=cache)
    if hit is not None:
        return hit
    pick = model_pick(op_kind, shape, dtype_name=dtype_name, sms=sms)
    cands = op.candidates(shape, _dtype(dtype_name), sms)
    if not cands:
        return pick
    if op_kind == "gemm":
        cands = shortlist(cands, op.fields, top_n, keep=pick)
    est = {tuple(c[f] for f in op.fields): c["est"] for c in cands}
    if timer is None:
        timer = card_timer(op_kind, shape, dtype_name=dtype_name, reps=reps,
                           warmup=warmup, extra=extra)
    timings = benchmark_candidates(list(est), timer)
    winner = timings[0]
    at_pick = next(t.us for t in timings if t.choice == pick)
    key = key_of(op_kind, shape, dtype_name)
    agrees = winner.choice == pick
    cache.put(key, {
        **dict(zip(op.fields, winner.choice)), "est": est[winner.choice],
        "measured_us": winner.us, "kind": op_kind,
        "model_pick": {**dict(zip(op.fields, pick)), "est": est[pick],
                       "measured_us": at_pick},
        "agrees_with_model": agrees, "candidates_timed": len(timings),
        **op.guards(shape), **(extra or {})})
    cache.save()
    if log is not None:
        log(f"[autotune] {key}: winner {dict(zip(op.fields, winner.choice))} "
            f"{winner.us:.2f}us, model {dict(zip(op.fields, pick))} "
            f"{at_pick:.2f}us, over {len(timings)} candidates (model "
            f"{'agrees' if agrees else 'overruled'})")
    return winner.choice


def autotune_gemm(m: int, k: int, n: int, *, dtype_name: str = "bfloat16",
                  sms: int = 132, **kw) -> tuple:
    """Measured ``(BM, BN, split)`` of one ``kraken_gemm`` cell."""
    return autotune("gemm", (m, k, n), dtype_name=dtype_name, sms=sms, **kw)


def autotune_paged_decode(slots: int, logical_len: int, head_dim: int, *,
                          page_size: int, kv_heads: int = 1,
                          q_heads: int | None = None, window: int = 0,
                          dtype_name: str = "bfloat16", sms: int = 132,
                          **kw) -> int:
    """Measured ``splits`` of one ``paged_decode_attention`` geometry,
    timed on a :func:`steady_state_pool` under ``window``."""
    shape = (slots, q_heads or kv_heads, kv_heads, head_dim, page_size,
             max(1, -(-logical_len // max(1, page_size))))
    return autotune("paged_decode", shape, dtype_name=dtype_name, sms=sms,
                    extra={"window": window}, **kw)[0]


def autotune_moe_gemm(experts: int, m_total: int, d: int, f: int, *,
                      dtype_name: str = "bfloat16", sms: int = 132,
                      **kw) -> tuple:
    """Measured ``(BM, split)`` of one ``grouped_moe_gemm`` cell of
    ``m_total = experts * capacity`` rows, timed over a
    :func:`skewed_group_sizes` table."""
    shape = (experts, max(1, -(-m_total // max(1, experts))), d, f)
    return autotune("moe_gemm", shape, dtype_name=dtype_name, sms=sms, **kw)


def autotune_conv(x_shape, k_shape, *, stride=(1, 1),
                  padding=((0, 0), (0, 0)), R: int = 7,
                  dtype_name: str = "bfloat16", sms: int = 132,
                  **kw) -> tuple:
    """Measured ``(BN, split)`` -- the c_o tile ``bco`` and the split over
    C_i -- of one ``kraken_conv2d_direct`` geometry."""
    shape = (tuple(x_shape), tuple(k_shape), tuple(stride),
             tuple(tuple(p) for p in padding), R)
    return autotune("conv_direct", shape, dtype_name=dtype_name, sms=sms,
                    **kw)
