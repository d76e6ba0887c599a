"""``swa_attention`` on Hopper: the hand-written CUDA kernel
``csrc/swa_attention.cu`` behind a checked Python wrapper and its planner.

It replaces the Pallas TPU kernel ``repro.kernels.swa_attention.swa_attention``:
causal sliding-window flash attention over a whole sequence (prefill and the
cache-less forward), q ``[B, H, S, D]`` against k/v ``[B, KV, S, D]``, token
``i`` attending to key ``j`` iff ``i - window < j <= i``.  One block per
(batch x head, q tile) walks only the kv tiles of its window, each once, with
the kv head resolved in its own offsets (no repeated-KV tensor) and a ragged
last tile masked in the kernel.

:func:`plan` lays one call onto the card (the kernel takes its plan as a list
of ints, :data:`PLAN_FIELDS`).  bfloat16 runs on ``wgmma``: 128-row q tiles,
two consumer warpgroups of 64 rows, a TMA ring of ``stages`` 64-key K and V
tiles read in ``DB`` boxes of 64 columns of D, scores and the online softmax
in registers, the probabilities rounded to bf16 before the PV product as the
Pallas kernel does; :func:`tile_walk` lists the kv tiles each warpgroup
takes and which of them evaluate the mask.  float32 keeps the first port's
FMA kernel.  With ``return_lse`` the kernel also writes each row's
log-sum-exp (fp32, natural log units), which training saves.

:func:`swa_attention_bwd` is the gradient, the hand-written
``csrc/swa_attention_bwd.cu`` (no TPU kernel has one): a delta pass, then
one grid of dQ blocks (one per (batch x head, q tile), walking its
window's kv tiles) and dK/dV blocks (one per (batch x KV head, key tile),
walking the q tiles that see those keys for each query head of the group
in order), no atomics.  bfloat16 runs on ``wgmma`` (64-row tiles of both
kinds, D padded to ``DP``, the walked tiles through a TMA ring of
``stages``; one warpgroup computes S and P, the other dP and dS, P handed
over once, so each is computed once a tile: ``ops`` = 14 operations per
in-window pair and dim), float32 on FMA (32-row tiles).  :func:`plan_bwd`
lays a call out (:data:`BWD_PLAN_FIELDS`), :func:`bwd_tile_walk` lists
both walks.

The wrappers take CUDA tensors only and launch the kernel or raise; the
plain versions are :func:`repro_torch.kernels.ref.sliding_window_attention`
and :func:`~repro_torch.kernels.ref.sliding_window_attention_bwd`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.elastic import SMEM_BUDGET, ceil_div, round_up
from repro_torch.kernels import _build

#: launches of the forward kernel and of the backward (its delta pass and
#: its dQ/dK/dV grid count as one) in this process; callers may reset them
launches = 0
bwd_launches = 0

#: bfloat16: q rows a block (two warpgroups of 64), keys a kv tile, bytes of
#: a 64-element swizzled row, ring stages at most, bytes kept for the
#: barriers and the 1024-byte alignment
BQ, BKV, ROW = 128, 64, 128
WG_ROWS = 64
STAGES_MAX = 4
RESERVED = 2048
#: float32: q and kv tile rows of the FMA kernel
BQ_F32 = BKV_F32 = 32
#: plan paths
PATH_FMA, PATH_WGMMA = 0, 1

#: the kernel's plan, in this order (``SWA_ATTENTION_PLAN`` in
#: swa_attention.cu, which the library reports and :func:`_library` checks)
PLAN_FIELDS = ("path", "B", "H", "KV", "S", "D", "W",
               # bfloat16: the wgmma kernel
               "DB", "stages", "qtiles", "blocks", "smem")

#: the backward's paths (float32 on FMA, bfloat16 on wgmma) and their
#: tiles: (a dQ block's q rows, keys of a kv tile, q rows of a dK/dV
#: block's step)
PATH_MMA = 1
BWD_TILES = {PATH_FMA: (32, 32, 32), PATH_MMA: (64, 64, 64)}
#: the products each kind of block computes per tile (each 2 operations per
#: pair and dim): S and dP once, then dV and dK, or dQ
BWD_PRODUCTS = {"dkv": ("S^T", "dP^T", "dV", "dK"), "dq": ("S", "dP", "dQ")}
BWD_OPS = 2 * sum(len(v) for v in BWD_PRODUCTS.values())
#: bfloat16: a [64, 64] box of a tile, a P hand-off buffer, a ring stage's
#: lse and delta, ring stages at most
BWD_BOX = 64 * ROW
BWD_XBUF = 64 * 64 * 2
BWD_STATS = 1024
BWD_STAGES_MAX = 4
#: the backward kernel's plan, in this order (``SWA_ATTENTION_BWD_PLAN`` in
#: swa_attention_bwd.cu, checked on load like :data:`PLAN_FIELDS`)
BWD_PLAN_FIELDS = ("path", "B", "H", "KV", "S", "D", "W",
                   # bfloat16: D padded to DP columns, ring stages
                   "DP", "stages", "qtiles", "kvtiles", "dq_blocks",
                   "dkv_blocks",
                   # operations per in-window pair and dim
                   "ops", "smem")

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_bwd_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("swa_attention")
        fn = lib.swa_attention
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.swa_attention_plan_fields.restype = ctypes.c_char_p
        theirs = lib.swa_attention_plan_fields().decode().rstrip(",")
        if theirs != ",".join(PLAN_FIELDS):
            raise RuntimeError(
                "swa_attention.cu's plan fields differ from PLAN_FIELDS: "
                f"{theirs} != {','.join(PLAN_FIELDS)}")
        _lib = lib
    return _lib


def _fma_smem(d: int) -> int:
    """The float32 kernel's shared memory (``fp32::Geometry``): Q, K and V
    tiles of 32 rows at stride D + 1, the scores at stride 36, the
    accumulator and (m, l), each region 128-byte aligned."""
    ldt = d + 1
    parts = (BQ_F32 * ldt, BKV_F32 * ldt, BKV_F32 * ldt, BQ_F32 * (BKV_F32 + 4),
             BQ_F32 * d, 2 * BQ_F32)
    return sum(round_up(4 * n, 128) for n in parts)


def plan(b: int, h: int, kv: int, s: int, d: int, window: int,
         dtype=torch.bfloat16) -> dict:
    """How one call runs on the card: every field of :data:`PLAN_FIELDS`.

    bfloat16: D is read in ``DB`` boxes of 64 columns (1, 2 or 4: D padded to
    64, 128 or 256, the PV product's width), the ring holds as many 64-key K
    and V stages (2-4) as fit beside the [128, 64 DB] Q tile, and the grid
    has one block per (b*h, q tile).  float32: the FMA kernel's 32-row
    tiles (``DB`` and ``stages`` 0).  Raises ValueError for a call the
    kernel does not take."""
    if dtype not in _DTYPE:
        raise ValueError(f"swa_attention dtype {dtype}: needs float32 or "
                         "bfloat16")
    if (b < 1 or kv < 1 or h % kv or s < 1 or d < 8 or d % 8 or d > 256
            or window < 1):
        raise ValueError(f"swa_attention shape B={b} H={h} KV={kv} S={s} "
                         f"D={d} W={window}")
    q = dict(path=PATH_FMA, B=b, H=h, KV=kv, S=s, D=d, W=int(window), DB=0,
             stages=0)
    if dtype == torch.float32:
        q.update(qtiles=ceil_div(s, BQ_F32), smem=_fma_smem(d))
    else:
        db = 1 if d <= 64 else 2 if d <= 128 else 4
        qbytes, stage = db * BQ * ROW, 2 * db * BKV * ROW
        stages = min(STAGES_MAX, (SMEM_BUDGET - RESERVED - qbytes) // stage)
        q.update(path=PATH_WGMMA, DB=db, stages=stages,
                 qtiles=ceil_div(s, BQ),
                 smem=qbytes + stages * stage + RESERVED)
    q["blocks"] = q["qtiles"] * b * h
    return q


def describe(q: dict) -> str:
    """One line for a log: the tile, ring, shared memory and blocks."""
    if q["path"] == PATH_FMA:
        return f"fp32 FMA 32x32 tiles, {q['blocks']} blocks, smem {q['smem']}"
    return (f"wgmma {BQ}x{BKV} tiles, D in {q['DB']} boxes of 64, "
            f"{q['stages']} stages, {q['blocks']} blocks, smem {q['smem']}")


def tile_walk(q: dict, qt: int) -> list[tuple[int, list[tuple[int, bool]]]]:
    """The bf16 kernel's walk for q tile ``qt``, as its loops compute it:
    for each consumer warpgroup, its first row ``r0`` and the kv tiles it
    takes, each with whether it evaluates the mask (it crosses the diagonal
    or the window's edge for rows ``r0 .. r0 + 63``).  The block's ring
    carries the union of the two, ``max(0, q0 - W + 1) // 64`` to the tile
    of ``min(S, q0 + 128) - 1``."""
    s, w = q["S"], q["W"]
    out = []
    for wg in range(BQ // WG_ROWS):
        r0 = qt * BQ + wg * WG_ROWS
        tiles = []
        if r0 < s:
            lo = max(0, r0 - w + 1) // BKV
            hi = (min(s, r0 + WG_ROWS) - 1) // BKV
            for kt in range(lo, hi + 1):
                k0 = kt * BKV
                tiles.append((kt, k0 + BKV - 1 > r0 or k0 < r0 + WG_ROWS - w))
        out.append((r0, tiles))
    return out


@functools.lru_cache(maxsize=1024)
def _launch_plan(b, h, kv, s, d, window, dtype):
    """The plan of a call and its fields as the C array the kernel takes,
    kept per distinct call."""
    q = plan(b, h, kv, s, d, window, dtype)
    return q, (ctypes.c_int * len(PLAN_FIELDS))(*(q[f] for f in PLAN_FIELDS))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           what: str = "swa_attention") -> None:
    """Raise ValueError for operands the kernels do not take."""
    if window < 1:
        raise ValueError(f"{what} needs a window >= 1, got {window}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q/k must be [B, H, S, D], got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if kvh == 0 or h % kvh or tuple(k.shape) != (b, kvh, s, d) \
            or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need k/v [B, KV, S, D] with "
                         "H % KV == 0")
    if d % 8 or d > 256:
        raise ValueError(f"{what} takes a head dim D % 8 == 0 up to "
                         f"256, got D={d}")
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         "need one of float32, bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what} needs CUDA tensors on one "
                             f"device, got {name} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} exceeds the grid's 65535")


def _call(fn, dev: int, *args) -> int:
    """``fn(*args, stream)`` on device ``dev``'s current raw stream (as
    PyTorch's own Triton launcher reads it)."""
    if dev == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, return_lse: bool = False):
    """q: [B, H, S, D]; k/v: [B, KV, S, D] in q's dtype (float32 or
    bfloat16), contiguous, ``H % KV == 0``, ``D % 8 == 0`` and ``D <= 256``;
    ``window >= 1``.  Returns [B, H, S, D] in q's dtype, and with
    ``return_lse`` also each row's log-sum-exp of its scaled scores, fp32
    [B, H, S] in natural log units (the output's bits are the same)."""
    global launches
    window = int(window)
    _check(q, k, v, window)
    b, h, s, d = q.shape
    kvh = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0 or s == 0:
        return (out, lse) if return_lse else out
    pl, fields = _launch_plan(b, h, kvh, s, d, window, q.dtype)
    err = _call(_library().swa_attention, q.get_device(), q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), fields,
                len(PLAN_FIELDS), 1.0 / math.sqrt(d))
    if err:
        raise RuntimeError(f"swa_attention launch failed: CUDA error {err} "
                           f"(B={b} H={h} KV={kvh} S={s} D={d} W={window} "
                           f"{q.dtype}; plan {describe(pl)})")
    launches += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("swa_attention_bwd")
        fn = lib.swa_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.swa_attention_bwd_plan_fields.restype = ctypes.c_char_p
        theirs = lib.swa_attention_bwd_plan_fields().decode().rstrip(",")
        if theirs != ",".join(BWD_PLAN_FIELDS):
            raise RuntimeError(
                "swa_attention_bwd.cu's plan fields differ from "
                f"BWD_PLAN_FIELDS: {theirs} != {','.join(BWD_PLAN_FIELDS)}")
        _bwd_lib = lib
    return _bwd_lib


def _bwd_smem(d: int, dp: int, stages: int = 0) -> int:
    """The backward kernel's shared memory.  float32 (``fp32::Geometry``
    in swa_attention_bwd.cu): the Q, dO, K and V tiles of 32 rows at stride
    D + 1, the P and dS tiles at stride 33, two [32, D] accumulators and the
    rows' lse and delta, each region 128-byte aligned.  bfloat16
    (``wg::smem_bytes``, ``dp`` > 0): the block's two fixed [64, DP] tiles,
    two P hand-off buffers, ``stages`` ring stages of two [64, DP] tiles and
    the rows' stats, and the alignment and barriers."""
    if dp:
        tile = dp // 64 * BWD_BOX
        return (2 * tile + 2 * BWD_XBUF + stages * (2 * tile + BWD_STATS)
                + RESERVED)
    tile = round_up(4 * 32 * (d + 1), 128)
    ptile = round_up(4 * 32 * 33, 128)
    acc = round_up(4 * 32 * d, 128)
    return 4 * tile + 2 * ptile + 2 * acc + round_up(4 * 2 * 32, 128)


def plan_bwd(b: int, h: int, kv: int, s: int, d: int, window: int,
             dtype=torch.bfloat16) -> dict:
    """How one backward call runs on the card: every field of
    :data:`BWD_PLAN_FIELDS`.  One dK/dV block per (b * KV, key tile) and
    one dQ block per (b * H, q tile), in one grid, the dK/dV blocks first;
    ``smem`` is what both kinds share.  bfloat16 takes the ``wgmma`` path
    with D padded to DP = 64, 128 or 256 columns and as many ring stages
    (2-4) as fit, float32 the FMA path (:data:`BWD_TILES`); both do
    ``ops`` = :data:`BWD_OPS` operations per in-window pair and dim.
    Raises ValueError for a call the kernel does not take."""
    if dtype not in _DTYPE:
        raise ValueError(f"swa_attention_bwd dtype {dtype}: needs float32 or "
                         "bfloat16")
    if (b < 1 or kv < 1 or h % kv or s < 1 or d < 8 or d % 8 or d > 256
            or window < 1):
        raise ValueError(f"swa_attention_bwd shape B={b} H={h} KV={kv} S={s} "
                         f"D={d} W={window}")
    path = PATH_MMA if dtype == torch.bfloat16 else PATH_FMA
    dp = (64 if d <= 64 else 128 if d <= 128 else 256) if path else 0
    stages = 0
    if path:
        tile = dp // 64 * BWD_BOX
        stages = min(BWD_STAGES_MAX,
                     (SMEM_BUDGET - _bwd_smem(d, dp, 0))
                     // (2 * tile + BWD_STATS))
    bq, bkv, _ = BWD_TILES[path]
    qtiles, kvtiles = ceil_div(s, bq), ceil_div(s, bkv)
    q = dict(path=path, B=b, H=h, KV=kv, S=s, D=d, W=int(window), DP=dp,
             stages=stages, qtiles=qtiles, kvtiles=kvtiles,
             dq_blocks=b * h * qtiles, dkv_blocks=b * kv * kvtiles,
             ops=BWD_OPS, smem=_bwd_smem(d, dp, stages))
    if q["smem"] > SMEM_BUDGET or (path and stages < 2):
        raise ValueError(f"swa_attention_bwd needs {q['smem']} bytes of "
                         f"shared memory at D={d}, over {SMEM_BUDGET}")
    return q


def describe_bwd(q: dict) -> str:
    """One line for a log: the route, tiles, blocks and shared memory."""
    bq, bkv, bqs = BWD_TILES[q["path"]]
    route = (f"wgmma bf16, D padded to {q['DP']}, {q['stages']} stages"
             if q["path"] else "fp32 FMA")
    return (f"{route}, dQ {bq} rows x {bkv}-key tiles, dK/dV {bkv} keys x "
            f"{bqs}-row steps, {q['dkv_blocks']} dK/dV + {q['dq_blocks']} "
            f"dQ blocks, {q['ops']} ops a pair and dim, smem {q['smem']}")


def bwd_tile_walk(q: dict) -> tuple[dict, dict]:
    """Both walks of the backward kernel, as its loops compute them: the dQ
    walk ``{q tile: [kv tiles]}`` (from the window's first tile of the
    tile's first row to the diagonal of its last) and the dK/dV walk
    ``{kv tile: [(query head of the group, q step)]}`` (the group's heads
    in order, each over the q steps of rows ``k0 .. k0 + BKV - 1 + W - 1``,
    clipped at S), in the plan's path's :data:`BWD_TILES`."""
    s, w, g = q["S"], min(q["W"], q["S"]), q["H"] // q["KV"]
    bq, bkv, bqs = BWD_TILES[q["path"]]
    dq = {}
    for qt in range(q["qtiles"]):
        q0 = qt * bq
        lo = max(0, q0 - w + 1) // bkv
        hi = (min(s, q0 + bq) - 1) // bkv
        dq[qt] = list(range(lo, hi + 1))
    dkv = {}
    for kt in range(q["kvtiles"]):
        k0 = kt * bkv
        lo = k0 // bqs
        hi = min(s - 1, k0 + bkv - 1 + w - 1) // bqs
        dkv[kt] = [(gi, qt) for gi in range(g) for qt in range(lo, hi + 1)]
    return dq, dkv


@functools.lru_cache(maxsize=1024)
def _launch_plan_bwd(b, h, kv, s, d, window, dtype):
    q = plan_bwd(b, h, kv, s, d, window, dtype)
    return q, (ctypes.c_int * len(BWD_PLAN_FIELDS))(
        *(q[f] for f in BWD_PLAN_FIELDS))


def swa_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor,
                      lse: torch.Tensor, *, window: int):
    """The gradient of :func:`swa_attention`: q, out and dout [B, H, S, D],
    k/v [B, KV, S, D], all of one dtype (float32 or bfloat16) and
    contiguous on the card; ``lse`` the forward's fp32 [B, H, S].  Returns
    (dq, dk, dv) in q's dtype, summed in fp32 in a fixed order."""
    global bwd_launches
    window = int(window)
    _check(q, k, v, window, "swa_attention_bwd")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 {(b, h, s)} on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or s == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    pl, fields = _launch_plan_bwd(b, h, kvh, s, d, window, q.dtype)
    err = _call(_bwd_library().swa_attention_bwd, q.get_device(),
                *(t.data_ptr() for t in (q, k, v, out, dout, lse, dq, dk, dv,
                                         delta)),
                fields, len(BWD_PLAN_FIELDS), 1.0 / math.sqrt(d))
    if err:
        raise RuntimeError(f"swa_attention_bwd launch failed: CUDA error "
                           f"{err} (B={b} H={h} KV={kvh} S={s} D={d} "
                           f"W={window} {q.dtype}; plan {describe_bwd(pl)})")
    bwd_launches += 1
    return dq, dk, dv
