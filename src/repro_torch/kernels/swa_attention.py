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
FMA kernel.  The wrapper takes CUDA tensors only and launches the kernel or
raises; the plain version is
:func:`repro_torch.kernels.ref.sliding_window_attention`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.elastic import SMEM_BUDGET, ceil_div, round_up
from repro_torch.kernels import _build

#: launches of the kernel in this process; callers may reset it to 0
launches = 0

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

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("swa_attention")
        fn = lib.swa_attention
        fn.argtypes = ([ctypes.c_void_p] * 4
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


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """q: [B, H, S, D]; k/v: [B, KV, S, D] in q's dtype (float32 or
    bfloat16), contiguous, ``H % KV == 0``, ``D % 8 == 0`` and ``D <= 256``;
    ``window >= 1``.  Returns [B, H, S, D] in q's dtype."""
    global launches
    window = int(window)
    if window < 1:
        raise ValueError(f"swa_attention needs a window >= 1, got {window}")
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
        raise ValueError(f"swa_attention takes a head dim D % 8 == 0 up to "
                         f"256, got D={d}")
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         "need one of float32, bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"swa_attention needs CUDA tensors on one "
                             f"device, got {name} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} exceeds the grid's 65535")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    pl, fields = _launch_plan(b, h, kvh, s, d, window, q.dtype)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), fields,
            len(PLAN_FIELDS), 1.0 / math.sqrt(d))
    lib = _library()
    # the raw current stream, as PyTorch's own Triton launcher reads it
    dev = q.get_device()
    if dev == torch._C._cuda_getDevice():
        err = lib.swa_attention(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = lib.swa_attention(*args,
                                    torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"swa_attention launch failed: CUDA error {err} "
                           f"(B={b} H={h} KV={kvh} S={s} D={d} W={window} "
                           f"{q.dtype}; plan {describe(pl)})")
    launches += 1
    return out
