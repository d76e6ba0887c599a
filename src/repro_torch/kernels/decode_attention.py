"""``decode_attention`` on Hopper: the hand-written CUDA kernel
``csrc/decode_attention.cu`` behind a checked Python wrapper and its
planner, and the int8 KV quantizer the dense and paged caches store with.

It replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``: one-token GQA
flash-decode over a dense ``[B, KV, S, D]`` cache with per-slot positions, a
sliding-window mask and int8 K/V dequantized in registers.  :func:`plan`
splits the sequence across blocks (flash-decoding) until the grid reaches
about one block per SM: block (slot, KV head, split) holds that head's
query rows, walks its chunk of 32-entry tiles and keeps the online-softmax
state in fp32, and a second kernel combines the splits in a fixed order.  A
ragged last tile is masked in the kernel, so the TPU's ``_divisible_block``
(pick a KV block that divides S, or pad the whole cache) has no
counterpart.  A slot with no live entry gives exact zeros, as the plain
version does.  The wrapper takes CUDA tensors only and launches the kernel
or raises; the plain version is
:func:`repro_torch.kernels.ref.decode_attention`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.elastic import SMEM_BUDGET, ceil_div
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import _DTYPE, _check, _int32_on
from repro_torch.kernels.ref import quantize_kv  # noqa: F401  (re-exported)

#: launches of the kernel in this process (one per call, the combine
#: included); callers may reset it to 0
launches = 0

#: the H100's streaming multiprocessors: the planner's default
SMS = 132
#: entries a tile: one per lane of the warp that scores them
TILE = 32

#: the kernel's plan, in this order (``DECODE_ATTENTION_PLAN`` in
#: decode_attention.cu, which the library reports and :func:`_library`
#: checks)
PLAN_FIELDS = ("B", "H", "KV", "S", "D", "G", "ntiles", "splits", "tps",
               "blocks", "smem")

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 9
                       + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_attention_plan_fields.restype = ctypes.c_char_p
        theirs = lib.decode_attention_plan_fields().decode().rstrip(",")
        if theirs != ",".join(PLAN_FIELDS):
            raise RuntimeError(
                "decode_attention.cu's plan fields differ from PLAN_FIELDS: "
                f"{theirs} != {','.join(PLAN_FIELDS)}")
        _lib = lib
    return _lib


def smem_bytes(g: int, d: int) -> int:
    """Shared memory of one block (``Geometry`` in the .cu): the query rows
    and the output accumulator [G, D] padded to a float4, the fp32 K and V
    tiles [32, D] at an odd float4 row stride, the tile's weights [G, 32],
    (m, l, alpha) per row and the tile's live flags."""
    d4 = ceil_div(d, 4)
    ldk = 4 * (d4 if d4 % 2 else d4 + 1)
    return 4 * (2 * g * 4 * d4 + 2 * TILE * ldk + g * TILE + 3 * g + TILE)


def plan(b: int, h: int, kv: int, s: int, d: int, dtype=torch.int8, *,
         sms: int = SMS) -> dict:
    """How one call runs on the card: every field of :data:`PLAN_FIELDS`.

    ``dtype`` is the cache's (float32, bfloat16 or int8).  The sequence of
    ``ntiles`` 32-entry tiles is split into ``splits`` chunks of ``tps``
    tiles, none empty, so that ``B * KV * splits`` reaches ``sms`` (one
    block per SM; the walk is latency-bound, not byte-bound) or every split
    holds one tile; when ``B * KV`` alone fills the card the sequence is not
    split.  Raises ValueError for a call the kernel does not take."""
    if dtype not in _DTYPE:
        raise ValueError(f"decode_attention cache dtype {dtype}")
    if b < 1 or kv < 1 or h < kv or h % kv or d < 1 or s < 0:
        raise ValueError(f"decode_attention shape B={b} H={h} KV={kv} S={s} "
                         f"D={d}")
    g = h // kv
    ntiles = ceil_div(s, TILE)
    base = b * kv
    # the most tiles a split that still gives ceil(sms / base) splits
    tps = max(1, ntiles // ceil_div(sms, base)) if base < sms else ntiles
    splits = ceil_div(ntiles, tps) if ntiles else 1
    smem = smem_bytes(g, d)
    if smem > SMEM_BUDGET:
        raise ValueError(f"decode_attention: {g} query rows of D={d} need "
                         f"{smem} bytes of shared memory (> {SMEM_BUDGET})")
    if base * splits > 2 ** 31 - 1:
        raise ValueError(f"decode_attention: {base * splits} blocks exceed "
                         "one grid")
    return dict(B=b, H=h, KV=kv, S=s, D=d, G=g, ntiles=ntiles, splits=splits,
                tps=tps, blocks=base * splits, smem=smem)


def describe(q: dict) -> str:
    """One line for a log: the split and the blocks."""
    return (f"{q['splits']} splits of {q['tps']} x {TILE} entries, "
            f"{q['blocks']} blocks of {q['G']} rows, smem {q['smem']}")


def chunks(q: dict) -> list[tuple[int, int]]:
    """The entries ``[start, stop)`` each split walks, in split order."""
    return [(z * q["tps"] * TILE, min(q["S"], (z + 1) * q["tps"] * TILE))
            for z in range(q["splits"])]


@functools.lru_cache(maxsize=1024)
def _launch_plan(b, h, kv, s, d, kv_dtype, device):
    """The plan of a call on CUDA device ``device`` and its fields as the C
    array the kernel takes, kept per distinct call."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q = plan(b, h, kv, s, d, kv_dtype, sms=sms)
    return q, (ctypes.c_int * len(PLAN_FIELDS))(*(q[f] for f in PLAN_FIELDS))


def decode_attention(q, k, v, *, kv_pos, q_pos, k_scale=None, v_scale=None,
                     window: int = 0) -> torch.Tensor:
    """q: [B, H, D]; k/v: [B, KV, S, D] in q's dtype, or int8 with fp32
    scales [B, KV, S]; kv_pos: [S] shared or [B, S] per slot (int32,
    -2^30 = empty); q_pos: a scalar or [B].  Returns [B, H, D] in q's
    dtype.

    A plan that splits the sequence launches two kernels, counted as one
    call: the splits' partial (m, l, acc) into an fp32 scratch tensor
    allocated here, then their fixed-order combine."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention needs CUDA tensors, got "
                         f"{q.device}")
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    dev = q.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if q.dtype not in (torch.float32, torch.bfloat16) or h % kvh:
        raise ValueError(f"q {q.dtype} with {h} heads over {kvh} KV heads")
    quant = k_scale is not None
    kv_dtype = torch.int8 if quant else q.dtype
    _check("q", q, (b, h, d), q.dtype, dev)
    _check("k", k, (b, kvh, s, d), kv_dtype, dev)
    _check("v", v, (b, kvh, s, d), kv_dtype, dev)
    if quant:
        _check("k_scale", k_scale, (b, kvh, s), torch.float32, dev)
        _check("v_scale", v_scale, (b, kvh, s), torch.float32, dev)
    kvp = _int32_on(kv_pos, dev)
    if tuple(kvp.shape) not in ((s,), (b, s)):
        raise ValueError(f"kv_pos shape {tuple(kvp.shape)}, expected ({s},) "
                         f"or ({b}, {s})")
    pos_stride = s if kvp.dim() == 2 else 0
    qp = _int32_on(q_pos, dev).reshape(-1)
    if qp.numel() not in (1, b):
        raise ValueError(f"q_pos of {qp.numel()} for B={b}")
    q_stride = 1 if qp.numel() == b and b > 1 else 0
    out = torch.empty_like(q)
    if b == 0:
        return out
    pl, fields = _launch_plan(b, h, kvh, s, d, kv_dtype, dev)
    part = None
    if pl["splits"] > 1:
        part = torch.empty(b * h * pl["splits"] * (d + 2),
                           dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            kvp.data_ptr(), qp.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), fields,
            len(PLAN_FIELDS), pos_stride, q_stride, int(window),
            1.0 / math.sqrt(d), _DTYPE[q.dtype], _DTYPE[kv_dtype])
    lib = _library()
    # the raw current stream, as PyTorch's own Triton launcher reads it
    if dev.index == torch._C._cuda_getDevice():
        err = lib.decode_attention(
            *args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = lib.decode_attention(
                *args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err} (B={b} H={h} KV={kvh} S={s} D={d} "
                           f"{q.dtype}/{kv_dtype}; plan {describe(pl)})")
    launches += 1
    return out
