"""``paged_decode_attention`` on Hopper: the hand-written CUDA kernel
``csrc/paged_attention.cu`` behind a checked Python wrapper and its planner.

It replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_decode_attention``: one-token GQA
flash-decode straight off the page pools, with the page table walked inside
the kernel, dead and fully masked pages skipped, a sliding-window mask, int8
pools dequantized in registers, and exact zeros for a slot with no live
entry.  :func:`plan` splits each slot's live pages across blocks
(flash-decoding) until the grid reaches about one block per SM: block (slot,
KV head, split) reads the slot's ``q_pos`` on the device, takes its equal
share of the slot's live logical pages, streams them through a ring fed by
TMA (or, where TMA refuses the shapes, by plain loads: the plan's route) and
keeps the online-softmax state in fp32; a second kernel combines the splits
in a fixed order.  Nothing reads ``q_pos`` or the table on the host, so a
call captures in a CUDA graph.  The TPU's ``pages_per_block`` tunable has no
counterpart.  The wrapper takes CUDA tensors only and launches the kernel or
raises; the plain version is
:func:`repro_torch.kernels.ref.paged_decode_attention`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.elastic import ceil_div
from repro_torch.kernels import _build

#: launches of the kernel in this process (one per call, the combine
#: included); callers may reset it to 0
launches = 0

#: shared memory one block may use on an H100 (bytes)
SMEM_MAX = 227 * 1024
#: the H100's streaming multiprocessors: the planner's default
SMS = 132
#: the largest page and head dim the kernel takes (a TMA box side; the
#: entries and columns one lane holds)
MAX_PS = MAX_D = 256
#: consumer warps of a block (each owns query rows w, w + 8, ...)
NWARPS = 8
#: the routes that feed the ring: TMA, or the producer warp's plain loads
#: where TMA refuses the shapes or the pointers
ROUTES = ("ldg", "tma")

#: the kernel's plan, in this order (``PAGED_ATTENTION_PLAN`` in
#: paged_attention.cu, which the library reports and :func:`_library`
#: checks)
PLAN_FIELDS = ("B", "H", "KV", "D", "G", "ps", "MP", "isz", "quant", "splits",
               "share", "pps", "ring", "tma", "blocks", "smem")

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ISZ = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_plan_fields.restype = ctypes.c_char_p
        theirs = lib.paged_attention_plan_fields().decode().rstrip(",")
        if theirs != ",".join(PLAN_FIELDS):
            raise RuntimeError(
                "paged_attention.cu's plan fields differ from PLAN_FIELDS: "
                f"{theirs} != {','.join(PLAN_FIELDS)}")
        _lib = lib
    return _lib


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _int32_on(x, dev: torch.device) -> torch.Tensor:
    """``x`` as a contiguous int32 tensor on CUDA device ``dev``: ``x``
    itself when it already is one."""
    if (isinstance(x, torch.Tensor) and x.dtype is torch.int32
            and x.get_device() == dev.index and x.is_contiguous()):
        return x
    return torch.as_tensor(x, device=dev).to(torch.int32).contiguous()


def _align(x: int, a: int) -> int:
    return ceil_div(x, a) * a


def smem_bytes(q: dict) -> int:
    """Shared memory of one block (``Geometry`` in the .cu): ``ring`` slots
    of K and V (and int8's scales), each piece rounded to 128 bytes; the
    query rows and the accumulator [G, D] in fp32; m per row and each
    lane's share of l; each consumer warp's weights of a step; the share's
    pages and their live-entry masks; the ring's mbarriers and the
    live-page count."""
    nw = ceil_div(q["ps"], 32)
    page = _align(q["ps"] * q["D"] * q["isz"], 128)
    scales = _align(q["ps"] * 4, 128) if q["quant"] else 0
    at = q["ring"] * (2 * page + 2 * scales) + 8 * q["G"] * q["D"] \
        + 4 * 33 * q["G"] + 4 * NWARPS * q["pps"] * q["ps"] \
        + 4 * q["share"] * (1 + nw)
    return _align(at, 8) + 16 * q["ring"] + 16


def route(d: int, ps: int, dtype, *, aligned: bool = True) -> str:
    """``tma`` where TMA takes every operand: a K/V row of ``d * itemsize``
    bytes and, for int8, a scale row of ``ps * 4`` bytes, each a multiple
    of 16, and (``aligned``) every pool 16-byte aligned; else ``ldg``."""
    ok = (d * _ISZ[dtype]) % 16 == 0 and (dtype != torch.int8 or ps % 4 == 0)
    return "tma" if ok and aligned else "ldg"


def plan(b: int, h: int, kv: int, d: int, ps: int, mp: int,
         dtype=torch.bfloat16, *, sms: int = SMS,
         aligned: bool = True) -> dict:
    """How one call runs on the card: every field of :data:`PLAN_FIELDS`.

    ``dtype`` is the pools' (float32, bfloat16 or int8).  Each slot's live
    logical pages are split ``splits`` ways, so that ``B * KV * splits``
    reaches ``sms`` (one block per SM; the walk is latency-bound, not
    byte-bound), never more than ``mp`` ways, and not at all once ``B * KV``
    fills the card; a split takes at most ``share`` pages.  A step scores
    ``pps`` pages (32 entries where ``ps`` divides 32); the ring holds
    ``ring`` pages: two steps, at least four pages, fewer only where shared
    memory runs out.  ``tma`` is the route (:func:`route`).  Raises
    ValueError for a call the kernel does not take."""
    if dtype not in _DTYPE:
        raise ValueError(f"paged_decode_attention pool dtype {dtype}")
    if (b < 1 or kv < 1 or h < kv or h % kv or not 1 <= d <= MAX_D
            or not 1 <= ps <= MAX_PS or mp < 0):
        raise ValueError(f"paged_decode_attention shape B={b} H={h} KV={kv} "
                         f"D={d} ps={ps} MP={mp}")
    base = b * kv
    splits = 1 if base >= sms or mp <= 1 else min(mp, max(1, sms // base))
    pps = 32 // ps if ps < 32 else 1
    q = dict(B=b, H=h, KV=kv, D=d, G=h // kv, ps=ps, MP=mp,
             isz=_ISZ[dtype], quant=int(dtype == torch.int8), splits=splits,
             share=ceil_div(mp, splits), pps=pps, ring=0,
             tma=int(route(d, ps, dtype, aligned=aligned) == "tma"),
             blocks=base * splits, smem=0)
    for ring in range(max(4, 2 * pps), pps - 1, -1):
        q["ring"], q["smem"] = ring, smem_bytes({**q, "ring": ring})
        if q["smem"] <= SMEM_MAX:
            break
    else:
        raise ValueError(f"paged_decode_attention: {q['G']} query rows of "
                         f"D={d} and pages of {ps} need {q['smem']} bytes of "
                         f"shared memory (> {SMEM_MAX})")
    if q["blocks"] > 2 ** 31 - 1:
        raise ValueError(f"paged_decode_attention: {q['blocks']} blocks "
                         "exceed one grid")
    return q


def describe(q: dict) -> str:
    """One line for a log: the route, the split and the ring."""
    return (f"{ROUTES[q['tma']]}: {q['splits']} splits of <= {q['share']} "
            f"pages, {q['pps']} page(s) a step, ring of {q['ring']}, "
            f"{q['blocks']} blocks of {q['G']} rows, smem {q['smem']}")


def shares(q: dict, q_pos: int) -> list[tuple[int, int]]:
    """The logical pages ``[lo, hi)`` each split of a slot at ``q_pos``
    walks, in split order: the slot's live pages ``[0, n_live)`` cut into
    equal shares, as the kernel cuts them."""
    n_live = 0 if q_pos < 0 else min(q["MP"], q_pos // q["ps"] + 1)
    s = q["splits"]
    return [(z * n_live // s, (z + 1) * n_live // s) for z in range(s)]


@functools.lru_cache(maxsize=1024)
def _launch_plan(b, h, kv, d, ps, mp, kv_dtype, aligned, device):
    """The plan of a call on CUDA device ``device`` and its fields as the C
    array the kernel takes, kept per distinct call."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q = plan(b, h, kv, d, ps, mp, kv_dtype, sms=sms, aligned=aligned)
    return q, (ctypes.c_int * len(PLAN_FIELDS))(*(q[f] for f in PLAN_FIELDS))


def paged_decode_attention(q, k_pages, v_pages, *, pos_pages, page_table,
                           q_pos, k_scale=None, v_scale=None,
                           window: int = 0) -> torch.Tensor:
    """q: [B, H, D]; k_pages/v_pages: [n_pages, KV, ps, D] in q's dtype, or
    int8 with fp32 scales [n_pages, KV, ps]; pos_pages: [n_pages, ps] int32;
    page_table: [B, MP] int32 (entries < 0 or >= n_pages are dead); q_pos:
    a scalar or [B].  Returns [B, H, D] in q's dtype.

    A plan that splits the slots' pages launches two kernels, counted as one
    call: the splits' partial (m, l, acc) into an fp32 scratch tensor
    allocated here, then their fixed-order combine."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention needs CUDA tensors, got "
                         f"{q.device}")
    b, h, d = q.shape
    n_pages, kvh, ps, _ = k_pages.shape
    mp = page_table.shape[1]
    dev = q.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if q.dtype not in (torch.float32, torch.bfloat16) or h % kvh:
        raise ValueError(f"q {q.dtype} with {h} heads over {kvh} KV heads")
    if window < 0:
        raise ValueError(f"window {window}")
    quant = k_scale is not None
    kv_dtype = torch.int8 if quant else q.dtype
    _check("q", q, (b, h, d), q.dtype, dev)
    _check("k_pages", k_pages, (n_pages, kvh, ps, d), kv_dtype, dev)
    _check("v_pages", v_pages, (n_pages, kvh, ps, d), kv_dtype, dev)
    _check("pos_pages", pos_pages, (n_pages, ps), torch.int32, dev)
    _check("page_table", page_table, (b, mp), torch.int32, dev)
    if quant:
        _check("k_scale", k_scale, (n_pages, kvh, ps), torch.float32, dev)
        _check("v_scale", v_scale, (n_pages, kvh, ps), torch.float32, dev)
    qp = _int32_on(q_pos, dev).reshape(-1)
    if qp.numel() not in (1, b):
        raise ValueError(f"q_pos of {qp.numel()} for B={b}")
    q_stride = 1 if qp.numel() == b and b > 1 else 0
    out = torch.empty_like(q)
    if b == 0:
        return out
    pools = (k_pages, v_pages) + ((k_scale, v_scale) if quant else ())
    aligned = n_pages > 0 and all(t.data_ptr() % 16 == 0 for t in pools)
    pl, fields = _launch_plan(b, h, kvh, d, ps, mp, kv_dtype, aligned, dev)
    part = None
    if pl["splits"] > 1:
        part = torch.empty(b * h * pl["splits"] * (d + 2),
                           dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            pos_pages.data_ptr(), page_table.data_ptr(), qp.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(), fields,
            len(PLAN_FIELDS), n_pages, q_stride, int(window),
            1.0 / math.sqrt(d), _DTYPE[q.dtype], _DTYPE[kv_dtype])
    lib = _library()
    # the raw current stream, as PyTorch's own Triton launcher reads it
    if dev.index == torch._C._cuda_getDevice():
        err = lib.paged_decode_attention(
            *args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = lib.paged_decode_attention(
                *args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err} (B={b} H={h} KV={kvh} D={d} "
                           f"ps={ps} MP={mp} {q.dtype}/{kv_dtype}; plan "
                           f"{describe(pl)})")
    launches += 1
    return out
