"""``kraken_gemm`` on Hopper: the hand-written CUDA kernel
``csrc/kraken_gemm.cu`` behind a checked Python wrapper and its tile planner.

It replaces the Pallas TPU kernel ``repro.kernels.kraken_gemm.kraken_gemm``:
``act(a @ b + bias)`` with fp32 accumulation and the epilogue fused, for
bfloat16 and float32.  The TPU's two schedules and its tile plan are not
carried over; the kernel masks ragged M/N/K edges itself, so nothing is
padded.

:func:`plan` lays one call onto the card (the kernel takes its plan as a
list of ints, :data:`PLAN_FIELDS`).  bfloat16 runs on ``wgmma``: an output
tile of ``BM`` (64 or 128) x ``BN`` (64, 128 or 256), a TMA ring of
``stages`` 64-deep K steps (A [BM, 64] and B [64, BN] as they lie in memory,
128-byte swizzled), and a split of K over blocks when the tiles alone leave
SMs idle, the partials summed in a fixed order by a second kernel.  An
operand whose base or row stride is not a multiple of 16 bytes, which TMA
refuses, is filled by the producer warps instead (``fill_a``, ``fill_b``).
float32 keeps the first port's FMA kernel, with no TF32.  The wrapper takes
CUDA tensors only and launches the kernel or raises; the plain version is
:func:`repro_torch.kernels.ref.matmul`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.elastic import ceil_div
from repro_torch.kernels import _build

#: launches of the kernel in this process (one per call, the split's sum
#: included); callers may reset it to 0
launches = 0

#: shared memory one block may use on an H100 (bytes)
SMEM_MAX = 227 * 1024
#: the H100's streaming multiprocessors: the planner's default
SMS = 132
#: K per ring stage: one 128-byte swizzled row of 64 bf16 elements
KB = 64
ROW = 128
#: the tiles the bf16 kernel is built for
TILE_M = (64, 128)
TILE_N = (64, 128, 256)
#: ring stages, at most; bytes kept for the barriers and the 1024-byte
#: alignment
STAGES_MAX = 5
RESERVED = 2048
#: plan paths
PATH_FMA, PATH_WGMMA = 0, 1
#: the planner's cost model, in SM cycles of an H100 (1.755 GHz): HBM's
#: 3.35 TB/s in bytes a cycle; the bytes a cycle one SM is fed from HBM
#: (about its share of that) and from L2; a block's ring fill and
#: epilogue; the split's second launch
HBM_BYTES = 1900
FEED_HBM, FEED_L2 = 16, 56
BLOCK_CYCLES, REDUCE_CYCLES = 1000, 4000

#: the kernel's plan, in this order (``KRAKEN_GEMM_PLAN`` in kraken_gemm.cu,
#: which the library reports and :func:`_library` checks)
PLAN_FIELDS = ("path", "M", "N", "K",
               # bfloat16: the wgmma kernel
               "BM", "BN", "stages", "nk", "split", "kps", "mtiles", "ntiles",
               "tiles", "fill_a", "fill_b", "smem")

_ACT = {None: 0, "relu": 1, "silu": 2, "gelu": 3}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("kraken_gemm")
        fn = lib.kraken_gemm
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.kraken_gemm_plan_fields.restype = ctypes.c_char_p
        theirs = lib.kraken_gemm_plan_fields().decode().rstrip(",")
        if theirs != ",".join(PLAN_FIELDS):
            raise RuntimeError(
                "kraken_gemm.cu's plan fields differ from PLAN_FIELDS: "
                f"{theirs} != {','.join(PLAN_FIELDS)}")
        _lib = lib
    return _lib


def tma_takes(align: int, row_elems: int) -> bool:
    """Whether TMA takes a 2-D bf16 operand whose data starts ``align``-byte
    aligned and whose rows hold ``row_elems`` elements: both the base and
    the row stride must be multiples of 16 bytes."""
    return align % 16 == 0 and (2 * row_elems) % 16 == 0


def _splits(nk: int) -> list[int]:
    """The split counts a K of ``nk`` steps can take: each split gets
    ceil(nk / s) steps and none is empty."""
    return sorted({ceil_div(nk, ceil_div(nk, s)) for s in range(1, nk + 1)})


def _plan_wgmma(m: int, k: int, n: int, *, sms: int, a_align: int,
                b_align: int) -> dict:
    """bfloat16: the tile, ring and split of least estimated time.

    The estimate is in SM cycles (the constants above, chosen against the
    device times ``tools/gemm_sweep.py`` takes of every tile and split at
    the yi-6b decode and mixed-step and the gemma3 forward shapes on an
    H100).  A 64-deep K step of a block takes the longer of its
    tensor-core work (BM x BN / 32 cycles: 4096 FLOP a cycle) and its bytes
    (the A rows and B columns inside the matrix) at the rate an SM is fed:
    its share of HBM when it is the only row tile (each weight byte read by
    one block, as at decode), L2's rate when row tiles share the operands.
    Blocks run in waves of ``sms``, each adds ``BLOCK_CYCLES``; the whole
    call takes at least its bytes at HBM's rate.  A split adds the partials'
    bytes to the kernel's and a second launch that reads them back.  K is
    split only when the tiles alone number fewer than ``sms``.  Ties go to
    fewer tiles, less split, less padded area (at M <= 64 the 64-row tile),
    the wider tile.
    """
    nk = ceil_div(k, KB)
    fill_a = int(not tma_takes(a_align, k))
    fill_b = int(not tma_takes(b_align, n))
    best = None
    for bm in TILE_M:
        for bn in TILE_N:
            stage = (bm + bn) * ROW
            stages = min(STAGES_MAX, (SMEM_MAX - RESERVED) // stage)
            mtiles, ntiles = ceil_div(m, bm), ceil_div(n, bn)
            mn = mtiles * ntiles
            feed = FEED_HBM if mtiles == 1 else FEED_L2
            step = max(bm * bn / 32, (min(bm, m) + min(bn, n)) * ROW / feed)
            for split in (_splits(nk) if mn < sms and nk > 1 else [1]):
                kps = ceil_div(nk, split)
                tiles = mn * split
                out_bytes = m * n * (2 if split == 1 else 4 * split)
                est = max(ceil_div(tiles, sms) * (kps * step + BLOCK_CYCLES),
                          (2 * (m * k + k * n) + out_bytes) / HBM_BYTES)
                if split > 1:
                    est += (4 * split + 2) * m * n / HBM_BYTES + REDUCE_CYCLES
                key = (est, tiles, split, mtiles * bm * ntiles * bn, -bn)
                if best is None or key < best[0]:
                    best = (key, dict(
                        path=PATH_WGMMA, BM=bm, BN=bn, stages=stages, nk=nk,
                        split=split, kps=kps, mtiles=mtiles, ntiles=ntiles,
                        tiles=tiles, fill_a=fill_a, fill_b=fill_b,
                        smem=stages * stage + RESERVED))
    return best[1]


def plan(m: int, k: int, n: int, *, dtype=torch.bfloat16, sms: int = SMS,
         a_align: int = 16, b_align: int = 16) -> dict:
    """How one ``[m, k] @ [k, n]`` call runs on the card: every field of
    :data:`PLAN_FIELDS` (the wgmma fields are 0 for float32).  ``sms`` is
    the card's SM count, ``a_align`` and ``b_align`` the byte alignment of
    the operands' data.  Raises ValueError for a call the kernel does not
    take."""
    if dtype not in _DTYPE:
        raise ValueError(f"kraken_gemm dtype {dtype}: needs bfloat16 or "
                         "float32")
    if m < 1 or n < 1 or k < 0:
        raise ValueError(f"kraken_gemm shape M={m} K={k} N={n}")
    q = dict.fromkeys(PLAN_FIELDS, 0)
    q.update(M=int(m), N=int(n), K=int(k))
    if dtype == torch.float32:
        if ceil_div(m, 64) > 65535:
            raise ValueError(f"kraken_gemm float32: M={m} needs more than "
                             "65535 row blocks")
        q["path"] = PATH_FMA
        return q
    q.update(_plan_wgmma(int(m), int(k), int(n), sms=sms, a_align=a_align,
                         b_align=b_align))
    if q["tiles"] > 2 ** 31 - 1:
        raise ValueError(f"kraken_gemm: {q['tiles']} tiles exceed one grid")
    return q


def describe(q: dict) -> str:
    """One line for a log: the plan's tile, ring, split, fill and blocks."""
    if q["path"] == PATH_FMA:
        return "fp32 FMA tile 64x64"
    fill = ("A and B filled" if q["fill_a"] and q["fill_b"] else
            "A filled" if q["fill_a"] else "B filled" if q["fill_b"] else
            "TMA")
    return (f"{q['BM']}x{q['BN']} {q['stages']} stages split {q['split']} "
            f"({q['kps']} of {q['nk']} k-steps) {q['tiles']} blocks "
            f"{fill} smem {q['smem']}")


def _ptr_align(ptr: int) -> int:
    return min(ptr & -ptr, 16) if ptr else 16


def alignment(t: torch.Tensor) -> int:
    """The byte alignment of ``t``'s data, at most 16 (what TMA asks)."""
    return _ptr_align(t.data_ptr())


@functools.lru_cache(maxsize=4096)
def _launch_plan(m, k, n, dtype, device, a_align, b_align):
    """The plan of a call on CUDA device ``device`` and its fields as the C
    array the kernel takes, kept per distinct call."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q = plan(m, k, n, dtype=dtype, sms=sms, a_align=a_align,
             b_align=b_align)
    return q, (ctypes.c_int * len(PLAN_FIELDS))(*(q[f] for f in PLAN_FIELDS))


def kraken_gemm(a: torch.Tensor, b: torch.Tensor, *,
                bias: torch.Tensor | None = None,
                activation: str | None = None) -> torch.Tensor:
    """``act(a @ b + bias)``: a [M, K], b [K, N], bias [N] (or [1, N]);
    out [M, N] in ``a.dtype``.  All on one CUDA device, a and b contiguous
    and of one dtype (bfloat16 or float32).

    A bf16 plan that splits K launches two kernels, counted as one call:
    the split products into an fp32 scratch tensor allocated here, then
    their fixed-order sum with bias and the activation."""
    global launches
    if not (a.is_cuda and b.is_cuda) or a.get_device() != b.get_device():
        raise ValueError(f"kraken_gemm needs CUDA tensors on one device, got "
                         f"{a.device} and {b.device}")
    sa, sb = a.shape, b.shape
    if len(sa) != 2 or len(sb) != 2 or sa[1] != sb[0]:
        raise ValueError(f"kraken_gemm shapes {tuple(sa)} @ {tuple(sb)}")
    dtype = a.dtype
    if dtype not in _DTYPE or b.dtype != dtype:
        raise ValueError(f"kraken_gemm dtypes {dtype}, {b.dtype}: needs "
                         "both bfloat16 or both float32")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("kraken_gemm needs contiguous operands")
    if activation not in _ACT:
        raise ValueError(activation)
    m, k = sa
    n = sb[1]
    dev = a.get_device()
    bias_ptr = None
    if bias is not None:
        bias_f = bias.reshape(-1).to(device=dev, dtype=torch.float32)
        if bias_f.numel() != n:
            raise ValueError(f"bias of {bias_f.numel()} for N={n}")
        bias_f = bias_f.contiguous()
        bias_ptr = bias_f.data_ptr()
    out = torch.empty((m, n), dtype=dtype, device=dev)
    if m == 0 or n == 0:
        return out
    pa, pb = a.data_ptr(), b.data_ptr()
    q, fields = _launch_plan(m, k, n, dtype, dev, _ptr_align(pa),
                             _ptr_align(pb))
    part = None
    if q["split"] > 1:
        part = torch.empty(q["split"] * m * n, dtype=torch.float32,
                           device=dev)
    args = (pa, pb, bias_ptr, out.data_ptr(),
            None if part is None else part.data_ptr(), fields,
            len(PLAN_FIELDS), _ACT[activation])
    lib = _library()
    # the raw current stream, as PyTorch's own Triton launcher reads it
    if dev == torch._C._cuda_getDevice():
        err = lib.kraken_gemm(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = lib.kraken_gemm(*args,
                                  torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"kraken_gemm launch failed: CUDA error {err} "
                           f"(M={m} N={n} K={k} {dtype}; plan "
                           f"{describe(q)})")
    launches += 1
    return out
