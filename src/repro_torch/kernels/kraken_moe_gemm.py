"""``grouped_moe_gemm`` on Hopper: the hand-written CUDA kernel
``csrc/grouped_moe_gemm.cu`` behind a checked Python wrapper and its
planner, and the expert FFN built from it.

It replaces the Pallas TPU kernel
``repro.kernels.kraken_moe_gemm.grouped_moe_gemm``: every expert's
``xs[e, :sizes[e]] @ w[e]`` over the ``[E, C, d]`` capacity buffer in one
call, with ``sizes`` read on the device only, no weight byte of a dead tile
read (an empty expert reads no weights) and rows past ``sizes[e]`` exactly
zero.  The TPU's ``block_rows`` has its counterpart in the wgmma route's
row tile ``BM``, which the tile cache may choose with the most splits of d
(:func:`candidates`); its lane padding has none.

:func:`plan` lays one call onto the card (the kernel takes its plan as a
list of ints, :data:`PLAN_FIELDS`) and names its route:

* ``wgmma`` (bfloat16 where TMA takes both operands: ``d`` and ``f``
  multiples of 8, 16-byte aligned data): a persistent grid of one block
  per SM walks the live tiles it finds in ``sizes``, each 64 x 256 when
  C <= 64 and 128 x 128 above (:data:`TILES`), through a TMA ring of
  ``stages`` 64-deep steps over d and SS ``wgmma`` on the weights as they
  lie.  When the live tiles alone leave SMs idle the kernel splits d, up to
  the plan's ``split`` (:func:`live_split`), and a second kernel sums the
  fp32 partials in a fixed order;
* ``tile`` (float32, int8, and bfloat16 that TMA cannot take): the first
  port's 64 x 64 tile loop, unchanged.

The wrapper takes CUDA tensors only and launches the kernel or raises; the
plain versions are :func:`repro_torch.kernels.ref.grouped_moe_gemm` and
:func:`repro_torch.kernels.ref.grouped_expert_ffn`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import elastic
from repro_torch.core.elastic import SMEM_BUDGET, ceil_div
from repro_torch.kernels import _build, ref

#: launches of the kernel in this process (one per call, the split's sum
#: included); callers may reset it to 0
launches = 0

#: the H100's streaming multiprocessors: the planner's default
SMS = 132
#: d per ring stage: one 128-byte swizzled row of 64 bf16 elements
KB = 64
ROW = 128
#: the bf16 kernel's tiles, BM -> BN: 64 x 256 at decode (a 32 KB weight
#: box a stage, the fewest, largest loads), 128 x 128 where C > 64 (the
#: mixed step: wider tiles leave too few stages); narrower tiles were
#: slower at every served shape (``PERF.md`` §6).  A shape with f under BN
#: runs on these too: the weights past f load as zeros
TILES = {64: 256, 128: 128}
#: ring stages, at most; the bytes a plan keeps past its ring (alignment,
#: barriers and the live table of at most EMAX experts)
STAGES_MAX = 5
RESERVED = 6144
EMAX = 1024
#: the most splits of d a plan allows, the fewest k-steps a split gets, and
#: the most bytes of fp32 partials a call may allocate
SPLIT_MAX = 16
SPLIT_MIN_KSTEPS = 4
PART_MAX_BYTES = 64 << 20
#: the routes
PATH_TILE, PATH_WGMMA = 0, 1

#: the kernel's plan, in this order (``GROUPED_MOE_GEMM_PLAN`` in
#: grouped_moe_gemm.cu, which the library reports and :func:`_library`
#: checks)
PLAN_FIELDS = ("path", "dtype", "E", "C", "d", "f",
               # bfloat16 on wgmma
               "BM", "BN", "stages", "nk", "mtiles", "ntiles", "split",
               "blocks", "smem")
#: the fields of a wgmma plan that the tile cache may choose; every other
#: field is derived from them
CHOICE = ("BM", "split")

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("grouped_moe_gemm")
        fn = lib.grouped_moe_gemm
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.grouped_moe_gemm_plan_fields.restype = ctypes.c_char_p
        theirs = lib.grouped_moe_gemm_plan_fields().decode().rstrip(",")
        if theirs != ",".join(PLAN_FIELDS):
            raise RuntimeError(
                "grouped_moe_gemm.cu's plan fields differ from PLAN_FIELDS: "
                f"{theirs} != {','.join(PLAN_FIELDS)}")
        _lib = lib
    return _lib


def _tma_refuses(e: int, d: int, f: int, x_align: int, w_align: int):
    """Why the wgmma route cannot take a bf16 call, or None."""
    if d % 8 or f % 8:
        return f"a row of d={d} or f={f} is not a multiple of 16 bytes"
    if x_align % 16 or w_align % 16:
        return "an operand's data is not 16-byte aligned"
    if e > EMAX:
        return f"E={e} is past the live table's {EMAX}"
    return None


def _stages(bm: int, bn: int) -> int:
    return min(STAGES_MAX, (SMEM_BUDGET - RESERVED) // ((bm + bn) * ROW))


def plan(e: int, c: int, d: int, f: int, dtype=torch.bfloat16, *,
         sms: int = SMS, x_align: int = 16, w_align: int = 16,
         choice=None) -> dict:
    """How one call with ``xs [e, c, d]`` and ``w [e, d, f]`` runs on the
    card: every field of :data:`PLAN_FIELDS` (the wgmma fields are 0 on the
    tile route).  ``sms`` is the card's SM count, ``x_align`` and
    ``w_align`` the byte alignment of the operands' data; ``choice`` (the
    wgmma route only) the :data:`CHOICE` fields of one of
    :func:`candidates` (None: the planner's pick).  Raises ValueError for a
    call the kernel does not take."""
    if dtype not in _DTYPE:
        raise ValueError(f"grouped_moe_gemm dtype {dtype}: needs bfloat16, "
                         "float32 or int8")
    if e < 1 or c < 1 or d < 0 or f < 1:
        raise ValueError(f"grouped_moe_gemm shape E={e} C={c} d={d} f={f}")
    q = dict.fromkeys(PLAN_FIELDS, 0)
    q.update(dtype=_DTYPE[dtype], E=int(e), C=int(c), d=int(d), f=int(f))
    if dtype != torch.bfloat16 or _tma_refuses(e, d, f, x_align, w_align):
        if e > 65535 or ceil_div(c, 64) > 65535:
            raise ValueError(f"grouped_moe_gemm tile route: E={e} or C={c} "
                             "exceeds the grid")
        if choice is not None:
            raise ValueError("grouped_moe_gemm's tile route has one plan: no "
                             "choice")
        q["path"] = PATH_TILE
        return q
    q.update(wgmma_plan(e, c, d, f, sms=sms, choice=choice))
    return q


def _split_cap(e: int, c: int, d: int, f: int) -> int:
    """The most splits of d any plan may take: each split at least
    SPLIT_MIN_KSTEPS deep, the partials at most PART_MAX_BYTES."""
    return max(1, min(SPLIT_MAX, ceil_div(d, KB) // SPLIT_MIN_KSTEPS,
                      PART_MAX_BYTES // (4 * e * c * f)))


def wgmma_plan(e: int, c: int, d: int, f: int, *, sms: int = SMS,
               stages: int | None = None, choice=None) -> dict:
    """The wgmma route's fields with ``stages`` ring stages (by default as
    many as fit) and ``choice`` (BM, split), by default the planner's:
    what :func:`plan` builds, and what ``tools/moe_sweep.py`` times every
    depth of."""
    if choice is None:
        bm = 64 if c <= 64 else 128
    else:
        bm, split = choice
        if bm not in TILES or not 1 <= split <= _split_cap(e, c, d, f):
            raise ValueError(f"grouped_moe_gemm E={e} C={c} d={d} f={f}: "
                             f"(BM, split) = {tuple(choice)} is not a "
                             "candidate plan")
    bn = TILES[bm]
    nk, mtiles, ntiles = ceil_div(d, KB), ceil_div(c, bm), ceil_div(f, bn)
    if choice is None:
        # the most splits a call may take: enough for one live m tile's n
        # tiles to fill the grid, within _split_cap
        split = 1
        if ntiles < sms:
            split = min(ceil_div(sms, ntiles), _split_cap(e, c, d, f))
    if e * mtiles * ntiles * split > 2 ** 31 - 1:
        raise ValueError(f"grouped_moe_gemm: E={e} C={c} f={f} exceeds the "
                         "work items' count")
    stages = stages or _stages(bm, bn)
    return dict(path=PATH_WGMMA, BM=bm, BN=bn, stages=stages, nk=nk,
                mtiles=mtiles, ntiles=ntiles, split=split, blocks=int(sms),
                smem=stages * (bm + bn) * ROW + RESERVED)


def candidates(e: int, c: int, d: int, f: int, dtype=torch.bfloat16, *,
               sms: int = SMS) -> list[dict]:
    """The plans a wgmma call may run with (the TPU's ``block_rows``
    lattice, ``repro.tuning.search.moe_gemm_candidates``, on the two tiles
    the kernel has): ``BM`` 64 (64 x 256) and 128 (128 x 128), each with
    the most splits of d 1, the powers of two up to the cap and the
    planner's own; with the planner's estimate ``est``, the k-steps the
    busiest block runs when every row is live.  The tile route has no
    choice: []."""
    if dtype != torch.bfloat16 or _tma_refuses(e, d, f, 16, 16):
        return []
    pick = wgmma_plan(e, c, d, f, sms=sms)
    cap = _split_cap(e, c, d, f)
    out = []
    for bm in sorted(TILES):
        splits = {1, pick["split"]} if bm == pick["BM"] else {1}
        s = 2
        while s <= cap:
            splits.add(s)
            s *= 2
        for split in sorted(splits):
            try:
                q = wgmma_plan(e, c, d, f, sms=sms, choice=(bm, split))
            except ValueError:
                continue
            tiles = e * q["mtiles"] * q["ntiles"]
            taken = live_split(q, tiles)
            est = ceil_div(tiles * taken, q["blocks"]) * ceil_div(
                q["nk"], taken) * bm * q["BN"] / (64 * 256)
            out.append(dict(BM=bm, split=split, est=est))
    return out


def live_tiles(q: dict, sizes) -> int:
    """The work items of one split of a call with these ``sizes``: its live
    m tiles (an expert's m tile is live when it starts below the expert's
    size, clamped to [0, C]) times its n tiles."""
    return sum(ceil_div(min(max(int(s), 0), q["C"]), q["BM"])
               for s in sizes) * q["ntiles"]


def live_split(q: dict, tiles: int) -> int:
    """The splits of d the wgmma kernel takes when ``tiles`` tiles are live
    (``live_split`` in grouped_moe_gemm.cu, computed there from ``sizes``
    by both kernels): none once the live tiles fill the grid, else up to
    the plan's ``split``, each a non-empty run of k-steps."""
    if q["split"] <= 1 or tiles <= 0 or tiles >= q["blocks"]:
        return 1
    s = min(q["split"], ceil_div(q["blocks"], tiles))
    return ceil_div(q["nk"], ceil_div(q["nk"], s))


def describe(q: dict, sizes=None) -> str:
    """One line for a log: the route, and on the wgmma route the tile, ring,
    most splits and grid (with ``sizes``, also the live tiles and the split
    the kernel takes for them)."""
    if q["path"] == PATH_TILE:
        why = ("float32" if q["dtype"] == 0 else "int8" if q["dtype"] == 2
               else "TMA refuses: " + (_tma_refuses(q["E"], q["d"], q["f"],
                                                    16, 16)
                                       or "an operand's data is not 16-byte "
                                          "aligned"))
        return f"tile route, 64x64 wmma/FMA ({why})"
    out = (f"wgmma {q['BM']}x{q['BN']} {q['stages']} stages, split up to "
           f"{q['split']} of {q['nk']} k-steps, {q['blocks']} persistent "
           f"blocks, smem {q['smem']}")
    if sizes is not None:
        tiles = live_tiles(q, sizes)
        out += f"; {tiles} live tiles, split {live_split(q, tiles)}"
    return out


def _ptr_align(ptr: int) -> int:
    return min(ptr & -ptr, 16) if ptr else 16


def plan_array(q: dict):
    """A plan's fields as the C array the kernel takes."""
    return (ctypes.c_int * len(PLAN_FIELDS))(*(q[k] for k in PLAN_FIELDS))


@functools.lru_cache(maxsize=1024)
def _launch_plan(e, c, d, f, dtype, device, x_align, w_align, choice=None):
    """The plan of a call on CUDA device ``device`` with ``choice`` (None:
    the planner's pick) and its C array, kept per distinct call and
    choice."""
    q = plan(e, c, d, f, dtype, sms=_build.sm_count(device), x_align=x_align,
             w_align=w_align, choice=choice)
    return q, plan_array(q)


def run_plan(xs: torch.Tensor, w: torch.Tensor, sizes: torch.Tensor,
             q: dict, fields=None) -> torch.Tensor:
    """One call on the plan ``q`` (``fields``: its :func:`plan_array`, made
    here if not given), operands already checked: allocates the output and,
    when the plan may split, the partials, and launches on the current
    stream of their device.  The wrapper runs every call through here, and
    ``tools/moe_sweep.py`` and ``chip_smoke.py`` force plans through it.
    Raises on a launch error; counts nothing."""
    e, c, d = xs.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), device=xs.device,
                      dtype=torch.int32 if xs.dtype == torch.int8 else xs.dtype)
    part = None
    if q["split"] > 1:
        # the most partials, then 4 floats: the kernel writes the split it
        # took into the first, and the sum reads it there
        part = torch.empty(q["split"] * e * c * f + 4, dtype=torch.float32,
                           device=xs.device)
    args = (xs.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            plan_array(q) if fields is None else fields, len(PLAN_FIELDS))
    lib = _library()
    dev = xs.get_device()
    # the raw current stream, as PyTorch's own Triton launcher reads it
    if dev == torch._C._cuda_getDevice():
        err = lib.grouped_moe_gemm(*args,
                                   torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = lib.grouped_moe_gemm(
                *args, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"grouped_moe_gemm launch failed: CUDA error {err} "
                           f"(E={e} C={c} d={d} f={f} {xs.dtype}; "
                           f"{describe(q)})")
    return out


def grouped_moe_gemm(xs: torch.Tensor, w: torch.Tensor,
                     sizes: torch.Tensor, *,
                     choice: tuple | None = None) -> torch.Tensor:
    """xs [E, C, d], w [E, d, f] of one dtype (bfloat16, float32 or int8),
    sizes [E] int32, all contiguous on one CUDA device.  Returns [E, C, f]
    in ``xs.dtype`` (int32 for int8).

    The wgmma route's plan is the tile policy's
    (:func:`elastic.choose_tiles`: the planner's pick unless the tile cache
    holds a measured one), or ``choice`` (BM, split) when given.  A wgmma
    plan that may split d allocates its fp32 partials here and
    launches two kernels, counted as one call."""
    global launches
    if xs.device.type != "cuda" or w.device != xs.device \
            or sizes.device != xs.device:
        raise ValueError(f"grouped_moe_gemm needs CUDA tensors on one device, "
                         f"got {xs.device}, {w.device} and {sizes.device}")
    if xs.dim() != 3 or w.dim() != 3 or w.shape[:2] != (xs.shape[0],
                                                         xs.shape[2]):
        raise ValueError(f"grouped_moe_gemm shapes {tuple(xs.shape)} x "
                         f"{tuple(w.shape)}")
    if xs.dtype not in _DTYPE or w.dtype != xs.dtype:
        raise ValueError(f"grouped_moe_gemm dtypes {xs.dtype}, {w.dtype}: "
                         "needs both bfloat16, float32 or int8")
    if sizes.shape != (xs.shape[0],) or sizes.dtype != torch.int32:
        raise ValueError(f"sizes must be [E] int32, got {tuple(sizes.shape)} "
                         f"{sizes.dtype}")
    if not (xs.is_contiguous() and w.is_contiguous()
            and sizes.is_contiguous()):
        raise ValueError("grouped_moe_gemm needs contiguous operands")
    e, c, d = xs.shape
    f = w.shape[2]
    if e * c * f == 0:
        return torch.empty((e, c, f), device=xs.device,
                           dtype=torch.int32 if xs.dtype == torch.int8
                           else xs.dtype)
    dev = xs.get_device()
    x_align, w_align = _ptr_align(xs.data_ptr()), _ptr_align(w.data_ptr())
    if (choice is None and xs.dtype == torch.bfloat16
            and not _tma_refuses(e, d, f, x_align, w_align)):
        choice = elastic.choose_tiles("moe_gemm", (e, c, d, f),
                                      dtype_name="bfloat16",
                                      sms=_build.sm_count(dev))
    q, fields = _launch_plan(e, c, d, f, xs.dtype, dev, x_align, w_align,
                             None if choice is None else tuple(choice))
    out = run_plan(xs, w, sizes, q, fields)
    launches += 1
    return out


def grouped_expert_ffn(buf, sizes, wi_gate, wi_up, wo) -> torch.Tensor:
    """The expert FFN ``silu(x @ wi_gate) * (x @ wi_up) @ wo`` over the
    ``[E, C, d]`` capacity buffer: three kernel calls and one elementwise
    ``silu * up``."""
    gate = grouped_moe_gemm(buf, wi_gate, sizes)
    up = grouped_moe_gemm(buf, wi_up, sizes)
    return grouped_moe_gemm(ref.silu_mul(gate, up), wo, sizes)
