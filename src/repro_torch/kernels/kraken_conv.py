"""``kraken_conv2d_direct`` on Hopper: the hand-written CUDA kernel
``csrc/kraken_conv.cu`` behind a checked Python wrapper and its tile planner.

It replaces the Pallas TPU kernel
``repro.kernels.kraken_conv.kraken_conv2d_direct``: an NHWC x HWIO -> NHWC
convolution by the paper's dataflow, f32 or bf16 in, fp32 accumulation.
Output-stationary: every output pixel's fp32 sums stay in registers from the
first tap to the last; the input band of each channel chunk is staged once in
shared memory, the padding applied as zeros while loading, and reused by
every (kh, kw) tap (Table II's row shift), so no interleaved X_hat copy is
made.

:func:`plan` lays one call onto the card (the kernel takes its plan as a
list of ints, :data:`PLAN_FIELDS`).  bfloat16 runs on ``wgmma``: a tile of
128 output pixels (``TR`` rows x ``TC`` columns of ``G`` images; ``TR`` is a
whole number of bands of ``R`` rows, cut at the image's bottom) times ``BN``
output channels, C_i walked in 64-channel chunks, an asynchronous ring of
input bands and per-tap weight tiles, and a split of C_i over blocks when the
tiles alone leave SMs idle.  float32 keeps the fp32 FMA kernel (one block per
R rows x 16 columns x 64 channels), for parity, with no TF32.  The TPU's
output-channel tile ``bco`` is the bf16 plan's ``BN``: a caller may fix it
(64 or 128), and the tile cache may choose it with the split
(:func:`candidates`).  The wrapper takes CUDA
tensors only and launches the kernel or raises; the plain version is
:func:`repro_torch.kernels.ref.conv2d`.

:func:`shift_factor` and :func:`interleave_input` are the paper's X -> X_hat
restructure (Alg. 1, Table II) as plain torch functions, with the JAX
module's return values; the kernel reads the same rows straight from X.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import elastic
from repro_torch.core.elastic import SMEM_BUDGET, ceil_div, round_up
from repro_torch.kernels import _build

#: launches of the kernel in this process; callers may reset it to 0
launches = 0

#: output rows per band the kernel takes, at most
MAX_R = 16

#: the H100's streaming multiprocessors: the planner's default
SMS = 132
#: bf16: channels per chunk, one 128-byte swizzled row per pixel
CK = 64
#: bf16: output pixels per tile, two consumer warpgroups of 64
SLOTS = 128
#: bf16: the most band and weight stages of the ring
NB_MAX, NW_MAX = 6, 8
#: bf16: bytes kept for the barriers and the 1024-byte alignment
RESERVED = 2048
#: bf16 band fill: TMA, or 2-byte loads by the producer warpgroup where TMA
#: cannot take the rows
BAND_TMA, BAND_LD2 = 0, 1

#: the kernel's plan, in this order (``KRAKEN_CONV_PLAN`` in kraken_conv.cu,
#: which the library reports and :func:`_library` checks)
PLAN_FIELDS = (
    "path", "dtype", "out_dtype",
    "N", "H", "W", "C_i", "K_H", "K_W", "C_o", "S_H", "S_W", "pt", "pl",
    "OH", "OW",
    # float32: the FMA kernel
    "R", "L", "ck", "khs", "fBR", "fBW", "off_w", "vec",
    # bfloat16: the wgmma kernel
    "packed", "band_mode", "BN", "TR", "TC", "G", "BR", "BW", "rowlen",
    "img_bytes", "band_bytes", "NB", "NW", "kcp", "taps", "nchunks", "split",
    "cps", "rts", "cts", "ptiles", "ctiles", "tiles", "grid", "smem")
#: the fields of a bf16 plan that the tile cache may choose; every other
#: field is derived from them
CHOICE = ("BN", "split")
#: the output-channel tiles (``bco``) the bf16 kernel is built for
BCO = (64, 128)

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("kraken_conv")
        fn = lib.kraken_conv2d
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.kraken_conv_plan_fields.restype = ctypes.c_char_p
        theirs = lib.kraken_conv_plan_fields().decode().rstrip(",")
        if theirs != ",".join(PLAN_FIELDS):
            raise RuntimeError(
                "kraken_conv.cu's plan fields differ from PLAN_FIELDS: "
                f"{theirs} != {','.join(PLAN_FIELDS)}")
        _lib = lib
    return _lib


def shift_factor(k_h: int, s_h: int) -> int:
    """Paper eq. (7): F = ceil(K_H / S_H) - 1."""
    return ceil_div(k_h, s_h) - 1


def interleave_input(x: torch.Tensor, *, R: int, k_h: int, s_h: int
                     ) -> tuple[torch.Tensor, int, int]:
    """X -> X_hat (Alg. 1): [N, H, W, C] (pre-padded) -> [N*L, R+F, S_H, W,
    C], so that output row ``r`` of block ``l`` at vertical tap ``kh`` reads
    band row ``r + kh // S_H``, sub-row ``kh % S_H``: input row
    ``(l*R + r)*S_H + kh`` (Table II).  Rows past H are zeros.

    Returns (x_hat, L, OH), as ``repro.kernels.kraken_conv.interleave_input``.
    """
    n, h, w, c = x.shape
    f = shift_factor(k_h, s_h)
    oh = (h - k_h) // s_h + 1
    L = ceil_div(oh, R)
    rows_needed = L * R * s_h + f * s_h + (s_h - 1)   # the last block's halo
    if rows_needed > h:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, rows_needed - h))
    row_idx = (torch.arange(L, device=x.device)[:, None] * (R * s_h)
               + torch.arange((R + f) * s_h, device=x.device)[None, :])
    xb = x[:, row_idx]                                 # [N, L, (R+F)*S_H, W, C]
    x_hat = xb.reshape(n * L, R + f, s_h, w, c)
    return x_hat, L, oh


def check_args(x_shape, k_shape, *, stride, padding, R, bco
               ) -> tuple[int, int]:
    """Validate a direct conv's arguments (the same on every device) and
    return the output size (OH, OW)."""
    if bco is not None and bco not in BCO:
        raise ValueError(
            f"kraken_conv2d_direct: bco = {bco}, but the card's kernel has "
            f"output-channel tiles {' and '.join(map(str, BCO))} (or None: "
            "the planner's or the tile cache's pick)")
    if len(x_shape) != 4 or len(k_shape) != 4 or x_shape[3] != k_shape[2]:
        raise ValueError(f"shapes x {tuple(x_shape)}, k {tuple(k_shape)}: need "
                         "x [N, H, W, C_i] and k [K_H, K_W, C_i, C_o]")
    (s_h, s_w), ((pt, pb), (pl, pr)) = stride, padding
    if s_h < 1 or s_w < 1 or min(pt, pb, pl, pr) < 0:
        raise ValueError(f"stride {stride} must be >= 1 and padding {padding} "
                         ">= 0")
    if not 1 <= int(R) <= MAX_R:
        raise ValueError(f"R = {R}: the kernel takes 1 <= R <= {MAX_R} output "
                         "rows per band")
    oh = (x_shape[1] + pt + pb - k_shape[0]) // s_h + 1
    ow = (x_shape[2] + pl + pr - k_shape[1]) // s_w + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"the kernel {tuple(k_shape[:2])} does not fit the "
                         f"padded input of x {tuple(x_shape)}")
    return oh, ow


def _plan_fma(q: dict, *, vec: bool) -> dict:
    """float32: the largest channel chunk (32, 16 or 8), all K_H weight rows
    before one row, that fits two blocks per SM, else one block per SM."""
    r, k_h, k_w = q["R"], q["K_H"], q["K_W"]
    br, bw = (r - 1) * q["S_H"] + k_h, 15 * q["S_W"] + k_w
    ck_max = min(32, round_up(q["C_i"], 8))
    cands = [ck_max] + [c for c in (32, 16, 8) if c < ck_max]
    for limit in (100 * 1024, SMEM_BUDGET):
        for ck in cands:
            for khs in (k_h, 1):
                off_w = round_up(4 * br * bw * ck, 128)
                smem = off_w + round_up(4 * khs * k_w * ck * 68, 128)
                if smem <= limit:
                    return dict(path=0, L=ceil_div(q["OH"], r), ck=ck, khs=khs,
                                fBR=br, fBW=bw, off_w=off_w, vec=int(vec),
                                smem=smem)
    raise ValueError(f"kraken_conv2d_direct: no float32 tile of R = {r} and "
                     f"kernel {k_h}x{k_w} fits {SMEM_BUDGET} bytes of shared "
                     "memory")


def _splits(nchunks: int) -> list[int]:
    """The split counts a C_i of ``nchunks`` chunks can take: each split gets
    ceil(nchunks / s) chunks and none is empty."""
    return sorted({ceil_div(nchunks, ceil_div(nchunks, s))
                   for s in range(1, nchunks + 1)})


def _tiles(q: dict):
    """Candidate pixel tiles (TR, TC, G): TR whole bands of R rows (cut at
    the image's bottom), TC an even share of the width, G images when the
    tile holds a whole image; at most SLOTS pixels."""
    oh, ow, r = q["OH"], q["OW"], q["R"]
    m = 1
    while True:
        tr = min(m * r, oh)
        if tr > SLOTS:
            return
        for nct in range(ceil_div(ow, SLOTS // tr), ow + 1):
            tc = ceil_div(ow, nct)
            if ceil_div(ow, tc) != nct:
                continue
            whole = tr == oh and tc == ow
            most = min(q["N"], SLOTS // (tr * tc)) if whole else 1
            for g in sorted({most, max(1, most // 2), 1}):
                yield tr, tc, g
        if tr == oh:
            return
        m += 1


def _best_wgmma(q: dict, *, sms: int, x_align: int, bn_only=None,
                split_only=None):
    """bfloat16: (key, fields) of the tile, c_o tile, ring and split of
    least estimated time, the c_o tile fixed to ``bn_only`` and the split to
    ``split_only`` where given; None when no tile fits.

    The estimate is in SM cycles.  A tile takes the longer of its tensor-core
    work (k16 steps x BN cycles for two warpgroups; the 64-wide c_o tile
    costed 15% more, as it reads the band twice per product) and its bytes
    (weights and bands at 20 bytes a cycle per SM), plus 600 for its
    epilogue; every tile costs that whatever share of its SLOTS pixels is
    real.  Time is waves x that, plus 2000 to fill the ring and, for a split,
    a launch and the partials' bytes.  When the unsplit tiles number fewer
    than ``sms`` and C_i has more than one chunk, C_i is split over the
    fewest blocks that fill the card, and plans that fill it win over plans
    that do not.  Ties go to fewer tiles, less split, the wider c_o tile and
    the smaller band.
    """
    c_i, k_h, k_w, c_o = q["C_i"], q["K_H"], q["K_W"], q["C_o"]
    s_h, s_w = q["S_H"], q["S_W"]
    packed = c_i < 16 and k_w * c_i <= CK
    outs = q["N"] * q["OH"] * q["OW"] * c_o
    if packed:       # (kw, c) packed into k: one chunk, a tap per kernel row
        nchunks, taps, kcp = 1, k_h, CK
        ksteps = ceil_div(k_w * c_i, 16)
        band_mode = BAND_LD2
    else:
        nchunks, taps, kcp = ceil_div(c_i, CK), k_h * k_w, round_up(c_i, CK)
        ksteps = min(4, ceil_div(c_i, 16))
        band_mode = (BAND_TMA if c_i % 8 == 0 and x_align % 16 == 0 else
                     BAND_LD2)
    best = None
    for tr, tc, g in _tiles(q):
        br, bw = (tr - 1) * s_h + k_h, (tc - 1) * s_w + k_w
        if br > 256 or bw > 256:          # a TMA box side
            continue
        rowlen = round_up(bw * c_i + 16, 8) if packed else 0
        img = round_up(br * rowlen * 2 if packed else br * bw * 128, 1024)
        band = g * img
        rts, cts = ceil_div(q["OH"], tr), ceil_div(q["OW"], tc)
        ptiles = ceil_div(q["N"], g) * rts * cts
        for bn in ((bn_only,) if bn_only else
                   (128, 64) if c_o > 64 else (64,)):
            # bands enough to stay 8 taps ahead, then as many weight stages
            # as fit
            nb = min(NB_MAX, max(2, ceil_div(8, taps)))
            while nb > 2 and nb * band + 2 * bn * 128 > SMEM_BUDGET - RESERVED:
                nb -= 1
            nw = min(NW_MAX, (SMEM_BUDGET - RESERVED - nb * band) // (bn * 128))
            if nw < 2:
                continue
            ctiles = ceil_div(c_o, bn)
            mn = ptiles * ctiles
            split = 1
            if split_only:
                split = split_only
            elif mn < sms:
                fits = [s for s in _splits(nchunks) if mn * s >= sms]
                split = fits[0] if fits else _splits(nchunks)[-1]
            cps = ceil_div(nchunks, split)
            tiles = mn * split
            mma = (cps * taps * ksteps
                     * (bn if bn == 128 or c_o <= 64 else 1.15 * bn))
            nbytes = (cps * (taps * bn + g * br * bw) * 2 * min(c_i, CK)
                      if not packed else
                      (taps * bn * CK + g * br * rowlen) * 2)
            est = ceil_div(tiles, sms) * (max(mma, nbytes / 20) + 600) + 2000
            if split > 1:
                est += 5000 + (split + 1) * 4 * outs / (15 * sms)
            key = (nchunks > 1 and tiles < sms, est, tiles, split, -bn, band)
            if best is None or key < best[0]:
                best = (key, dict(
                    path=1, packed=int(packed), band_mode=band_mode, BN=bn,
                    TR=tr, TC=tc, G=g, BR=br, BW=bw, rowlen=rowlen,
                    img_bytes=img, band_bytes=band, NB=nb, NW=nw, kcp=kcp,
                    taps=taps, nchunks=nchunks, split=split, cps=cps,
                    rts=rts, cts=cts, ptiles=ptiles,
                    ctiles=ctiles, tiles=tiles, grid=min(tiles, sms),
                    smem=nb * band + nw * bn * 128 + RESERVED))
    return best


def _plan_wgmma(q: dict, *, sms: int, x_align: int, choice=None) -> dict:
    """bfloat16: the plan of :func:`_best_wgmma`; ``choice`` (BN, split)
    fixes the c_o tile and, unless its split is None, the split, which must
    be one :func:`_splits` gives."""
    bn = split = None
    if choice is not None:
        bn, split = choice
        nchunks = (1 if q["C_i"] < 16 and q["K_W"] * q["C_i"] <= CK
                   else ceil_div(q["C_i"], CK))
        if bn not in BCO or (split is not None
                             and split not in _splits(nchunks)):
            raise ValueError(f"kraken_conv2d_direct: (BN, split) = "
                             f"{tuple(choice)} is not a candidate plan")
    best = _best_wgmma(q, sms=sms, x_align=x_align, bn_only=bn,
                       split_only=split)
    if best is None:
        k_h, k_w = q["K_H"], q["K_W"]
        raise ValueError(
            f"kraken_conv2d_direct: no bfloat16 tile of kernel {k_h}x{k_w} "
            f"stride ({q['S_H']}, {q['S_W']}) fits a 256-pixel TMA box and "
            f"{SMEM_BUDGET} bytes of shared memory"
            + (f" with (BN, split) = {tuple(choice)}" if choice else ""))
    return best[1]


def candidates(x_shape, k_shape, *, stride=(1, 1),
               padding=((0, 0), (0, 0)), R: int = 7, dtype=torch.bfloat16,
               sms: int = SMS) -> list[dict]:
    """The plans a bf16 call may run with (the TPU's ``bco``, and the split
    over C_i): every c_o tile the planner considers with every split of C_i
    into non-empty runs of chunks, each with its best pixel tile and the
    planner's estimate ``est`` (SM cycles).  float32 has one plan: []."""
    if dtype != torch.bfloat16:
        return []
    q = _base_fields(x_shape, k_shape, stride=stride, padding=padding, R=R,
                     dtype=dtype, out_dtype=dtype)
    packed = q["C_i"] < 16 and q["K_W"] * q["C_i"] <= CK
    nchunks = 1 if packed else ceil_div(q["C_i"], CK)
    out = []
    for bn in ((128, 64) if q["C_o"] > 64 else (64,)):
        for split in _splits(nchunks):
            best = _best_wgmma(q, sms=sms, x_align=16, bn_only=bn,
                               split_only=split)
            if best is not None:
                out.append(dict(BN=bn, split=split, est=best[0][1]))
    return out




def _base_fields(x_shape, k_shape, *, stride, padding, R, dtype,
                 out_dtype) -> dict:
    """A plan's shape fields (every other field 0), the arguments checked."""
    oh, ow = check_args(x_shape, k_shape, stride=stride, padding=padding,
                        R=R, bco=None)
    if dtype not in _DTYPE or out_dtype not in _DTYPE:
        raise ValueError(f"dtypes {dtype} -> {out_dtype}: need float32 or "
                         "bfloat16")
    n, h, w, c_i = map(int, x_shape)
    k_h, k_w, _, c_o = map(int, k_shape)
    (s_h, s_w), ((pt, _), (pl, _)) = stride, padding
    q = dict.fromkeys(PLAN_FIELDS, 0)
    q.update(dtype=_DTYPE[dtype], out_dtype=_DTYPE[out_dtype], N=n, H=h, W=w,
             C_i=c_i, K_H=k_h, K_W=k_w, C_o=c_o, S_H=s_h, S_W=s_w, pt=pt,
             pl=pl, OH=oh, OW=ow, R=int(R))
    return q


def plan(x_shape, k_shape, *, stride=(1, 1), padding=((0, 0), (0, 0)),
         R: int = 7, dtype=torch.bfloat16, out_dtype=None, sms: int = SMS,
         x_align: int = 16, k_align: int = 16, choice=None) -> dict:
    """How one call runs on the card: every field of :data:`PLAN_FIELDS`
    (those of the other dtype's kernel are 0).  ``sms`` is the card's SM
    count, ``x_align`` and ``k_align`` the byte alignment of the operands'
    data; ``choice`` (bf16 only) the :data:`CHOICE` fields of one of
    :func:`candidates` -- or (BN, None), a c_o tile with the planner's
    split for it -- from which every other field is derived (None: the
    planner's pick).  Raises ValueError for a call the kernel does not
    take."""
    q = _base_fields(x_shape, k_shape, stride=stride, padding=padding, R=R,
                     dtype=dtype, out_dtype=out_dtype or dtype)
    n, ow = q["N"], q["OW"]
    c_i, c_o = q["C_i"], q["C_o"]
    if dtype == torch.float32:
        if choice is not None:
            raise ValueError("kraken_conv2d_direct float32 has one plan: no "
                             "choice")
        vec = (x_align % 16 == 0 and k_align % 16 == 0 and c_i % 4 == 0
               and c_o % 4 == 0)
        q.update(_plan_fma(q, vec=vec))
        if n * q["L"] > 65535 or ceil_div(ow, 16) > 65535:
            raise ValueError(f"kraken_conv2d_direct: grid of N * L = "
                             f"{n * q['L']} bands is too large")
    else:
        q.update(_plan_wgmma(q, sms=sms, x_align=x_align, choice=choice))
    return q


def _align(t: torch.Tensor) -> int:
    ptr = t.data_ptr()
    return min(ptr & -ptr, 16) if ptr else 16


@functools.lru_cache(maxsize=4096)
def _launch_plan(x_shape, k_shape, stride, padding, R, dtype, out_dtype, sms,
                 x_align, k_align, choice=None):
    """The plan of a call with ``choice`` (None: the planner's pick) and its
    fields as the C array the kernel takes, kept per distinct call and
    choice: planning walks every candidate tile."""
    q = plan(x_shape, k_shape, stride=stride, padding=padding, R=R,
             dtype=dtype, out_dtype=out_dtype, sms=sms, x_align=x_align,
             k_align=k_align, choice=choice)
    return q, (ctypes.c_int * len(PLAN_FIELDS))(*(q[f] for f in PLAN_FIELDS))


def _resolve_bco(x_shape, k_shape, stride, padding, R, sms, bco):
    """The bf16 choice of a call (``repro.kernels.kraken_conv._resolve_bco``):
    a caller's ``bco`` as the c_o tile with the planner's split for it;
    else the tile policy's (:func:`elastic.choose_tiles`), None for the
    planner's pick."""
    if bco is not None:
        return (int(bco), None)
    return elastic.choose_tiles(
        "conv_direct", (tuple(x_shape), tuple(k_shape), stride, padding, R),
        dtype_name="bfloat16", sms=sms)


def kraken_conv2d_direct(x: torch.Tensor, k: torch.Tensor, *,
                         stride: tuple[int, int] = (1, 1),
                         padding: tuple[tuple[int, int], tuple[int, int]] = (
                             (0, 0), (0, 0)),
                         R: int = 7, bco: int | None = None,
                         out_dtype=None,
                         choice: tuple | None = None) -> torch.Tensor:
    """x: [N, H, W, C_i]; k: [K_H, K_W, C_i, C_o] in x's dtype (float32 or
    bfloat16), contiguous, on one CUDA device; ``padding`` ((top, bottom),
    (left, right)) of zeros; ``R`` output rows per band (1..16).  Returns
    [N, OH, OW, C_o] in ``out_dtype`` (default x's dtype).

    The bf16 plan takes ``choice`` (BN, split) when given, else ``bco``
    (64 or 128) as its c_o tile, else the tile policy's choice (the
    planner's pick unless the tile cache holds a measured one); float32
    takes neither.

    bfloat16 launches three kernels, counted as one call: the weights'
    K-major copy, the convolution, and (when C_i is split) the fixed-order
    sum of the split's fp32 partials; the copy and the partials live in
    buffers this wrapper allocates."""
    global launches
    oh, ow = check_args(x.shape, k.shape, stride=stride, padding=padding,
                        R=R, bco=bco)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPE or k.dtype != x.dtype or out_dtype not in _DTYPE:
        raise ValueError(f"dtypes x {x.dtype}, k {k.dtype}, out {out_dtype}: "
                         "need one of float32, bfloat16")
    for name, t in (("x", x), ("k", k)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"kraken_conv2d_direct needs CUDA tensors on one "
                             f"device, got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, c_o = x.shape[0], k.shape[3]
    out = torch.empty((n, oh, ow, c_o), dtype=out_dtype, device=x.device)
    if n == 0 or c_o == 0:
        return out
    (s_h, s_w), ((pt, pb), (pl, pr)) = stride, padding
    stride = (int(s_h), int(s_w))
    padding = ((int(pt), int(pb)), (int(pl), int(pr)))
    sms = _build.sm_count(x.device)
    if choice is None and x.dtype == torch.bfloat16:
        choice = _resolve_bco(x.shape, k.shape, stride, padding, int(R), sms,
                              bco)
    q, fields = _launch_plan(
        tuple(x.shape), tuple(k.shape), stride, padding, int(R), x.dtype,
        out_dtype, sms, _align(x), _align(k),
        None if choice is None else tuple(choice))
    # bf16: one scratch buffer holds the weights' K-major copy and, for a
    # split, the fp32 partials
    scratch = wt = part = None
    if q["path"] == 1:
        wt_bytes = q["taps"] * c_o * q["kcp"] * 2
        part_bytes = q["split"] * n * oh * ow * c_o * 4 if q["split"] > 1 \
            else 0
        scratch = torch.empty(round_up(wt_bytes, 256) + part_bytes,
                              dtype=torch.uint8, device=x.device)
        wt = scratch.data_ptr()
        part = wt + round_up(wt_bytes, 256) if part_bytes else None
    lib = _library()
    # the raw current stream, as PyTorch's own Triton launcher reads it:
    # torch.cuda.current_stream() costs a fifth of a batch-1 call's host time
    dev = x.device.index
    if dev == torch.cuda.current_device():
        err = lib.kraken_conv2d(x.data_ptr(), k.data_ptr(), out.data_ptr(),
                                wt, part, fields, len(PLAN_FIELDS),
                                torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(x.device):
            err = lib.kraken_conv2d(x.data_ptr(), k.data_ptr(),
                                    out.data_ptr(), wt, part, fields,
                                    len(PLAN_FIELDS),
                                    torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(
            f"kraken_conv2d_direct launch failed: CUDA error {err} (x "
            f"{tuple(x.shape)} k {tuple(k.shape)} stride {tuple(stride)} "
            f"padding {tuple(padding)} R={R} {x.dtype})")
    launches += 1
    return out
