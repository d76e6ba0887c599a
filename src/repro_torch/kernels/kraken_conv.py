"""``kraken_conv2d_direct`` on Hopper: the hand-written CUDA kernel
``csrc/kraken_conv.cu`` behind a checked Python wrapper.

It replaces the Pallas TPU kernel
``repro.kernels.kraken_conv.kraken_conv2d_direct``: an NHWC x HWIO -> NHWC
convolution by the paper's dataflow, f32 or bf16 in, fp32 accumulation.  One
block per (c_o tile, image, band of ``R`` output rows, 16 output columns)
keeps its outputs in fp32 accumulators from the first tap to the last; the
input band is staged once per channel chunk in shared memory, with the
padding applied as zeros while loading, and reused by every (kh, kw) tap
(Table II's row shift), so no interleaved X_hat copy is made.  The TPU's
output-channel tile ``bco`` is the kernel's own (64) and is not tunable
here.  The wrapper takes CUDA tensors only and launches the kernel or
raises; the plain version is :func:`repro_torch.kernels.ref.conv2d`.

:func:`shift_factor` and :func:`interleave_input` are the paper's X -> X_hat
restructure (Alg. 1, Table II) as plain torch functions, with the JAX
module's return values; the kernel reads the same rows straight from X.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.elastic import ceil_div
from repro_torch.kernels import _build

#: launches of the kernel in this process; callers may reset it to 0
launches = 0

#: output rows per block the kernel takes, at most
MAX_R = 16

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("kraken_conv")
        fn = lib.kraken_conv2d
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 16
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
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
    if bco is not None:
        raise ValueError(
            f"kraken_conv2d_direct takes bco=None only, got {bco}: the card's "
            "c_o tile is the kernel's own; a tunable tile is ROADMAP Queue 1 "
            "item 10")
    if len(x_shape) != 4 or len(k_shape) != 4 or x_shape[3] != k_shape[2]:
        raise ValueError(f"shapes x {tuple(x_shape)}, k {tuple(k_shape)}: need "
                         "x [N, H, W, C_i] and k [K_H, K_W, C_i, C_o]")
    (s_h, s_w), ((pt, pb), (pl, pr)) = stride, padding
    if s_h < 1 or s_w < 1 or min(pt, pb, pl, pr) < 0:
        raise ValueError(f"stride {stride} must be >= 1 and padding {padding} "
                         ">= 0")
    if not 1 <= int(R) <= MAX_R:
        raise ValueError(f"R = {R}: the kernel takes 1 <= R <= {MAX_R} output "
                         "rows per block")
    oh = (x_shape[1] + pt + pb - k_shape[0]) // s_h + 1
    ow = (x_shape[2] + pl + pr - k_shape[1]) // s_w + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"the kernel {tuple(k_shape[:2])} does not fit the "
                         f"padded input of x {tuple(x_shape)}")
    return oh, ow


def kraken_conv2d_direct(x: torch.Tensor, k: torch.Tensor, *,
                         stride: tuple[int, int] = (1, 1),
                         padding: tuple[tuple[int, int], tuple[int, int]] = (
                             (0, 0), (0, 0)),
                         R: int = 7, bco: int | None = None,
                         out_dtype=None) -> torch.Tensor:
    """x: [N, H, W, C_i]; k: [K_H, K_W, C_i, C_o] in x's dtype (float32 or
    bfloat16), contiguous, on one CUDA device; ``padding`` ((top, bottom),
    (left, right)) of zeros; ``R`` output rows per block (1..16).  Returns
    [N, OH, OW, C_o] in ``out_dtype`` (default x's dtype)."""
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
    n, h, w, c_i = x.shape
    k_h, k_w, _, c_o = k.shape
    out = torch.empty((n, oh, ow, c_o), dtype=out_dtype, device=x.device)
    if n == 0 or c_o == 0:
        return out
    (s_h, s_w), ((pt, _), (pl, _)) = stride, padding
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kraken_conv2d(x.data_ptr(), k.data_ptr(), out.data_ptr(),
                                n, h, w, c_i, k_h, k_w, c_o, s_h, s_w, pt, pl,
                                oh, ow, int(R), _DTYPE[x.dtype],
                                _DTYPE[out_dtype], stream)
    if err:
        raise RuntimeError(
            f"kraken_conv2d_direct launch failed: CUDA error {err} (x "
            f"{tuple(x.shape)} k {tuple(k.shape)} stride {tuple(stride)} "
            f"padding {tuple(padding)} R={R} {x.dtype}; a shape whose tiles "
            "exceed the shared memory is refused too)")
    launches += 1
    return out
