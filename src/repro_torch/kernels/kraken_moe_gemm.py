"""``grouped_moe_gemm`` on Hopper: the hand-written CUDA kernel
``csrc/grouped_moe_gemm.cu`` behind a checked Python wrapper, and the
expert FFN built from it.

It replaces the Pallas TPU kernel
``repro.kernels.kraken_moe_gemm.grouped_moe_gemm``: every expert's
``xs[e, :sizes[e]] @ w[e]`` over the ``[E, C, d]`` capacity buffer in one
launch, with ``sizes`` read on the device, dead row tiles zero-filled
without reading a weight byte (an empty expert reads no weights) and rows
past ``sizes[e]`` exactly zero.  bfloat16 and float32 accumulate in fp32;
int8 accumulates in int32 and writes int32.  The TPU's ``block_rows`` plan
and lane padding have no counterpart: the kernel masks ragged edges itself.
The wrapper takes CUDA tensors only and launches the kernel or raises; the
plain versions are :func:`repro_torch.kernels.ref.grouped_moe_gemm` and
:func:`repro_torch.kernels.ref.grouped_expert_ffn`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: launches of the kernel in this process; callers may reset it to 0
launches = 0

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("grouped_moe_gemm")
        fn = lib.grouped_moe_gemm
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def grouped_moe_gemm(xs: torch.Tensor, w: torch.Tensor,
                     sizes: torch.Tensor) -> torch.Tensor:
    """xs [E, C, d], w [E, d, f] of one dtype (bfloat16, float32 or int8),
    sizes [E] int32, all contiguous on one CUDA device.  Returns [E, C, f]
    in ``xs.dtype`` (int32 for int8)."""
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
    out = torch.empty((e, c, f), device=xs.device,
                      dtype=torch.int32 if xs.dtype == torch.int8 else xs.dtype)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grouped_moe_gemm(xs.data_ptr(), w.data_ptr(),
                                   sizes.data_ptr(), out.data_ptr(), e, c, d,
                                   f, _DTYPE[xs.dtype], stream)
    if err:
        raise RuntimeError(f"grouped_moe_gemm launch failed: CUDA error {err} "
                           f"(E={e} C={c} d={d} f={f} {xs.dtype})")
    launches += 1
    return out


def grouped_expert_ffn(buf, sizes, wi_gate, wi_up, wo) -> torch.Tensor:
    """The expert FFN ``silu(x @ wi_gate) * (x @ wi_up) @ wo`` over the
    ``[E, C, d]`` capacity buffer: three kernel launches and one
    elementwise ``silu * up``."""
    gate = grouped_moe_gemm(buf, wi_gate, sizes)
    up = grouped_moe_gemm(buf, wi_up, sizes)
    return grouped_moe_gemm(ref.silu_mul(gate, up), wo, sizes)
