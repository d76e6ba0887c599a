"""``kraken_gemm`` on Hopper: the hand-written CUDA kernel
``csrc/kraken_gemm.cu`` behind a checked Python wrapper.

It replaces the Pallas TPU kernel ``repro.kernels.kraken_gemm.kraken_gemm``:
``act(a @ b + bias)`` with fp32 accumulation and the epilogue fused, for
bfloat16 and float32.  The TPU's two schedules and its tile plan are not
carried over; the kernel masks ragged M/N/K edges itself, so nothing is
padded.  The wrapper takes CUDA tensors only and launches the kernel or
raises; the plain version is :func:`repro_torch.kernels.ref.matmul`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: launches of the kernel in this process; callers may reset it to 0
launches = 0

_ACT = {None: 0, "relu": 1, "silu": 2, "gelu": 3}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("kraken_gemm")
        fn = lib.kraken_gemm
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def kraken_gemm(a: torch.Tensor, b: torch.Tensor, *,
                bias: torch.Tensor | None = None,
                activation: str | None = None) -> torch.Tensor:
    """``act(a @ b + bias)``: a [M, K], b [K, N], bias [N] (or [1, N]);
    out [M, N] in ``a.dtype``.  All on one CUDA device, a and b contiguous
    and of one dtype (bfloat16 or float32)."""
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"kraken_gemm needs CUDA tensors on one device, got "
                         f"{a.device} and {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"kraken_gemm shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPE or b.dtype != a.dtype:
        raise ValueError(f"kraken_gemm dtypes {a.dtype}, {b.dtype}: needs "
                         "both bfloat16 or both float32")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("kraken_gemm needs contiguous operands")
    if activation not in _ACT:
        raise ValueError(activation)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    bias_f = None
    if bias is not None:
        bias_f = bias.reshape(-1).to(device=a.device, dtype=torch.float32)
        if bias_f.numel() != n:
            raise ValueError(f"bias of {bias_f.numel()} for N={n}")
        bias_f = bias_f.contiguous()
    if m == 0 or n == 0:
        return out
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kraken_gemm(a.data_ptr(), b.data_ptr(),
                              None if bias_f is None else bias_f.data_ptr(),
                              out.data_ptr(), m, n, k, _DTYPE[a.dtype],
                              _ACT[activation], stream)
    if err:
        raise RuntimeError(f"kraken_gemm launch failed: CUDA error {err} "
                           f"(M={m} N={n} K={k} {a.dtype})")
    launches += 1
    return out
