"""``swa_attention`` on Hopper: the hand-written CUDA kernel
``csrc/swa_attention.cu`` behind a checked Python wrapper.

It replaces the Pallas TPU kernel ``repro.kernels.swa_attention.swa_attention``:
causal sliding-window flash attention over a whole sequence (prefill and the
cache-less forward), q ``[B, H, S, D]`` against k/v ``[B, KV, S, D]``, token
``i`` attending to key ``j`` iff ``i - window < j <= i``.  One block per
(batch x head, q tile) walks only the kv tiles of its window, each once, with
the kv head resolved in its own offsets (no repeated-KV tensor) and a ragged
last tile masked in the kernel; bf16 runs ``wmma`` with fp32 accumulators and
rounds the probabilities to bf16 before the PV product, as the Pallas kernel
does; float32 runs fp32 FMA.  The wrapper takes CUDA tensors only and
launches the kernel or raises; the plain version is
:func:`repro_torch.kernels.ref.sliding_window_attention`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: launches of the kernel in this process; callers may reset it to 0
launches = 0

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("swa_attention")
        fn = lib.swa_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swa_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), b, h, kvh, s, d, window,
                                1.0 / math.sqrt(d), _DTYPE[q.dtype], stream)
    if err:
        raise RuntimeError(f"swa_attention launch failed: CUDA error {err} "
                           f"(B={b} H={h} KV={kvh} S={s} D={d} W={window} "
                           f"{q.dtype})")
    launches += 1
    return out
