"""``decode_attention`` on Hopper: the hand-written CUDA kernel
``csrc/decode_attention.cu`` behind a checked Python wrapper, and the int8
KV quantizer the dense and paged caches store with.

It replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``: one-token GQA
flash-decode over a dense ``[B, KV, S, D]`` cache with per-slot positions, a
sliding-window mask and int8 K/V dequantized in registers.  One block per
(slot, KV head) holds that head's query rows, walks the cache in tiles and
keeps the online-softmax state in fp32; a ragged last tile is masked in the
kernel, so the TPU's ``_divisible_block`` (pick a KV block that divides S,
or pad the whole cache) has no counterpart.  A slot with no live entry
gives exact zeros, as the plain version does.  The wrapper takes CUDA
tensors only and launches the kernel or raises; the plain version is
:func:`repro_torch.kernels.ref.decode_attention`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import _DTYPE, _check
from repro_torch.kernels.ref import quantize_kv  # noqa: F401  (re-exported)

#: launches of the kernel in this process; callers may reset it to 0
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def decode_attention(q, k, v, *, kv_pos, q_pos, k_scale=None, v_scale=None,
                     window: int = 0) -> torch.Tensor:
    """q: [B, H, D]; k/v: [B, KV, S, D] in q's dtype, or int8 with fp32
    scales [B, KV, S]; kv_pos: [S] shared or [B, S] per slot (int32,
    -2^30 = empty); q_pos: a scalar or [B].  Returns [B, H, D] in q's
    dtype."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention needs CUDA tensors, got "
                         f"{q.device}")
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    dev = q.device
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
    kvp = torch.as_tensor(kv_pos, device=dev).to(torch.int32).contiguous()
    if tuple(kvp.shape) not in ((s,), (b, s)):
        raise ValueError(f"kv_pos shape {tuple(kvp.shape)}, expected ({s},) "
                         f"or ({b}, {s})")
    pos_stride = s if kvp.dim() == 2 else 0
    qp = torch.as_tensor(q_pos, dtype=torch.int32, device=dev)
    qp = qp.reshape(-1).expand(b).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            kvp.data_ptr(), qp.data_ptr(), out.data_ptr(), b, h, kvh, s, d,
            pos_stride, int(window), 1.0 / math.sqrt(d), _DTYPE[q.dtype],
            _DTYPE[kv_dtype], stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err} (B={b} H={h} KV={kvh} S={s} D={d} "
                           f"{q.dtype}/{kv_dtype})")
    launches += 1
    return out
