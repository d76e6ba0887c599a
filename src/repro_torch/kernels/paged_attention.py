"""``paged_decode_attention`` on Hopper: the hand-written CUDA kernel
``csrc/paged_attention.cu`` behind a checked Python wrapper.

It replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_decode_attention``: one-token GQA
flash-decode straight off the page pools, with the page table walked inside
the kernel, dead and fully masked pages skipped, a sliding-window mask, int8
pools dequantized on load, and exact zeros for a slot with no live entry.
One block per (slot, KV head) holds that head's query rows and keeps the
online-softmax state in fp32.  The TPU's ``pages_per_block`` tunable has no
counterpart: the block walks the slot's pages one at a time.  The wrapper
takes CUDA tensors only and launches the kernel or raises; the plain version
is :func:`repro_torch.kernels.ref.paged_decode_attention`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: launches of the kernel in this process; callers may reset it to 0
launches = 0

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
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


def paged_decode_attention(q, k_pages, v_pages, *, pos_pages, page_table,
                           q_pos, k_scale=None, v_scale=None,
                           window: int = 0) -> torch.Tensor:
    """q: [B, H, D]; k_pages/v_pages: [n_pages, KV, ps, D] in q's dtype, or
    int8 with fp32 scales [n_pages, KV, ps]; pos_pages: [n_pages, ps] int32;
    page_table: [B, MP] int32 (entries >= n_pages are dead); q_pos: [B]
    int32.  Returns [B, H, D] in q's dtype."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention needs CUDA tensors, got "
                         f"{q.device}")
    b, h, d = q.shape
    n_pages, kvh, ps, _ = k_pages.shape
    mp = page_table.shape[1]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16) or h % kvh:
        raise ValueError(f"q {q.dtype} with {h} heads over {kvh} KV heads")
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
    qp = torch.as_tensor(q_pos, dtype=torch.int32, device=dev)
    qp = qp.reshape(-1).expand(b).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            pos_pages.data_ptr(), page_table.data_ptr(), qp.data_ptr(),
            out.data_ptr(), b, h, kvh, d, n_pages, ps, mp, int(window),
            1.0 / math.sqrt(d), _DTYPE[q.dtype], _DTYPE[kv_dtype], stream)
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err} (B={b} H={h} KV={kvh} D={d} "
                           f"ps={ps} MP={mp} {q.dtype}/{kv_dtype})")
    launches += 1
    return out
