"""The entry points the model code calls, one per kernel.

The dispatch has exactly two cases, decided by where the input lies: a CUDA
tensor launches the hand-written kernel (or the wrapper raises); a CPU
tensor runs the kernel's plain version from :mod:`ref`.  There is no
fallback from one to the other, and no TPU tile plan.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import kraken_gemm as _gemm
from repro_torch.kernels import kraken_moe_gemm as _moe
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import swa_attention as _swa
from repro_torch.kernels import ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def kraken_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  bias: torch.Tensor | None = None,
                  activation: str | None = None,
                  out_dtype=None) -> torch.Tensor:
    """Uniform-dataflow matmul: [M, K] @ [K, N] (+bias, +activation).
    The kernel writes ``a.dtype``; another ``out_dtype`` is refused on the
    card."""
    if _on_cuda(a):
        if out_dtype is not None and out_dtype != a.dtype:
            raise ValueError("kraken_gemm writes a.dtype only")
        return _gemm.kraken_gemm(a, b, bias=bias, activation=activation)
    return ref.matmul(a, b, bias=bias, activation=activation,
                      out_dtype=out_dtype)


def kraken_paged_attention(q, k_pages, v_pages, *, pos_pages, page_table,
                           q_pos, k_scale=None, v_scale=None,
                           window: int = 0) -> torch.Tensor:
    """One-token GQA attention straight off a (possibly int8) page pool."""
    if _on_cuda(q):
        return _pa.paged_decode_attention(
            q, k_pages, v_pages, pos_pages=pos_pages, page_table=page_table,
            q_pos=q_pos, k_scale=k_scale, v_scale=v_scale, window=window)
    return ref.paged_decode_attention(
        q, k_pages, v_pages, pos_pages=pos_pages, page_table=page_table,
        q_pos=q_pos, k_scale=k_scale, v_scale=v_scale, window=window)


def kraken_decode_attention(q, k, v, *, kv_pos, q_pos, k_scale=None,
                            v_scale=None, window: int = 0) -> torch.Tensor:
    """One-token GQA attention over a dense (possibly int8) KV cache."""
    if _on_cuda(q):
        return _dec.decode_attention(q, k, v, kv_pos=kv_pos, q_pos=q_pos,
                                     k_scale=k_scale, v_scale=v_scale,
                                     window=window)
    return ref.decode_attention(q, k, v, kv_pos=kv_pos, q_pos=q_pos,
                                k_scale=k_scale, v_scale=v_scale,
                                window=window)


def swa_attention(q, k, v, *, window: int) -> torch.Tensor:
    """Causal sliding-window attention over a whole sequence: q
    [B, H, S, D], k/v [B, KV, S, D]; token ``i`` attends to ``j`` iff
    ``i - window < j <= i``."""
    if _on_cuda(q):
        return _swa.swa_attention(q, k, v, window=window)
    return ref.sliding_window_attention(q, k, v, window=window)


def grouped_expert_ffn(buf, sizes, wi_gate, wi_up, wo) -> torch.Tensor:
    """The MoE expert FFN over the ``[E, C, d]`` capacity buffer (``sizes``
    live rows per expert), as three grouped GEMMs."""
    if _on_cuda(buf):
        return _moe.grouped_expert_ffn(buf, sizes, wi_gate, wi_up, wo)
    return ref.grouped_expert_ffn(buf, sizes, wi_gate, wi_up, wo)
