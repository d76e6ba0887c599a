"""Gradient compression for the cross-pod all-reduce: int8 quantization
with error feedback, a port of ``repro.optim.compress`` on tensors.

Quantizing the gradients to int8 cuts the bytes of the slowest links 4x
(bf16), while the error-feedback buffer keeps the accumulated
quantization error in the update path (the 1-bit-Adam / EF-SGD lineage).
This module holds the compression and its state; the all-reduce that
carries the compressed gradients comes with the multi-device code (ROADMAP
Queue 1 item 14).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as T


class CompressionState(NamedTuple):
    error: Any   # residual per param, same tree as grads (fp32)


def init_state(params) -> CompressionState:
    return CompressionState(error=T.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def quantize(g: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Symmetric per-tensor int quantization.  Returns (q, scale)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / qmax
    q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(
        torch.int8 if bits == 8 else torch.int32)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, comp_state: CompressionState, bits: int = 8):
    """Apply error feedback and quantize each leaf.  Returns
    (quantized tree, scales tree, the state holding the new residuals)."""
    def one(g, e):
        gf = g.to(torch.float32) + e
        q, s = quantize(gf, bits)
        return q, s, gf - dequantize(q, s)

    qs, ss, es = zip(*(one(g, e) for g, e in zip(
        T.leaves(grads), T.leaves(comp_state.error))))
    return (T.unflatten_like(grads, list(qs)),
            T.unflatten_like(grads, list(ss)),
            CompressionState(error=T.unflatten_like(grads, list(es))))


def decompress_grads(q_tree, scale_tree):
    return T.map_leaves(dequantize, q_tree, scale_tree)
