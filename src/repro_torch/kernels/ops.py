"""The entry points the model code calls, one per kernel.

The dispatch has exactly two cases, decided by where the input lies: a CUDA
tensor launches the hand-written kernel (or the wrapper raises); a CPU
tensor runs the kernel's plain version from :mod:`ref`.  There is no
fallback from one to the other, and no TPU tile plan.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import kraken_conv as _conv
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


def kraken_conv2d_direct(x: torch.Tensor, k: torch.Tensor, *,
                         stride: tuple[int, int] = (1, 1),
                         padding: tuple[tuple[int, int], tuple[int, int]] = (
                             (0, 0), (0, 0)),
                         R: int = 7, bco: int | None = None,
                         out_dtype=None) -> torch.Tensor:
    """Direct Kraken-dataflow convolution: x [N, H, W, C_i] NHWC, k
    [K_H, K_W, C_i, C_o] HWIO -> NHWC, fp32 accumulation, cast once to
    ``out_dtype`` (default x's dtype).  ``R`` is the paper's row count, the
    output rows of one band (a tile on the card holds whole bands);
    ``bco`` is the card's c_o tile, 64 or 128 (None: the tile policy's)."""
    if _on_cuda(x):
        return _conv.kraken_conv2d_direct(x, k, stride=stride,
                                          padding=padding, R=R, bco=bco,
                                          out_dtype=out_dtype)
    _conv.check_args(x.shape, k.shape, stride=stride, padding=padding, R=R,
                     bco=bco)
    return ref.conv2d(x, k, stride=stride, padding=padding,
                      out_dtype=out_dtype)


def kraken_conv2d(x: torch.Tensor, k: torch.Tensor, *,
                  stride: tuple[int, int] = (1, 1),
                  padding: tuple[tuple[int, int], tuple[int, int]] = (
                      (0, 0), (0, 0)),
                  out_dtype=None) -> torch.Tensor:
    """Convolution by the uniform lowering conv -> im2col ->
    :func:`kraken_matmul` (``repro.kernels.ops.kraken_conv2d``).

    x: [N, H, W, C_i], k: [K_H, K_W, C_i, C_o] -> [N, OH, OW, C_o].  The
    patches are channel-major, (C_i, K_H, K_W), as JAX's
    ``conv_general_dilated_patches`` gives them, and the weight rows follow
    that order.
    """
    (s_h, s_w), ((pt, pb), (pl, pr)) = stride, padding
    n = x.shape[0]
    k_h, k_w, c_i, c_o = k.shape
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    patches = xp.unfold(1, k_h, s_h).unfold(2, k_w, s_w)  # [N,OH,OW,C,KH,KW]
    oh, ow = patches.shape[1], patches.shape[2]
    lhs = patches.reshape(n * oh * ow, c_i * k_h * k_w)
    rhs = k.permute(2, 0, 1, 3).reshape(c_i * k_h * k_w, c_o)
    out = kraken_matmul(lhs, rhs, out_dtype=out_dtype)
    return out.reshape(n, oh, ow, c_o)


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
