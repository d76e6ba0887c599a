"""Post-training int8 weight quantization: a port of
``repro.optim.quantize`` on tensors.

Symmetric per-channel quantization (TFLite spec, as the paper cites it):
``q = clip(round(w / s), -127, 127)``, ``s = max|w_col| / 127``, the scales
fp32 and kept with the reduced axes as size-1 dims.  Weights live as int8
plus scales and are dequantized to the compute dtype where they are used;
biases, norms and gains stay as they are.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree as T


class QuantizedTensor(NamedTuple):
    """int8 values + per-out-channel scales."""
    q: torch.Tensor          # int8, same shape as the source
    scale: torch.Tensor      # fp32, the source's shape with reduced dims 1


def quantize_weight(w: torch.Tensor, *, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-channel int8.  ``axis`` is the output-channel dim."""
    wf = w.to(torch.float32)
    reduce_axes = tuple(i for i in range(w.dim()) if i != (axis % w.dim()))
    amax = torch.amax(torch.abs(wf), dim=reduce_axes, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale.to(torch.float32))


def dequantize_weight(qt: QuantizedTensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    return (qt.q.to(torch.float32) * qt.scale).to(dtype)


def _is_matmul_weight(path: str, leaf) -> bool:
    """Quantize 2-D+ projection weights; skip norms/biases/embedding gains."""
    if leaf.dim() < 2:
        return False
    name = path.rsplit("'", 2)[-2] if "'" in path else path
    return not name.endswith(("_gamma", "_beta"))


def quantize_params(params):
    """Tree -> (tree with the matmul weights as :class:`QuantizedTensor`
    leaves, {"bytes_before", "bytes_after", "ratio"})."""
    before = after = 0

    def one(path, leaf):
        nonlocal before, after
        nbytes = leaf.numel() * leaf.element_size()
        before += nbytes
        if _is_matmul_weight(path, leaf):
            qt = quantize_weight(leaf)
            after += qt.q.numel() + qt.scale.numel() * 4
            return qt
        after += nbytes
        return leaf

    tree = T.map_with_path(one, params)
    return tree, {"bytes_before": before, "bytes_after": after,
                  "ratio": before / max(1, after)}


def _is_q(leaf) -> bool:
    return isinstance(leaf, QuantizedTensor)


def dequantize_params(qparams, dtype=torch.bfloat16):
    """Inverse of :func:`quantize_params`."""
    return T.map_leaves(
        lambda leaf: dequantize_weight(leaf, dtype) if _is_q(leaf) else leaf,
        qparams, is_leaf=_is_q)


def quantization_error(params, qparams) -> dict[str, float]:
    """Max relative error per quantized leaf (PTQ sanity metric)."""
    errs = {}
    quantized = dict(T.leaves_with_path(qparams, is_leaf=_is_q))
    for path, w in T.leaves_with_path(params):
        ql = quantized.get(path)
        if _is_q(ql):
            wd = dequantize_weight(ql, torch.float32)
            wf = w.to(torch.float32)
            denom = torch.clamp_min(torch.abs(wf).max(), 1e-12)
            errs[path] = float(torch.abs(wd - wf).max() / denom)
    return errs
