"""Gradient compression for the cross-pod all-reduce: int8 quantization
with error feedback, a port of ``repro.optim.compress`` on tensors.

Quantizing the gradients to int8 cuts the bytes of the slowest links 4x
(bf16), while the error-feedback buffer keeps the accumulated
quantization error in the update path (the 1-bit-Adam / EF-SGD lineage).
:func:`allreduce_compressed` carries the compressed gradients over one
mesh dimension's process group (JAX's runs inside ``shard_map`` over an
axis name).
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


def state_specs(param_specs) -> CompressionState:
    """The state's shapes on the ``meta`` device (fp32 residuals)."""
    return CompressionState(error=T.map_leaves(
        lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
        param_specs))


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


def _group(axis):
    """A process group, or the group of the installed mesh's dimension
    named ``axis``."""
    if not isinstance(axis, str):
        return axis
    from repro_torch import sharding
    c = sharding.current()
    if c is None or c["mesh"] is None:
        raise RuntimeError(f"allreduce_compressed over {axis!r} needs an "
                           "installed mesh (sharding.use_mesh_and_rules)")
    return c["mesh"].get_group(axis)


def allreduce_compressed(grads, comp_state: CompressionState, axis,
                         bits: int = 8):
    """Error-feedback int8 all-reduce over ``axis``: a dimension name of
    the installed mesh, or a process group.  Each rank passes its own
    (local) gradients; every rank gets their mean.

    JAX's arithmetic: each leaf is quantized with error feedback, ``q *
    scale`` is widened to fp32 and summed over the group, then divided by
    the group size (the wire format is the int8 payload and one scale a
    tensor; the sum carries their fp32 product for transparency, as
    there).  Returns (mean tree, new state)."""
    import torch.distributed as dist
    group = _group(axis)
    q, s, new_state = compress_grads(grads, comp_state, bits)

    def red(qq, sc):
        x = qq.to(torch.float32) * sc
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    n = dist.get_world_size(group)
    summed = T.map_leaves(red, q, s)
    return T.map_leaves(lambda x: x / n, summed), new_state
