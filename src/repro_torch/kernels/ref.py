"""Plain PyTorch versions of the port's kernels.

Each function computes exactly what its hand-written CUDA kernel computes,
in plain tensor ops with fp32 math.  The CPU path of :mod:`ops` runs them,
and ``chip_smoke.py`` holds every kernel against them on the card.  They are
ports of ``repro.kernels.ref`` and keep its semantics, out-of-range
handling included: an out-of-range gather index is clamped, as JAX does.
"""

from __future__ import annotations

import math

import torch

POS_EMPTY = -(2 ** 30)   # position of an empty cache entry (always masked)


def matmul(a: torch.Tensor, b: torch.Tensor, *, bias: torch.Tensor | None = None,
           activation: str | None = None, out_dtype=None) -> torch.Tensor:
    """Plain ``kraken_gemm``: fp32-accumulated ``a @ b`` + optional epilogue.

    ``gelu`` is the tanh approximation (``repro.kernels.ref.matmul``), not
    ``torch.nn.functional.gelu``'s default erf form.
    """
    out = a.to(torch.float32) @ b.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    if activation == "relu":
        out = torch.clamp_min(out, 0.0)
    elif activation == "silu":
        out = out * torch.reciprocal(1.0 + torch.exp(-out))
    elif activation == "gelu":
        out = 0.5 * out * (1.0 + torch.tanh(
            0.7978845608028654 * (out + 0.044715 * out ** 3)))
    elif activation is not None:
        raise ValueError(activation)
    return out.to(out_dtype or a.dtype)


def conv2d(x: torch.Tensor, k: torch.Tensor, *,
           stride: tuple[int, int] = (1, 1),
           padding: tuple[tuple[int, int], tuple[int, int]] = ((0, 0), (0, 0)),
           out_dtype=None) -> torch.Tensor:
    """Plain ``kraken_conv2d_direct``: NHWC x HWIO -> NHWC cross-correlation
    in fp32, cast once at the end (``repro.kernels.ref.conv2d``).

    x: [N, H, W, C_i]; k: [K_H, K_W, C_i, C_o]; ``padding`` is ((top,
    bottom), (left, right)) of zeros.  The sum over the (kh, kw) taps of the
    strided input slice ``@ k[kh, kw]``; it calls no library convolution,
    so that cuDNN stays a separate yardstick.
    """
    (s_h, s_w), ((pt, pb), (pl, pr)) = stride, padding
    k_h, k_w = k.shape[:2]
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, 0, pl, pr, pt, pb))
    kf = k.to(torch.float32)
    oh = (xf.shape[1] - k_h) // s_h + 1
    ow = (xf.shape[2] - k_w) // s_w + 1
    out = None
    for kh in range(k_h):
        for kw in range(k_w):
            xs = xf[:, kh:kh + (oh - 1) * s_h + 1:s_h,
                    kw:kw + (ow - 1) * s_w + 1:s_w]          # [N, OH, OW, C_i]
            term = xs @ kf[kh, kw]
            out = term if out is None else out + term
    return out.to(out_dtype or x.dtype)


def grouped_moe_gemm(xs: torch.Tensor, w: torch.Tensor,
                     sizes: torch.Tensor) -> torch.Tensor:
    """Plain ``grouped_moe_gemm``: every expert's ``xs[e, :sizes[e]] @
    w[e]``, one product per expert.

    xs: [E, C, d]; w: [E, d, f]; sizes: [E] live rows per expert, clamped
    to C (``repro.kernels.kraken_moe_gemm.grouped_moe_gemm``).  Rows
    ``>= sizes[e]`` are masked to zero before the product, so those output
    rows are exactly zero.  Floats accumulate in fp32 and write
    ``xs.dtype``; int8 accumulates exactly and writes int32 (the sums go
    through float64, which holds every int32 exactly: the card has no
    integer matmul).  Nothing here reads ``sizes`` on the host.
    """
    e, c, _ = xs.shape
    integer = not xs.is_floating_point()
    acc = torch.float64 if integer else torch.float32
    rows = torch.arange(c, device=xs.device)
    live = rows[None, :] < sizes.clamp(max=c)[:, None]             # [E, C]
    outs = [torch.where(live[i, :, None], xs[i], 0).to(acc) @ w[i].to(acc)
            for i in range(e)]
    return torch.stack(outs).to(torch.int32 if integer else xs.dtype)


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in fp32, rounded once to ``gate.dtype``: the
    elementwise step between the expert FFN's grouped GEMMs."""
    g = gate.to(torch.float32)
    return (g * torch.sigmoid(g) * up.to(torch.float32)).to(gate.dtype)


def grouped_expert_ffn(buf, sizes, wi_gate, wi_up, wo) -> torch.Tensor:
    """Plain expert FFN over the ``[E, C, d]`` capacity buffer:
    ``silu(x @ wi_gate) * (x @ wi_up) @ wo`` per expert, rows past
    ``sizes`` zero (``repro.kernels.kraken_moe_gemm.grouped_expert_ffn``)."""
    gate = grouped_moe_gemm(buf, wi_gate, sizes)
    up = grouped_moe_gemm(buf, wi_up, sizes)
    return grouped_moe_gemm(silu_mul(gate, up), wo, sizes)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             return_lse: bool = False):
    """Plain ``swa_attention``: causal sliding-window attention over a whole
    sequence in fp32 (``repro.kernels.ref.sliding_window_attention``).

    q: [B, H, S, D]; k/v: [B, KV, S, D].  Query head ``h`` reads KV head
    ``h // (H // KV)``, as ``jnp.repeat`` of the KV heads and the Pallas
    kernel's ``kv_head`` map both give.  Token ``i`` attends to key ``j``
    iff ``i - window < j <= i``.  Scores, softmax and the value product are
    fp32; the output is in q's dtype.  With ``return_lse`` also each row's
    log-sum-exp of its scaled scores, fp32 [B, H, S].
    """
    b, h, s, d = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, kvh, h // kvh, s, d).to(torch.float32)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) \
        * (1.0 / math.sqrt(d))
    logits = logits.masked_fill(~_window_mask(s, window, q.device),
                                float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.to(torch.float32))
    out = out.reshape(b, h, s, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(b, h, s)


def _window_mask(s: int, window: int, device) -> torch.Tensor:
    """[S, S]: key ``j`` is inside query ``i``'s causal window."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return (j <= i) & (j > i - window)


def sliding_window_attention_bwd(q, k, v, out, dout, lse, *, window: int):
    """Plain ``swa_attention_bwd``: the gradient of
    :func:`sliding_window_attention` with respect to q, k and v, the
    probabilities recomputed from the forward's ``lse`` (fp32 [B, H, S]), in
    fp32: ``P = exp(s - lse)`` inside the window, ``dS = P (dP - delta)``
    with ``dP = dout v^T`` and ``delta = rowsum(dout * out)``; ``dq = scale
    dS k``, ``dk = scale dS^T q`` and ``dv = P^T dout`` summed over the
    group's query heads.  One KV head's group at a time, so that the [S, S]
    tiles of one group are the most it holds.  Returns (dq, dk, dv) in the
    inputs' dtypes."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    mask = _window_mask(s, window, q.device)
    delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for c in range(kvh):
        hs = slice(c * g, (c + 1) * g)
        qf, do = q[:, hs].to(torch.float32), dout[:, hs].to(torch.float32)
        kf, vf = k[:, c].to(torch.float32), v[:, c].to(torch.float32)
        logits = torch.einsum("bgqd,bsd->bgqs", qf, kf) * scale
        p = torch.where(mask, torch.exp(logits - lse[:, hs, :, None]), 0.0)
        dp = torch.einsum("bgqd,bsd->bgqs", do, vf)
        ds = p * (dp - delta[:, hs, :, None])
        dq[:, hs] = (torch.einsum("bgqs,bsd->bgqd", ds, kf)
                     * scale).to(q.dtype)
        dk[:, c] = (torch.einsum("bgqs,bgqd->bsd", ds, qf)
                    * scale).to(k.dtype)
        dv[:, c] = torch.einsum("bgqs,bgqd->bsd", p, do).to(v.dtype)
    return dq, dk, dv


def paged_decode_attention(q, k_pages, v_pages, *, pos_pages, page_table,
                           q_pos, k_scale=None, v_scale=None,
                           window: int = 0) -> torch.Tensor:
    """Plain ``paged_decode_attention``: gather the pool through the table,
    then exact one-token attention.

    q: [B, H, D]; k_pages/v_pages: [n_pages, KV, ps, D]; pos_pages:
    [n_pages, ps]; page_table: [B, MP] (sentinel ``n_pages`` = dead page);
    scales: [n_pages, KV, ps] or None; q_pos: [B] (or a scalar).  Dead
    pages gather clamped garbage under an all-masked position row, so a
    slot with no live page returns zeros.
    """
    n_pages, kvh, ps, d = k_pages.shape
    b, mp = page_table.shape
    tbl = page_table.long().clamp(0, n_pages - 1)
    live = (page_table < n_pages).repeat_interleave(ps, dim=1)   # [B, MP*ps]
    k = k_pages[tbl].permute(0, 2, 1, 3, 4).reshape(b, kvh, mp * ps, d)
    v = v_pages[tbl].permute(0, 2, 1, 3, 4).reshape(b, kvh, mp * ps, d)
    pos = torch.where(live, pos_pages[tbl].reshape(b, mp * ps),
                      torch.full_like(live, POS_EMPTY, dtype=torch.int32))
    ks = vs = None
    if k_scale is not None:
        ks = k_scale[tbl].permute(0, 2, 1, 3).reshape(b, kvh, mp * ps)
        vs = v_scale[tbl].permute(0, 2, 1, 3).reshape(b, kvh, mp * ps)
    qp = torch.as_tensor(q_pos, dtype=torch.int32, device=q.device)
    qp = qp.reshape(-1).expand(b)
    return decode_attention(q, k, v, kv_pos=pos, q_pos=qp, k_scale=ks,
                            v_scale=vs, window=window)


def decode_attention(q, k, v, *, kv_pos, q_pos, k_scale=None, v_scale=None,
                     window: int = 0) -> torch.Tensor:
    """One-token GQA attention over a (possibly int8) KV cache, fp32 math.

    q: [B, H, D]; k/v: [B, KV, S, D]; scales: [B, KV, S] or None.  kv_pos:
    [S] shared or [B, S] per slot; q_pos: a scalar or [B].  The masked
    softmax uses -inf and turns NaN into 0, so a slot with no live entry
    gives exact zeros.
    """
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    qg = q.reshape(b, kvh, g, d).to(torch.float32)
    logits = torch.einsum("bkgd,bksd->bkgs", qg, kf) / math.sqrt(d)
    kvp = kv_pos if kv_pos.dim() == 2 else kv_pos[None, :]
    qp = torch.as_tensor(q_pos, device=q.device).reshape(-1, 1)
    mask = (kvp >= 0) & (kvp <= qp)
    if window:
        mask = mask & (kvp > qp - window)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    out = torch.einsum("bkgs,bksd->bkgd", p, vf)
    return out.reshape(b, h, d).to(q.dtype)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, head, slot) symmetric int8: x [B, KV, S, D] -> (int8
    [B, KV, S, D], scale f32 [B, KV, S]).  Bit for bit
    ``repro.kernels.decode_attention.quantize_kv``: ``scale = max(amax /
    127, 1e-12)``, a division by the scale (not a product with its
    reciprocal), round half to even, then a clip to +-127."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale
