"""Model building blocks on the serving main path: RMSNorm and LayerNorm,
RoPE and sinusoidal positions, the uniform-GEMM dense layer, GQA attention
(causal over paged KV pools and dense KV caches, and the unmasked form
that cross attention uses), and the SwiGLU and gelu MLPs.

A port of ``repro.models.layers``.  Every matmul goes through
:func:`dense`, which calls ``kernels.matmul`` -- by default
:func:`repro_torch.kernels.ops.kraken_matmul`, the hand-written
``kraken_gemm`` on CUDA tensors -- with the activation fused in its
epilogue.  Decode attention reads the page pools through
``kernels.paged_attention`` (the hand-written ``paged_decode_attention``);
the int8 dense-cache decode goes through ``kernels.decode_attention`` (the
hand-written ``decode_attention``); the cache-less windowed attention at
``S % 128 == 0`` goes through ``kernels.swa_attention`` (the hand-written
``swa_attention``).  Callers may pass other ``Kernels`` (the plain
versions) to compare.

Unlike the JAX version, both the dense and the paged caches are updated
**in place** (``index_put_``, ``copy_``): JAX rebuilt every cache
functionally and relied on buffer donation to alias it.  Out-of-range
indices follow JAX's rules exactly with a fixed-shape scheme: every pool
holds one extra *trash page* at index ``n_pages`` that absorbs the writes
JAX drops (``mode="drop"``), and every gather through a page table clamps
to ``n_pages - 1``, as JAX clamps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch import sharding
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import quantize_kv

Params = dict

POS_EMPTY = -(2 ** 30)   # position of an empty cache entry (always masked)


class Kernels(NamedTuple):
    """The kernel entry points the model calls."""
    matmul: Callable
    paged_attention: Callable
    moe_ffn: Callable
    decode_attention: Callable
    swa_attention: Callable


DEFAULT_KERNELS = Kernels(ops.kraken_matmul, ops.kraken_paged_attention,
                          ops.grouped_expert_ffn, ops.kraken_decode_attention,
                          ops.swa_attention)


class Spec(NamedTuple):
    """Parameter spec: shape + logical axes + init scale."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    scale: float = 1.0  # stddev multiplier on 1/sqrt(fan_in); 0 -> zeros, -1 -> ones


def init_param(generator: torch.Generator, spec: Spec, dtype,
               device) -> torch.Tensor:
    """A parameter drawn like ``repro``'s ``init_param`` (normal with
    stddev ``scale / sqrt(fan_in)``, in fp32, then cast), from ``generator``
    (which must live on ``device``).  Stacked weights are drawn one
    trailing matrix at a time, so the fp32 draw never holds more than one
    ``[fan_in, fan_out]`` matrix (an expert bank of mixtral is 26 GB in
    fp32)."""
    if spec.scale == 0.0:
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.scale == -1.0:
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if len(spec.shape) == 1 else spec.shape[-2]
    std = spec.scale / math.sqrt(max(1, fan_in))
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    mats = out.view(-1, *spec.shape[-2:]) if out.dim() > 2 else out[None]
    for m in mats:
        m.copy_(torch.randn(m.shape, generator=generator, dtype=torch.float32,
                            device=device) * std)
    return out


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32 (the biased variance, as ``jnp.var``), cast back."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)
            + beta.to(torch.float32)).to(x.dtype)


def apply_norm(cfg, params: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, params[f"{prefix}_gamma"],
                          params[f"{prefix}_beta"], cfg.norm_eps)
    return rms_norm(x, params[f"{prefix}_gamma"], cfg.norm_eps)


def norm_specs(cfg, prefix: str) -> dict[str, Spec]:
    s = {f"{prefix}_gamma": Spec((cfg.d_model,), ("embed",), -1.0)}
    if cfg.norm == "layernorm":
        s[f"{prefix}_beta"] = Spec((cfg.d_model,), ("embed",), 0.0)
    return s


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: [..., S, D]; positions: [S] shared across the
    batch, or [B, S] per slot."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs   # [..., S, half]
    if positions.dim() == 2:   # [B, S, half] -> broadcast over the heads dim
        ang = ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """[sin | cos] position embedding in fp32: [S] -> [S, d_model], or
    [B, S] per slot -> [B, S, d_model]."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# The uniform-GEMM dense layer
# ---------------------------------------------------------------------------

def needs_grad(*tensors) -> bool:
    """Whether autograd records an op on ``tensors`` (None entries
    ignored)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def dense(x: torch.Tensor, w: torch.Tensor, *, bias: torch.Tensor | None = None,
          activation: str | None = None,
          kernels: Kernels = DEFAULT_KERNELS) -> torch.Tensor:
    """x: [..., K] @ w: [K, N] through ``kraken_gemm``, bias and activation
    fused in its epilogue.  When autograd records (grad enabled and an
    operand requiring it) the call goes through
    :func:`~repro_torch.kernels.ops.kraken_matmul_grad`, whose backward's
    two products are ``kernels.matmul`` too; otherwise it is the direct
    call the serving paths make."""
    lead = x.shape[:-1]
    a = sharding.gather_inner(x).reshape(-1, x.shape[-1]).contiguous()
    if not needs_grad(x, w, bias):
        out = ops.gemm(a, w, bias=bias, activation=activation,
                       matmul=kernels.matmul)
        return out.reshape(*lead, w.shape[-1])
    out = ops.kraken_matmul_grad(a, w, bias=bias, activation=activation,
                                 matmul=kernels.matmul)
    out = out.reshape(*lead, w.shape[-1])
    return sharding.gather_inner_grad(out)


# ---------------------------------------------------------------------------
# Attention (GQA; causal and unmasked, paged-cache serving)
# ---------------------------------------------------------------------------

def attention_specs(cfg, prefix: str = "attn") -> dict[str, Spec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        f"{prefix}_wq": Spec((d, h * hd), ("embed", "qkv")),
        f"{prefix}_wk": Spec((d, kv * hd), ("embed", "qkv")),
        f"{prefix}_wv": Spec((d, kv * hd), ("embed", "qkv")),
        f"{prefix}_wo": Spec((h * hd, d), ("qkv", "embed")),
    }
    if cfg.qkv_bias:
        s[f"{prefix}_bq"] = Spec((h * hd,), ("qkv",), 0.0)
        s[f"{prefix}_bk"] = Spec((kv * hd,), ("qkv",), 0.0)
        s[f"{prefix}_bv"] = Spec((kv * hd,), ("qkv",), 0.0)
    return s


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    x = sharding.fit_split(x, 2, n)
    return x.reshape(b, s, n, hd).transpose(1, 2)   # [B, H, S, D]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return sharding.fit_split_grad(x.transpose(1, 2).reshape(b, s, h * d),
                                   2, h)


def _gqa_sdpa_direct(q, k, v, *, window: int, q_pos, kv_pos,
                     mask_mode: str = "causal", return_state: bool = False):
    """Attention by position: q [B,H,Sq,D], k/v [B,KV,Sk,D], fp32 scores.
    With ``mask_mode="causal"`` key ``j`` is visible to query ``i`` when
    ``0 <= kv_pos[j] <= q_pos[i]`` (and inside ``window`` when one is set);
    with ``"none"`` every key is (cross attention).

    Masked scores are -1e30, not -inf, so a row with nothing to attend to
    (an idle slot) stays finite, as in the JAX version.  The probabilities
    are rounded to the compute dtype before the value product, as there.
    With ``return_state`` the softmax comes back unnormalized, as the
    chunked form keeps it: ``(acc [B,KV,G,Sq,D], m, l [B,KV,G,Sq,1])``,
    fp32, a kv shard's part for the combine across shards.
    """
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    group = h // kvh
    qg = q.reshape(b, kvh, group, sq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    if mask_mode != "none":
        # positions may be shared ([Sq]/[Sk]) or per slot ([B, Sq]/[B, Sk])
        qp = q_pos[None, :, None] if q_pos.dim() == 1 else q_pos[:, :, None]
        kp = kv_pos[None, None, :] if kv_pos.dim() == 1 else kv_pos[:, None, :]
        mask = (kp <= qp) & (kp >= 0)   # kp >= 0 excludes empty entries
        if window:
            mask = mask & (kp > qp - window)
        logits = logits.masked_fill(~mask[:, None, None], -1e30)
    if return_state:
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        acc = torch.einsum("bkgqs,bksd->bkgqd",
                           p.to(v.dtype).to(torch.float32), v.to(torch.float32))
        return acc, m, p.sum(dim=-1, keepdim=True)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd",
                       probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.reshape(b, h, sq, d).to(q.dtype)


_CHUNK_Q = 1024
_CHUNK_KV = 1024


def _gqa_sdpa_chunked(q, k, v, *, window: int, q_pos, kv_pos,
                      return_state: bool = False,
                      allow_window_slice: bool = True):
    """Flash-style double-chunked causal attention in torch ops, for long
    prefill sequences (JAX ``_gqa_sdpa_chunked`` with ``causal=True``).

    q [B,H,Sq,D], k/v [B,KV,Skv,D], shared positions q_pos [Sq] and kv_pos
    [Skv].  An online softmax over kv chunks inside a loop over q chunks
    keeps the live scores at [B, H, cq, ckv] instead of [B, H, Sq, Skv].
    For a window layer only the ``window + cq`` kv slice of each q chunk is
    read, when it is at most half the padded kv length.  Padded q rows
    carry position 2^30 and padded kv slots -2^30, so the mask drops them.
    Scores are fp32 and the probabilities are rounded to V's dtype before
    the value product, as there.

    ``return_state=True`` returns the *unnormalized* softmax state ``(acc
    [B,KV,G,Sq,D], m, l [B,KV,G,Sq,1])``, fp32, instead of the output: the
    context-parallel attention combines states across kv shards.
    ``allow_window_slice=False`` reads every kv chunk (the positions are
    global there and the kv a local shard, so the mask does the
    windowing).
    """
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    group = h // kvh
    cq, ckv = min(_CHUNK_Q, sq), min(_CHUNK_KV, skv)
    pad_q = -sq % cq
    qp = torch.nn.functional.pad(q_pos, (0, pad_q), value=2 ** 30)
    qpad = torch.nn.functional.pad(q, (0, 0, 0, pad_q))
    nq = qpad.shape[2] // cq
    scale = 1.0 / math.sqrt(d)

    pad_kv = -skv % ckv
    kpad = torch.nn.functional.pad(k, (0, 0, 0, pad_kv))
    vpad = torch.nn.functional.pad(v, (0, 0, 0, pad_kv))
    kvp = torch.nn.functional.pad(kv_pos, (0, pad_kv), value=POS_EMPTY)
    skv_p = kpad.shape[2]
    use_window_slice = (allow_window_slice and bool(window)
                        and (window + cq) * 2 <= skv_p)
    wlen = -(-(window + cq) // ckv) * ckv if use_window_slice else skv_p

    qr = qpad.reshape(b, kvh, group, nq, cq, d)
    outs = []
    for qi in range(nq):
        qck = qr[:, :, :, qi].to(torch.float32)     # [B, KV, G, cq, D]
        qpc = qp[qi * cq:(qi + 1) * cq]
        start = (min(max(qi * cq + cq - wlen, 0), skv_p - wlen)
                 if use_window_slice else 0)
        m = torch.full((b, kvh, group, cq, 1), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, group, cq, d), dtype=torch.float32,
                          device=q.device)
        for c0 in range(start, start + wlen, ckv):
            kck = kpad[:, :, c0:c0 + ckv].to(torch.float32)
            vck = vpad[:, :, c0:c0 + ckv]
            kpc = kvp[c0:c0 + ckv]
            logits = torch.einsum("bkgqd,bksd->bkgqs", qck, kck) * scale
            mask = (kpc[None, :] >= 0) & (kpc[None, :] <= qpc[:, None])
            if window:
                mask = mask & (kpc[None, :] > qpc[:, None] - window)
            logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bkgqs,bksd->bkgqd", p.to(v.dtype).to(torch.float32),
                vck.to(torch.float32))
            m = m_new
        if return_state:
            outs.append((acc, m, l))
        else:
            outs.append((acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype))
    if return_state:
        return tuple(torch.cat([o[i] for o in outs], dim=3)[:, :, :, :sq]
                     for i in range(3))
    out = torch.cat(outs, dim=3).reshape(b, h, nq * cq, d)
    return out[:, :, :sq]


class _SumAcross(torch.autograd.Function):
    """An all-reduce sum over ``group`` whose output every rank holds in
    full: its gradient is the output's, unchanged (the cotangent of a
    replicated output is counted once)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gqa_sdpa_context_parallel(q, k, v, *, window: int, q_pos, kv_pos,
                               axis: str) -> torch.Tensor:
    """Context-parallel flash attention under ``local_map``.

    For heads that do not divide the model axis (llama4 / llama-3.2: 40 H,
    8 KV on a 16-way axis), the kv *sequence* is sharded over ``axis``
    instead: each rank runs :func:`_gqa_sdpa_chunked` over its kv shard
    with its softmax state returned, and the states are combined across the
    shards as JAX combines them -- an all-reduce max of ``m`` (detached: it
    is a pure shift that cancels in the quotient), then sums of ``l * a``
    and ``acc * a`` with ``a = exp(m - m_max)`` -- ring attention's combine
    without the ring.  Plain tensors count as replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    c = sharding.current()
    mesh = c["mesh"]
    batch_axes = c["rules"].get("batch") or None
    bspec = tuple(batch_axes) if batch_axes else None
    group = mesh.get_group(axis)

    def dt(x):
        return x if isinstance(x, DTensor) else DTensor.from_local(
            x, mesh, [Replicate()] * mesh.ndim, run_check=False)

    def pl(*spec):
        return sharding.placements(mesh, spec)

    def body(ql, kl, vl, qpl, kpl):
        acc, m, l = _gqa_sdpa_chunked(
            ql, kl, vl, window=window, q_pos=qpl, kv_pos=kpl,
            return_state=True, allow_window_slice=False)
        out = _combine_states(acc, m, l, [group])
        b, kvh, g, s, d = out.shape
        return out.reshape(b, kvh * g, s, d).to(ql.dtype)

    q_in, kv_in = pl(bspec, None, None, None), pl(bspec, None, (axis,), None)
    # each kv shard gives q a partial gradient
    q_grad = tuple(Partial() if name == axis else p
                   for name, p in zip(sharding.mesh_shape(mesh), q_in))
    ins = (q_in, kv_in, kv_in, pl(None), pl((axis,)))
    f = local_map(body, out_placements=(q_in,), in_placements=ins,
                  in_grad_placements=(q_grad,) + ins[1:], device_mesh=mesh,
                  redistribute_inputs=True)
    return f(dt(q), dt(k), dt(v), dt(q_pos), dt(kv_pos))


def _combine_states(acc, m, l, groups):
    """The softmax states of kv shards combined over ``groups`` (JAX's
    context-parallel combine): a detached all-reduce max of ``m``, then
    sums of ``l * a`` and ``acc * a`` with ``a = exp(m - m_max)``, and
    the quotient."""
    import torch.distributed as dist
    m_g = m.detach().clone()
    for g in groups:
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=g)
    alpha = torch.exp(m - m_g)
    l_g, acc_g = l * alpha, acc * alpha
    for g in groups:
        l_g = _SumAcross.apply(l_g, g)
        acc_g = _SumAcross.apply(acc_g, g)
    return acc_g / torch.where(l_g == 0.0, 1.0, l_g)


def _gqa_sdpa_sharded(q, k, v, *, window: int, q_pos, kv_pos,
                      mask_mode: str = "causal", fn=None) -> torch.Tensor:
    """GQA attention over DTensors, run on each rank's local (batch, head)
    blocks under ``local_map``: attention is independent per row and per
    head, so the rows stay on their batch shards and the query heads on
    their model shards when they divide (else they are gathered); the KV
    heads shard with them when they divide too, else each rank holds them
    all and takes the one each of its query heads reads.  A KV sequence sharded
    over mesh dims (decode's ``kv_seq``) stays sharded: each rank attends
    over its entries and the softmax states are combined across them.  A
    mesh dim of size 1 shards nothing, so a one-rank mesh runs the
    unsharded arithmetic.  ``fn`` (default the direct or chunked form, as
    :func:`_gqa_sdpa` picks) takes ``(q, k, v, q_pos, kv_pos)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ref = next(t for t in (q, k, v) if isinstance(t, DTensor))
    mesh = ref.device_mesh
    n = mesh.ndim
    sizes = list(mesh.shape)

    def dims(t, d):
        if not isinstance(t, DTensor):
            return []
        return [i for i, p in enumerate(t.placements)
                if isinstance(p, Shard) and p.dim == d and sizes[i] > 1]

    bd = dims(q, 0)
    hd = sorted(set(dims(q, 1)) | set(dims(k, 1)))
    hsize = math.prod(sizes[i] for i in hd)
    if q.shape[1] % hsize:
        hd = []
    # the query heads shard; the KV heads too when they divide, else every
    # rank holds them all and takes the ones its query heads read
    kv_hd = [] if k.shape[1] % hsize else hd
    pick = None
    if hd and not kv_hd:
        coord, idx = mesh.get_coordinate(), 0
        for i in hd:
            idx = idx * sizes[i] + coord[i]
        hl, group = q.shape[1] // hsize, q.shape[1] // k.shape[1]
        pick = (idx * hl + torch.arange(hl)) // group
    sd = dims(k, 2)

    def pl(**by):
        out = [Replicate()] * n
        for d, mdims in by.items():
            for i in mdims:
                out[i] = Shard(int(d[1:]))
        return tuple(out)

    q_pl = pl(d0=bd, d1=hd)
    kv_pl = pl(d0=bd, d1=kv_hd, d2=sd)
    qp_pl = pl(d0=bd) if q_pos.dim() == 2 else pl()
    kp_pl = pl(d0=bd, d1=sd) if kv_pos.dim() == 2 else pl(d0=sd)
    groups = [mesh.get_group(i) for i in sd]
    sq = q.shape[2]

    def body(ql, kl, vl, qpl, kpl):
        if pick is not None:
            kl, vl = kl[:, pick.to(kl.device)], vl[:, pick.to(vl.device)]
        if groups:
            acc, m, l = _gqa_sdpa_direct(ql, kl, vl, window=window,
                                         q_pos=qpl, kv_pos=kpl,
                                         mask_mode=mask_mode,
                                         return_state=True)
            out = _combine_states(acc, m, l, groups)
            b, kvh, g, s, d = out.shape
            return out.reshape(b, kvh * g, s, d).to(ql.dtype)
        if fn is not None:
            return fn(ql, kl, vl, qpl, kpl)
        if sq >= 2048 and mask_mode != "none":
            return _gqa_sdpa_chunked(ql, kl, vl, window=window, q_pos=qpl,
                                     kv_pos=kpl)
        return _gqa_sdpa_direct(ql, kl, vl, window=window, q_pos=qpl,
                                kv_pos=kpl, mask_mode=mask_mode)

    rep = (Replicate(),) * n

    def dt(x):
        return x if isinstance(x, DTensor) else DTensor.from_local(
            x, mesh, rep, run_check=False)

    ins = (q_pl, kv_pl, kv_pl, qp_pl, kp_pl)
    # held whole, the KV heads get a partial gradient from each head shard
    kv_grad = tuple(Partial() if pick is not None and i in hd else p
                    for i, p in enumerate(kv_pl))
    f = local_map(body, out_placements=(q_pl,), in_placements=ins,
                  in_grad_placements=(q_pl, kv_grad, kv_grad) + ins[3:],
                  device_mesh=mesh, redistribute_inputs=True)
    return f(dt(q), dt(k), dt(v), dt(q_pos), dt(kv_pos))


def _context_parallel_axis(skv: int) -> str | None:
    """The mesh axis for context-parallel attention, if the rules enable it
    and the kv length divides."""
    c = sharding.current()
    if not c or c["mesh"] is None:
        return None
    axis = c["rules"].get("attn_context_parallel")
    if not axis:
        return None
    if skv % sharding.mesh_shape(c["mesh"]).get(axis, 1) != 0:
        return None
    return axis


def _gqa_sdpa(q, k, v, *, window: int, q_pos, kv_pos,
              mask_mode: str = "causal") -> torch.Tensor:
    """GQA attention as JAX ``_gqa_sdpa`` dispatches it: for a masked mode
    at 2048 queries or more (shared [S] positions) the context-parallel
    form when the rules ask for it and the kv sequence divides, else the
    chunked form; the direct form otherwise, so an unmasked (cross)
    prefill of any length stays direct.  DTensors (under a mesh) go
    through :func:`_gqa_sdpa_sharded`."""
    sq, skv = q.shape[2], k.shape[2]
    if sq >= 2048 and mask_mode != "none":
        axis = _context_parallel_axis(skv)
        if axis is not None and sq == skv:
            return _gqa_sdpa_context_parallel(q, k, v, window=window,
                                              q_pos=q_pos, kv_pos=kv_pos,
                                              axis=axis)
    if any(sharding.is_dtensor(t) for t in (q, k, v)):
        return _gqa_sdpa_sharded(q, k, v, window=window, q_pos=q_pos,
                                 kv_pos=kv_pos, mask_mode=mask_mode)
    if sq >= 2048 and mask_mode != "none":
        return _gqa_sdpa_chunked(q, k, v, window=window, q_pos=q_pos,
                                 kv_pos=kv_pos)
    return _gqa_sdpa_direct(q, k, v, window=window, q_pos=q_pos,
                            kv_pos=kv_pos, mask_mode=mask_mode)


@dataclasses.dataclass
class KVCache:
    """Dense decode cache for one attention layer (and the
    position-identity block ``scatter_prefill`` writes into the pages).

    ``k, v``: [B, KV, S_cache, D].  ``pos``: [B, S_cache] token position
    held in each slot (-2^30 for empty: always masked); every batch row
    advances at its own position.  For sliding-window layers ``S_cache ==
    window`` and the slots are a ring buffer (position ``p`` at ``p %
    S_cache``); for full attention ``S_cache`` is the max context.  With
    ``cfg.kv_cache_dtype == "int8"``, ``k``/``v`` hold int8 values with
    per-(batch, head, slot) symmetric scales ``k_scale``/``v_scale``
    ([B, KV, S_cache] f32), dequantized inside ``decode_attention``.  The
    tensors are updated in place.
    """
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def init(cfg, batch: int, s_cache: int, dtype, device) -> "KVCache":
        """An empty cache: zeros, every position empty."""
        kvh, hd = cfg.num_kv_heads, cfg.head_dim
        int8 = getattr(cfg, "kv_cache_dtype", "") == "int8"
        shape = (batch, kvh, s_cache, hd)
        kv_dtype = torch.int8 if int8 else dtype
        scales = {}
        if int8:
            scales = {name: torch.zeros(shape[:3], dtype=torch.float32,
                                        device=device)
                      for name in ("k_scale", "v_scale")}
        return KVCache(
            k=torch.zeros(shape, dtype=kv_dtype, device=device),
            v=torch.zeros(shape, dtype=kv_dtype, device=device),
            pos=torch.full((batch, s_cache), POS_EMPTY, dtype=torch.int32,
                           device=device),
            **scales)


@dataclasses.dataclass
class PagedKVCache:
    """Block/paged decode cache for one attention layer (serving engine).

    ``k, v``: [n_pages + 1, KV, page_size, D] -- a pool of fixed-size pages
    shared by every serving slot, plus the trash page at index ``n_pages``
    (module docstring).  ``pos``: [n_pages + 1, page_size] absolute token
    position per entry (-2^30 = empty).  ``page_table``: [n_slots,
    max_pages] int32 physical page per (slot, logical page); rows of
    unallocated slots hold the sentinel ``n_pages``, so their writes land in
    the trash page and their reads are dead.  Token position ``p`` of a slot
    lives at logical index ``p % logical_len`` (ring semantics).  An int8
    pool (``cfg.kv_cache_dtype == "int8"``) holds int8 ``k``/``v`` with
    per-(page, head, offset) scales ``k_scale``/``v_scale`` ([n_pages + 1,
    KV, page_size] f32, the trash page included).  The tensors are updated
    in place.
    """
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    page_table: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def logical_len(self) -> int:
        return self.page_table.shape[1] * self.k.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k.shape[0] - 1   # the last page is the trash page


def _gather_pool_view(cache: PagedKVCache, bsz: int, kvh: int, hd: int):
    """Per-slot contiguous view of the pool: (k, v [B, KV, L, D] -- f32
    dequantized for an int8 pool -- and pos [B, L]).  Sentinel entries
    clamp to page ``n_pages - 1``, as JAX's gather does; their positions
    are garbage the mask never admits for a live query."""
    logical = cache.logical_len
    tbl = cache.page_table.long().clamp(0, cache.n_pages - 1)
    kg = cache.k[tbl].permute(0, 2, 1, 3, 4).reshape(bsz, kvh, logical, hd)
    vg = cache.v[tbl].permute(0, 2, 1, 3, 4).reshape(bsz, kvh, logical, hd)
    posg = cache.pos[tbl].reshape(bsz, logical)
    if cache.quantized:
        ksg = cache.k_scale[tbl].permute(0, 2, 1, 3).reshape(bsz, kvh, logical)
        vsg = cache.v_scale[tbl].permute(0, 2, 1, 3).reshape(bsz, kvh, logical)
        kg = kg.to(torch.float32) * ksg[..., None]
        vg = vg.to(torch.float32) * vsg[..., None]
    return kg, vg, posg


def _paged_chunk(cfg, cache: PagedKVCache, q, k, v, *, positions, lengths,
                 window: int):
    """Prefill one chunk against a paged cache: each row attends over its
    already-written pages plus the causal in-chunk block, then its valid
    K/V are scattered into the pages (attend before scatter: with ring wrap
    a chunk may evict positions its own earlier queries still need).

    ``positions`` [B, S] are global (row ``b`` holds ``starts[b] +
    arange(S)``); ``lengths[b]`` of the S tokens are real (0 for an idle
    row, whose state is untouched).  Returns (out, cache), the cache
    updated in place.
    """
    from repro_torch.serving.paged_kv import scatter_prefill
    b, kvh, s, hd = k.shape
    if positions.dim() != 2:
        raise ValueError("paged chunk prefill needs per-slot [B, S] "
                         "positions (global: starts[b] + arange(S))")
    positions = positions.to(torch.int32)
    starts = positions[:, 0]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=k.device)
    lengths = lengths.to(torch.int32)

    kg, vg, posg = _gather_pool_view(cache, b, kvh, hd)
    # in-chunk keys past a row's length are masked by the empty position:
    # an idle row (length 0) has no valid query to hide behind
    j = torch.arange(s, dtype=torch.int32, device=k.device)
    in_pos = torch.where(j[None, :] < lengths[:, None], positions,
                         torch.full_like(positions, POS_EMPTY))
    k_all = torch.cat([kg, k.to(kg.dtype)], dim=2)
    v_all = torch.cat([vg, v.to(vg.dtype)], dim=2)
    pos_all = torch.cat([posg, in_pos], dim=1)
    out = _gqa_sdpa_direct(q, k_all, v_all, window=window, q_pos=positions,
                           kv_pos=pos_all)
    ks = vs = None
    if cache.quantized:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    dense_rows = KVCache(k=k, v=v, pos=in_pos, k_scale=ks, v_scale=vs)
    scatter_prefill(cache, dense_rows,
                    torch.arange(b, dtype=torch.int32, device=k.device),
                    lengths, starts=starts)
    return out, cache


def _paged_decode(cfg, cache: PagedKVCache, q, k, v, *, positions,
                  window: int, lengths=None,
                  kernels: Kernels = DEFAULT_KERNELS):
    """One-token decode against a paged cache: write the new K/V into each
    slot's page (in place), then attend straight off the page pools with
    ``kernels.paged_attention``.

    ``positions`` must be per slot [B, 1].  Rows of unallocated slots carry
    the sentinel in their table row, so their writes go to the trash page
    and their attention reads nothing.  ``lengths`` ([B], the live mask)
    additionally sends the writes of rows with ``lengths == 0`` to the
    trash page -- a slot mid-prefill holds a live table row that a decode
    step it does not take part in must not touch.
    """
    if positions.dim() != 2:
        raise ValueError("paged decode needs per-slot [B, 1] positions")
    if k.shape[2] != 1:
        raise ValueError("paged cache decode is one token per slot; chunk "
                         "prefill goes through _paged_chunk")
    bsz = q.shape[0]
    ps = cache.page_size
    n_pages = cache.n_pages
    pvec = positions[:, 0].to(torch.int32)                       # [B]
    li = pvec % cache.logical_len                                 # ring slot
    rows = torch.arange(bsz, device=q.device)
    pp = cache.page_table[rows, (li // ps).long()].long()         # [B]
    if lengths is not None:
        pp = torch.where(lengths > 0, pp, torch.full_like(pp, n_pages))
    off = (li % ps).long()
    ksc = vsc = None
    if cache.quantized:
        k, ks_new = quantize_kv(k)
        v, vs_new = quantize_kv(v)
        cache.k_scale[pp, :, off] = ks_new[:, :, 0]
        cache.v_scale[pp, :, off] = vs_new[:, :, 0]
        ksc, vsc = cache.k_scale[:n_pages], cache.v_scale[:n_pages]
    cache.k[pp, :, off] = k[:, :, 0].to(cache.k.dtype)
    cache.v[pp, :, off] = v[:, :, 0].to(cache.v.dtype)
    cache.pos[pp, off] = pvec
    out = kernels.paged_attention(
        q[:, :, 0].contiguous(), cache.k[:n_pages], cache.v[:n_pages],
        pos_pages=cache.pos[:n_pages], page_table=cache.page_table,
        q_pos=pvec, k_scale=ksc, v_scale=vsc, window=window)[:, :, None]
    return out, cache


def _dense_prefill(cache: KVCache, k, v, *, positions) -> None:
    """Write a prefill's K/V into a dense cache, in place: the last
    ``keep = min(S, S_cache)`` rows go to slots ``0..keep-1``, then the
    whole cache rolls by ``positions[-keep] % S_cache``, so slot == pos %
    S_cache, as the per-slot decode writes it (JAX ``layers.py`` dense
    prefill).  int8 caches store the quantized rows and their scales.  The
    roll is a gather by a device index, so nothing syncs with the host."""
    s_cache = cache.k.shape[2]
    keep = min(k.shape[2], s_cache)
    k_last, v_last = k[:, :, -keep:], v[:, :, -keep:]
    p_last = positions[-keep:].to(torch.int32)
    slot = torch.arange(s_cache, device=k.device)
    src = (slot - p_last[0].long()) % s_cache     # torch.roll by p_last[0]
    if sharding.is_dtensor(cache.k):
        _dense_prefill_sharded(cache, k_last, v_last, p_last, src, keep)
        return
    if cache.quantized:
        k_last, ks_new = quantize_kv(k_last)
        v_last, vs_new = quantize_kv(v_last)
        for leaf, new in ((cache.k_scale, ks_new), (cache.v_scale, vs_new)):
            leaf[:, :, :keep] = new
            leaf.copy_(leaf.index_select(2, src))
    for leaf, new in ((cache.k, k_last), (cache.v, v_last)):
        leaf[:, :, :keep] = new.to(leaf.dtype)
        leaf.copy_(leaf.index_select(2, src))
    cache.pos[:, :keep] = p_last
    cache.pos.copy_(cache.pos.index_select(1, src))


def _assign(leaf, new) -> None:
    """``leaf.copy_(new)``, a DTensor ``new`` placed as ``leaf`` first."""
    if sharding.is_dtensor(leaf) and sharding.is_dtensor(new) and tuple(
            new.placements) != tuple(leaf.placements):
        new = new.redistribute(leaf.device_mesh, leaf.placements)
    leaf.copy_(new)


def _dense_prefill_sharded(cache: KVCache, k_last, v_last, p_last, src,
                           keep: int) -> None:
    """:func:`_dense_prefill`'s writes on DTensor caches, out of place and
    then copied in (DTensor takes no in-place write that changes a
    placement): the same values."""
    news = [(cache.k, k_last), (cache.v, v_last)]
    if cache.quantized:
        k_last, ks_new = quantize_kv(k_last)
        v_last, vs_new = quantize_kv(v_last)
        news = [(cache.k, k_last), (cache.v, v_last),
                (cache.k_scale, ks_new), (cache.v_scale, vs_new)]
    for leaf, new in news:
        full = torch.cat([new.to(leaf.dtype), leaf[:, :, keep:]], dim=2)
        _assign(leaf, full.index_select(2, src))
    pos = torch.cat([p_last[None].expand(cache.pos.shape[0], keep),
                     cache.pos[:, keep:]], dim=1)
    _assign(cache.pos, pos.index_select(1, src))


def _put_slots(leaf, new, slots) -> None:
    """``leaf[rows, :, slots] = new`` (``leaf[rows, slots]`` for a [B, S]
    leaf), in place.  On a DTensor ``leaf`` the write is made on this
    rank's shard: ``new`` and ``slots`` are placed as the leaf's rows and
    heads, whole along the sequence, each slot is shifted by the shard's
    first entry, and a row whose slot another shard holds keeps its entry
    (O(B*KV*D) a step, as the unsharded write)."""
    sdim = min(2, leaf.dim() - 1)
    if not sharding.is_dtensor(leaf):
        rows = torch.arange(slots.shape[0], device=slots.device)
        leaf[(rows,) + (slice(None),) * (sdim - 1) + (slots,)] = new.to(
            leaf.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = leaf.device_mesh, leaf.placements
    # this shard's first entry and length along the sequence, split as
    # torch.chunk splits, mesh dim by mesh dim
    lo, n, coord = 0, leaf.shape[sdim], mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == sdim:
            c = -(-n // mesh.size(i))
            lo += min(coord[i] * c, n)
            n = max(0, min(c, n - coord[i] * c))
    if n == 0:
        return

    def local(t, want):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, want).to_local()

    new_l = local(new, [Shard(p.dim - (p.dim > sdim))
                        if isinstance(p, Shard) and p.dim != sdim
                        else Replicate() for p in pl]).to(leaf.dtype)
    sl = local(slots, [p if isinstance(p, Shard) and p.dim == 0
                       else Replicate() for p in pl]) - lo
    hit = ((sl >= 0) & (sl < n)).view(-1, *([1] * (new_l.dim() - 1)))
    rows = torch.arange(sl.shape[0], device=sl.device)
    idx = (rows,) + (slice(None),) * (sdim - 1) + (sl.clamp(0, n - 1),)
    ll = leaf.to_local()
    ll[idx] = torch.where(hit, new_l, ll[idx])


def _dense_decode(cache: KVCache, q, k, v, *, positions, window: int,
                  kernels: Kernels = DEFAULT_KERNELS):
    """One-token decode against a dense cache: every row writes its token
    at its own ring slot ``pos % S_cache`` (in place), then attends at its
    own position.  int8 caches quantize the token first and attend through
    ``kernels.decode_attention`` over the quantized cache, the new token
    included; float caches attend with the plain ``_gqa_sdpa``, as JAX
    does."""
    if k.shape[2] != 1:
        raise ValueError(
            "per-slot positions with multi-token input: per-slot prefill "
            "goes through the serving engine's chunked prefill, not the "
            "dense cache path")
    s_cache = cache.k.shape[2]
    pvec = positions[:, 0].to(torch.int32)                        # [B]
    slots = (pvec % s_cache).long()
    # two advanced indices around a slice: the broadcast [B] dim comes
    # first, so the target is [B, KV, D] ([B, KV] for the scales), as in
    # JAX's ``.at[rows, :, slots]``
    if cache.quantized:
        k, ks_new = quantize_kv(k)
        v, vs_new = quantize_kv(v)
        _put_slots(cache.k_scale, ks_new[:, :, 0], slots)
        _put_slots(cache.v_scale, vs_new[:, :, 0], slots)
    _put_slots(cache.k, k[:, :, 0], slots)
    _put_slots(cache.v, v[:, :, 0], slots)
    _put_slots(cache.pos, pvec, slots)
    if cache.quantized:
        return kernels.decode_attention(
            q[:, :, 0].contiguous(), cache.k, cache.v, kv_pos=cache.pos,
            q_pos=pvec, k_scale=cache.k_scale, v_scale=cache.v_scale,
            window=window)[:, :, None]
    return _gqa_sdpa(q, cache.k, cache.v, window=window, q_pos=positions,
                     kv_pos=cache.pos)


def attention(cfg, params: Params, prefix: str, x: torch.Tensor, *,
              positions: torch.Tensor, window: int = 0,
              cache: KVCache | PagedKVCache | None = None,
              lengths: torch.Tensor | None = None,
              kernels: Kernels = DEFAULT_KERNELS):
    """One attention layer through the uniform-GEMM projections.

    Modes: causal self-attention over x (no cache; a window layer at
    ``S % 128 == 0`` through ``kernels.swa_attention``); dense prefill (a ``KVCache``, shared
    [S] positions: attend over the raw K/V, store the last rows); dense
    decode (a ``KVCache``, per-slot [B, 1] positions); paged decode (a
    ``PagedKVCache``, one token per slot, per-slot [B, 1] positions); paged
    chunk prefill (a ``PagedKVCache``, S > 1, per-slot [B, S] positions,
    ``lengths`` real tokens per row).  RoPE applies only under
    ``cfg.positional == "rope"``.  Cross attention is
    ``transformer._cross``.  Returns (y, cache).
    """
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(x, params[f"{prefix}_wq"], bias=params.get(f"{prefix}_bq"),
              kernels=kernels)
    k = dense(x, params[f"{prefix}_wk"], bias=params.get(f"{prefix}_bk"),
              kernels=kernels)
    v = dense(x, params[f"{prefix}_wv"], bias=params.get(f"{prefix}_bv"),
              kernels=kernels)
    q = _split_heads(q, h, hd)
    k = _split_heads(k, kv, hd)
    v = _split_heads(v, kv, hd)
    if cfg.positional == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if isinstance(cache, PagedKVCache):
        if k.shape[2] == 1:
            out, cache = _paged_decode(cfg, cache, q, k, v,
                                       positions=positions, window=window,
                                       lengths=lengths, kernels=kernels)
        else:
            out, cache = _paged_chunk(cfg, cache, q, k, v,
                                      positions=positions, lengths=lengths,
                                      window=window)
    elif cache is not None and positions.dim() == 1:
        _dense_prefill(cache, k, v, positions=positions)
        out = _gqa_sdpa(q, k, v, window=window, q_pos=positions,
                        kv_pos=positions)
    elif cache is not None:
        out = _dense_decode(cache, q, k, v, positions=positions,
                            window=window, kernels=kernels)
    elif window and q.shape[2] % 128 == 0:
        # the reference's own dispatch, not a fallback: JAX takes its
        # swa_attention kernel (128-row blocks) only when S % 128 == 0 and
        # _gqa_sdpa otherwise.  The kernel masks by the implicit arange(S),
        # as the Pallas kernel does: this branch only has shared [S]
        # positions, and the mask depends on their differences alone.  Under
        # grad the entry records its own gradient, as ``dense``'s does:
        # ops.swa_attention through SwaAttention (the backward a kernel on
        # the card), the plain version through autograd, so a ``Kernels``
        # with the plain entry is plain both ways.
        swa = lambda a, b, c, *_: kernels.swa_attention(  # noqa: E731
            a.contiguous(), b.contiguous(), c.contiguous(), window=window)
        out = (_gqa_sdpa_sharded(q, k, v, window=window, q_pos=positions,
                                 kv_pos=positions, fn=swa)
               if sharding.is_dtensor(q) else swa(q, k, v))
    else:
        out = _gqa_sdpa(q, k, v, window=window, q_pos=positions,
                        kv_pos=positions)
    out = sharding.shard(out, "batch", "heads", "seq", "head_dim")
    y = dense(_merge_heads(out), params[f"{prefix}_wo"], kernels=kernels)
    return y, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_specs(cfg, prefix: str = "mlp") -> dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {
            f"{prefix}_wi_gate": Spec((d, f), ("embed", "mlp")),
            f"{prefix}_wi_up": Spec((d, f), ("embed", "mlp")),
            f"{prefix}_wo": Spec((f, d), ("mlp", "embed")),
        }
    return {
        f"{prefix}_wi": Spec((d, f), ("embed", "mlp")),
        f"{prefix}_bi": Spec((f,), ("mlp",), 0.0),
        f"{prefix}_wo": Spec((f, d), ("mlp", "embed")),
        f"{prefix}_bo": Spec((d,), ("embed",), 0.0),
    }


def mlp(cfg, params: Params, prefix: str, x: torch.Tensor, *,
        kernels: Kernels = DEFAULT_KERNELS) -> torch.Tensor:
    """SwiGLU (the gate's silu in its GEMM's epilogue), or the gelu MLP
    (bias and the tanh gelu in the first GEMM's epilogue, bias in the
    second's)."""
    if cfg.mlp == "swiglu":
        gate = dense(x, params[f"{prefix}_wi_gate"], activation="silu",
                     kernels=kernels)
        up = dense(x, params[f"{prefix}_wi_up"], kernels=kernels)
        h = sharding.shard(gate * up, "batch", "seq", "mlp")
        return dense(h, params[f"{prefix}_wo"], kernels=kernels)
    h = dense(x, params[f"{prefix}_wi"], bias=params[f"{prefix}_bi"],
              activation="gelu", kernels=kernels)
    h = sharding.shard(h, "batch", "seq", "mlp")
    return dense(h, params[f"{prefix}_wo"], bias=params[f"{prefix}_bo"],
                 kernels=kernels)
