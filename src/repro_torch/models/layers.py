"""Model building blocks on the serving main path: RMSNorm, RoPE, the
uniform-GEMM dense layer, GQA attention over paged KV pools and dense KV
caches, and the SwiGLU MLP.

A port of ``repro.models.layers`` for the dense GQA decoder (layernorm,
sinusoidal positions and the gelu MLP come with musicgen, ROADMAP Queue 1
item 8).  Every matmul
goes through :func:`dense`, which calls ``kernels.matmul`` -- by default
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


def apply_norm(cfg, params: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params[f"{prefix}_gamma"], cfg.norm_eps)


def norm_specs(cfg, prefix: str) -> dict[str, Spec]:
    return {f"{prefix}_gamma": Spec((cfg.d_model,), ("embed",), -1.0)}


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


# ---------------------------------------------------------------------------
# The uniform-GEMM dense layer
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor, *, bias: torch.Tensor | None = None,
          activation: str | None = None,
          kernels: Kernels = DEFAULT_KERNELS) -> torch.Tensor:
    """x: [..., K] @ w: [K, N] through ``kraken_gemm``, bias and activation
    fused in its epilogue."""
    lead = x.shape[:-1]
    out = kernels.matmul(x.reshape(-1, x.shape[-1]).contiguous(), w,
                         bias=bias, activation=activation)
    return out.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# Attention (GQA; causal self-attention and paged-cache serving)
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
    return x.reshape(b, s, n, hd).transpose(1, 2)   # [B, H, S, D]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _gqa_sdpa_direct(q, k, v, *, window: int, q_pos, kv_pos) -> torch.Tensor:
    """Causal attention by position: q [B,H,Sq,D], k/v [B,KV,Sk,D], fp32
    scores; key ``j`` is visible to query ``i`` when ``0 <= kv_pos[j] <=
    q_pos[i]`` (and inside ``window`` when one is set).

    Masked scores are -1e30, not -inf, so a row with nothing to attend to
    (an idle slot) stays finite, as in the JAX version.  The probabilities
    are rounded to the compute dtype before the value product, as there.
    """
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    group = h // kvh
    qg = q.reshape(b, kvh, group, sq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    # positions may be shared ([Sq]/[Sk]) or per slot ([B, Sq]/[B, Sk])
    qp = q_pos[None, :, None] if q_pos.dim() == 1 else q_pos[:, :, None]
    kp = kv_pos[None, None, :] if kv_pos.dim() == 1 else kv_pos[:, None, :]
    mask = (kp <= qp) & (kp >= 0)   # kp >= 0 excludes empty entries
    if window:
        mask = mask & (kp > qp - window)
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd",
                       probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.reshape(b, h, sq, d).to(q.dtype)


_CHUNK_Q = 1024
_CHUNK_KV = 1024


def _gqa_sdpa_chunked(q, k, v, *, window: int, q_pos, kv_pos) -> torch.Tensor:
    """Flash-style double-chunked causal attention in torch ops, for long
    prefill sequences (JAX ``_gqa_sdpa_chunked`` with ``causal=True``,
    ``return_state=False``, ``allow_window_slice=True``; the
    context-parallel state comes with the multi-device code, ROADMAP Queue 1
    item 14).

    q [B,H,Sq,D], k/v [B,KV,Skv,D], shared positions q_pos [Sq] and kv_pos
    [Skv].  An online softmax over kv chunks inside a loop over q chunks
    keeps the live scores at [B, H, cq, ckv] instead of [B, H, Sq, Skv].
    For a window layer only the ``window + cq`` kv slice of each q chunk is
    read, when it is at most half the padded kv length.  Padded q rows
    carry position 2^30 and padded kv slots -2^30, so the mask drops them.
    Scores are fp32 and the probabilities are rounded to V's dtype before
    the value product, as there.
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
    use_window_slice = bool(window) and (window + cq) * 2 <= skv_p
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
        outs.append((acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype))
    out = torch.cat(outs, dim=3).reshape(b, h, nq * cq, d)
    return out[:, :, :sq]


def _gqa_sdpa(q, k, v, *, window: int, q_pos, kv_pos) -> torch.Tensor:
    """Causal GQA attention as JAX ``_gqa_sdpa`` dispatches it: the chunked
    form for 2048 queries or more (it takes shared [S] positions), the
    direct form below.  (JAX's unmasked mode comes with cross attention,
    ROADMAP Queue 1 item 8; its context-parallel branch with the
    multi-device code, item 14.)"""
    if q.shape[2] >= 2048:
        return _gqa_sdpa_chunked(q, k, v, window=window, q_pos=q_pos,
                                 kv_pos=kv_pos)
    return _gqa_sdpa_direct(q, k, v, window=window, q_pos=q_pos,
                            kv_pos=kv_pos)


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
    rows = torch.arange(q.shape[0], device=q.device)
    # two advanced indices around a slice: the broadcast [B] dim comes
    # first, so the target is [B, KV, D] ([B, KV] for the scales), as in
    # JAX's ``.at[rows, :, slots]``
    if cache.quantized:
        k, ks_new = quantize_kv(k)
        v, vs_new = quantize_kv(v)
        cache.k_scale[rows, :, slots] = ks_new[:, :, 0]
        cache.v_scale[rows, :, slots] = vs_new[:, :, 0]
    cache.k[rows, :, slots] = k[:, :, 0].to(cache.k.dtype)
    cache.v[rows, :, slots] = v[:, :, 0].to(cache.v.dtype)
    cache.pos[rows, slots] = pvec
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
    ``S % 128 == 0`` through ``kernels.swa_attention``); dense prefill (a
    ``KVCache``, shared [S] positions: attend over the raw K/V, store the
    last rows); dense decode (a ``KVCache``, per-slot [B, 1] positions);
    paged decode (a ``PagedKVCache``, one token per slot, per-slot [B, 1]
    positions); paged chunk prefill (a ``PagedKVCache``, S > 1, per-slot
    [B, S] positions, ``lengths`` real tokens per row).  Returns (y, cache).
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
        # positions, and the mask depends on their differences alone.
        out = kernels.swa_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), window=window)
    else:
        out = _gqa_sdpa(q, k, v, window=window, q_pos=positions,
                        kv_pos=positions)
    y = dense(_merge_heads(out), params[f"{prefix}_wo"], kernels=kernels)
    return y, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_specs(cfg, prefix: str = "mlp") -> dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        f"{prefix}_wi_gate": Spec((d, f), ("embed", "mlp")),
        f"{prefix}_wi_up": Spec((d, f), ("embed", "mlp")),
        f"{prefix}_wo": Spec((f, d), ("mlp", "embed")),
    }


def mlp(cfg, params: Params, prefix: str, x: torch.Tensor, *,
        kernels: Kernels = DEFAULT_KERNELS) -> torch.Tensor:
    """SwiGLU: the gate's silu runs in its GEMM's epilogue."""
    gate = dense(x, params[f"{prefix}_wi_gate"], activation="silu",
                 kernels=kernels)
    up = dense(x, params[f"{prefix}_wi_up"], kernels=kernels)
    return dense(gate * up, params[f"{prefix}_wo"], kernels=kernels)
