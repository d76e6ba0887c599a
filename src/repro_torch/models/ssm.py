"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba2 (SSD).

A port of ``repro.models.ssm``.  Both carry O(1) recurrent state per row.
The projections go through :func:`~repro_torch.models.layers.dense`, so
through ``kraken_gemm`` on the card; the recurrences are torch ops (the
reference has no Pallas kernel for them).  States are NamedTuples of
tensors: the float32 recurrent state and the token-shift or conv window in
the model dtype.

Prefill and the engine's mixed step use a *chunked* evaluation: the
sequence is split into chunks, the within-chunk terms are computed for all
chunks at once, and an exact state is carried from chunk to chunk.  The
reference writes its within-chunk terms so that they take ``exp`` of a
positive number and overflow float32 at full width (``ssm.py:181-182``,
``:399``: NaN outputs past about 64 tokens for rwkv6-3b and 100 for
zamba2-1.2b).  The port computes the same recurrence in a form whose kept
terms never do: Mamba masks the exponent, not the product, and RWKV's
within-chunk decay is taken pairwise inside ``BLOCK``-token sub-blocks and,
between them, factored through the end of the earlier sub-block, so both
factors are at most 1.  The chunk length is the port's own choice: it does
not change the function.

While a profiler records, the recurrences run inside
``record_function("recurrence")``, so a trace can group their kernels.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.models.layers import DEFAULT_KERNELS, Kernels, Spec, dense

Params = dict
#: the longest chunk of the chunked evaluation (the reference uses 128)
CHUNK = 64
#: RWKV's within-chunk sub-block (divides CHUNK)
BLOCK = 16


def _span():
    """The profiler range the recurrences run in, only while one records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("recurrence")
    return contextlib.nullcontext()


def _chunk_len(s: int) -> int:
    """The chunk for ``s`` tokens: ``CHUNK``, or ``s`` rounded up to a
    whole ``BLOCK`` when that is shorter."""
    return min(CHUNK, -(-s // BLOCK) * BLOCK)


# ===========================================================================
# RWKV6 (Finch): data-dependent decay, per-head 2D state [D_head, D_head].
# ===========================================================================

def rwkv_specs(cfg, prefix: str = "rwkv") -> dict[str, Spec]:
    d = cfg.d_model
    lora = max(32, d // 16)
    return {
        f"{prefix}_mix_r": Spec((d,), ("embed",), 0.0),
        f"{prefix}_mix_k": Spec((d,), ("embed",), 0.0),
        f"{prefix}_mix_v": Spec((d,), ("embed",), 0.0),
        f"{prefix}_mix_w": Spec((d,), ("embed",), 0.0),
        f"{prefix}_wr": Spec((d, d), ("embed", "qkv")),
        f"{prefix}_wk": Spec((d, d), ("embed", "qkv")),
        f"{prefix}_wv": Spec((d, d), ("embed", "qkv")),
        f"{prefix}_wg": Spec((d, d), ("embed", "qkv")),
        f"{prefix}_wo": Spec((d, d), ("qkv", "embed")),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        f"{prefix}_w0": Spec((d,), ("embed",), 0.0),
        f"{prefix}_wa": Spec((d, lora), ("embed", None)),
        f"{prefix}_wb": Spec((lora, d), (None, "embed")),
        f"{prefix}_bonus": Spec((d,), ("embed",), 0.0),  # u
        f"{prefix}_ln_gamma": Spec((d,), ("embed",), -1.0),
    }


class RwkvState(NamedTuple):
    s: torch.Tensor        # [B, H, Dh, Dh] fp32 state (k outer v)
    x_prev: torch.Tensor   # [B, d] last token (for token-shift)


def _rwkv_heads(cfg) -> tuple[int, int]:
    h = cfg.ssm_heads or (cfg.d_model // 64)
    return h, cfg.d_model // h


def rwkv_state_init(cfg, batch: int, dtype, device) -> RwkvState:
    h, dh = _rwkv_heads(cfg)
    return RwkvState(
        s=torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        x_prev=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))


def _rwkv_project(cfg, params: Params, prefix: str, x: torch.Tensor,
                  x_shift: torch.Tensor, kernels: Kernels):
    """Token-shift mixes + projections.  x, x_shift: [B, S, d].  The mixes
    run in the model dtype; the gate reads the un-shifted ``x``."""
    def mix(name):
        return x + (x_shift - x) * params[f"{prefix}_mix_{name}"]

    r = dense(mix("r"), params[f"{prefix}_wr"], kernels=kernels)
    k = dense(mix("k"), params[f"{prefix}_wk"], kernels=kernels)
    v = dense(mix("v"), params[f"{prefix}_wv"], kernels=kernels)
    g = F.silu(dense(x, params[f"{prefix}_wg"], kernels=kernels))
    lora = torch.tanh(dense(mix("w"), params[f"{prefix}_wa"],
                            kernels=kernels).to(torch.float32))
    # the LoRA's second factor is a plain fp32 product, as in the reference
    w = torch.exp(-torch.exp(params[f"{prefix}_w0"].to(torch.float32)
                             + lora @ params[f"{prefix}_wb"].to(torch.float32)))
    # w: [B,S,d] in (0,1); under a mesh the recurrence runs on batch
    # shards only
    return tuple(sharding.keep_batch(t) for t in (r, k, v, g, w))


def _valid_mask(lengths: torch.Tensor | None, s: int, device):
    """[B, S] bool: position < row length (the recurrence must not see the
    pads of a row shorter than the step)."""
    if lengths is None:
        return None
    return (torch.arange(s, dtype=torch.int32, device=device)[None, :]
            < lengths.to(torch.int32)[:, None])


def _last_valid(x: torch.Tensor, lengths: torch.Tensor | None,
                prev: torch.Tensor | None = None) -> torch.Tensor:
    """x[:, length-1, :] per row ([B, d]); x[:, -1, :] when unmasked.
    ``prev`` is the carried value for rows with ``lengths == 0``: a slot
    that sits out a mixed step keeps its token-shift carry untouched."""
    if lengths is None:
        return x[:, -1, :]
    lengths = lengths.long()
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, (lengths - 1).clamp(min=0)]
    if prev is None:
        return last
    return torch.where((lengths > 0)[:, None], last, prev.to(last.dtype))


def _rwkv_intra(r, k, cum, cum_prev):
    """The within-chunk attention of RWKV, strictly causal: ``att[t, j] =
    sum_d r_t[d] exp(cum_prev_t[d] - cum_j[d]) k_j[d]`` for ``j < t``.

    r, k, cum, cum_prev: [..., C, Dh] with C a multiple of ``BLOCK``.  On a
    diagonal sub-block the decay is taken pairwise, its exponent masked to
    -inf above the diagonal before ``exp``; for a key sub-block J below the
    query's it is factored through J's last position e_J, as
    ``exp(cum_prev_t - e_J) * exp(e_J - cum_j)``: both exponents are <= 0
    (the log-decays are), so nothing overflows.  Returns [..., C, C]."""
    *lead, c, dh = r.shape
    nb, bl = c // BLOCK, BLOCK
    dev = r.device
    blk = lambda a: a.reshape(*lead, nb, bl, dh)  # noqa: E731
    rb, kb, cb, cpb = blk(r), blk(k), blk(cum), blk(cum_prev)
    # diagonal sub-blocks, pairwise: [..., nb, t, j]
    below = torch.tril(torch.ones(bl, bl, dtype=torch.bool, device=dev), -1)
    expo = torch.where(below[:, :, None],
                       cpb[..., :, None, :] - cb[..., None, :, :],
                       -torch.inf)
    diag = (rb[..., :, None, :] * torch.exp(expo)
            * kb[..., None, :, :]).sum(-1)
    # sub-blocks J below the query's, through e_J: [..., C, nb, bl]
    e = cb[..., -1, :]                                     # [..., nb, Dh]
    later = (torch.arange(c, device=dev)[:, None] // bl
             > torch.arange(nb, device=dev)[None, :])      # [C, nb]
    qf = r[..., :, None, :] * torch.exp(torch.where(
        later[:, :, None], cum_prev[..., :, None, :] - e[..., None, :, :],
        -torch.inf))
    kf = kb * torch.exp(e[..., :, None, :] - cb)           # [..., nb, bl, Dh]
    off = torch.einsum("...tJd,...Jjd->...tJj", qf, kf)
    eye = torch.eye(nb, dtype=torch.bool, device=dev)
    att = torch.where(eye[:, None, :, None], diag[..., :, :, None, :],
                      off.reshape(*lead, nb, bl, nb, bl))
    return att.reshape(*lead, c, c)


def _rwkv_scan(r, k, v, w, u, s):
    """The chunked RWKV recurrence.  r, k, v, w: [B, S, H, Dh] fp32 (w the
    per-token decay in (0, 1], 1 at masked positions); u: [H, Dh]; s: the
    state [B, H, Dh, Dh].  Returns (y [B, S, H, Dh], final state)."""
    b, sl, h, dh = r.shape
    c = _chunk_len(sl)
    pad = -sl % c
    if pad:
        z = lambda a, val=0.0: F.pad(a, (0, 0, 0, 0, 0, pad), value=val)  # noqa: E731
        r, k, v, w = z(r), z(k), z(v), z(w, 1.0)
    n = r.shape[1] // c
    # [B, H, NC, C, Dh]
    resh = lambda a: a.reshape(b, n, c, h, dh).permute(0, 3, 1, 2, 4)  # noqa: E731
    r, k, v, w = resh(r), resh(k), resh(v), resh(w)
    logw = torch.log(w.clamp(1e-12, 1.0))
    cum = torch.cumsum(logw, dim=3)                  # inclusive: prod w_1..t
    # exclusive, prod w_1..t-1: cum shifted, so cum_prev_t - cum_{t-1} is
    # exactly 0 (the reference's cum - logw rounds at large |cum|)
    cum_prev = F.pad(cum[..., :-1, :], (0, 0, 1, 0))
    # within each chunk, every chunk at once: the strictly causal decayed
    # term and the bonus diagonal r_t . (u * k_t) v_t
    y = _rwkv_intra(r, k, cum, cum_prev) @ v
    y = y + (r * k * u[None, :, None, None, :]).sum(-1, keepdim=True) * v
    # across chunks: the state decayed into each token, and the state carried
    rq = r * torch.exp(cum_prev)
    total = cum[..., -1:, :]                         # [B, H, NC, 1, Dh]
    kq = k * torch.exp(total - cum)
    decay = torch.exp(total[..., 0, :])              # [B, H, NC, Dh]
    for i in range(n):
        y[:, :, i] += rq[:, :, i] @ s
        s = decay[:, :, i, :, None] * s + kq[:, :, i].transpose(-1, -2) @ v[:, :, i]
    y = y.permute(0, 2, 3, 1, 4).reshape(b, n * c, h, dh)[:, :sl]
    return y, s


def _group_norm(y: torch.Tensor) -> torch.Tensor:
    """Per-head normalization over the last dim (population variance)."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + 64e-5)


def rwkv_mix(cfg, params: Params, prefix: str, x: torch.Tensor,
             state: RwkvState | None = None,
             lengths: torch.Tensor | None = None, *,
             kernels: Kernels = DEFAULT_KERNELS):
    """RWKV6 time-mixing over a sequence (prefill and the mixed step).

    Per head h, per step t:  S_t = diag(w_t) S_{t-1} + k_t v_t^T
                             y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
    ``lengths`` ([B]): positions at and beyond a row's length are masked
    out of the recurrence (``w = 1``, ``k = 0``), so the new state is the
    state after ``lengths[b]`` real tokens; outputs there are garbage for
    the caller to discard.  Returns (y, new_state)."""
    b, s, d = x.shape
    h, dh = _rwkv_heads(cfg)
    if state is None:
        state = rwkv_state_init(cfg, b, x.dtype, x.device)
    x_shift = torch.cat([state.x_prev[:, None, :], x[:, :-1, :]], dim=1)
    r, k, v, g, w = _rwkv_project(cfg, params, prefix, x, x_shift, kernels)
    heads = lambda a: a.reshape(b, s, h, dh).to(torch.float32)  # noqa: E731
    rh, kh, vh, wh = heads(r), heads(k), heads(v), heads(w)
    valid = _valid_mask(lengths, s, x.device)
    if valid is not None:
        kh = kh * valid[:, :, None, None]
        wh = torch.where(valid[:, :, None, None], wh, 1.0)
    u = params[f"{prefix}_bonus"].to(torch.float32).reshape(h, dh)
    with _span():
        y, s_final = sharding.by_rows(_rwkv_scan, rh, kh, vh, wh, u,
                                      state.s, shared=(4,), n_out=2)
    # group norm over heads, then gate + output projection
    y = (sharding.fit_split_grad(_group_norm(y).reshape(b, s, d), 2, h)
         * params[f"{prefix}_ln_gamma"]).to(x.dtype)
    out = dense(y * g, params[f"{prefix}_wo"], kernels=kernels)
    return out, RwkvState(s=s_final,
                          x_prev=_last_valid(x, lengths, state.x_prev))


def _rwkv_step_core(rh, kh, vh, wh, uh, s):
    """One token of the recurrence: (y [B,H,Dh], the new state)."""
    kv = kh[..., :, None] * vh[..., None, :]                 # [B,H,Dh,Dh]
    y = (rh[..., None, :] @ (s + uh[None, :, :, None] * kv))[..., 0, :]
    return y, wh[..., None] * s + kv


def rwkv_step(cfg, params: Params, prefix: str, x: torch.Tensor,
              state: RwkvState, lengths: torch.Tensor | None = None, *,
              kernels: Kernels = DEFAULT_KERNELS):
    """Single-token decode: x [B, 1, d].  ``lengths`` ([B] 0/1, the live
    mask): rows at 0 carry a garbage token and keep their state."""
    b, _, d = x.shape
    h, dh = _rwkv_heads(cfg)
    r, k, v, g, w = _rwkv_project(cfg, params, prefix, x,
                                  state.x_prev[:, None, :], kernels)
    head = lambda a: a.reshape(b, h, dh).to(torch.float32)  # noqa: E731
    rh, kh, vh, wh = head(r), head(k), head(v), head(w)
    uh = params[f"{prefix}_bonus"].to(torch.float32).reshape(h, dh)
    with _span():
        y, s_new = sharding.by_rows(_rwkv_step_core, rh, kh, vh, wh, uh,
                                    state.s, shared=(4,), n_out=2)
    x_last = x[:, -1, :]
    if lengths is not None:
        live = lengths.to(torch.int32) > 0
        s_new = torch.where(live[:, None, None, None], s_new, state.s)
        x_last = torch.where(live[:, None], x_last, state.x_prev)
    yflat = (sharding.fit_split_grad(_group_norm(y).reshape(b, 1, d), 2, h)
             * params[f"{prefix}_ln_gamma"]).to(x.dtype)
    out = dense(yflat * g, params[f"{prefix}_wo"], kernels=kernels)
    return out, RwkvState(s=s_new, x_prev=x_last)


def rwkv_channel_specs(cfg, prefix: str = "cmix") -> dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        f"{prefix}_mix_k": Spec((d,), ("embed",), 0.0),
        f"{prefix}_mix_r": Spec((d,), ("embed",), 0.0),
        f"{prefix}_wk": Spec((d, f), ("embed", "mlp")),
        f"{prefix}_wv": Spec((f, d), ("mlp", "embed")),
        f"{prefix}_wr": Spec((d, d), ("embed", "embed")),
    }


def rwkv_channel_mix(cfg, params: Params, prefix: str, x: torch.Tensor,
                     x_prev: torch.Tensor,
                     lengths: torch.Tensor | None = None, *,
                     kernels: Kernels = DEFAULT_KERNELS):
    """RWKV channel mixing (the FFN); x_prev [B, d] for token shift.  The
    ReLU runs in the GEMM's epilogue.  Token shift is causal, so only the
    carried ``x_prev`` needs each row's last *valid* token."""
    xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    mk = x + (xs - x) * params[f"{prefix}_mix_k"]
    mr = x + (xs - x) * params[f"{prefix}_mix_r"]
    k = dense(mk, params[f"{prefix}_wk"], activation="relu",
              kernels=kernels) ** 2
    k = sharding.shard(k, "batch", "seq", "mlp")
    r = torch.sigmoid(dense(mr, params[f"{prefix}_wr"], kernels=kernels))
    return (r * dense(k, params[f"{prefix}_wv"], kernels=kernels),
            _last_valid(x, lengths, x_prev))


# ===========================================================================
# Mamba2 (SSD): scalar-per-head decay, state [H, Dh, N].
# ===========================================================================

def _mamba_dims(cfg) -> tuple[int, int, int, int]:
    """(heads, head dim, state size N, conv channels) of the expand-2
    block with one group of B and C."""
    d = cfg.d_model
    h = cfg.ssm_heads or (2 * d // 64)
    n = cfg.ssm_state
    return h, 2 * d // h, n, 2 * d + 2 * n


def mamba_specs(cfg, prefix: str = "mamba") -> dict[str, Spec]:
    d = cfg.d_model
    h, _, n, conv_dim = _mamba_dims(cfg)
    din = 2 * d          # inner dim
    return {
        f"{prefix}_in_proj": Spec((d, 2 * din + 2 * n + h), ("embed", "mlp")),
        f"{prefix}_conv_w": Spec((cfg.conv_kernel, conv_dim), ("conv_k", "mlp"), 1.0),
        f"{prefix}_conv_b": Spec((conv_dim,), ("mlp",), 0.0),
        f"{prefix}_a_log": Spec((h,), (None,), 0.0),
        f"{prefix}_dt_bias": Spec((h,), (None,), 0.0),
        f"{prefix}_d_skip": Spec((h,), (None,), -1.0),
        f"{prefix}_norm_gamma": Spec((din,), ("mlp",), -1.0),
        f"{prefix}_out_proj": Spec((din, d), ("mlp", "embed")),
    }


class MambaState(NamedTuple):
    ssm: torch.Tensor      # [B, H, Dh, N] fp32
    conv: torch.Tensor     # [B, K-1, conv_dim] rolling conv input window


def mamba_state_init(cfg, batch: int, dtype, device) -> MambaState:
    h, dh, n, conv_dim = _mamba_dims(cfg)
    return MambaState(
        ssm=torch.zeros((batch, h, dh, n), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype,
                         device=device))


def _mamba_project(cfg, params, prefix, x, conv_state, lengths=None, *,
                   kernels: Kernels = DEFAULT_KERNELS):
    """Shared front: in_proj -> causal conv1d -> (z, xs, B, C, dt).

    ``lengths`` ([B]): the carried conv window holds the inputs ending at
    each row's true length: for row b after L real tokens it is ``full[b,
    L : L+K-1]`` (a row with no token this step keeps its window)."""
    b, s, d = x.shape
    h, _, n, conv_dim = _mamba_dims(cfg)
    din = 2 * d
    # under a mesh the recurrence runs on batch shards only
    zxbcdt = sharding.keep_batch(dense(x, params[f"{prefix}_in_proj"],
                                       kernels=kernels))
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * n, h], dim=-1)
    # causal depthwise conv over the sequence with a rolling window
    kk = cfg.conv_kernel
    full = torch.cat([conv_state, xbc], dim=1)           # [B, K-1+S, cd]
    if kk <= 1:
        new_conv = conv_state
    elif lengths is None:
        new_conv = full[:, -(kk - 1):, :]
    else:
        idx = (lengths.long()[:, None]
               + torch.arange(kk - 1, device=x.device)[None, :])
        new_conv = torch.gather(full, 1,
                                idx[:, :, None].expand(-1, -1, conv_dim))
    w = params[f"{prefix}_conv_w"].to(torch.float32)
    xbc = sum(full[:, i:i + s, :].to(torch.float32) * w[i]
              for i in range(kk)).to(x.dtype)
    xbc = F.silu(xbc + params[f"{prefix}_conv_b"])
    xs, bmat, cmat = torch.split(xbc, [din, n, n], dim=-1)
    # F.softplus is the identity above its threshold of 20, where
    # log1p(exp(-x)) < 2.1e-9: below float32's resolution of x there
    dt = F.softplus(dt + params[f"{prefix}_dt_bias"])    # [B, S, H]
    return z, xs, bmat, cmat, dt, new_conv


def _mamba_scan(x, bm, cm, dt, la, s):
    """The chunked SSD recurrence.  x [B, S, H, Dh], bm/cm [B, S, N], dt
    and the log-decay la = dt * a [B, S, H], all fp32 (dt = 0 at masked
    positions); s the state [B, H, Dh, N].  Returns (y [B, S, H, Dh],
    final state)."""
    b, sl, h, dh = x.shape
    c = _chunk_len(sl)
    pad = -sl % c
    if pad:
        z = lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))  # noqa: E731
        x, bm, cm, dt, la = z(x), z(bm), z(cm), z(dt), z(la)
    n = x.shape[1] // c
    ch = lambda a: a.reshape(b, n, c, *a.shape[2:])  # noqa: E731
    xc, bc, cc, dc, lc = ch(x), ch(bm), ch(cm), ch(dt), ch(la)
    cum = torch.cumsum(lc, dim=2)                        # [B, NC, C, H]
    # within each chunk: y_t = sum_{j<=t} exp(cum_t - cum_j) dt_j (C_t.B_j)
    # x_j; the exponent is masked above the diagonal, before exp
    gad = cc @ bc.transpose(-1, -2)                      # [B, NC, t, j]
    tril = torch.tril(torch.ones(c, c, dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(
        tril[:, :, None], cum[:, :, :, None, :] - cum[:, :, None, :, :],
        -torch.inf))                                     # [B, NC, t, j, H]
    kern = decay * gad[..., None] * dc[:, :, None, :, :]
    y = torch.einsum("bntjh,bnjhd->bnthd", kern, xc)
    # across chunks: y_t += exp(cum_t) C_t . S; S' = exp(total) S +
    # sum_j exp(total - cum_j) dt_j x_j B_j^T
    total = cum[:, :, -1]                                # [B, NC, H]
    wgt = torch.exp(total[:, :, None, :] - cum) * dc     # [B, NC, C, H]
    for i in range(n):
        y[:, i] += (torch.einsum("btn,bhdn->bthd", cc[:, i], s)
                    * torch.exp(cum[:, i])[..., None])
        s = (torch.exp(total[:, i])[:, :, None, None] * s
             + torch.einsum("bchd,bcn->bhdn", xc[:, i] * wgt[:, i, :, :, None],
                            bc[:, i]))
    return y.reshape(b, n * c, h, dh)[:, :sl], s


def _mamba_out(cfg, params, prefix, y, xh, z, x, kernels):
    """D skip, gated RMSNorm and the out projection of one Mamba block."""
    b, s, h, dh = y.shape
    y = y + xh * params[f"{prefix}_d_skip"].to(torch.float32)[None, None, :, None]
    y = sharding.fit_split_grad(y.reshape(b, s, h * dh), 2, h).to(
        x.dtype) * F.silu(z)
    var = torch.mean(torch.square(y.to(torch.float32)), -1, keepdim=True)
    y = (y * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype)
    y = y * params[f"{prefix}_norm_gamma"]
    return dense(y, params[f"{prefix}_out_proj"], kernels=kernels)


def mamba_mix(cfg, params: Params, prefix: str, x: torch.Tensor,
              state: MambaState | None = None,
              lengths: torch.Tensor | None = None, *,
              kernels: Kernels = DEFAULT_KERNELS):
    """Mamba2 block over a sequence, chunked SSD evaluation.  ``lengths``
    ([B]): pad positions take ``dt = 0`` (decay 1, zero input weight), so
    the carried state is exact at each row's true length; outputs there
    are garbage for the caller to discard.  Returns (y, new_state)."""
    b, s, _ = x.shape
    h, dh, _, _ = _mamba_dims(cfg)
    if state is None:
        state = mamba_state_init(cfg, b, x.dtype, x.device)
    z, xs, bmat, cmat, dt, new_conv = _mamba_project(
        cfg, params, prefix, x, state.conv, lengths=lengths, kernels=kernels)
    a = -torch.exp(params[f"{prefix}_a_log"].to(torch.float32))   # [H] < 0
    xh = xs.reshape(b, s, h, dh).to(torch.float32)
    dtf = dt.to(torch.float32)
    valid = _valid_mask(lengths, s, x.device)
    if valid is not None:
        dtf = dtf * valid[:, :, None]
    with _span():
        y, s_final = sharding.by_rows(
            _mamba_scan, xh, bmat.to(torch.float32), cmat.to(torch.float32),
            dtf, dtf * a[None, None, :], state.ssm, n_out=2)
    out = _mamba_out(cfg, params, prefix, y, xh, z, x, kernels)
    return out, MambaState(ssm=s_final, conv=new_conv)


def _mamba_step_core(xh, dtf, bm, cm, s, live, a):
    """One token of the SSD recurrence (rows whose ``live`` is False keep
    their state): (y [B,H,Dh], the new state)."""
    decay = torch.exp(dtf * a[None])                        # [B, H]
    kv = (xh * dtf[..., None])[..., :, None] * bm[:, None, None, :]
    s_new = decay[..., None, None] * s + kv
    if live is not None:
        s_new = torch.where(live[:, None, None, None], s_new, s)
    return (s_new @ cm[:, None, :, None])[..., 0], s_new


def mamba_step(cfg, params: Params, prefix: str, x: torch.Tensor,
               state: MambaState, lengths: torch.Tensor | None = None, *,
               kernels: Kernels = DEFAULT_KERNELS):
    """Single-token decode; x [B, 1, d].  ``lengths`` ([B] 0/1 live mask):
    rows at 0 keep their SSM state and conv window untouched."""
    b = x.shape[0]
    h, dh, _, _ = _mamba_dims(cfg)
    z, xs, bmat, cmat, dt, new_conv = _mamba_project(
        cfg, params, prefix, x, state.conv, kernels=kernels)
    a = -torch.exp(params[f"{prefix}_a_log"].to(torch.float32))
    xh = xs.reshape(b, h, dh).to(torch.float32)
    dtf = dt[:, 0].to(torch.float32)                        # [B, H]
    live = lengths.to(torch.int32) > 0 if lengths is not None else None
    with _span():
        y, s_new = sharding.by_rows(
            _mamba_step_core, xh, dtf, bmat[:, 0].to(torch.float32),
            cmat[:, 0].to(torch.float32), state.ssm, live, a, shared=(6,),
            n_out=2)
        if live is not None:
            new_conv = torch.where(live[:, None, None], new_conv, state.conv)
    out = _mamba_out(cfg, params, prefix, y[:, None], xh[:, None], z, x,
                     kernels)
    return out, MambaState(ssm=s_new, conv=new_conv)
