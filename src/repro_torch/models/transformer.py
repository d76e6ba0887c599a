"""Layer-stack assembly: the repeating slot pattern of an architecture,
evaluated as a plain loop over layers.

A port of ``repro.models.transformer`` for attention (MLP or MoE), cross
attention, RWKV and Mamba slots and zamba2's weight-shared attention
block, called after each period and not after the tail.  The JAX version
scans stacked parameters with ``lax.scan``; the port needs no scan and runs
the flat, unrolled layout of its serving path: one step per layer, each
with its own cache.  Parameters keep the JAX key structure --
``stack/slots[i]/<name>`` with a leading ``n_periods`` dim,
``stack/shared/<name>`` -- so bridging JAX parameters is a copy; layer
``p`` of slot ``i`` reads index ``p`` of that dim (a contiguous view).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch import sharding
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import Spec

Params = dict


#: Every kind ``build_pattern`` emits; ``slot_cache`` has a cache for each.
SLOT_KINDS = ("attn", "cross", "rwkv", "mamba")


@dataclasses.dataclass(frozen=True)
class Slot:
    kind: str          # one of SLOT_KINDS
    ffn: str           # 'mlp' | 'moe' | 'cmix' | 'none'
    window: int = 0    # sliding window for 'attn' (0 = full)


def _dots_contexts():
    """``remat="dots"``'s checkpoint contexts: the dense GEMMs' outputs
    saved, the rest recomputed."""
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        ops.save_dots)


def build_pattern(cfg) -> tuple[list[Slot], bool]:
    """Return (pattern, has_shared_attn)."""
    fam = cfg.family
    if fam == "ssm":
        return [Slot("rwkv", "cmix")], False
    if fam == "hybrid":
        return [Slot("mamba", "none")] * cfg.mamba_per_shared_attn, True
    if fam == "vlm" and cfg.cross_attn_period:
        p = [Slot("attn", "mlp")] * (cfg.cross_attn_period - 1)
        return p + [Slot("cross", "mlp")], False
    if cfg.local_global_period:
        p = [Slot("attn", "mlp", window=cfg.local_window)] * (cfg.local_global_period - 1)
        return p + [Slot("attn", "mlp", window=0)], False
    ffn_all = "moe" if (cfg.num_experts and cfg.moe_interleave == 1) else "mlp"
    if cfg.num_experts and cfg.moe_interleave > 1:
        p = [Slot("attn", "mlp", window=cfg.sliding_window)] * (cfg.moe_interleave - 1)
        return p + [Slot("attn", "moe", window=cfg.sliding_window)], False
    return [Slot("attn", ffn_all, window=cfg.sliding_window)], False


def slot_specs(cfg, slot: Slot) -> dict[str, Spec]:
    s: dict[str, Spec] = {}
    s.update(L.norm_specs(cfg, "attn_norm"))
    if slot.kind in ("attn", "cross"):
        s.update(L.attention_specs(cfg, "attn"))
        if slot.kind == "cross":
            s.update(L.norm_specs(cfg, "cross_kv_norm"))
    elif slot.kind == "rwkv":
        s.update(SSM.rwkv_specs(cfg, "rwkv"))
    else:
        s.update(SSM.mamba_specs(cfg, "mamba"))
    if slot.ffn == "none":
        return s
    s.update(L.norm_specs(cfg, "mlp_norm"))
    if slot.ffn == "moe":
        s.update(MOE.moe_specs(cfg, "moe"))
    elif slot.ffn == "cmix":
        s.update(SSM.rwkv_channel_specs(cfg, "cmix"))
    else:
        s.update(L.mlp_specs(cfg, "mlp"))
    return s


def shared_attn_specs(cfg) -> dict[str, Spec]:
    """zamba2's weight-shared attention + MLP block."""
    s = {}
    s.update(L.norm_specs(cfg, "shared_attn_norm"))
    s.update(L.attention_specs(cfg, "shared_attn"))
    s.update(L.norm_specs(cfg, "shared_mlp_norm"))
    s.update(L.mlp_specs(cfg, "shared_mlp"))
    return s


# ---------------------------------------------------------------------------
# Per-slot caches (the sequential decode path; the engine's row states)
# ---------------------------------------------------------------------------

def slot_cache(cfg, slot: Slot, batch: int, cache_len: int, dtype, *,
               device, clamp_window: bool = True):
    """One layer's cache: a dense KV cache for attention (a sliding-window
    layer keeps a ring of ``min(window, cache_len)`` slots, or all
    ``cache_len`` with ``clamp_window=False``: the whole-prompt prefill
    that ``StateTree.scatter_prefill`` reads keeps every position at its
    own row and windows by the mask alone), the frozen
    cross-attention K/V rows ``{"k", "v"}: [batch, KV,
    cfg.num_frontend_tokens, D]`` (zeros until a frontend fills them), or
    the recurrent state rows of an RWKV (with the channel mix's token
    shift) or Mamba layer."""
    if slot.kind == "cross":
        shape = (batch, cfg.num_kv_heads, cfg.num_frontend_tokens,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if slot.kind == "rwkv":
        return {"rwkv": SSM.rwkv_state_init(cfg, batch, dtype, device),
                "cmix_x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                           device=device)}
    if slot.kind == "mamba":
        return SSM.mamba_state_init(cfg, batch, dtype, device)
    s_cache = (min(slot.window, cache_len)
               if slot.window and clamp_window else cache_len)
    return L.KVCache.init(cfg, batch, s_cache, dtype, device)


class Ctx(NamedTuple):
    mode: str                          # 'train' | 'prefill' | 'decode' | 'chunk'
    positions: torch.Tensor            # [S] shared or [B, S] per slot
    frontend: torch.Tensor | None = None  # image/audio embeddings [B, P, d]
    shared_params: Params | None = None   # zamba2's shared block
    lengths: torch.Tensor | None = None   # [B] real tokens per row
    kernels: L.Kernels = L.DEFAULT_KERNELS


def _store(cache, new) -> None:
    """Copy a recurrent state's new tensors into its cache, in place."""
    for dst, src in zip(cache, new):
        dst.copy_(src)


def _mixer(cfg, slot: Slot, params: Params, h: torch.Tensor, cache,
           ctx: Ctx):
    """The slot's sequence mixer on the normed input: (y, new cache).  The
    recurrences take their per-token step only in decode mode, as in the
    reference; every other mode runs the length-masked chunked mix.  Row
    states are updated in place."""
    kw = dict(lengths=ctx.lengths, kernels=ctx.kernels)
    if slot.kind == "attn":
        return L.attention(cfg, params, "attn", h, positions=ctx.positions,
                           window=slot.window, cache=cache, **kw)
    if slot.kind == "cross":
        return _cross(cfg, params, h, cache, ctx)
    if slot.kind == "rwkv":
        fn = SSM.rwkv_step if ctx.mode == "decode" else SSM.rwkv_mix
        st = cache["rwkv"] if cache is not None else None
        y, new = fn(cfg, params, "rwkv", h, st, **kw)
        if cache is not None:
            _store(st, new)
        return y, cache
    fn = SSM.mamba_step if ctx.mode == "decode" else SSM.mamba_mix
    y, new = fn(cfg, params, "mamba", h, cache, **kw)
    if cache is not None:
        _store(cache, new)
    return y, cache


def _cross(cfg, params: Params, h: torch.Tensor, cache, ctx: Ctx):
    """A cross-attention layer: (y, cache).  In decode mode, and in any
    step with a cache but no frontend (text-only serving), it attends over
    the frozen K/V rows as they are: all-zero rows add an exact zero.
    Otherwise the frontend, normed by ``cross_kv_norm``, is projected to
    K/V once, frozen into the rows when there is a cache (in place), and
    attended without a mask: JAX's ``attention(kv_x=...)`` followed by
    ``_project_cross_kv``, with two GEMMs fewer."""
    if ctx.mode == "decode" or (ctx.frontend is None and cache is not None):
        return _cross_from_cache(cfg, params, h, cache, ctx.kernels), cache
    if ctx.frontend is None:
        raise ValueError(f"{cfg.name}'s cross-attention layers need a "
                         "frontend or a cache")
    kv_src = L.apply_norm(cfg, params, "cross_kv_norm", ctx.frontend)
    kv = _project_cross_kv(cfg, params, kv_src, ctx.kernels)
    if cache is not None:
        for name, t in kv.items():
            cache[name].copy_(t)
    return _cross_from_cache(cfg, params, h, kv, ctx.kernels), cache


def _project_cross_kv(cfg, params: Params, kv_src: torch.Tensor,
                      kernels: L.Kernels) -> dict:
    """The frontend's K/V, ``{"k", "v"}: [B, KV, P, D]``."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    k = L.dense(kv_src, params["attn_wk"], bias=params.get("attn_bk"),
                kernels=kernels)
    v = L.dense(kv_src, params["attn_wv"], bias=params.get("attn_bv"),
                kernels=kernels)
    return {"k": L._split_heads(k, kv, hd), "v": L._split_heads(v, kv, hd)}


def _cross_from_cache(cfg, params: Params, h: torch.Tensor, kv,
                      kernels: L.Kernels) -> torch.Tensor:
    """Unmasked attention of ``h``'s queries over cross K/V ``kv``
    (``{"k", "v"}: [B, KV, P, D]``: the frozen rows or a frontend's)."""
    q = L.dense(h, params["attn_wq"], bias=params.get("attn_bq"),
                kernels=kernels)
    qh = L._split_heads(q, cfg.num_heads, cfg.head_dim)
    n = kv["k"].shape[2]
    out = L._gqa_sdpa(qh, kv["k"], kv["v"], window=0,
                      q_pos=torch.arange(qh.shape[2], device=h.device),
                      kv_pos=torch.arange(n, device=h.device),
                      mask_mode="none")
    return L.dense(L._merge_heads(out), params["attn_wo"], kernels=kernels)


def _sp(x):
    """Residual-stream constraint: sequence parallel over the model axis
    (Megatron-SP) under rules that map ``act_seq``; replicated (a no-op)
    otherwise."""
    return sharding.shard(x, "batch", "act_seq", "embed")


def _gather_seq(h):
    """The SP boundary: the sequence gathered again before a TP block."""
    return sharding.shard(h, "batch", "seq", "embed")


def _residual(x, y):
    return _sp(x + y)


def apply_slot(cfg, slot: Slot, params: Params, x: torch.Tensor, cache,
               ctx: Ctx):
    """Returns (x, new_cache, aux_loss); aux_loss is None for a slot
    without MoE.  The residual stream and the blocks' inputs carry JAX's
    sharding constraints."""
    x = _sp(x)
    h = _gather_seq(L.apply_norm(cfg, params, "attn_norm", x))
    y, new_cache = _mixer(cfg, slot, params, h, cache, ctx)
    x = _residual(x, y)
    if slot.ffn == "none":
        return x, new_cache, None
    h = _gather_seq(L.apply_norm(cfg, params, "mlp_norm", x))
    if slot.ffn == "moe":
        out = MOE.moe_block(cfg, params, "moe", h, kernels=ctx.kernels)
        return _residual(x, out.y), new_cache, out.aux_loss
    if slot.ffn == "cmix":
        xp = (cache["cmix_x_prev"] if cache is not None else
              torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                          device=x.device))
        y, xp_new = SSM.rwkv_channel_mix(cfg, params, "cmix", h, xp,
                                         lengths=ctx.lengths,
                                         kernels=ctx.kernels)
        if cache is not None:
            xp.copy_(xp_new)
        return _residual(x, y), new_cache, None
    x = _residual(x, L.mlp(cfg, params, "mlp", h, kernels=ctx.kernels))
    return x, new_cache, None


def apply_shared_attn(cfg, params: Params, x: torch.Tensor, cache,
                      ctx: Ctx):
    """zamba2's shared block: attention over its own cache of this call,
    then the SwiGLU MLP.  Returns (x, new_cache)."""
    x = _sp(x)
    h = _gather_seq(L.apply_norm(cfg, params, "shared_attn_norm", x))
    y, new_cache = L.attention(cfg, params, "shared_attn", h,
                               positions=ctx.positions, cache=cache,
                               lengths=ctx.lengths, kernels=ctx.kernels)
    x = _residual(x, y)
    h = _gather_seq(L.apply_norm(cfg, params, "shared_mlp_norm", x))
    return _residual(x, L.mlp(cfg, params, "shared_mlp", h,
                              kernels=ctx.kernels)), new_cache


class LayerStack:
    def __init__(self, cfg):
        self.cfg = cfg
        self.pattern, self.has_shared = build_pattern(cfg)
        p = len(self.pattern)
        self.n_periods = cfg.num_layers // p
        self.n_tail = cfg.num_layers % p

    def param_specs_dict(self) -> dict[str, Any]:
        cfg = self.cfg
        out: dict[str, Any] = {"slots": [], "tail": []}
        for slot in self.pattern:
            specs = slot_specs(cfg, slot)
            out["slots"].append({
                k: Spec((self.n_periods,) + s.shape, ("layers",) + s.axes, s.scale)
                for k, s in specs.items()})
        for i in range(self.n_tail):
            out["tail"].append(slot_specs(cfg, self.pattern[i]))
        if self.has_shared:
            out["shared"] = shared_attn_specs(cfg)
        return out

    def cache_tree(self, batch: int, cache_len: int, dtype, *, device,
                   clamp_window: bool = True):
        """Caches for every layer, in the serving layout: ``{"slots":
        [[cache per period] per pattern slot], "tail": [...]}`` and, with a
        shared block, ``"shared": [cache per period]`` (each call of the
        block attends over its own cache).  ``clamp_window``: see
        :func:`slot_cache`."""
        def one(slot):
            return slot_cache(self.cfg, slot, batch, cache_len, dtype,
                              device=device, clamp_window=clamp_window)
        tree = {"slots": [[one(s) for _ in range(self.n_periods)]
                          for s in self.pattern],
                "tail": [one(self.pattern[i]) for i in range(self.n_tail)]}
        if self.has_shared:
            tree["shared"] = [one(Slot("attn", "none"))
                              for _ in range(self.n_periods)]
        return tree

    def apply(self, params: Params, x: torch.Tensor, ctx: Ctx, caches=None,
              remat: str = "none"):
        """Every layer in order, the shared block after each period.
        ``caches`` is a :meth:`cache_tree` or the engine's pools, in the
        same layout and updated in place, or None.  Returns (x, caches,
        aux_loss), the MoE auxiliary losses summed over the layers.

        Each stacked leaf is taken apart once with ``unbind(0)``: under
        autograd its backward is one ``stack``, where indexing each layer
        would allocate a zero tensor of the whole leaf per layer.  A
        stacked leaf may also come as the tuple of its periods (the tensors
        ``launch/steps`` differentiates against, so that no ``stack`` runs
        at all).  While
        autograd records, ``remat`` is JAX's: ``"none"``; ``"full"``, each
        period a non-reentrant ``torch.utils.checkpoint``; ``"dots"``, the
        same with the dense GEMMs' outputs kept (the selective-checkpoint
        policy :func:`~repro_torch.kernels.ops.save_dots`)."""
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"remat {remat!r}: none, full or dots")
        use_cache = caches is not None
        slots = [{k: w if isinstance(w, tuple) else w.unbind(0)
                  for k, w in sp.items()} for sp in params["slots"]]

        def period(i, x, aux):
            # a remat's recompute runs in the backward, outside the
            # forward's contexts: under a mesh it mixes plain tensors with
            # DTensors again
            with sharding.mixing(x):
                return _period(i, x, aux)

        def _period(i, x, aux):
            for s, slot in enumerate(self.pattern):
                sp = {k: w[i] for k, w in slots[s].items()}
                c = caches["slots"][s][i] if use_cache else None
                x, c_new, a = apply_slot(self.cfg, slot, sp, x, c, ctx)
                if a is not None:
                    aux = aux + a
                if use_cache:
                    caches["slots"][s][i] = c_new
            if self.has_shared:
                c = caches["shared"][i] if use_cache else None
                x, c_new = apply_shared_attn(self.cfg, ctx.shared_params, x,
                                             c, ctx)
                if use_cache:
                    caches["shared"][i] = c_new
            return x, aux

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = remat if torch.is_grad_enabled() else "none"
        for i in range(self.n_periods):
            if remat == "none":
                x, aux = period(i, x, aux)
                continue
            x, aux = torch.utils.checkpoint.checkpoint(
                period, i, x, aux, use_reentrant=False,
                **({"context_fn": _dots_contexts} if remat == "dots" else {}))
        for i in range(self.n_tail):
            c = caches["tail"][i] if use_cache else None
            x, c_new, a = apply_slot(self.cfg, self.pattern[i],
                                     params["tail"][i], x, c, ctx)
            if a is not None:
                aux = aux + a
            if use_cache:
                caches["tail"][i] = c_new
        return x, caches, aux
