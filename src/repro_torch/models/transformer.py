"""Layer-stack assembly: the repeating slot pattern of an architecture,
evaluated as a plain loop over layers.

A port of ``repro.models.transformer`` for attention (MLP or MoE), RWKV
and Mamba slots and zamba2's weight-shared attention block, called after
each period and not after the tail.  The JAX version scans stacked
parameters with ``lax.scan``; the port needs no scan and runs the flat,
unrolled layout of its serving path: one step per layer, each with its own
cache.  Parameters keep the JAX key structure -- ``stack/slots[i]/<name>``
with a leading ``n_periods`` dim, ``stack/shared/<name>`` -- so bridging
JAX parameters is a copy; layer ``p`` of slot ``i`` reads index ``p`` of
that dim (a contiguous view).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import Spec

Params = dict


@dataclasses.dataclass(frozen=True)
class Slot:
    kind: str          # 'attn' | 'cross' | 'rwkv' | 'mamba'
    ffn: str           # 'mlp' | 'moe' | 'cmix' | 'none'
    window: int = 0    # sliding window for 'attn' (0 = full)


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


def slot_is_ported(cfg, slot: Slot) -> bool:
    """Whether this slot runs in the port yet: every slot but cross
    attention, under RMSNorm, a SwiGLU MLP and no sinusoidal positions or
    modality frontend (ROADMAP Queue 1 item 8 brings the others)."""
    return (slot.kind in ("attn", "rwkv", "mamba")
            and cfg.norm == "rmsnorm" and cfg.mlp == "swiglu"
            and cfg.positional != "sinusoidal" and not cfg.frontend)


def _check_ported(cfg, slot: Slot) -> None:
    if not slot_is_ported(cfg, slot):
        raise NotImplementedError(
            f"{cfg.name}'s slot {slot} is not ported yet: cross attention, "
            "layernorm, the gelu MLP, sinusoidal positions and frontends "
            "come with ROADMAP Queue 1 item 8")


def slot_specs(cfg, slot: Slot) -> dict[str, Spec]:
    _check_ported(cfg, slot)
    s: dict[str, Spec] = {}
    s.update(L.norm_specs(cfg, "attn_norm"))
    if slot.kind == "attn":
        s.update(L.attention_specs(cfg, "attn"))
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
               device):
    """One layer's cache: a dense KV cache for attention (a sliding-window
    layer keeps a ring of ``min(window, cache_len)`` slots), or the
    recurrent state rows of an RWKV (with the channel mix's token shift)
    or Mamba layer."""
    _check_ported(cfg, slot)
    if slot.kind == "rwkv":
        return {"rwkv": SSM.rwkv_state_init(cfg, batch, dtype, device),
                "cmix_x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                           device=device)}
    if slot.kind == "mamba":
        return SSM.mamba_state_init(cfg, batch, dtype, device)
    s_cache = min(slot.window, cache_len) if slot.window else cache_len
    return L.KVCache.init(cfg, batch, s_cache, dtype, device)


class Ctx(NamedTuple):
    mode: str                          # 'train' | 'prefill' | 'decode' | 'chunk'
    positions: torch.Tensor            # [S] shared or [B, S] per slot
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


def apply_slot(cfg, slot: Slot, params: Params, x: torch.Tensor, cache,
               ctx: Ctx):
    """Returns (x, new_cache, aux_loss); aux_loss is None for a slot
    without MoE."""
    h = L.apply_norm(cfg, params, "attn_norm", x)
    y, new_cache = _mixer(cfg, slot, params, h, cache, ctx)
    x = x + y
    if slot.ffn == "none":
        return x, new_cache, None
    h = L.apply_norm(cfg, params, "mlp_norm", x)
    if slot.ffn == "moe":
        out = MOE.moe_block(cfg, params, "moe", h, kernels=ctx.kernels)
        return x + out.y, new_cache, out.aux_loss
    if slot.ffn == "cmix":
        xp = (cache["cmix_x_prev"] if cache is not None else
              torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                          device=x.device))
        y, xp_new = SSM.rwkv_channel_mix(cfg, params, "cmix", h, xp,
                                         lengths=ctx.lengths,
                                         kernels=ctx.kernels)
        if cache is not None:
            xp.copy_(xp_new)
        return x + y, new_cache, None
    x = x + L.mlp(cfg, params, "mlp", h, kernels=ctx.kernels)
    return x, new_cache, None


def apply_shared_attn(cfg, params: Params, x: torch.Tensor, cache,
                      ctx: Ctx):
    """zamba2's shared block: attention over its own cache of this call,
    then the SwiGLU MLP.  Returns (x, new_cache)."""
    h = L.apply_norm(cfg, params, "shared_attn_norm", x)
    y, new_cache = L.attention(cfg, params, "shared_attn", h,
                               positions=ctx.positions, cache=cache,
                               lengths=ctx.lengths, kernels=ctx.kernels)
    x = x + y
    h = L.apply_norm(cfg, params, "shared_mlp_norm", x)
    return x + L.mlp(cfg, params, "shared_mlp", h, kernels=ctx.kernels), \
        new_cache


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

    def cache_tree(self, batch: int, cache_len: int, dtype, *, device):
        """Caches for every layer, in the serving layout: ``{"slots":
        [[cache per period] per pattern slot], "tail": [...]}`` and, with a
        shared block, ``"shared": [cache per period]`` (each call of the
        block attends over its own cache)."""
        def one(slot):
            return slot_cache(self.cfg, slot, batch, cache_len, dtype,
                              device=device)
        tree = {"slots": [[one(s) for _ in range(self.n_periods)]
                          for s in self.pattern],
                "tail": [one(self.pattern[i]) for i in range(self.n_tail)]}
        if self.has_shared:
            tree["shared"] = [one(Slot("attn", "none"))
                              for _ in range(self.n_periods)]
        return tree

    def apply(self, params: Params, x: torch.Tensor, ctx: Ctx, caches=None):
        """Every layer in order, the shared block after each period.
        ``caches`` is a :meth:`cache_tree` or the engine's pools, in the
        same layout and updated in place, or None.  Returns (x, caches,
        aux_loss), the MoE auxiliary losses summed over the layers."""
        use_cache = caches is not None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.n_periods):
            for s, slot in enumerate(self.pattern):
                sp = {k: w[i] for k, w in params["slots"][s].items()}
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
        for i in range(self.n_tail):
            c = caches["tail"][i] if use_cache else None
            x, c_new, a = apply_slot(self.cfg, self.pattern[i],
                                     params["tail"][i], x, c, ctx)
            if a is not None:
                aux = aux + a
            if use_cache:
                caches["tail"][i] = c_new
        return x, caches, aux
