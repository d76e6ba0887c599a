"""Layer-stack assembly: the repeating slot pattern of an architecture,
evaluated as a plain loop over layers.

A port of ``repro.models.transformer`` for ``Slot("attn", "mlp")`` and
``Slot("attn", "moe")`` stacks.
The JAX version scans stacked parameters with ``lax.scan``; the port needs
no scan and runs the flat, unrolled layout of its serving path: one step per
layer, each with its own cache.  Parameters keep the JAX key structure --
``stack/slots[i]/<name>`` with a leading ``n_periods`` dim -- so bridging
JAX parameters is a copy; layer ``p`` of slot ``i`` reads index ``p`` of
that dim (a contiguous view).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
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
    """Whether this slot runs in the port yet: a RoPE attention block with
    RMSNorm, a SwiGLU MLP or MoE, and no modality frontend (ROADMAP Queue 1
    items 5-8 bring the others)."""
    return (slot.kind == "attn" and slot.ffn in ("mlp", "moe")
            and cfg.norm == "rmsnorm" and cfg.mlp == "swiglu"
            and cfg.positional == "rope" and not cfg.frontend)


def _check_ported(cfg, slot: Slot) -> None:
    if not slot_is_ported(cfg, slot):
        raise NotImplementedError(
            f"{cfg.name}'s slot {slot} is not ported yet: only RoPE "
            "attention + SwiGLU or MoE blocks with RMSNorm run (ROADMAP "
            "Queue 1 items 5-8)")


def slot_specs(cfg, slot: Slot) -> dict[str, Spec]:
    _check_ported(cfg, slot)
    s: dict[str, Spec] = {}
    s.update(L.norm_specs(cfg, "attn_norm"))
    s.update(L.attention_specs(cfg, "attn"))
    s.update(L.norm_specs(cfg, "mlp_norm"))
    if slot.ffn == "moe":
        s.update(MOE.moe_specs(cfg, "moe"))
    else:
        s.update(L.mlp_specs(cfg, "mlp"))
    return s


# ---------------------------------------------------------------------------
# Per-slot dense caches (the sequential decode path)
# ---------------------------------------------------------------------------

def slot_cache(cfg, slot: Slot, batch: int, cache_len: int, dtype, *,
               device) -> L.KVCache:
    """One layer's dense cache.  A sliding-window layer keeps a ring of
    ``min(window, cache_len)`` slots."""
    _check_ported(cfg, slot)
    s_cache = min(slot.window, cache_len) if slot.window else cache_len
    return L.KVCache.init(cfg, batch, s_cache, dtype, device)


class Ctx(NamedTuple):
    positions: torch.Tensor            # [S] shared or [B, S] per slot
    lengths: torch.Tensor | None = None   # [B] real tokens per row
    kernels: L.Kernels = L.DEFAULT_KERNELS


def apply_slot(cfg, slot: Slot, params: Params, x: torch.Tensor, cache,
               ctx: Ctx):
    """Returns (x, new_cache, aux_loss); aux_loss is None for a slot
    without MoE."""
    h = L.apply_norm(cfg, params, "attn_norm", x)
    y, new_cache = L.attention(cfg, params, "attn", h, positions=ctx.positions,
                               window=slot.window, cache=cache,
                               lengths=ctx.lengths, kernels=ctx.kernels)
    x = x + y
    h = L.apply_norm(cfg, params, "mlp_norm", x)
    if slot.ffn == "moe":
        out = MOE.moe_block(cfg, params, "moe", h, kernels=ctx.kernels)
        return x + out.y, new_cache, out.aux_loss
    x = x + L.mlp(cfg, params, "mlp", h, kernels=ctx.kernels)
    return x, new_cache, None


class LayerStack:
    def __init__(self, cfg):
        self.cfg = cfg
        self.pattern, self.has_shared = build_pattern(cfg)
        p = len(self.pattern)
        self.n_periods = cfg.num_layers // p
        self.n_tail = cfg.num_layers % p

    def param_specs_dict(self) -> dict[str, Any]:
        if self.has_shared:
            raise NotImplementedError(
                "weight-shared attention blocks are not ported yet (ROADMAP "
                "Queue 1 item 7)")
        cfg = self.cfg
        out: dict[str, Any] = {"slots": [], "tail": []}
        for slot in self.pattern:
            specs = slot_specs(cfg, slot)
            out["slots"].append({
                k: Spec((self.n_periods,) + s.shape, ("layers",) + s.axes, s.scale)
                for k, s in specs.items()})
        for i in range(self.n_tail):
            out["tail"].append(slot_specs(cfg, self.pattern[i]))
        return out

    def cache_tree(self, batch: int, cache_len: int, dtype, *, device):
        """Dense caches for every layer, in the serving layout:
        ``{"slots": [[cache per period] per pattern slot], "tail": [...]}``."""
        def one(slot):
            return slot_cache(self.cfg, slot, batch, cache_len, dtype,
                              device=device)
        return {"slots": [[one(s) for _ in range(self.n_periods)]
                          for s in self.pattern],
                "tail": [one(self.pattern[i]) for i in range(self.n_tail)]}

    def apply(self, params: Params, x: torch.Tensor, ctx: Ctx, caches=None):
        """Every layer in order.  ``caches`` is a :meth:`cache_tree` or the
        engine's pools, in the same layout and updated in place, or None.
        Returns (x, caches, aux_loss), the MoE auxiliary losses summed over
        the layers."""
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
        for i in range(self.n_tail):
            c = caches["tail"][i] if use_cache else None
            x, c_new, a = apply_slot(self.cfg, self.pattern[i],
                                     params["tail"][i], x, c, ctx)
            if a is not None:
                aux = aux + a
            if use_cache:
                caches["tail"][i] = c_new
        return x, caches, aux
