"""Mixture-of-Experts: top-k routing with capacity-based dispatch.

A port of ``repro.models.moe``:

* router -> top-k experts per token (fp32 logits and softmax, the top-k
  weights renormalised for k > 1) and the Switch auxiliary loss,
* position-in-expert by a cumulative sum over the flat token-major
  assignment list, so the same tokens are dropped when an expert is over
  capacity,
* a linear-index scatter into the ``[E, C, d]`` capacity buffer,
* the expert FFN over that buffer through ``kernels.moe_ffn`` -- by default
  :func:`repro_torch.kernels.ops.grouped_expert_ffn`, the hand-written
  ``grouped_moe_gemm`` on CUDA tensors -- with the per-expert live-row
  counts ``sizes``; when autograd records, the reference's einsum branch
  instead (``torch.einsum``, the batched products outside any kernel),
* a gather back to token order and the weighted top-k sum, plus the shared
  expert through :func:`~repro_torch.models.layers.dense`.

As in the JAX version the tokens split into one dispatch group per shard
of the token batch under a mesh (:func:`_dispatch_groups`), each group
routed with its own capacity on the rank that holds its tokens; without a
mesh there is one group.  The JAX einsum branch is the plain version of
the FFN (``kernels.ref.grouped_expert_ffn``).

Nothing here reads a device value on the host (no ``.item()``, no boolean
mask indexing), so a step on the card never waits for it.  JAX drops the
scatter writes of dropped tokens (``mode="drop"``); here they land in one
trash row at index ``E * C`` of an ``[E * C + 1, d]`` buffer, the same idea
as the page pools' trash page.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import sharding
from repro_torch.models import layers as L
from repro_torch.models.layers import Spec

Params = dict


def moe_specs(cfg, prefix: str = "moe") -> dict[str, Spec]:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    s = {
        f"{prefix}_router": Spec((d, e), ("embed", None)),
        f"{prefix}_wi_gate": Spec((e, d, f), ("experts", "embed", "mlp")),
        f"{prefix}_wi_up": Spec((e, d, f), ("experts", "embed", "mlp")),
        f"{prefix}_wo": Spec((e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.shared_expert:
        s[f"{prefix}_shared_wi_gate"] = Spec((d, f), ("embed", "mlp"))
        s[f"{prefix}_shared_wi_up"] = Spec((d, f), ("embed", "mlp"))
        s[f"{prefix}_shared_wo"] = Spec((f, d), ("mlp", "embed"))
    return s


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


def _dispatch_groups(t: int) -> int:
    """Number of dispatch groups: the size of the mesh axes the token
    batch is sharded over (``moe_groups``, else ``batch``), 1 without a
    mesh or when it does not divide the ``t`` tokens.  Each data shard
    routes and scatters its own tokens into a ``[G, E, C_g, d]`` buffer
    whose group dim is sharded like the tokens (JAX's ``_dispatch_groups``)."""
    c = sharding.current()
    if not c or c["mesh"] is None:
        return 1
    mapped = c["rules"].get("moe_groups") or c["rules"].get("batch")
    if mapped is None:
        return 1
    if isinstance(mapped, str):
        mapped = (mapped,)
    sizes = sharding.mesh_shape(c["mesh"])
    g = 1
    for a in mapped:
        g *= sizes.get(a, 1)
    return g if (g > 0 and t % g == 0) else 1


def expert_capacity(tokens: int, cfg) -> int:
    """Per-expert capacity C for a program routing ``tokens`` tokens."""
    return max(1, int(tokens * cfg.experts_per_token / cfg.num_experts
                      * cfg.capacity_factor))


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot rows, by comparison: nothing is checked on the host."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(
        torch.int32)


def _route_and_dispatch(cfg, router_w, xt: torch.Tensor):
    """xt: [T, d] -> (buf [E, C, d], combine info, aux, sizes [E] int32)."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(xt.to(torch.float32) @ router_w.to(torch.float32),
                          dim=-1)                                  # [T, E]
    # a stable sort keeps the lower expert first on a tie, as
    # jax.lax.top_k does (torch.topk promises no order)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]    # [T, k]
    if k > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Switch aux loss
    onehot = _one_hot(expert_ids[:, 0], e).to(torch.float32)
    aux = e * torch.sum(onehot.mean(0) * probs.mean(0))

    capacity = expert_capacity(t, cfg)
    flat_ids = expert_ids.reshape(-1)                              # [T*k]
    eo = _one_hot(flat_ids, e)                                     # [T*k, E]
    pos = ((torch.cumsum(eo, dim=0, dtype=torch.int32) - 1) * eo).sum(
        dim=-1, dtype=torch.int32)                                 # [T*k]
    keep = pos < capacity
    # dropped tokens go to the trash row E*C (JAX drops them out of range)
    lin = torch.where(keep, flat_ids * capacity + pos, e * capacity)
    buf = xt.new_zeros((e * capacity + 1, d))
    buf.index_copy_(0, lin, xt[:, None].expand(t, k, d).reshape(t * k, d))
    buf = buf[:e * capacity].view(e, capacity, d)
    sizes = (eo * keep[:, None]).sum(dim=0, dtype=torch.int32)    # [E]
    return buf, (lin, keep, gate_vals), aux, sizes


def _combine(out_buf: torch.Tensor, info, t: int, k: int,
             dtype) -> torch.Tensor:
    """Gather expert outputs back to token order and take the weighted
    top-k sum, in the compute dtype."""
    lin, keep, gate_vals = info
    flat = out_buf.reshape(-1, out_buf.shape[-1])                  # [E*C, d]
    gathered = flat[lin.clamp(max=flat.shape[0] - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)             # [T*k, d]
    gathered = gathered.reshape(t, k, gathered.shape[-1])
    return torch.einsum("tkd,tk->td", gathered, gate_vals.to(dtype))


def _route_groups(cfg, router_w, xg: torch.Tensor):
    """:func:`_route_and_dispatch` of each group of ``xg`` [G, Tg, d]:
    (buf [G, E, Cg, d], lin, keep [G, Tg*k], gate_vals [G, Tg, k], aux [G],
    sizes [G, E])."""
    outs = []
    for xi in xg.unbind(0):
        buf, (lin, keep, gv), aux, sizes = _route_and_dispatch(
            cfg, router_w, xi)
        outs.append((buf, lin, keep, gv, aux, sizes))
    return tuple(torch.stack(o) for o in zip(*outs))


def _combine_groups(out_buf, lin, keep, gate_vals, k: int, dtype):
    """:func:`_combine` of each group: [G, Tg, d]."""
    return torch.stack([
        _combine(ob, (li, kp, gv), gv.shape[0], k, dtype)
        for ob, li, kp, gv in zip(out_buf, lin, keep, gate_vals)])


def moe_block(cfg, params: Params, prefix: str, x: torch.Tensor, *,
              kernels: L.Kernels = L.DEFAULT_KERNELS) -> MoEOut:
    """x: [B, S, d] -> (y [B, S, d], aux loss, the groups' mean).

    Under a mesh the tokens split into the dispatch groups of
    :func:`_dispatch_groups`; each rank routes, dispatches and combines its
    own groups on local rows, and the expert GEMMs run on the group- and
    expert-sharded buffer, as JAX's ``moe_block``."""
    b, s, d = x.shape
    t = b * s
    k = cfg.experts_per_token
    xt = sharding.shard(x.reshape(t, d), "moe_groups", "embed")
    g = _dispatch_groups(t)
    xg = sharding.shard(xt.reshape(g, t // g, d), "moe_groups", None,
                        "embed")
    buf, lin, keep, gate_vals, aux, sizes = sharding.by_rows(
        lambda w, xs: _route_groups(cfg, w, xs), params[f"{prefix}_router"],
        xg, shared=(0,), n_out=6)
    aux = aux.mean()
    buf = sharding.shard(buf, "moe_groups", "experts", "expert_capacity",
                         "embed")
    wi_gate, wi_up, wo = (params[f"{prefix}_{n}"]
                          for n in ("wi_gate", "wi_up", "wo"))
    if L.needs_grad(buf, wi_gate, wi_up, wo) or sharding.is_dtensor(buf) \
            or g > 1:
        # the reference's einsum branch, the one with a VJP and the mesh
        # story: the grouped kernel serves unsharded inference only, there
        # as here
        wi_gate = sharding.shard(wi_gate, "experts", None, "mlp")
        wi_up = sharding.shard(wi_up, "experts", None, "mlp")
        wo = sharding.shard(wo, "experts", "mlp", None)
        h = torch.nn.functional.silu(
            torch.einsum("gecd,edf->gecf", buf, wi_gate)) * torch.einsum(
            "gecd,edf->gecf", buf, wi_up)
        h = sharding.shard(h, "moe_groups", "experts", "expert_capacity",
                           "mlp")
        out_buf = torch.einsum("gecf,efd->gecd", h, wo)
        out_buf = sharding.shard(out_buf, "moe_groups", "experts",
                                 "expert_capacity", "moe_out_embed")
    else:
        out_buf = kernels.moe_ffn(buf[0], sizes[0], wi_gate, wi_up, wo)[None]
    y = sharding.by_rows(
        lambda *a: _combine_groups(*a, k, x.dtype),
        out_buf, lin, keep, gate_vals).reshape(t, d)
    if cfg.shared_expert:
        g_ = L.dense(xt, params[f"{prefix}_shared_wi_gate"],
                     activation="silu", kernels=kernels)
        u = L.dense(xt, params[f"{prefix}_shared_wi_up"], kernels=kernels)
        y = y + L.dense(g_ * u, params[f"{prefix}_shared_wo"],
                        kernels=kernels)
    return MoEOut(y=sharding.gather_inner_grad(y.reshape(b, s, d)),
                  aux_loss=aux)
