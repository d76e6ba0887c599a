"""Step builders (train / prefill / decode) + abstract sharded input
specs: a port of ``repro.launch.steps``.

The train step differentiates ``Model.loss`` with autograd (every dense
product and both products of its backward on ``kraken_gemm``) and applies
:class:`~repro_torch.optim.adamw.AdamW` in place.  Under a mesh the
parameters, moments and batch are DTensors: the spec builders
(``batch_specs``, ``sharded_*_specs``) give them with the rule's
placements and a ``meta`` (or, under ``FakeTensorMode``, fake) local shard,
so a step runs over them with nothing allocated -- the dry run's contract.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import sharding as Sh
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, AdamWState


def split_batch(batch: dict, n: int) -> list[dict]:
    """``batch`` split into ``n`` microbatches along its first axis.  A
    DTensor sharded on that axis splits each rank's shard, so every
    microbatch stays sharded the same way and nothing moves (microbatch
    ``j`` is the ``j``-th slice of every shard: the same rows as the
    unsharded split when the batch is not sharded, a different grouping of
    them when it is; with microbatches of equal size the mean over them is
    the same)."""
    from torch.distributed.tensor import DTensor, Shard

    def part(v, j):
        if isinstance(v, DTensor) and any(
                isinstance(p, Shard) and p.dim == 0 for p in v.placements):
            loc = v.to_local()
            m = loc.shape[0] // n
            return DTensor.from_local(
                loc[j * m:(j + 1) * m], v.device_mesh, v.placements,
                run_check=False,
                shape=torch.Size((v.shape[0] // n, *v.shape[1:])),
                stride=loc[j * m:(j + 1) * m].stride())
        m = v.shape[0] // n
        return v[j * m:(j + 1) * m]

    return [{k: part(v, j) for k, v in batch.items()} for j in range(n)]


def _sync(g, p):
    """A gradient in its parameter's placements: the data-parallel sum of
    a ``Partial`` gradient (the one collective of the gradient sync)."""
    if g is None or not Sh.is_dtensor(g):
        return g
    if tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _full(t):
    return t.full_tensor() if Sh.is_dtensor(t) else t


def make_train_step(model: Model, optimizer: AdamW, *,
                    num_microbatches: int = 1, remat: str = "full"):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    The parameters and the optimizer state are updated in place (and
    returned); the parameters are made to require grad.  The step
    differentiates against each stacked leaf's periods (``unbind(0)``
    views), so a stacked leaf's gradient stays one tensor a period and is
    never stacked: full-width yi-6b would otherwise hold a 2.9 GB
    ``stack`` beside its 32 period gradients.  With one microbatch the
    gradients stay in the parameters' dtype and the optimizer reads them
    slice by slice in fp32 (the reference casts the whole tree to fp32
    first: the same values).  With ``n`` microbatches the batch splits
    along its first axis, the fp32 gradients accumulate and are divided by
    ``n``, and the metrics keep the reference's form: the mean loss and
    ce, and ``aux`` zero.

    Under a mesh (DTensor parameters and batch) the batch splits into
    microbatches shard by shard (:func:`split_batch`), each gradient is
    summed over the data ranks into its parameter's placements, the
    metrics are whole tensors, and AdamW updates the shards in place
    (ZeRO-1 when the moments are sharded further)."""

    def grads_of(leaves, params, mb):
        # under a mesh the backward (and a remat's recompute) mixes plain
        # tensors with DTensors as the forward does
        with Sh.mixing(leaves[0]):
            loss, aux = model.loss(params, mb, remat=remat)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        grads = [_sync(g, p) for g, p in zip(grads, leaves)]
        return (_full(loss.detach()),
                {k: _full(v.detach()) for k, v in aux.items()}, grads)

    def train_step(params, opt_state, batch):
        for t in T.leaves(params):
            t.requires_grad_(True)
        stack = params["stack"]
        params_in = {**params, "stack": {**stack, "slots": [
            {k: w.unbind(0) for k, w in sp.items()}
            for sp in stack["slots"]]}}
        leaves = T.leaves(params_in)
        if num_microbatches == 1:
            loss, aux, grads = grads_of(leaves, params_in, batch)
        else:
            n = num_microbatches
            mbs = split_batch(batch, n)
            acc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
            losses, ces = [], []
            for mb in mbs:
                loss, aux, grads = grads_of(leaves, params_in, mb)
                acc = [s + g.to(torch.float32) for s, g in zip(acc, grads)]
                losses.append(loss)
                ces.append(aux["ce"])
            grads = [s / n for s in acc]
            loss = torch.mean(torch.stack(losses))
            aux = {"ce": torch.mean(torch.stack(ces)),
                   "aux": torch.zeros((), device=loss.device)}
        grads = T.unflatten_like(params_in, list(grads))
        params, opt_state, om = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **aux, **om}

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, caches, batch):
        return model.prefill(params, batch, caches)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, caches, tokens, pos, frontend=None):
        return model.decode_step(params, caches, tokens, pos,
                                 frontend=frontend)
    return decode_step


# ---------------------------------------------------------------------------
# Abstract specs with shardings
# ---------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, cell: ShapeCell, mesh, rules, *,
                device="meta") -> dict:
    b, s = cell.global_batch, cell.seq_len
    d = {
        "tokens": Sh.abstract((b, s), torch.int32, ("batch", "seq"), mesh,
                              rules, device=device),
        "labels": Sh.abstract((b, s), torch.int32, ("batch", "seq"), mesh,
                              rules, device=device),
    }
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "image_patches":
        d["frontend"] = Sh.abstract(
            (b, cfg.num_frontend_tokens, cfg.d_model), dt,
            ("batch", "frontend_seq", "embed"), mesh, rules, device=device)
    elif cfg.frontend == "audio_frames":
        d["frontend"] = Sh.abstract((b, s, cfg.d_model), dt,
                                    ("batch", "seq", "embed"), mesh, rules,
                                    device=device)
    return d


def sharded_param_specs(model: Model, mesh, rules, *, device="meta"):
    dt = getattr(torch, model.cfg.dtype)
    return model.param_specs(lambda s: Sh.abstract(
        s.shape, dt, s.axes, mesh, rules, device=device))


def sharded_opt_specs(model: Model, optimizer: AdamW, mesh, rules,
                      zero1_rules: dict | None = None, *, device="meta"):
    """The AdamW state: fp32 moments placed as the parameters are under
    ``zero1_rules`` (ZeRO-1: sharded further over the data axis), the step
    a replicated scalar."""
    st = optimizer.state_specs(model.param_specs(
        lambda s: torch.empty(s.shape, device="meta")))
    zr = zero1_rules or rules
    mom = lambda: model.param_specs(lambda s: Sh.abstract(
        s.shape, torch.float32, s.axes, mesh, zr, device=device))
    step = torch.empty(st.step.shape, dtype=st.step.dtype, device=device)
    return AdamWState(step=step, m=mom(), v=mom())


def map_cache(caches, fn):
    """``caches`` with every tensor leaf replaced by ``fn(names, leaf)``
    (the leaves and names of :func:`~repro_torch.models.model.cache_leaves`,
    in the same order)."""
    def walk(node, names):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            return fn(names, node)
        if isinstance(node, dict):
            return {k: walk(node[k], names + [k]) for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, names + [f])
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, names + [f"[{i}]"])
                              for i, v in enumerate(node))
        if isinstance(node, L.KVCache):
            return dataclasses.replace(node, **{
                f: walk(getattr(node, f), names + [f])
                for f in ("k", "v", "pos", "k_scale", "v_scale")})
        raise TypeError(f"cache leaf of type {type(node).__name__}")
    return walk(caches, [])


def sharded_cache_specs(model: Model, batch: int, cache_len: int, mesh,
                        rules, *, flat: bool = True, device="meta"):
    """The decode caches (JAX's ``flat=True`` layout, one buffer a layer)
    with every leaf placed by ``cache_axes_list``."""
    specs = model.cache_specs(batch, cache_len, flat=flat)
    axes = iter(model.cache_axes_list(batch, cache_len, flat=flat))
    return map_cache(specs, lambda _, s: Sh.abstract(
        s.shape, s.dtype, next(axes), mesh, rules, device=device))
