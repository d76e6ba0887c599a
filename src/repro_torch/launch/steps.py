"""Step builders (train / prefill / decode): a port of
``repro.launch.steps`` for one device.

The train step differentiates ``Model.loss`` with autograd (every dense
product and both products of its backward on ``kraken_gemm``) and applies
:class:`~repro_torch.optim.adamw.AdamW` in place.  The sharded spec
builders (``batch_specs``, ``sharded_*_specs``) are GSPMD and come with the
multi-device code (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW


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
    ce, and ``aux`` zero."""

    def grads_of(leaves, params, mb):
        loss, aux = model.loss(params, mb, remat=remat)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

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
            mbs = [{k: v[j * (v.shape[0] // n):(j + 1) * (v.shape[0] // n)]
                    for k, v in batch.items()} for j in range(n)]
            acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                   for t in leaves]
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
