"""AdamW on tensors, updating the parameters and moments in place.

A port of ``repro.optim.adamw`` with JAX's arithmetic in JAX's order: the
global-norm clip over fp32 gradients, fp32 moments, bias correction,
decoupled weight decay on every leaf, the result cast to the parameter's
dtype.  The reference returns new trees; here the update runs in place,
leaf by leaf and in slices along each leaf's leading axis (one period of a
stacked weight, at most :data:`SLICE` elements of any other), under
``torch.no_grad()``, so the fp32 temporaries stay at one slice's size:
full-width yi-6b holds 12.1 GB of bf16 parameters, as many of bf16
gradients and 48.5 GB of fp32 moments on an 80 GB card.  ZeRO-1 sharding
of the moments comes with the multi-device code (ROADMAP Queue 1 item
14).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree as T

#: the most elements of one slice of a leaf that is not stacked (the
#: stacked leaves go one period at a time): 256 MiB in fp32
SLICE = 1 << 26


def _span():
    """The profiler range the update runs in, only while one records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("adamw")
    return contextlib.nullcontext()


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: Any
    v: Any


def slices(shape) -> list:
    """Slices of the leading axis: one row at a time when a row holds
    :data:`SLICE` elements or more (a period of a stacked leaf), else as
    many rows as fit in :data:`SLICE`; a scalar is one slice."""
    if not shape:
        return [...]
    row = math.prod(shape[1:])
    rows = max(1, SLICE // max(row, 1))
    return [slice(i, i + rows) for i in range(0, shape[0], rows)]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Any = 3e-4          # float or callable(step) -> float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        device = T.leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=T.map_leaves(zeros, params), v=T.map_leaves(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """Returns (params, state, {"grad_norm"}): the same parameter and
        moment tensors, updated in place.  A gradient leaf may be None (an
        unused parameter: a zero gradient), of any float dtype, or, for a
        stacked leaf, the tuple of its periods' gradients; it is read slice
        by slice in fp32.  While a profiler records, the update runs inside
        ``record_function("adamw")``."""
        with _span():
            return self._update(grads, state, params)

    def _update(self, grads, state: AdamWState, params):
        step = state.step + 1
        stepf = step.to(torch.float32)
        lr = self.lr(step) if callable(self.lr) else self.lr
        ps = T.leaves(params)
        gs = T.leaves(grads, is_leaf=lambda g: type(g) is tuple)
        ms, vs = T.leaves(state.m), T.leaves(state.v)

        def g32(g, m, sl):
            if g is None:
                return torch.zeros_like(m[sl])
            if type(g) is tuple:     # a stacked leaf, period by period
                rows = g[sl]
                g = rows[0][None] if len(rows) == 1 else torch.stack(rows)
                return g.to(torch.float32)
            return g[sl].to(torch.float32)

        if self.grad_clip:
            sq = torch.zeros((), dtype=torch.float32, device=stepf.device)
            for g, m in zip(gs, ms):
                for sl in slices(m.shape):
                    sq = sq + torch.sum(torch.square(g32(g, m, sl)))
            gn = torch.sqrt(sq)
            scale = torch.clamp(self.grad_clip / (gn + 1e-9), max=1.0)
        else:
            gn, scale = torch.zeros((), device=stepf.device), None

        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        for p, g, m, v in zip(ps, gs, ms, vs):
            for sl in slices(p.shape):
                gf = g32(g, m, sl)
                if scale is not None:
                    gf = gf * scale
                mm, vv = m[sl], v[sl]
                mm.mul_(b1).add_((1 - b1) * gf)
                vv.mul_(b2).add_((1 - b2) * torch.square(gf))
                pf = p[sl].to(torch.float32)
                delta = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
                delta.add_(self.weight_decay * pf)
                p[sl] = (pf - lr * delta).to(p.dtype)
        return params, AdamWState(step=step, m=state.m, v=state.v), {
            "grad_norm": gn}


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """lr(step): linear warm-up to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total``, in fp32 as the reference computes
    it."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (
            1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
