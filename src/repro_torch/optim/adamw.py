"""AdamW on tensors, updating the parameters and moments in place.

A port of ``repro.optim.adamw`` with JAX's arithmetic in JAX's order: the
global-norm clip over fp32 gradients, fp32 moments, bias correction,
decoupled weight decay on every leaf, the result cast to the parameter's
dtype.  The reference returns new trees; here the update runs in place,
leaf by leaf and in slices along each leaf's leading axis (one period of a
stacked weight, at most :data:`SLICE` elements of any other), under
``torch.no_grad()``, so the fp32 temporaries stay at one slice's size:
full-width yi-6b holds 12.1 GB of bf16 parameters, as many of bf16
gradients and 48.5 GB of fp32 moments on an 80 GB card.

Under a mesh the parameters, gradients and moments are DTensors, and the
update runs on local shards.  With ZeRO-1 (JAX's ``zero1_param_rules``:
the moments placed by :meth:`AdamW.init`'s ``mesh``/``rules``, sharded
over the data axis on the dim the parameters keep replicated) each rank
updates the slice of each parameter its moments hold, and the new slices
are gathered back into the parameter's placements.
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

    def init(self, params, *, axes=None, mesh=None,
             rules=None) -> AdamWState:
        """Zero moments in fp32.  With ``mesh`` (and the parameters'
        logical ``axes`` tree and ``rules``, ZeRO-1's for sharded
        moments) each moment is a DTensor placed by the rules; otherwise
        the moments follow the parameters (a DTensor parameter gets a
        moment of its placements)."""
        device = T.leaves(params)[0].device
        if mesh is not None:
            from repro_torch import sharding as Sh

            from torch.distributed.tensor import DTensor

            def zeros(p, ax):
                spec = Sh.partition_spec_of(mesh, rules, p.shape, ax)
                loc = Sh.local_shape(p.shape, mesh, spec)
                return DTensor.from_local(
                    torch.zeros(loc, dtype=torch.float32, device=device),
                    mesh, Sh.placements(mesh, spec), run_check=False,
                    shape=p.shape,
                    stride=torch.empty(p.shape, device="meta").stride())
            mk = lambda: T.map_leaves(zeros, params, axes)
        else:
            zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
            mk = lambda: T.map_leaves(zeros, params)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=mk(), v=mk())

    def state_specs(self, param_specs) -> AdamWState:
        """The state's shapes and dtypes on the ``meta`` device, from a
        tree of parameter tensors (meta ones allocate nothing)."""
        f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,
                                    device="meta")
        return AdamWState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            m=T.map_leaves(f32, param_specs),
            v=T.map_leaves(f32, param_specs))

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
        views = [_local_views(p, g, m, v) for p, g, m, v in
                 zip(ps, gs, ms, vs)]

        def g32(g, m, sl):
            if g is None:
                return torch.zeros_like(m[sl])
            if type(g) is tuple:     # a stacked leaf, period by period
                rows = g[sl]
                g = rows[0][None] if len(rows) == 1 else torch.stack(rows)
                return g.to(torch.float32)
            return g[sl].to(torch.float32)

        if self.grad_clip:
            parts = [own(torch.sum(torch.square(g32(g, m, sl))))
                     for _, g, m, _, own in views for sl in slices(m.shape)]
            sq = torch.zeros((), dtype=torch.float32, device=stepf.device)
            for x in _summed(parts, ms):
                sq = sq + x
            gn = torch.sqrt(sq)
            scale = torch.clamp(self.grad_clip / (gn + 1e-9), max=1.0)
        else:
            gn, scale = torch.zeros((), device=stepf.device), None

        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        for (p, g, m, v, _), whole_p, whole_m in zip(views, ps, ms):
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
            _put_back(p, whole_p, whole_m)
        return params, AdamWState(step=step, m=state.m, v=state.v), {
            "grad_norm": gn}


def _local_views(p, g, m, v):
    """``(p, g, m, v, own)`` as the update reads them.  Plain tensors as
    they are, ``own`` the identity.  With DTensor moments (a mesh), this
    rank's local tensors in the moment's placements: the parameter's
    shard (itself when the placements agree, a copy under ZeRO-1),
    the gradient's (each period of a stacked leaf apart; a slice of a
    replicated gradient moves nothing), and ``own``, which keeps a
    per-slice scalar on the ranks at coordinate 0 of every mesh dim the
    moment is replicated on and zeros it elsewhere, so that a sum over the
    whole mesh (:func:`_summed`) counts each shard once."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(m, DTensor):
        return p, g, m, v, lambda x: x
    mesh, pl = m.device_mesh, list(m.placements)
    rep = [Replicate()] * mesh.ndim

    def local(t, placements):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return t.redistribute(mesh, placements).to_local()

    if type(g) is tuple:
        if any(isinstance(x, Shard) and x.dim == 0 for x in pl):
            raise ValueError("a stacked leaf sharded over its periods")
        row = [Shard(x.dim - 1) if isinstance(x, Shard) else x for x in pl]
        gl = tuple(local(r, row) for r in g)
    else:
        gl = None if g is None else local(g, pl)
    coord = mesh.get_coordinate()
    mine = all(coord[i] == 0 for i, x in enumerate(pl)
               if not isinstance(x, Shard))

    def own(x):
        return x if mine else torch.zeros_like(x)
    return local(p, pl), gl, m.to_local(), v.to_local(), own


def _summed(parts: list, ms: list) -> list:
    """The per-slice squared sums, each summed over the mesh when the
    moments are DTensors: all of them in one vector, summed by one
    all-reduce over each mesh dim (not one a slice), so each slice's
    total is its shards' sum, added by the caller in the unsharded
    order."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = next((m.device_mesh for m in ms if isinstance(m, DTensor)), None)
    if mesh is None or not parts:
        return parts
    vec = DTensor.from_local(torch.stack(parts), mesh,
                             [Partial()] * mesh.ndim, run_check=False)
    return list(vec.full_tensor().unbind(0))


def _put_back(local, p, m) -> None:
    """Write an updated local parameter slice back into ``p``: nothing to
    do when it is a view of ``p``; under ZeRO-1 the moments' shards are
    gathered into the parameter's placements (the all-gather) and copied
    in place."""
    from torch.distributed.tensor import DTensor
    if not isinstance(m, DTensor):
        return
    if isinstance(p, DTensor) and list(p.placements) == list(m.placements):
        return
    full = DTensor.from_local(local, m.device_mesh, m.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())
    if isinstance(p, DTensor):
        p.to_local().copy_(full.redistribute(p.device_mesh, p.placements)
                           .to_local())
    else:
        p.copy_(full.full_tensor())


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
