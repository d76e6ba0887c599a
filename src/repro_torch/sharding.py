"""Logical-axis sharding: MaxText-style rules mapping logical axes to mesh
axes, over DTensor.

A port of ``repro.sharding``.  Every parameter and key activation in the
model code carries *logical* axis names (``embed``, ``heads``, ``mlp``,
``experts``, ``vocab``, ``batch``, ``seq``, ...).  The launcher installs a
mesh plus a rule table mapping logical axes to mesh axes (DP/TP/EP/SP
strategies are just different rule tables), and the model code calls
:func:`shard` / :func:`logical_to_sharding` without knowing the topology.

Divisibility guard: a logical axis whose dimension is not divisible by the
product of its mapped mesh axes is replicated instead (recorded in
``dropped_axes`` so the roofline report can call it out), as in JAX.

:func:`partition_spec` gives JAX's ``PartitionSpec`` as a plain tuple, one
entry a tensor dimension: a tuple of mesh axis names, or None.
:func:`placements` turns it into DTensor placements, one a mesh dimension:
a dimension mapped to ``("pod", "data")`` is ``Shard(d)`` on both mesh
dimensions, split pod-major as JAX splits it.  A *mesh* is anything with
named dimensions and sizes -- a ``DeviceMesh`` (over a real or a fake
process group), a ``{name: size}`` dict, or an object whose ``shape`` is
such a dict -- so the dry run's mesh and a real one go through the same
code.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Sequence

import torch

_state = threading.local()

# Default rule tables.  Values are a mesh axis name, a tuple of them, or None.
RULES_SINGLE_POD = {
    "batch": ("data",),
    "moe_groups": ("data",),   # MoE dispatch groups ride the token sharding
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "qkv": ("model",),          # flattened heads*head_dim projections
    "mlp": ("model",),
    "experts": ("model",),
    "expert_capacity": None,
    "vocab": ("model",),
    "kv_seq": None,
    "layers": None,
    "conv_k": None,
    "state": None,
    "frontend_seq": None,
}

RULES_MULTI_POD = dict(RULES_SINGLE_POD, batch=("pod", "data"),
                       moe_groups=("pod", "data"))

# Sequence-parallel variants (long-context cells: batch too small to shard).
# moe_groups keeps riding the *token* sharding (flattened B*S = seq here).
RULES_SP_SINGLE_POD = dict(RULES_SINGLE_POD, batch=None, seq=("data",),
                           kv_seq=("data",), moe_groups=("data",))
RULES_SP_MULTI_POD = dict(RULES_SINGLE_POD, batch=None, seq=("pod", "data"),
                          kv_seq=("pod", "data"),
                          moe_groups=("pod", "data"))


def _ctx():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


@contextlib.contextmanager
def use_mesh_and_rules(mesh, rules: dict[str, Any] | None):
    """Install (mesh, rules) for model code executed in this thread."""
    _ctx().append({"mesh": mesh, "rules": rules or {}, "dropped": []})
    try:
        yield
    finally:
        _ctx().pop()


def current() -> dict | None:
    stack = _ctx()
    return stack[-1] if stack else None


def dropped_axes() -> list[tuple]:
    c = current()
    return list(c["dropped"]) if c else []


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a dict, or an object
    whose ``shape`` is a dict (a JAX mesh), in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(mesh.shape)


def _mesh_axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_shape(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def partition_spec(shape: Sequence[int],
                   logical_axes: Sequence[str | None]) -> tuple:
    """Map logical axes to JAX's ``PartitionSpec`` entries under the
    installed rules: one entry a dimension, a tuple of mesh axes or None
    (``()`` without an installed mesh, as ``PartitionSpec()``)."""
    c = current()
    if c is None or c["mesh"] is None:
        return ()
    mesh, rules = c["mesh"], c["rules"]
    spec = []
    used: set[str] = set()
    for dim, name in zip(shape, logical_axes):
        mapped = rules.get(name) if name else None
        if mapped is not None:
            if isinstance(mapped, str):
                mapped = (mapped,)
            # a mesh axis may appear at most once per spec: drop repeats
            mapped = tuple(a for a in mapped if a not in used)
            if not mapped:
                mapped = None
            else:
                size = _mesh_axis_size(mesh, mapped)
                if dim % size != 0:
                    c["dropped"].append((name, dim, mapped))
                    mapped = None
                else:
                    used.update(mapped)
        spec.append(mapped)
    return tuple(spec)


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements, one a mesh dimension, of a ``partition_spec``:
    ``Shard(d)`` on every mesh dimension that tensor dimension ``d`` maps
    to, ``Replicate()`` elsewhere.  A dimension over several mesh axes
    must name them in the mesh's order (major to minor), which is the
    order DTensor splits in."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(order)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        if isinstance(axes, str):
            axes = (axes,)
        idx = [order.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dimension {d} maps to {axes}, not in the "
                             f"mesh's order {order}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_to_sharding(shape: Sequence[int],
                        logical_axes: Sequence[str | None]):
    """(mesh, placements) of a tensor under the installed rules; None
    without an installed mesh."""
    c = current()
    if c is None or c["mesh"] is None:
        return None
    return c["mesh"], placements(c["mesh"],
                                 partition_spec(shape, logical_axes))


def local_shape(shape: Sequence[int], mesh, spec: Sequence) -> tuple:
    """The per-device shape of ``shape`` under ``spec`` (JAX's
    ``NamedSharding.shard_shape``); the guard keeps every split even."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            out[d] //= sizes[a]
    return tuple(out)


def shard(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """Sharding constraint on an activation: a no-op without an installed
    mesh or on a plain tensor; a DTensor is redistributed to the rule's
    placements."""
    c = current()
    if c is None or c["mesh"] is None:
        return x
    assert len(logical_axes) == x.dim(), (tuple(x.shape), logical_axes)
    if not is_dtensor(x):
        return x
    want = placements(x.device_mesh, partition_spec(x.shape, logical_axes))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


_DTENSOR: list = []


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (the class imported once, on first use:
    the serving paths ask on every layer)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def distribute(t: torch.Tensor, mesh, placements):
    """``t`` (the whole tensor, the same on every rank) as a DTensor that
    keeps this rank's shard; nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def abstract(shape: Sequence[int], dtype, axes: Sequence[str | None] | None,
             mesh, rules, *, device="meta"):
    """A DTensor of ``shape`` placed by ``axes`` under (mesh, rules) whose
    local shard is an empty tensor on ``device``: ``meta`` allocates
    nothing, and under ``FakeTensorMode`` any device is fake.  ``axes``
    None replicates."""
    from torch.distributed.tensor import DTensor
    with use_mesh_and_rules(mesh, rules):
        spec = (partition_spec(shape, axes) if axes is not None
                else (None,) * len(shape))
    pl = placements(mesh, spec)
    local = torch.empty(local_shape(shape, mesh, spec), dtype=dtype,
                        device=device)
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def local_bytes(tree_leaves) -> int:
    """Bytes of this rank's shards of the DTensors (or of the plain
    tensors) in ``tree_leaves``."""
    n = 0
    for t in tree_leaves:
        loc = t.to_local() if is_dtensor(t) else t
        n += loc.numel() * loc.element_size()
    return n


def partition_spec_of(mesh, rules, shape: Sequence[int],
                      axes: Sequence[str | None]) -> tuple:
    """:func:`partition_spec` under (mesh, rules), installed for the call."""
    with use_mesh_and_rules(mesh, rules):
        return partition_spec(shape, axes)


@contextlib.contextmanager
def mixing(x):
    """The context under which plain tensors count as replicated beside
    DTensors (``implicit_replication``) when ``x`` is a DTensor; a null
    context otherwise.  It nests: leaving it restores the setting it
    found (``implicit_replication`` itself clears it on exit)."""
    if not is_dtensor(x):
        yield
        return
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


# ---------------------------------------------------------------------------
# DTensor placements the model's reshapes can take
# ---------------------------------------------------------------------------

def _gathered(x: torch.Tensor, drop) -> torch.Tensor:
    """A DTensor ``x`` gathered on every ``Shard`` placement for which
    ``drop(placement)`` holds; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if isinstance(p, Shard) and drop(p) else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def fit_split(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` ready for dimension ``dim`` to split into ``n`` major parts
    (a head split): a DTensor sharded on ``dim`` over mesh dims whose
    sizes do not divide ``n`` is gathered on ``dim`` first, as GSPMD
    reshards there (DTensor refuses an uneven split)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    dim = dim % x.dim()
    size = 1
    for p, k in zip(x.placements, x.device_mesh.shape):
        if isinstance(p, Shard) and p.dim == dim:
            size *= k
    if n % size == 0:
        return x
    return _gathered(x, lambda p: p.dim == dim)


def gather_inner(x: torch.Tensor) -> torch.Tensor:
    """``x`` ready to flatten its leading dimensions into one: a DTensor
    sharded on a dimension between the first and the last is gathered on
    it (flattening it would give a strided shard; GSPMD gathers there
    too)."""
    return _gathered(x, lambda p: 0 < p.dim < x.dim() - 1)


def keep_batch(x: torch.Tensor) -> torch.Tensor:
    """A DTensor sharded on its first (batch) dimension only, gathered on
    every other: the recurrences keep their row states sharded by batch
    alone."""
    return _gathered(x, lambda p: p.dim != 0)


class _OnGrad(torch.autograd.Function):
    """The identity, whose gradient is passed through ``fn``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def gather_inner_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is gathered on its inner dimensions
    (:func:`gather_inner`) before it flows on: the gradient of a tensor
    unflattened from ``[B*S, N]`` comes back sequence-sharded from the
    residual stream, and flattening it again must not give a strided
    shard (Megatron-SP's backward all-gather).  A plain tensor is returned
    as it is."""
    return _OnGrad.apply(x, gather_inner) if is_dtensor(x) else x


def fit_split_grad(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` (a merge of ``n`` parts into ``dim``), whose gradient is made
    ready by :func:`fit_split` for the backward's split of ``dim`` into
    ``n`` parts.  A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    return _OnGrad.apply(x, lambda g: fit_split(g, dim, n))


# ---------------------------------------------------------------------------
# local work under a mesh
# ---------------------------------------------------------------------------

def by_rows(fn, *args, shared: tuple = (), n_out: int = 1):
    """``fn(*args)``, whose args are batch-major rows (every arg whose
    index is not in ``shared``) and replicated operands (``shared``),
    returning ``n_out`` batch-major tensors.  When a row arg is a DTensor
    it runs on each rank's local rows (``local_map``): a recurrence
    updates each row on its own, so nothing moves but the gathering of a
    row arg sharded on another dim.  Plain args count as replicated; the
    outputs are placed as the first row DTensor's batch shards."""
    dts = [a for i, a in enumerate(args) if i not in shared
           and is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = dts[0].device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in dts[0].placements)
    rep = (Replicate(),) * mesh.ndim
    ins = tuple(None if not isinstance(a, torch.Tensor) else
                (rep if i in shared else rows) for i, a in enumerate(args))
    # a shared operand's local gradient covers this rank's rows only: a
    # partial sum over the row shards
    part = tuple(Partial() if isinstance(p, Shard) else p for p in rows)
    grads = tuple(part if i in shared and p is not None else p
                  for i, p in enumerate(ins))
    f = local_map(fn, out_placements=(rows,) * n_out, in_placements=ins,
                  in_grad_placements=grads, device_mesh=mesh,
                  redistribute_inputs=True)
    return f(*[DTensor.from_local(a, mesh, rep, run_check=False)
               if isinstance(a, torch.Tensor)
               and not isinstance(a, DTensor) else a for a in args])


def _vocab_parallel(table):
    """(the table with only its row (vocab) shards kept, those mesh dims,
    this rank's first row, its row count)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    vdims = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    pl = [Shard(0) if i in vdims else Replicate() for i in range(mesh.ndim)]
    if list(table.placements) != pl:
        table = table.redistribute(mesh, pl)
    coord, idx = mesh.get_coordinate(), 0
    for i in vdims:
        idx = idx * mesh.size(i) + coord[i]
    n = table.to_local().shape[0]
    return table, vdims, idx * n, n


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` of a DTensor table as a vocab-parallel lookup: the
    table keeps its row shards (any other dim is gathered, FSDP's
    all-gather), the ids are gathered whole, each rank looks up the rows
    it holds and zeros the rest, and the output is a ``Partial`` sum over
    the row shards' mesh dims.  The gradient accumulates as the unsharded
    gather's (``index_put_`` with ``accumulate``) into each rank's rows."""

    @staticmethod
    def forward(ctx, table, ids):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh = table.device_mesh
        rep = [Replicate()] * mesh.ndim
        with torch.no_grad():
            tv, vdims, lo, n = _vocab_parallel(table)
            idl = (ids.redistribute(mesh, rep).to_local()
                   if isinstance(ids, DTensor) else ids)
            mine = (idl >= lo) & (idl < lo + n)
            at = torch.where(mine, idl - lo, 0)
            rows = torch.where(mine[..., None], tv.to_local()[at], 0)
        ctx.save_for_backward(at, mine)
        ctx.meta = (table.placements, tv.placements, table.shape,
                    table.stride(), n)
        return DTensor.from_local(
            rows, mesh, [Partial() if i in vdims else Replicate()
                         for i in range(mesh.ndim)], run_check=False,
            shape=torch.Size((*idl.shape, table.shape[1])),
            stride=rows.stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate
        at, mine = ctx.saved_tensors
        pl, vpl, shape, stride, n = ctx.meta
        mesh = g.device_mesh
        gl = g.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        grad = torch.zeros((n + 1, shape[1]), dtype=gl.dtype,
                           device=gl.device)
        # rows another rank holds land on a trash row
        grad.index_put_((torch.where(mine, at, n),), gl, accumulate=True)
        grad = DTensor.from_local(grad[:n], mesh, vpl, run_check=False,
                                  shape=shape, stride=stride)
        return grad.redistribute(mesh, pl), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; a DTensor table is looked up vocab-parallel
    (:class:`_GatherRows`), with the unsharded gather's gradient
    arithmetic, on every torch version (DTensor's own ``index`` and
    ``index_put`` rules refuse some placements)."""
    if not is_dtensor(table):
        return table[ids]
    return _GatherRows.apply(table, ids)
