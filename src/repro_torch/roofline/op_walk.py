"""The ops a step dispatches, counted: the counterpart of
``repro.roofline.hlo_walk``.

JAX compiles a step and walks its optimized HLO; the port runs the step
eagerly -- on fake tensors in the dry run -- under :class:`OpWalk`, a
``TorchDispatchMode`` that sees every op at the dispatcher.  Under DTensor
it sees the per-rank *local* ops (it steps aside for the DTensor and
counts what DTensor dispatches on the local shards), which is JAX's
per-device convention, and the collectives DTensor issues to move shards.
It counts:

* **FLOPs**: matrix products by ``torch.utils.flop_counter``'s formulas
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, SDPA; an einsum
  reaches the dispatcher as ``bmm``), plus :data:`FLOP_FORMULAS` for the
  port's own ops (``repro_torch::dense_gemm``: ``2 M K N``); like the
  walk's dot FLOPs, elementwise work is not counted.
* **HBM bytes**: operands plus outputs of each op, ``cost_analysis``'s
  convention.  View ops, allocations and ops that return no tensor (a
  metadata query) move nothing (``hlo_walk._FREE_OPS``), a fill writes
  its output and reads nothing; a gather
  reads what it gathers, not the whole table, and a scatter writes what it
  scatters, not the whole destination (the walk's slice-aware accounting).
* **Collectives**: count and operand bytes by kind (all-gather,
  all-reduce, reduce-scatter, all-to-all) of the ``_c10d_functional``
  collectives that DTensor issues and of the ``c10d`` ops that
  ``torch.distributed``'s own calls dispatch (``dist.all_reduce`` in the
  softmax combines, the vocab-parallel loss and the compressed
  all-reduce).
* **Live bytes**: the peak of the bytes held by tensors the walked ops
  made, over the walk (a tensor is freed when the last Python object that
  shares its storage goes).

Eager dispatch unrolls every loop -- the microbatches, the layers, the
attention chunks -- so every op is seen as many times as it runs, and no
trip-count logic is ported.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# the ops ``torch.distributed``'s calls dispatch (in place, into tensors
# the caller holds): kind, and the argument that holds the operands
_C10D_KIND = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
}

# ops that only rename or alias bytes, beside every op whose schema says
# its output is a view
_FREE = {"detach", "alias", "lift_fresh", "_unsafe_view", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "wait_tensor", "_local_scalar_dense", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "set_"}
# write their output and read nothing
_FILLS = {"new_zeros", "new_ones", "new_full", "zeros_like", "ones_like",
          "full_like", "zeros", "ones", "full", "arange", "scalar_tensor"}
# reads as many table entries as it writes
_GATHERS = {"index", "index_select", "gather", "embedding"}
# writes as many entries as its source holds
_SCATTERS = {"index_put", "index_put_", "index_copy", "index_copy_",
             "scatter", "scatter_", "scatter_add", "scatter_add_",
             "index_add", "index_add_", "masked_scatter", "masked_scatter_"}


def _dense_gemm_flops(a, b, *args, out_val=None, **kwargs):
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


#: FLOP formulas of the port's own ops, by ``namespace::name``
FLOP_FORMULAS = {"repro_torch::dense_gemm": _dense_gemm_flops}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


@dataclasses.dataclass
class WalkResult:
    """Per-device totals of one walk (the fields of
    ``hlo_walk.WalkResult`` that the port can count)."""
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    coll_bytes_by_kind: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    n_ops: int = 0
    peak_live_bytes: int = 0
    # op name -> [calls, HBM bytes, FLOPs]
    by_op: dict = dataclasses.field(default_factory=dict)


class OpWalk(TorchDispatchMode):
    """``with OpWalk() as w: step(...)``, then ``w.result``."""

    def __init__(self):
        super().__init__()
        self.result = WalkResult()
        self._live = 0
        self._bytes: dict[int, int] = {}    # storage -> its bytes
        self._refs: dict[int, int] = {}     # storage -> tensors seen on it

    # -- live bytes -------------------------------------------------------
    def _track(self, t: torch.Tensor, new: bool) -> None:
        """Count ``t``'s storage live while any tensor object that the walk
        saw on it lives; only a storage that a non-view op made (``new``)
        adds bytes."""
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._bytes:
            if not new:
                return
            self._bytes[key] = st.nbytes()
            self._refs[key] = 0
            self._live += self._bytes[key]
            self.result.peak_live_bytes = max(self.result.peak_live_bytes,
                                              self._live)
        self._refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            self._live -= self._bytes.pop(key)
            del self._refs[key]

    # -- dispatch ---------------------------------------------------------
    def __enter__(self):
        # DTensor infers an output's global shape by running the op on fake
        # global-shape tensors: those runs are not the rank's work
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._muted = 0
        self._orig = ShardingPropagator._propagate_tensor_meta_non_cached
        walk = self

        def muted(prop, op_schema):
            walk._muted += 1
            try:
                return walk._orig(prop, op_schema)
            finally:
                walk._muted -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = muted
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._orig
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # count the local ops DTensor runs
        out = func(*args, **kwargs)
        if self._muted:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        r = self.result
        b0, f0 = r.hbm_bytes + r.coll_bytes, r.dot_flops
        self._count_op(func, args, kwargs, out)
        row = r.by_op.setdefault(func._opname, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += r.hbm_bytes + r.coll_bytes - b0
        row[2] += r.dot_flops - f0

    def _collective(self, kind: str, operands) -> None:
        r = self.result
        b = sum(_nbytes(t) for t in operands)
        r.coll_counts[kind] += 1
        r.coll_bytes_by_kind[kind] += b
        r.coll_bytes += b

    def _count_op(self, func, args, kwargs, out) -> None:
        r = self.result
        r.n_ops += 1
        ns, name = func.namespace, func._opname
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if ns == "_c10d_functional" and name in _COLL_KIND:
            self._collective(_COLL_KIND[name], ins)
            for t in outs:
                self._track(t, new=True)
            return
        if ns == "c10d" and name in _C10D_KIND:
            kind, i = _C10D_KIND[name]
            self._collective(kind, [t for t in tree_leaves(args[i])
                                    if isinstance(t, torch.Tensor)])
            return
        if name in _FREE or func.is_view or not outs:
            # views, allocations and metadata queries (``.device``, a
            # size) move no bytes
            for t in outs:
                self._track(t, new=False)
            return
        key = f"{ns}::{name}"
        if key in FLOP_FORMULAS:
            r.dot_flops += FLOP_FORMULAS[key](*args, out_val=out, **kwargs)
        else:
            from torch.utils.flop_counter import flop_registry
            fn = flop_registry.get(func.overloadpacket)
            if fn is not None:
                r.dot_flops += fn(*args, **kwargs, out_val=out)
        if name in _FILLS:
            r.hbm_bytes += sum(_nbytes(t) for t in outs)
        elif name in _GATHERS:
            idx = sum(_nbytes(t) for t in ins[1:])
            r.hbm_bytes += idx + 2 * sum(_nbytes(t) for t in outs)
        elif name in _SCATTERS:
            src = sum(_nbytes(t) for t in ins[1:])
            r.hbm_bytes += 2 * src
        elif name.endswith("_") or name == "copy_":
            # in place: the sources read, the destination written once
            r.hbm_bytes += sum(_nbytes(t) for t in ins[1:]) + sum(
                _nbytes(t) for t in outs)
        else:
            r.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        for t in outs:
            if not any(t is i for i in ins):
                self._track(t, new=True)


def walk(fn, *args, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), WalkResult)`` with ``fn`` run under an
    :class:`OpWalk`."""
    with OpWalk() as w:
        out = fn(*args, **kwargs)
    return out, w.result
