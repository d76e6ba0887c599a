"""Elastic re-sharding: restore a checkpoint onto a different mesh.

A port of ``repro.checkpoint.elastic``.  Checkpoints are saved unsharded
(JAX's format, :mod:`repro_torch.checkpoint.checkpoint`), so restoring onto
a new mesh is ``distribute_tensor`` per leaf with placements rebuilt from
the *new* mesh and the same logical rules -- the mechanism behind elastic
restarts (a 2-pod job resuming on 1 pod, or 256 chips growing to 512).
"""

from __future__ import annotations

from repro_torch import sharding as Sh
from repro_torch import tree as T


def reshard_tree(tree, axes_tree, mesh, rules):
    """Every leaf of ``tree`` as a DTensor on ``mesh``, placed per its
    logical axes under ``rules`` (a leaf whose axes are None is
    replicated).  Each rank keeps only its own shard."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    with Sh.use_mesh_and_rules(mesh, rules):
        def place(leaf, axes):
            if axes is None:
                pl = [Replicate()] * mesh.ndim
            else:
                pl = Sh.logical_to_sharding(leaf.shape, axes)[1]
            return distribute_tensor(leaf, mesh, pl)
        return T.map_leaves(place, tree, axes_tree,
                            is_leaf=lambda x: x is None or (
                                isinstance(x, tuple) and all(
                                    a is None or isinstance(a, str)
                                    for a in x)))


def elastic_restore(directory: str, specs_tree, axes_tree, mesh, rules,
                    step: int | None = None):
    """``restore()`` + :func:`reshard_tree` onto (mesh, rules)."""
    from repro_torch.checkpoint.checkpoint import restore
    host_tree, step, extra = restore(directory, specs_tree, step)
    return reshard_tree(host_tree, axes_tree, mesh, rules), step, extra
