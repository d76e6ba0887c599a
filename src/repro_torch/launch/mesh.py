"""Meshes over the initialized process group: the production 16x16
``("data", "model")`` and 2x16x16 ``("pod", "data", "model")`` meshes, and
small host meshes.

A port of ``repro.launch.mesh``.  A ``DeviceMesh`` takes its ranks from
whatever default process group is initialized: a fake one of 256 or 512
ranks in the dry run (:mod:`repro_torch.launch.dryrun`), gloo on the CPU,
NCCL on the card.  Functions, not module constants, so importing this
module touches no process group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {shape} needs an initialized process "
                           f"group of {need} ranks")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"mesh {shape} needs {need} ranks, the process "
                           f"group has {world}")
    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A ``(data, model)`` mesh over the initialized group, whose world
    size must be ``data * model``."""
    return _mesh((data, model), ("data", "model"))
