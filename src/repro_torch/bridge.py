"""Parameters from a numpy tree with ``repro``'s layout.

``params_from_numpy(jax.tree.map(np.asarray, repro.Model(cfg).init(key)))``
gives the port's parameters for the same model.  Both packages keep dense
weights as ``[K, N]`` (``dense`` computes ``x @ w``) and the same nested
keys, so the bridge only copies: no transpose, no renaming.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device


def _to_tensor(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind not in "biuf":
        # bfloat16 (ml_dtypes) has no numpy-native torch counterpart: widen
        # exactly to float32 first
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, *, device=None, dtype: torch.dtype | None = None):
    """The same nested dict/list tree with every array as a tensor on
    ``device`` (default ``cuda``); ``dtype`` casts floating leaves."""
    dev = _device.resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _to_tensor(node, dev, dtype)

    return walk(tree)
