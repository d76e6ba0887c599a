"""Fault-tolerant checkpointing: atomic, asynchronous, in the reference's
on-disk format (a port of ``repro.checkpoint.checkpoint``).

* **Atomic**: a checkpoint is written to ``step_XXXXXXXX.tmp/`` and renamed
  only after every array and the manifest are written and the manifest
  fsynced: a crash mid-write never corrupts the latest restorable state.
* **Asynchronous**: :class:`AsyncCheckpointer` copies the tensors to host
  memory on the caller's thread (the training loop updates them in place
  afterwards), then writes on a background thread.
* **One format for both packages**: ``manifest.json`` + ``arrays.npz``,
  each leaf keyed by its ``jax.tree_util.keystr`` path
  (``['params']['stack']['slots'][0]['attn_wq']``, ``['opt'].m[...]``);
  bfloat16 is stored as a ``uint16`` view with ``"bfloat16"`` in the
  manifest, which the reference reads through ``ml_dtypes`` and this
  module without it.  A checkpoint written by either package restores in
  the other.
* **Retention**: keeps the last ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import tree as T


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (a storable numpy array, its true dtype's name): bf16 as
    its bits in ``uint16``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        name = str(t.dtype).removeprefix("torch.")
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """Undo :func:`_host`: the stored array as a CPU tensor of its true
    dtype."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_name)))


def save(directory: str, step: int, tree, extra: dict | None = None,
         keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "arrays": []}
    arrays = {}
    for i, (key, leaf) in enumerate(T.leaves_with_path(tree)):
        arr, dtype_name = _host(leaf)
        name = f"arr_{i:05d}"
        arrays[name] = np.ascontiguousarray(arr)
        manifest["arrays"].append({"key": key, "name": name,
                                   "shape": list(arr.shape),
                                   "dtype": dtype_name})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(directory: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like``, whose leaves are
    tensors (or anything with a torch ``dtype``): each comes back as a CPU
    tensor of that dtype.  Returns (tree, step, extra).  Raises
    FileNotFoundError if there is no checkpoint, KeyError if a leaf is
    missing from it."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    by_key = {e["key"]: e for e in manifest["arrays"]}

    def one(key, leaf):
        if key not in by_key:
            raise KeyError(f"checkpoint missing {key}")
        e = by_key[key]
        t = _tensor(data[e["name"]], e["dtype"])
        want = getattr(leaf, "dtype", None)
        if isinstance(want, torch.dtype) and t.dtype != want:
            t = t.to(want)
        return t

    tree = T.map_with_path(one, tree_like)
    return tree, manifest["step"], manifest["extra"]


class AsyncCheckpointer:
    """Device->host snapshot on the caller thread, disk write in background;
    a failed write raises on the next :meth:`wait` (or :meth:`save`)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()  # one in flight at a time
        # a copy, not a view: the caller updates its tensors in place
        host_tree = T.map_leaves(
            lambda x: x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.array(x), tree)

        def _write():
            try:
                save(self.directory, step, host_tree, extra, self.keep)
            except BaseException as e:  # surfaces on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
