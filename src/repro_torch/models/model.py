"""Model: the public API over configs -- spec tree, init, forward, the
loss value, and the serving steps (``decode_step``, ``chunk_step``).

A port of ``repro.models.model``.  Parameters are a plain nested dict of
tensors with ``repro``'s keys (``embed``, ``final_norm_gamma``,
``stack/slots[i]/<name>``, ``stack/shared/<name>``, ``unembed``), so :mod:`repro_torch.bridge` maps a
JAX parameter tree onto it by copying.  ``Model(cfg, kernels=...)`` selects
the kernel entry points (default: the hand-written kernels on CUDA tensors,
their plain versions on CPU tensors).
"""

from __future__ import annotations

import weakref
from typing import Any

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Spec
from repro_torch.models.transformer import Ctx, LayerStack

Params = dict


def _flatten(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict/list tree (a ``Spec`` is a
    leaf), dict keys sorted as ``jax.tree`` orders them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _map_specs(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_specs(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_specs(v, fn) for v in tree]
    return fn(tree)


class Model:
    def __init__(self, cfg: ArchConfig, kernels: L.Kernels | None = None):
        self.cfg = cfg
        self.stack = LayerStack(cfg)
        self.kernels = kernels or L.DEFAULT_KERNELS
        # the tied unembed [d_model, vocab]: (weak ref to the embedding it
        # was made from, that tensor's version, the contiguous transpose)
        self._tied = None

    # ------------------------------------------------------------------ specs
    def _spec_tree(self) -> dict[str, Any]:
        cfg = self.cfg
        tree = {
            "embed": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
            "stack": self.stack.param_specs_dict(),
        }
        tree.update(L.norm_specs(cfg, "final_norm"))
        if not cfg.tie_embeddings:
            tree["unembed"] = Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
        return tree

    def param_numels(self) -> list[tuple[str, int]]:
        """(path, element count) for every parameter; allocates nothing."""
        out = []
        for path, s in _flatten(self._spec_tree()):
            n = 1
            for d in s.shape:
                n *= d
            out.append((path, n))
        return out

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters in ``cfg.dtype`` with ``repro``'s scaling
        (normal, ``scale / sqrt(fan_in)``; norms ones, biases zeros), drawn
        on the generator's device.  The values differ from JAX's for the
        same seed; tests bridge JAX's parameters instead
        (:mod:`repro_torch.bridge`)."""
        dt = getattr(torch, self.cfg.dtype)
        return _map_specs(self._spec_tree(), lambda s: L.init_param(
            generator, s, dt, generator.device))

    # ------------------------------------------------------------------ embed
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def tied_unembed(self, embed: torch.Tensor) -> torch.Tensor:
        """``embed.T`` as the contiguous [d_model, vocab] operand of the
        unembed GEMM, transposed once and reused while ``embed`` is the same
        tensor at the same version (an in-place update transposes it
        again).  At gemma3's width the copy is 2 GB in bf16."""
        if self._tied is not None:
            ref, version, w = self._tied
            if ref() is embed and version == embed._version:
                return w
        w = embed.T.contiguous()
        self._tied = (weakref.ref(embed), embed._version, w)
        return w

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w = (self.tied_unembed(params["embed"]) if self.cfg.tie_embeddings
             else params["unembed"])
        return L.dense(x, w, kernels=self.kernels)

    # ------------------------------------------------------------------ forward
    @torch.no_grad()
    def forward(self, params: Params, batch: dict, *, mode: str = "train",
                caches=None):
        """Returns (logits [B, S, V], caches, aux); caches are updated in
        place.  ``aux`` is the MoE auxiliary loss summed over the layers
        (0 without MoE layers).  ``mode`` ('train', 'prefill', 'decode' or
        'chunk') picks the recurrences' per-token step in decode mode and
        their chunked mix otherwise."""
        tokens = batch["tokens"]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
        x = self._embed(params, tokens)
        ctx = Ctx(mode=mode, positions=positions,
                  shared_params=params["stack"].get("shared"),
                  lengths=batch.get("lengths"), kernels=self.kernels)
        x, caches, aux = self.stack.apply(params["stack"], x, ctx,
                                          caches=caches)
        x = L.apply_norm(self.cfg, params, "final_norm", x)
        logits = self._unembed(params, x)
        return logits, caches, aux

    # ------------------------------------------------------------------ train
    @torch.no_grad()
    def loss(self, params: Params, batch: dict):
        """Next-token cross-entropy of ``forward`` against
        ``batch["labels"]`` [B, S], averaged over ``batch["mask"]`` (default
        every position), plus ``0.01 * aux``.  Returns (total, {"ce",
        "aux"}).  The value only: the gradient comes with training (ROADMAP
        Queue 1 item 12)."""
        logits, _, aux = self.forward(params, batch)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        labels = batch["labels"].long()
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        mask = batch.get("mask")
        mask = (torch.ones_like(nll) if mask is None
                else mask.to(torch.float32))
        ce = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------ serve
    def init_caches(self, batch: int, cache_len: int, *, device=None):
        """Empty caches for :meth:`prefill` and :meth:`decode_step` (the
        sequential path) on ``device`` (default ``cuda``), one per layer: a
        dense KV cache per attention layer and shared-block call, zeroed
        state rows per recurrent layer; see ``LayerStack.cache_tree``."""
        return self.stack.cache_tree(
            batch, cache_len, getattr(torch, self.cfg.dtype),
            device=_device.resolve(device))

    def prefill(self, params: Params, batch: dict, caches):
        """Run a prompt (``batch["tokens"]`` [B, S], shared ``positions``
        [S]) and store its K/V in the dense ``caches`` (in place).  Returns
        (logits of the last position [B, 1, V], caches)."""
        logits, caches, _ = self.forward(params, batch, mode="prefill",
                                         caches=caches)
        return logits[:, -1:], caches

    def decode_step(self, params: Params, caches, tokens: torch.Tensor,
                    pos: torch.Tensor, lengths: torch.Tensor | None = None):
        """tokens [B, 1]; pos [B] int32 per-slot absolute positions;
        ``caches`` are the engine's page pools or dense caches from
        :meth:`init_caches`.  ``lengths`` ([B] 0/1) is the live mask of the
        paged path and of the recurrent layers: rows at 0 write nothing
        and keep their state (dense attention, like JAX's, ignores it).  Returns (logits [B, V], caches)."""
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        if pos.dim() != 1:
            raise ValueError("decode_step needs per-slot positions pos: [B] "
                             "int32")
        batch = {"tokens": tokens, "positions": pos.reshape(-1, 1)}
        if lengths is not None:
            batch["lengths"] = torch.as_tensor(lengths, dtype=torch.int32,
                                               device=tokens.device)
        logits, caches, _ = self.forward(params, batch, mode="decode",
                                         caches=caches)
        return logits[:, -1], caches

    def chunk_step(self, params: Params, caches, tokens: torch.Tensor,
                   positions: torch.Tensor, lengths: torch.Tensor,
                   return_greedy: bool = False):
        """One mixed continuous-batching step: tokens [B, S], positions
        [B, S] absolute per slot (row ``b`` holds ``start_b + arange(S)``),
        lengths [B] real tokens per row (1 for a decoding slot, 0 for an
        idle one).  Returns (per-row logits at column ``lengths - 1``
        [B, V], caches), plus the per-column argmax chain [B, S] int32 in
        the middle with ``return_greedy=True``."""
        positions = torch.as_tensor(positions, dtype=torch.int32,
                                    device=tokens.device)
        if positions.dim() != 2:
            raise ValueError("chunk_step needs per-slot [B, S] positions")
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=tokens.device)
        batch = {"tokens": tokens, "positions": positions, "lengths": lengths}
        logits, caches, _ = self.forward(params, batch, mode="chunk",
                                         caches=caches)
        idx = (lengths.long() - 1).clamp(min=0)
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        if return_greedy:
            greedy = torch.argmax(logits, dim=-1).to(torch.int32)
            return last, greedy, caches
        return last, caches
