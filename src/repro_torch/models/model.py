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

import math
import weakref
from typing import Any

import torch

from repro_torch import device as _device
from repro_torch import sharding
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

    def param_specs(self, fn=None):
        """The parameter tree with each ``Spec`` mapped by ``fn`` (for
        example to a ``meta`` tensor, a checkpoint's restore target); the
        Specs themselves without it."""
        return _map_specs(self._spec_tree(), fn or (lambda s: s))

    def param_axes(self):
        """The logical axes of every parameter, in the parameter tree."""
        return _map_specs(self._spec_tree(), lambda s: s.axes)

    def param_shardings(self, mesh, rules):
        """``(mesh, placements)`` of every parameter under (mesh, rules),
        in the parameter tree (JAX's ``NamedSharding`` tree)."""
        with sharding.use_mesh_and_rules(mesh, rules):
            return _map_specs(self._spec_tree(), lambda s:
                              sharding.logical_to_sharding(s.shape, s.axes))

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
    def _embed(self, params: Params, tokens: torch.Tensor,
               positions: torch.Tensor,
               frontend: torch.Tensor | None) -> torch.Tensor:
        """Token embeddings; plus the sinusoidal position embedding (fp32,
        cast to the activation dtype before the add, broadcast over the
        batch for shared [S] positions) and then, for the audio frontend,
        the frame embeddings, in JAX's order (in bf16 another order rounds
        apart)."""
        cfg = self.cfg
        x = sharding.gather_rows(params["embed"], tokens.long())
        if cfg.positional == "sinusoidal":
            pos = L.sinusoidal_pos_emb(positions, cfg.d_model)
            if positions.dim() == 1:   # shared [S] -> broadcast over batch
                pos = pos[None]
            x = x + pos.to(x.dtype)
        if cfg.frontend == "audio_frames" and frontend is not None:
            x = x + frontend.to(x.dtype)
        return sharding.shard(x, "batch", "seq", "embed")

    def tied_unembed(self, embed: torch.Tensor) -> torch.Tensor:
        """``embed.T`` as the contiguous [d_model, vocab] operand of the
        unembed GEMM, transposed once and reused while ``embed`` is the same
        tensor at the same version (an in-place update transposes it
        again).  At gemma3's width the copy is 2 GB in bf16.  While
        autograd records through ``embed`` the transpose is made in the
        graph on every call and never cached, so the unembed's gradient
        reaches ``embed``."""
        if L.needs_grad(embed):
            return embed.T.contiguous()
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
        logits = L.dense(x, w, kernels=self.kernels)
        return sharding.shard(logits, "batch", "seq", "vocab")

    # ------------------------------------------------------------------ forward
    def forward(self, params: Params, batch: dict, *, mode: str = "train",
                caches=None, remat: str = "none"):
        """Returns (logits [B, S, V], caches, aux); caches are updated in
        place.  ``aux`` is the MoE auxiliary loss summed over the layers
        (0 without MoE layers).  ``mode`` ('train', 'prefill', 'decode' or
        'chunk') picks the recurrences' per-token step in decode mode and
        their chunked mix otherwise.  ``batch["frontend"]`` ([B, P,
        d_model], optional) holds the precomputed image patches the cross
        layers attend over, or the audio frames added to the embeddings.
        Differentiable when the parameters require grad; ``remat`` ('none',
        'full' or 'dots', see ``LayerStack.apply``) applies then.  With
        DTensor parameters (under a mesh) the plain tensors the step makes
        (positions, masks) count as replicated.
        """
        with sharding.mixing(params["embed"]):
            return self._forward(params, batch, mode=mode, caches=caches,
                                 remat=remat)

    def _forward(self, params: Params, batch: dict, *, mode: str, caches,
                 remat: str):
        tokens = batch["tokens"]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
        frontend = batch.get("frontend")
        x = self._embed(params, tokens, positions, frontend)
        ctx = Ctx(mode=mode, positions=positions, frontend=frontend,
                  shared_params=params["stack"].get("shared"),
                  lengths=batch.get("lengths"), kernels=self.kernels)
        x, caches, aux = self.stack.apply(params["stack"], x, ctx,
                                          caches=caches, remat=remat)
        x = L.apply_norm(self.cfg, params, "final_norm", x)
        logits = self._unembed(params, x)
        return logits, caches, aux

    # ------------------------------------------------------------------ train
    def loss(self, params: Params, batch: dict, *, remat: str = "none"):
        """Next-token cross-entropy of ``forward`` against
        ``batch["labels"]`` [B, S], averaged over ``batch["mask"]`` (default
        every position), plus ``0.01 * aux``.  Returns (total, {"ce",
        "aux"}), differentiable in the parameters that require grad."""
        logits, _, aux = self.forward(params, batch, remat=remat)
        nll = _nll(logits, batch["labels"].long())
        mask = batch.get("mask")
        mask = (torch.ones_like(nll) if mask is None
                else mask.to(torch.float32))
        ce = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------ serve
    def cache_len_for(self, seq_len: int) -> int:
        """The dense cache length a sequence of ``seq_len`` tokens needs."""
        return seq_len

    def init_caches(self, batch: int, cache_len: int, *, device=None,
                    clamp_window: bool = True):
        """Empty caches for :meth:`prefill` and :meth:`decode_step` (the
        sequential path) on ``device`` (default ``cuda``), one per layer: a
        dense KV cache per attention layer and shared-block call, zeroed
        state rows per recurrent layer and zeroed K/V rows of
        ``cfg.num_frontend_tokens`` per cross-attention layer; see
        ``LayerStack.cache_tree``.  ``clamp_window=False`` keeps a
        sliding-window layer's cache at the whole ``cache_len`` (the
        whole-prompt prefill ``StateTree.scatter_prefill`` reads)."""
        return self.stack.cache_tree(
            batch, cache_len, getattr(torch, self.cfg.dtype),
            device=_device.resolve(device), clamp_window=clamp_window)

    def cache_specs(self, batch: int, cache_len: int, *, flat: bool = True):
        """:meth:`init_caches`'s tree on the ``meta`` device: nothing is
        allocated.  The port keeps JAX's ``flat=True`` layout only."""
        if not flat:
            raise ValueError("the port keeps one cache per layer (JAX's "
                             "flat=True layout) only")
        return self.stack.cache_tree(batch, cache_len,
                                     getattr(torch, self.cfg.dtype),
                                     device=torch.device("meta"))

    def cache_axes_list(self, batch: int = 1, cache_len: int = 2, *,
                        flat: bool = True) -> list:
        """Logical axes aligned with :func:`cache_leaves` of
        ``cache_specs(...)``, as JAX's ``cache_axes_list(flat=True)``
        names them: a position row is ``("batch", "kv_seq")``, a K or V
        block ``("batch", "kv_heads", "kv_seq", "head_dim")``, anything
        else is sharded over the batch only."""
        out = []
        for names, leaf in cache_leaves(self.cache_specs(batch, cache_len,
                                                         flat=flat)):
            rank = leaf.dim()
            if "pos" in names:
                out.append(("batch", "kv_seq"))
            elif rank >= 3 and ("k" in names or "v" in names):
                out.append(("batch", "kv_heads", "kv_seq",
                            "head_dim")[-rank:])
            else:
                out.append(tuple(["batch"] + [None] * (rank - 1)))
        return out

    @torch.no_grad()
    def prefill(self, params: Params, batch: dict, caches):
        """Run a prompt (``batch["tokens"]`` [B, S], shared ``positions``
        [S], an optional ``frontend``) and store its K/V in the dense
        ``caches`` (in place; the cross layers' rows hold the frontend's
        K/V).  Returns (logits of the last position [B, 1, V], caches)."""
        logits, caches, _ = self.forward(params, batch, mode="prefill",
                                         caches=caches)
        return logits[:, -1:], caches

    @torch.no_grad()
    def decode_step(self, params: Params, caches, tokens: torch.Tensor,
                    pos: torch.Tensor, frontend: torch.Tensor | None = None,
                    lengths: torch.Tensor | None = None):
        """tokens [B, 1]; pos [B] int32 per-slot absolute positions;
        ``caches`` are the engine's page pools or dense caches from
        :meth:`init_caches`; ``frontend`` ([B, 1, d_model]) the audio
        frames of this step (the cross layers read their frozen rows and
        ignore it).  ``lengths`` ([B] 0/1) is the live mask of the paged
        path and of the recurrent layers: rows at 0 write nothing and keep
        their state (dense attention, like JAX's, ignores it).  Returns
        (logits [B, V], caches)."""
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        if pos.dim() != 1:
            raise ValueError("decode_step needs per-slot positions pos: [B] "
                             "int32")
        batch = {"tokens": tokens, "positions": pos.reshape(-1, 1),
                 "frontend": frontend}
        if lengths is not None:
            batch["lengths"] = torch.as_tensor(lengths, dtype=torch.int32,
                                               device=tokens.device)
        logits, caches, _ = self.forward(params, batch, mode="decode",
                                         caches=caches)
        return logits[:, -1], caches

    @torch.no_grad()
    def chunk_step(self, params: Params, caches, tokens: torch.Tensor,
                   positions: torch.Tensor, lengths: torch.Tensor,
                   frontend: torch.Tensor | None = None,
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
        batch = {"tokens": tokens, "positions": positions, "lengths": lengths,
                 "frontend": frontend}
        logits, caches, _ = self.forward(params, batch, mode="chunk",
                                         caches=caches)
        idx = (lengths.long() - 1).clamp(min=0)
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        if return_greedy:
            greedy = torch.argmax(logits, dim=-1).to(torch.int32)
            return last, greedy, caches
        return last, caches


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-log_softmax(logits)[labels]`` in fp32, [B, S].  Logits sharded
    over the vocab (a DTensor on mesh dims of size > 1) stay sharded: each
    rank takes its vocab slice's max, sum of exponentials and label logit,
    and the three are combined across the slices (a vocab-parallel
    cross-entropy, where gathering the vocab would hold [B, S, V] fp32
    tensors whole on every rank)."""
    vdims = []
    if sharding.is_dtensor(logits):
        from torch.distributed.tensor import Shard
        vdims = [i for i, p in enumerate(logits.placements)
                 if isinstance(p, Shard) and p.dim == 2
                 and logits.device_mesh.size(i) > 1]
    if not vdims:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        return -torch.gather(logp, -1, labels[..., None])[..., 0]
    return _nll_vocab_parallel(logits, labels, vdims)


def _nll_vocab_parallel(logits, labels, vdims) -> torch.Tensor:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    bd = [i for i, p in enumerate(logits.placements)
          if isinstance(p, Shard) and p.dim == 0]
    groups = [mesh.get_group(i) for i in vdims]
    coord, idx = mesh.get_coordinate(), 0
    for i in vdims:
        idx = idx * mesh.size(i) + coord[i]
    n = logits.shape[-1] // math.prod(mesh.size(i) for i in vdims)
    lo = idx * n

    def pl(**by):
        out = [Replicate()] * mesh.ndim
        for d, mdims in by.items():
            for i in mdims:
                out[i] = Shard(int(d[1:]))
        return tuple(out)

    def body(xl, yl):
        x = xl.to(torch.float32)
        m = x.amax(dim=-1, keepdim=True).detach()
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        z = x - m
        se, mine = torch.exp(z).sum(dim=-1), (yl >= lo) & (yl < lo + n)
        tz = torch.where(mine, torch.gather(
            z, -1, torch.where(mine, yl - lo, 0)[..., None])[..., 0], 0.0)
        for g in groups:
            se, tz = L._SumAcross.apply(se, g), L._SumAcross.apply(tz, g)
        return torch.log(se) - tz

    f = local_map(body, out_placements=(pl(d0=bd),),
                  in_placements=(pl(d0=bd, d2=vdims), pl(d0=bd)),
                  device_mesh=mesh, redistribute_inputs=True)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    return f(logits, labels)


def cache_leaves(caches) -> list:
    """(path names, tensor) of every cache leaf in ``jax.tree.leaves``
    order: dicts by sorted key, lists in order, a ``KVCache``'s fields as
    JAX registers them (k, v, pos, k_scale, v_scale; None skipped), a
    NamedTuple state's fields in order."""
    out = []

    def walk(node, names):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            out.append((names, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], names + [k])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, names + [f])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, names + [f"[{i}]"])
        elif isinstance(node, L.KVCache):
            for f in ("k", "v", "pos", "k_scale", "v_scale"):
                walk(getattr(node, f), names + [f])
        else:
            raise TypeError(f"cache leaf of type {type(node).__name__}")

    walk(caches, [])
    return out


# ---------------------------------------------------------------------------
# FLOPs model (roofline MODEL_FLOPS = 6*N*D for train, 2*N*D for inference)
# ---------------------------------------------------------------------------

def model_flops(cfg: ArchConfig, tokens: int, kind: str) -> float:
    n_active = cfg.active_param_count()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens
