"""Quickstart: build a small model, run a forward pass, take 3 train steps,
then serve a few tokens -- the port's public API in one screen.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

On the card (the default ``--device cuda``) every dense product, its
gradient's two products included, goes through ``kraken_gemm``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.configs import get_arch, smoke_config
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW


def run(model: Model, params, *, device, log=print) -> dict:
    """The quickstart on ``model`` and ``params`` (on ``device``; the
    parameters are updated in place by the three AdamW steps): the
    forward's logits, the three losses and the greedy tokens of the
    8-token prefill and 8 decode steps."""
    cfg = model.cfg
    n_params = sum(t.numel() for t in T.leaves(params))
    log(f"arch={cfg.name} family={cfg.family} params={n_params:,}")

    # 1. Forward + loss.
    rng = np.random.default_rng(0)
    b, s = 4, 32
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                dtype=torch.int32, device=device)
             for k in ("tokens", "labels")}
    with torch.no_grad():
        logits, _, _ = model.forward(params, batch)
    log(f"logits: {tuple(logits.shape)} "
        f"({str(logits.dtype).removeprefix('torch.')})")

    # 2. Three optimizer steps: the loss's gradient, then AdamW in place.
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    leaves = T.leaves(params)
    losses = []
    for i in range(3):
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        params, state, _ = opt.update(T.unflatten_like(params, list(grads)),
                                      state, params)
        losses.append(float(loss.detach()))
        log(f"step {i}: loss {losses[-1]:.4f}")
    for t in leaves:
        t.requires_grad_(False)

    # 3. Serve: prefill a prompt, then greedy-decode 8 tokens.
    caches = model.init_caches(1, 64, device=device)
    prompt = batch["tokens"][:1, :8]
    last, caches = model.prefill(
        params, {"tokens": prompt,
                 "positions": torch.arange(8, dtype=torch.int32,
                                           device=device)}, caches)
    tok = torch.argmax(last[:, -1], dim=-1)[:, None]
    out = [int(tok[0, 0])]
    for t in range(8, 16):
        # pos is per-slot [B]: lockstep decode passes one position for all
        last, caches = model.decode_step(
            params, caches, tok,
            torch.full((1,), t, dtype=torch.int32, device=device))
        tok = torch.argmax(last, dim=-1)[:, None]
        out.append(int(tok[0, 0]))
    log(f"decoded tokens: {out}")
    return {"params": n_params, "logits": logits, "losses": losses,
            "tokens": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    dev = _device.resolve(p.parse_args(argv).device)
    # any registry architecture, shrunk to its smoke config
    model = Model(smoke_config(get_arch("yi-6b")))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    run(model, params, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
