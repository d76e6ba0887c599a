"""Long-context decode across attention families (the ``long_500k`` cell).

Why the dry run runs that cell only for archs with a bounded state:

* rwkv6-3b     -- attention-free, O(1) recurrent state;
* zamba2-1.2b  -- Mamba2 O(1) state + a shared attention block;
* mixtral-8x22b -- every layer sliding-window: its KV is bounded by the
  window (here by the 32-entry ring).

Each model decodes with a *small* cache while the position runs far past
it (the ring buffer or the recurrent state carries the context), which is
what makes a 524k-token decode cell shardable.  Smoke configs:

    PYTHONPATH=src python -m repro_torch.examples.long_context --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.models.model import Model
from repro_torch.serving.state import tensor_leaves

ARCHS = ("rwkv6-3b", "zamba2-1.2b", "mixtral-8x22b")
PROMPT = 8


def _allocated(device) -> int | None:
    return (torch.cuda.memory_allocated(device)
            if device.type == "cuda" else None)


def run(model: Model, params, *, cache_len: int = 32, horizon: int = 128,
        batch: int = 2, device, log=print) -> dict:
    """Prefill ``batch`` seeded prompts of 8 tokens into caches of
    ``cache_len`` entries, then decode greedily to position ``8 +
    horizon``; every step's logits must be finite (else AssertionError).
    Returns the greedy tokens (the prefill's, then one list a step), the
    last logits [batch, V], the decode rate in tok/s, and after the first
    and the last decode step the cache leaves' bytes and, on the card,
    ``torch.cuda.memory_allocated``."""
    device = torch.device(device)
    cfg = model.cfg
    caches = model.init_caches(batch, cache_len, device=device)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (batch, PROMPT)),
                             dtype=torch.int32, device=device)
    last, caches = model.prefill(
        params, {"tokens": prompt,
                 "positions": torch.arange(PROMPT, dtype=torch.int32,
                                           device=device)}, caches)
    tok = torch.argmax(last[:, -1], dim=-1)[:, None].to(torch.int32)
    tokens = [tok[:, 0].tolist()]
    mem = {}
    t0 = time.perf_counter()
    for pos in range(PROMPT, PROMPT + horizon):
        last, caches = model.decode_step(
            params, caches, tok,
            torch.full((batch,), pos, dtype=torch.int32, device=device))
        tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
        if not bool(torch.isfinite(last).all()):
            raise AssertionError(f"{cfg.name}: a logit is not finite at "
                                 f"position {pos}")
        tokens.append(tok[:, 0].tolist())
        if pos in (PROMPT, PROMPT + horizon - 1):
            when = "first" if pos == PROMPT else "last"
            mem[f"cache_bytes_{when}"] = sum(
                t.numel() * t.element_size() for t in tensor_leaves(caches))
            mem[f"allocated_{when}"] = _allocated(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok_s = horizon * batch / dt
    log(f"{cfg.name:16s} [{cfg.family}] decoded to position "
        f"{PROMPT + horizon} with a {cache_len}-slot cache: {tok_s:6.1f} "
        f"tok/s (no NaNs)")
    return {"tokens": tokens, "last_logits": last, "tok_s": tok_s,
            "seconds": dt, **mem}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = _device.resolve(args.device)
    for arch in ARCHS:
        model = Model(smoke_config(get_arch(arch)))
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        run(model, params, device=dev)
    print("long-context decode: position >> cache everywhere — the state "
          "stays O(window/recurrence), which is what long_500k shards.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
