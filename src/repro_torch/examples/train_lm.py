"""End-to-end driver: train a ~100M-parameter dense LM for a few hundred
steps with the full production stack (checkpointing, supervisor, straggler
watchdog, cosine schedule).

    PYTHONPATH=src python -m repro_torch.examples.train_lm            # 300 steps
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 30  # quick check

The config is a scaled yi-family model in float32: 12L x d768 x 12H (4 KV
heads of 64), d_ff 2048, vocab 16000 (~114M params).  The loss starts at
about ln 16000 = 9.68 nats.  ``SyntheticLM`` draws each next token as the
last plus a uniform drift in 1..16, so ln 16 = 2.77 nats is the least
expected loss any model can reach; training moves the loss from the start
toward that floor.  Any other flag of ``repro_torch.launch.train`` passes
through and overrides the example's (``--device``, default ``cuda``;
``--smoke`` with a smaller ``--batch``/``--seq`` for a CPU check).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import tempfile

from repro_torch.configs import ArchConfig, get_arch
from repro_torch.configs import registry as R
from repro_torch.launch import train as T

#: the loss of a uniform guess over the vocabulary, and the floor the
#: synthetic stream allows (a uniform drift over 16 successors)
START_LOSS = math.log(16000)
FLOOR_LOSS = math.log(16)


def config() -> ArchConfig:
    """yi-6b's family scaled to ~100M parameters, float32."""
    return dataclasses.replace(
        get_arch("yi-6b"), name="yi-100m",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=16000, dtype="float32")


def launcher_args(steps: int, ckpt_dir: str) -> list[str]:
    """The training launcher's arguments for the example's run."""
    return ["--arch", "yi-100m", "--steps", str(steps),
            "--batch", "8", "--seq", "256", "--lr", "1e-3",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "100",
            "--log-every", "10"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    args, rest = p.parse_known_args(argv)

    # registered under its name so the launcher's --arch finds it
    cfg = config()
    R.ARCHS[cfg.name] = cfg
    n = cfg.param_count()
    print(f"training {cfg.name}: {n / 1e6:.1f}M params, {args.steps} steps")
    return T.main(launcher_args(args.steps, args.ckpt_dir) + rest)


if __name__ == "__main__":
    sys.exit(main())
