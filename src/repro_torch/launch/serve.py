"""Serving launcher of the port: a thin frontend over the PagedEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
        --device cpu --requests 4 --max-new 4 --repeat 2

Weights are random, drawn on the device from ``--seed`` with ``repro``'s
init scaling.  The engine runs on ``--device`` (default ``cuda``; asking for
CUDA without a device fails).  ``--repeat 2`` serves the workload twice
through one engine and prints each pass's new program signatures: a warm
pass prints ``prefill retraces=0 decode retraces=0``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch import device as _device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch.engine_args import add_engine_args, engine_config_from_args


def _parse_lens(spec: str | None, default: int) -> list[int]:
    if not spec:
        return [default]
    return [int(x) for x in spec.split(",") if x.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="yi-6b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--prompt-lens", default=None, metavar="L1,L2,...",
                   help="mixed prompt lengths, cycled over requests")
    p.add_argument("--max-new", type=int, default=16)
    add_engine_args(p)
    p.add_argument("--repeat", type=int, default=1,
                   help="serve the workload N times through one engine; a "
                        "warm pass must print zero retraces")
    p.add_argument("--priority", default=None, metavar="P1,P2,...",
                   help="priority classes (0 = most urgent), cycled over "
                        "requests (default: all class 0 == FIFO)")
    args = p.parse_args(argv)

    import torch

    from repro_torch.models.model import Model
    from repro_torch.serving import PagedEngine

    dev = _device.resolve(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    model = Model(cfg)
    config = engine_config_from_args(args)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen)
    eng = PagedEngine(model, params, config=config)
    lens = _parse_lens(args.prompt_lens, args.prompt_len)
    prios = _parse_lens(args.priority, 0)
    rng = np.random.default_rng(args.seed)
    print(f"# {cfg.name} on {dev}: chunk={eng.chunk} "
          f"step budget={eng.step_budget}")
    done = {}
    for rep in range(max(1, args.repeat)):
        before = (eng._prefill.retraces, eng._decode.retraces)
        for i in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size,
                                  size=(lens[i % len(lens)],)).astype(np.int32)
            eng.submit(prompt, args.max_new, priority=prios[i % len(prios)])
        done = eng.run_until_idle()
        dp = eng._prefill.retraces - before[0]
        dd = eng._decode.retraces - before[1]
        print(f"pass {rep + 1}: prefill retraces={dp} decode retraces={dd}")
        print(eng.report())
    for rid in sorted(done):
        print(f"req {rid}: {done[rid][:8]}...")
    expected = args.requests * max(1, args.repeat)
    print(f"served {len(done)}/{expected} requests")
    return 0 if len(done) == expected else 1


if __name__ == "__main__":
    sys.exit(main())
