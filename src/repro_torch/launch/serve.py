"""Serving launcher of the port: a thin frontend over the PagedEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
        --device cpu --requests 4 --max-new 4 --repeat 2

Weights are random, drawn on the device from ``--seed`` with ``repro``'s
init scaling; the same seed seeds the prompts and, with ``--temperature``
above 0, the engine's sampler.  The engine runs on ``--device`` (default
``cuda``; asking for CUDA without a device fails).  ``--repeat 2`` serves
the workload twice through one engine and prints each pass's new program
signatures: a warm pass prints ``prefill retraces=0 decode retraces=0``.

The serving features are the JAX launcher's: ``--shared-prefix N``
prepends one N-token prefix to every prompt (what ``--prefix-cache`` hits
on), ``--priority 0,1`` cycles priority classes over requests and
``--preempt`` lets an urgent arrival swap a lower-class victim out to host,
``--stagger N`` runs N engine steps between submissions, ``--speculate K``
drafts up to K tokens a decoding slot, and ``--faults SPEC`` injects a
seeded fault plan (with ``--watchdog`` sweeps).  ``--verify-speculate``,
``--verify-preempt`` and ``--verify-faults`` replay every submission
through a fresh engine with ``EngineConfig.verify_reference()`` and check
token identity (for faults: of every request that completed).
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


def _replay(model, params, config, subs):
    """Every submission through a fresh ``verify_reference()`` engine."""
    from repro_torch.serving import PagedEngine
    ref_eng = PagedEngine(model, params, config=config.verify_reference())
    for rid, prompt, max_new, prio in subs:
        ref_eng.submit(prompt, max_new, rid=rid, priority=prio)
    return ref_eng.run_until_idle()


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
    p.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                   help="prepend one fixed N-token prefix to every prompt "
                        "(the shared-prefix trace the prefix cache hits on)")
    p.add_argument("--priority", default=None, metavar="P1,P2,...",
                   help="priority classes (0 = most urgent), cycled over "
                        "requests (default: all class 0 == FIFO)")
    p.add_argument("--stagger", type=int, default=0, metavar="N",
                   help="run N engine steps between submissions (bursty "
                        "arrivals: later requests meet a busy engine)")
    p.add_argument("--verify-speculate", action="store_true",
                   help="replay every submission through a fresh "
                        "speculation-off engine and assert token identity "
                        "(greedy only)")
    p.add_argument("--verify-preempt", action="store_true",
                   help="replay every submission through a fresh "
                        "preempt-off engine and assert token identity "
                        "(greedy only)")
    p.add_argument("--verify-faults", action="store_true",
                   help="replay every submission through a fresh "
                        "fault-free engine and assert each request that "
                        "completed under faults is token-identical "
                        "(greedy only)")
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
    shared = rng.integers(0, cfg.vocab_size,
                          size=(args.shared_prefix,)).astype(np.int32)
    print(f"# {cfg.name} on {dev}: chunk={eng.chunk} "
          f"step budget={eng.step_budget}"
          + (f" prefix cache={'on' if eng.prefix_cache is not None else 'off'}"
             if args.prefix_cache else "")
          + (" preempt=on" if args.preempt else "")
          + (f" speculate={eng.speculate}" if args.speculate else "")
          + (f" temperature={eng.temperature:g}" if eng.temperature else "")
          + (" watchdog=on" if args.watchdog else "")
          + (f" faults[{args.faults}]" if args.faults else ""))
    done = {}
    subs = []   # every submission, for the verify replays
    for rep in range(max(1, args.repeat)):
        before = (eng._prefill.retraces, eng._decode.retraces)
        for i in range(args.requests):
            prompt = np.concatenate([shared, rng.integers(
                0, cfg.vocab_size,
                size=(lens[i % len(lens)],)).astype(np.int32)])
            prio = prios[i % len(prios)]
            r = eng.submit(prompt, args.max_new, priority=prio)
            subs.append((r.rid, prompt, args.max_new, prio))
            for _ in range(args.stagger):
                eng.step()
        done = eng.run_until_idle()
        dp = eng._prefill.retraces - before[0]
        dd = eng._decode.retraces - before[1]
        print(f"pass {rep + 1}: prefill retraces={dp} decode retraces={dd}")
        print(eng.report())
    for rid in sorted(done):
        print(f"req {rid}: {done[rid][:8]}...")
    expected = args.requests * max(1, args.repeat)
    print(f"served {len(done)}/{expected} requests")
    for flag, what in ((args.verify_speculate, "speculate"),
                       (args.verify_preempt, "preempt")):
        if not flag:
            continue
        # speculation and preemption change latency, never output
        ref = _replay(model, params, config, subs)
        bad = [rid for rid, *_ in subs if done.get(rid) != ref.get(rid)]
        if bad:
            print(f"{what} token-identity: FAIL (requests {bad})")
            return 1
        print(f"{what} token-identity: ok ({len(subs)} requests)")
    if args.faults:
        fs = eng.faults.stats()
        ws = eng.watchdog.stats()
        print(f"faults: injected={fs['injected']} "
              f"corrupted={fs['corrupted_snapshots']} "
              f"recovered={eng.recovered} "
              f"failed={len(eng.sched.failed)} sweeps={ws['sweeps']}")
    if args.verify_faults:
        # faults may fail requests, never corrupt them
        ref = _replay(model, params, config, subs)
        bad = [rid for rid in done if done[rid] != ref.get(rid)]
        if bad:
            print(f"fault token-identity: FAIL (requests {bad})")
            return 1
        print(f"fault token-identity: ok ({len(done)}/{len(subs)} "
              f"completed, {len(subs) - len(done)} faulted)")
    if not args.faults and len(done) != expected:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
