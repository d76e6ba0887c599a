"""Training launcher: supervised, checkpointed, restartable (a port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --device cpu --steps 20 --ckpt-dir build/ckpt

* the supervisor restarts from the last atomic checkpoint on any step
  failure (``--inject-failure-at N`` exercises this),
* asynchronous checkpointing off the training thread, in the reference's
  on-disk format,
* heartbeat + straggler watchdog,
* the data pipeline replays deterministically to the restored step.

The model runs on ``--device`` (default ``cuda``; asking for CUDA without a
device fails): every dense product of the forward and both products of its
backward go through ``kraken_gemm`` on the card, the plain versions on the
CPU.  Weights are drawn from a generator seeded 0 on the device.
``--autotune --tile-cache F`` measures the forward GEMM cells of a
microbatch on the card before training (refused on the CPU, where no
kernel runs); ``--tile-cache F`` alone replays them.

``--data-model d m`` trains on a ``(d, m)`` mesh with
``RULES_SINGLE_POD``, one rank a device, under ``torchrun``:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --device cpu --data-model 2 2 --steps 4

(gloo on the CPU, NCCL on the card, device ``cuda:LOCAL_RANK``).  The
parameters, moments and batch are DTensors; rank 0 prints, writes the
checkpoints (gathered whole, in the same format) and restores them onto
the mesh.  A world size other than ``d * m`` is refused.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from repro_torch import device as _device
from repro_torch.configs import get_arch, smoke_config


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="yi-6b")
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-sized)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--remat", default="none")
    p.add_argument("--inject-failure-at", type=int, default=-1)
    p.add_argument("--data-model", type=int, nargs=2, default=(1, 1),
                   help="mesh (data, model) over local devices")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--autotune", action="store_true",
                   help="benchmark tile candidates for this run's GEMM "
                        "cells and persist the winners before training")
    p.add_argument("--tile-cache", default=None, metavar="PATH",
                   help="tile-plan cache file (also: $KRAKEN_TILE_CACHE); "
                        "without --autotune, replays it read-only")
    args = p.parse_args(argv)

    dm, tm = args.data_model
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dm * tm != world:
        p.error(f"--data-model {dm} {tm}: a ({dm}, {tm}) mesh needs "
                f"{dm * tm} ranks (run under torchrun --nproc-per-node "
                f"{dm * tm}); this run has {world}")
    dev = _device.resolve(args.device)
    rank = int(os.environ.get("RANK", "0"))
    if dm * tm > 1 and dev.type == "cuda":
        dev = _device.resolve(f"cuda:{os.environ.get('LOCAL_RANK', '0')}")
    if args.autotune and dev.type != "cuda":
        p.error(f"--autotune measures the hand-written kernels on the card; "
                f"on --device {args.device} no kernel runs to measure (the "
                "CPU runs their plain versions)")

    if dev.type == "cuda":
        # a full-width step fills the card (yi-6b: 72.7 GB of parameters,
        # gradients and moments on 80 GB); expandable segments keep the
        # per-layer gradients from stranding reserved blocks
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    import torch

    from repro_torch import sharding as Sh
    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.pipeline import PipelineState, SyntheticLM
    from repro_torch.launch import steps as S
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule
    from repro_torch.runtime.fault_tolerance import (Heartbeat,
                                                     StragglerDetector,
                                                     Supervisor)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.tile_cache or args.autotune:
        from repro_torch import tuning
        from repro_torch.core.unified import (arch_cells, dedup_cells,
                                              tunable_cells)
        tuning.set_tile_cache(args.tile_cache)
        if args.autotune:
            mb = max(args.batch // max(args.microbatches, 1), 1)
            cells = dedup_cells(tunable_cells(
                arch_cells(cfg, batch=mb, seq_q=args.seq, name="train")))
            tuning.warm_cells(cells, dtype_name=cfg.dtype, log=print,
                              verbose=False, label="train cells")
        tuning.set_tile_mode("cached")
    model = Model(cfg)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=20, total=args.steps))
    pipe = SyntheticLM(cfg.vocab_size, args.seq, args.batch)

    mesh = rules = None
    if dm * tm > 1:
        import torch.distributed as dist
        from repro_torch.checkpoint.elastic import reshard_tree
        from repro_torch.launch.mesh import make_host_mesh
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        mesh = make_host_mesh(dm, tm)
        rules = Sh.RULES_SINGLE_POD
    axes = model.param_axes()

    def place(params, ostate=None):
        """The parameters (and moments) as DTensors on the mesh: every
        rank holds them whole and keeps its shards."""
        if mesh is None:
            return params, ostate
        params = reshard_tree(params, axes, mesh, rules)
        if ostate is not None:
            ostate = AdamWState(step=ostate.step,
                                m=reshard_tree(ostate.m, axes, mesh, rules),
                                v=reshard_tree(ostate.v, axes, mesh, rules))
        return params, ostate

    def whole(tree):
        """Every DTensor leaf gathered (a collective: every rank calls)."""
        return T.map_leaves(lambda t: t.full_tensor() if Sh.is_dtensor(t)
                            else t, tree)

    train_step = S.make_train_step(model, opt,
                                   num_microbatches=args.microbatches,
                                   remat=args.remat)

    hb = Heartbeat(os.path.join(
        args.ckpt_dir, "heartbeat.json" if rank == 0
        else f"heartbeat_{rank}.json"), interval_s=5)
    straggler = StragglerDetector()
    writer = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3)
    injected = {"done": False}

    def make_state():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        params, _ = place(params)
        return {"params": params, "opt": opt.init(params),
                "pipe": PipelineState(0)}

    def run_one(state, step):
        if step == args.inject_failure_at and not injected["done"]:
            injected["done"] = True
            raise RuntimeError("injected failure (test)")
        batch_np, pstate = pipe(state["pipe"])
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batch_np.items()}
        if mesh is not None:
            batch = {k: Sh.distribute(v, mesh, Sh.placements(
                mesh, Sh.partition_spec_of(mesh, rules, v.shape,
                                           ("batch", "seq"))))
                     for k, v in batch.items()}
        with Sh.use_mesh_and_rules(mesh, rules):
            params, ostate, metrics = train_step(state["params"],
                                                 state["opt"], batch)
        if step % args.log_every == 0 and rank == 0:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        return {"params": params, "opt": ostate, "pipe": pstate}

    def save_state(step, state):
        tree = whole({"params": state["params"], "opt": state["opt"]})
        if rank == 0:
            writer.save(step, tree, extra={"pipe_step": state["pipe"].step})

    def restore_state():
        # Drain any in-flight async save first: a failure right after a
        # checkpoint step must not race the background write and restore
        # from one checkpoint earlier (or from scratch).
        try:
            writer.wait()
        except Exception as e:  # noqa: BLE001 - fall back to last durable
            print(f"[restore] pending checkpoint write failed "
                  f"({type(e).__name__}: {e}); using last durable checkpoint")
        last = ckpt.latest_step(args.ckpt_dir)
        if last is None:
            return None
        # dtype-carrying leaves that allocate nothing
        meta = lambda dtype: lambda s: torch.empty(s.shape, dtype=dtype,
                                                   device="meta")
        pspecs = model.param_specs(meta(getattr(torch, cfg.dtype)))
        fspecs = model.param_specs(meta(torch.float32))
        specs = {"params": pspecs, "opt": AdamWState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            m=fspecs, v=fspecs)}
        tree, step, extra = ckpt.restore(args.ckpt_dir, specs)
        tree = T.map_leaves(lambda t: t.to(dev), tree)
        params, ostate = place(tree["params"], tree["opt"])
        if rank == 0:
            print(f"[restore] resumed from step {step}")
        return ({"params": params, "opt": ostate,
                 "pipe": PipelineState(extra["pipe_step"])}, step)

    sup = Supervisor(make_state=make_state, step_fn=run_one,
                     save_state=save_state, restore_state=restore_state,
                     checkpoint_every=args.ckpt_every, heartbeat=hb,
                     straggler=straggler)
    t0 = time.time()
    report = sup.run(args.steps)
    writer.wait()
    dt = time.time() - t0
    if rank == 0:
        print(f"done: {report.steps_done} steps in {dt:.1f}s "
              f"({report.restarts} restarts, {report.straggler_steps} "
              "straggler steps)")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
