"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors.

A port of ``repro.launch.dryrun``.  For each cell this driver starts a fake
process group of the mesh's size (256 ranks for 16x16, 512 for 2x16x16),
builds the production mesh over it, makes the cell's sharded inputs as
DTensors whose local shards are fake tensors (nothing is allocated), and
runs the cell's step -- ``make_train_step`` for train cells,
``make_prefill_step`` / ``make_decode_step`` for serving cells -- under
``FakeTensorMode`` inside :class:`~repro_torch.roofline.op_walk.OpWalk`.
The walk sees rank 0's local ops, the collectives DTensor issues and
those the model's own ``dist.all_reduce`` calls make, as JAX's per-device
compiled program; the record holds per-device memory, the
collectives and the roofline, with JAX's keys.

The step runs the kernels' plain versions, as JAX's dry run traces its
reference path (``repro.kernels.ops``: the Pallas kernels lower only on a
TPU): that is the counterpart, not a fallback.  Every dense GEMM reaches
the dispatcher as ``repro_torch::dense_gemm``, the op the kernel carries
on the card, and is counted as one.

The fake group is this process's default group, so the dry run runs in a
process of its own (as JAX's, for its ``XLA_FLAGS``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl

Beside JAX's flags: ``--mesh DxM`` traces on a ``(data, model)`` host mesh
instead of the production one, ``--smoke`` takes the arch's smoke config,
``--layers N`` cuts the depth (the widths stay) and ``--seq`` /
``--batch`` resize the cell; the record names every such cut under
``cuts`` (its one key beside JAX's).
``lower_s`` is the time to build the sharded inputs and ``compile_s`` the
time of the traced step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

from repro_torch.configs import (ARCHS, SHAPES, LONG_CONTEXT_OK,
                                 LONG_CONTEXT_SKIP_REASON, get_arch,
                                 smoke_config)
from repro_torch.configs.base import ShapeCell

# Per-arch microbatch counts for train_4k (activation memory control).
TRAIN_MICROBATCHES = {
    "mixtral-8x22b": 8,
    "llama4-maverick-400b-a17b": 8,
    "yi-9b": 4, "yi-6b": 4, "codeqwen1.5-7b": 4, "gemma3-12b": 4,
    "musicgen-large": 2, "rwkv6-3b": 2, "zamba2-1.2b": 2,
    "llama-3.2-vision-11b": 4,
}


def cell_applicable(arch_name: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch_name not in LONG_CONTEXT_OK:
        return False, LONG_CONTEXT_SKIP_REASON[arch_name]
    return True, ""


def _mesh_name(multi_pod: bool, host: tuple | None) -> str:
    if host:
        return f"{host[0]}x{host[1]}"
    return "2x16x16" if multi_pod else "16x16"


def _fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks (this is rank 0):
    collectives return at once, on fake tensors."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _bytes(tensors) -> int:
    from repro_torch import sharding as Sh
    return Sh.local_bytes(tensors)


def lower_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
               rules_override: dict | None = None,
               microbatches: int | None = None,
               remat: str | None = None, host_mesh: tuple | None = None,
               smoke: bool = False, layers: int | None = None,
               seq: int | None = None, batch: int | None = None) -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import sharding as Sh
    from repro_torch import tree as T
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.sharding_rules import rules_for, zero1_param_rules
    from repro_torch.models.model import Model, cache_leaves, model_flops
    from repro_torch.optim.adamw import AdamW
    from repro_torch.roofline import op_walk
    from repro_torch.roofline.analysis import collective_stats, from_counts

    cfg = get_arch(arch_name)
    if smoke:
        cfg = smoke_config(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    cell = SHAPES[shape_name]
    cell = ShapeCell(cell.name, seq or cell.seq_len,
                     batch or cell.global_batch, cell.kind)
    if host_mesh:
        _fake_group(host_mesh[0] * host_mesh[1])
        mesh = make_host_mesh(*host_mesh)
    else:
        _fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    rules = rules_override or rules_for(cfg, cell, multi_pod=multi_pod)
    model = Model(cfg)
    dt = getattr(torch, cfg.dtype)
    dev = "cpu"

    with FakeTensorMode(), Sh.use_mesh_and_rules(mesh, rules):
        t0 = time.time()
        pspecs = S.sharded_param_specs(model, mesh, rules, device=dev)
        if cell.kind == "train":
            opt = AdamW()
            ospecs = S.sharded_opt_specs(
                model, opt, mesh, rules,
                zero1_rules=zero1_param_rules(rules), device=dev)
            bspecs = S.batch_specs(cfg, cell, mesh, rules, device=dev)
            nmb = microbatches or TRAIN_MICROBATCHES.get(arch_name, 4)
            step = S.make_train_step(model, opt, num_microbatches=nmb,
                                     remat=remat or "full")
            args = (pspecs, ospecs, bspecs)
            inplace = T.leaves(pspecs) + T.leaves(ospecs)
            arg_leaves = inplace + list(bspecs.values())
            tokens = cell.global_batch * cell.seq_len
            mf = model_flops(cfg, tokens, "train")
        elif cell.kind == "prefill":
            cspecs = S.sharded_cache_specs(model, cell.global_batch,
                                           cell.seq_len, mesh, rules,
                                           device=dev)
            bspecs = S.batch_specs(cfg, cell, mesh, rules, device=dev)
            bspecs.pop("labels")
            step = S.make_prefill_step(model)
            args = (pspecs, cspecs, bspecs)
            inplace = [t for _, t in cache_leaves(cspecs)]
            arg_leaves = T.leaves(pspecs) + inplace + list(bspecs.values())
            tokens = cell.global_batch * cell.seq_len
            mf = model_flops(cfg, tokens, "inference")
        else:  # decode: flat per-layer cache buffers, updated in place
            cspecs = S.sharded_cache_specs(model, cell.global_batch,
                                           cell.seq_len, mesh, rules,
                                           device=dev)
            tok = Sh.abstract((cell.global_batch, 1), torch.int32, None,
                              mesh, rules, device=dev)
            pos = Sh.abstract((cell.global_batch,), torch.int32, None, mesh,
                              rules, device=dev)
            step = S.make_decode_step(model)
            args = (pspecs, cspecs, tok, pos)
            if cfg.frontend == "image_patches":
                args += (Sh.abstract(
                    (cell.global_batch, cfg.num_frontend_tokens,
                     cfg.d_model), dt, None, mesh, rules, device=dev),)
            elif cfg.frontend == "audio_frames":
                args += (Sh.abstract((cell.global_batch, 1, cfg.d_model), dt,
                                     None, mesh, rules, device=dev),)
            inplace = [t for _, t in cache_leaves(cspecs)]
            arg_leaves = T.leaves(pspecs) + inplace + list(args[2:])
            tokens = cell.global_batch        # one new token per sequence
            mf = model_flops(cfg, tokens, "inference")
        t_lower = time.time() - t0

        t0 = time.time()
        with op_walk.OpWalk() as w:
            out = step(*args)
        t_compile = time.time() - t0
        outs = [t for t in T.leaves(out) if isinstance(t, torch.Tensor)]
        aliased = [t for t in outs if any(t is a for a in inplace)]
        fresh = [t for t in outs if not any(t is a for a in inplace)]
        dropped = [list(map(lambda x: list(x) if isinstance(x, tuple) else x,
                            d)) for d in Sh.dropped_axes()]

    walk = w.result
    roof = from_counts(walk, chips, mf)
    colls = collective_stats(walk)
    arg_b = _bytes(arg_leaves)
    rec = {
        "arch": arch_name, "shape": shape_name,
        "mesh": _mesh_name(multi_pod, host_mesh), "chips": chips,
        "status": "ok",
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": _bytes(fresh),
            "temp_bytes": walk.peak_live_bytes,
            "alias_bytes": _bytes(aliased),
            "peak_per_device_bytes": arg_b + walk.peak_live_bytes,
        },
        "collectives": {"counts": colls.counts,
                        "operand_bytes_per_device": colls.operand_bytes},
        "roofline": roof.as_dict(),
        "dropped_shardings": dropped,
    }
    cuts = {k: v for k, v in (("smoke", smoke), ("layers", layers),
                              ("seq", seq), ("batch", batch)) if v}
    if cuts:
        rec["cuts"] = cuts
    rec["_by_op"] = walk.by_op
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", choices=["on", "off", "both"], default="off")
    p.add_argument("--out", default=None, help="append JSONL records here")
    p.add_argument("--microbatches", type=int, default=None)
    p.add_argument("--remat", default=None)
    p.add_argument("--mesh", default=None, metavar="DxM",
                   help="a (data, model) host mesh instead of the "
                        "production mesh")
    p.add_argument("--smoke", action="store_true",
                   help="the arch's smoke config")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth to this many layers")
    p.add_argument("--seq", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--ops", type=int, default=0, metavar="N",
                   help="print the N ops that move the most bytes")
    args = p.parse_args(argv)
    host = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None

    cells: list[tuple[str, str]] = []
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    for a in archs:
        for s in shapes:
            cells.append((a, s))

    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]
    if host:
        pods = [False]
    out_f = open(args.out, "a") if args.out else None
    failures = 0
    for arch_name, shape_name in cells:
        ok, reason = cell_applicable(arch_name, shape_name)
        for mp in pods:
            mname = _mesh_name(mp, host)
            tag = f"{arch_name} x {shape_name} x {mname}"
            if not ok:
                rec = {"arch": arch_name, "shape": shape_name, "mesh": mname,
                       "status": "skip", "reason": reason}
                print(f"SKIP  {tag}: {reason}")
            else:
                try:
                    rec = lower_cell(arch_name, shape_name, multi_pod=mp,
                                     microbatches=args.microbatches,
                                     remat=args.remat, host_mesh=host,
                                     smoke=args.smoke, layers=args.layers,
                                     seq=args.seq, batch=args.batch)
                    by_op = rec.pop("_by_op")
                    m = rec["memory"]
                    r = rec["roofline"]
                    print(f"OK    {tag}: trace {rec['compile_s']}s  "
                          f"args/dev {m['argument_bytes']/2**30:.2f}GiB  "
                          f"temp/dev {m['temp_bytes']/2**30:.2f}GiB  "
                          f"bottleneck {r['bottleneck']}  "
                          f"roofline_frac {r['roofline_fraction']:.3f}")
                    for name, (n, b, f) in sorted(
                            by_op.items(), key=lambda kv: -kv[1][1])[
                            :args.ops]:
                        print(f"      {name:32s} x{n:<7d} {b / 1e9:10.3f} GB"
                              f"  {f / 1e12:9.3f} TFLOP")
                except Exception as e:  # noqa: BLE001
                    failures += 1
                    rec = {"arch": arch_name, "shape": shape_name,
                           "mesh": mname, "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    print(f"FAIL  {tag}: {type(e).__name__}: {e}")
                    traceback.print_exc()
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
    if out_f:
        out_f.close()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
