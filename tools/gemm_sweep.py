#!/usr/bin/env python3
"""Time every tile and split of ``kraken_gemm`` at the LM paths' shapes, on
a machine with one NVIDIA GPU, and hold the planner's pick against the
fastest.

    python3 tools/gemm_sweep.py [--out build/gemm_sweep.json] [--only bf16|f32]

bfloat16: for each shape (yi-6b's ``GEMMS`` at M 4 and 256, gemma3's
``GEMMA_GEMMS`` but the unembed at M 4096): every BM x BN the kernel is
built for and the splits of K that leave none empty (at M 4096 only 1 and
2), each a candidate of ``kernels/kraken_gemm.py::candidates`` run through
the wrapper with that ``choice``.  float32: for each of train_lm's
products (``TRAIN_LM_GEMMS``' forward, dA and dB at M 2048): every split
of the FMA kernel's one tile that the planner considers
(``kernels/kraken_gemm.py::_fma_plans``), run through the wrapper with
its plan put in the planner's place.  Each is checked against an fp32
product and timed by CUDA-graph replay over rotating weight copies
(``chip_smoke.graph_ms``), beside ``torch.matmul``.  Prints per shape the
planner's pick, its time and how much slower it is than the fastest plan;
the planner's cost constants are meant to keep that small.  Writes every
timing to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path,
                   default=ROOT / "build" / "gemm_sweep.json")
    p.add_argument("--only", choices=("bf16", "f32"), default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gemm_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.elastic import ceil_div
    from repro_torch.core.gemm_cases import GEMMA_GEMMS, GEMMA_SEQ, GEMMS
    from repro_torch.kernels import kraken_gemm as kg
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    shapes = list(dict.fromkeys(  # gate and up share a shape
        [(m, k, n) for m in (4, 256) for _, k, n, _, _ in GEMMS]
        + [(GEMMA_SEQ, k, n) for name, k, n, _, _ in GEMMA_GEMMS
           if name != "unembed"]))
    results, worst = [], 0.0
    if args.only == "f32":
        shapes = []
    for m, k, n in shapes:
        g = torch.Generator(device="cuda").manual_seed(0)
        a = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        bs = cs.rotating(lambda: (torch.randn((k, n), generator=g,
                                              device="cuda")
                                  / math.sqrt(k)).to(torch.bfloat16), k * n * 2)
        want = a.float() @ bs[0].float()
        it = [0]

        def cycle(fn):
            def run():
                it[0] = (it[0] + 1) % len(bs)
                return fn(bs[it[0]])
            return run
        matmul_ms = cs.graph_ms(cycle(lambda b: torch.matmul(a, b)), len(bs))
        nk = ceil_div(k, kg.KB)
        pick = kg.plan(m, k, n)
        splits = sorted({s for s in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
                         if s <= nk and (m <= 256 or s <= 2)}
                        | {pick["split"]})
        rows = []
        for bm in kg.TILE_M:
            for bn in kg.TILE_N:
                for split in splits:
                    choice = (bm, bn, split)
                    try:     # a candidate: no split left empty, and K
                        # split only while the tiles leave SMs idle
                        q = kg.plan(m, k, n, choice=choice)
                    except ValueError:
                        continue
                    err = (kg.kraken_gemm(a, bs[0], choice=choice).float()
                           - want).abs().max().item()
                    if not err < 0.1:
                        raise AssertionError(f"{kg.describe(q)}: err {err}")
                    ms = cs.graph_ms(cycle(lambda b, c=choice: kg.kraken_gemm(
                        a, b, choice=c)), len(bs))
                    rows.append({"ms": ms, "BM": bm, "BN": bn,
                                 "split": split, "tiles": q["tiles"]})
        rows.sort(key=lambda r: r["ms"])
        mine = next(r for r in rows if (r["BM"], r["BN"], r["split"])
                    == (pick["BM"], pick["BN"], pick["split"]))
        slower = mine["ms"] / rows[0]["ms"] - 1
        worst = max(worst, slower)
        print(f"M={m} K={k} N={n}: torch.matmul {matmul_ms:.4f} ms; planner "
              f"{kg.describe(pick)}: {mine['ms']:.4f} ms, {100 * slower:.1f}% "
              f"over the fastest ({rows[0]['BM']}x{rows[0]['BN']} split "
              f"{rows[0]['split']}: {rows[0]['ms']:.4f})", flush=True)
        results.append({"shape": [m, k, n], "matmul_ms": matmul_ms,
                        "pick": mine, "rows": rows})
        del bs
        torch.cuda.empty_cache()
    f32, worst32 = ([], 0.0) if args.only == "bf16" else sweep_f32(cs, kg)
    print(f"gemm_sweep: the planner's pick is at most {100 * worst:.1f}% "
          f"(bf16) and {100 * worst32:.1f}% (float32) over the fastest plan")
    results += f32
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": cs.card_line(),
                                    "shapes": results}, indent=1))
    return 0


def sweep_f32(cs, kg):
    """float32 at train_lm's products: every split the planner considers,
    each run through the wrapper with that plan in the planner's place.
    Returns (result rows, the planner's largest share over the fastest)."""
    import ctypes
    import torch
    from repro_torch.core.gemm_cases import TRAIN_LM_GEMMS, TRAIN_LM_M
    shapes = list(dict.fromkeys(
        s for _, k, n, *_ in TRAIN_LM_GEMMS
        for s in ((TRAIN_LM_M, k, n), (TRAIN_LM_M, n, k), (k, TRAIN_LM_M, n))))
    real = kg._launch_plan
    results, worst = [], 0.0
    try:
        for m, k, n in shapes:
            g = torch.Generator(device="cuda").manual_seed(0)
            a = torch.randn((m, k), generator=g, device="cuda")
            bs = cs.rotating(lambda: torch.randn((k, n), generator=g,
                                                 device="cuda") / math.sqrt(k),
                             k * n * 4)
            want = a @ bs[0]
            it = [0]

            def cycle(fn):
                def run():
                    it[0] = (it[0] + 1) % len(bs)
                    return fn(bs[it[0]])
                return run
            matmul_ms = cs.graph_ms(cycle(lambda b: torch.matmul(a, b)),
                                    len(bs))
            pick = kg.plan(m, k, n, dtype=torch.float32)
            rows = []
            for _, q in kg._fma_plans(m, k, n, sms=kg.SMS, b_align=16):
                q = dict(pick, **q)
                fields = (ctypes.c_int * len(kg.PLAN_FIELDS))(
                    *(q[f] for f in kg.PLAN_FIELDS))
                kg._launch_plan = lambda *args, q=q, f=fields: (q, f)
                err = (kg.kraken_gemm(a, bs[0]) - want).abs().max().item()
                if not err < 1e-3:
                    raise AssertionError(f"{kg.describe(q)}: err {err}")
                ms = cs.graph_ms(cycle(lambda b: kg.kraken_gemm(a, b)),
                                 len(bs))
                rows.append({"ms": ms, "split": q["split"],
                             "tiles": q["tiles"]})
                kg._launch_plan = real
            rows.sort(key=lambda r: r["ms"])
            mine = next(r for r in rows if r["split"] == pick["split"])
            slower = mine["ms"] / rows[0]["ms"] - 1
            worst = max(worst, slower)
            print(f"float32 M={m} K={k} N={n}: torch.matmul {matmul_ms:.4f} "
                  f"ms; planner {kg.describe(pick)}: {mine['ms']:.4f} ms "
                  f"({mine['ms'] / matmul_ms:.2f}x matmul), "
                  f"{100 * slower:.1f}% over the fastest (split "
                  f"{rows[0]['split']}: {rows[0]['ms']:.4f})", flush=True)
            results.append({"dtype": "float32", "shape": [m, k, n],
                            "matmul_ms": matmul_ms, "pick": mine,
                            "rows": rows})
            del bs
            torch.cuda.empty_cache()
    finally:
        kg._launch_plan = real
    return results, worst


if __name__ == "__main__":
    sys.exit(main())
