#!/usr/bin/env python3
"""Time every ring depth of the bf16 ``grouped_moe_gemm`` at the shapes of
``repro_torch/core/moe_cases.py``, on a machine with one NVIDIA GPU, and
hold the planner's pick against the fastest.

    python3 tools/moe_sweep.py [--out build/moe_sweep.json]

For each live case of ``MOE_CASES`` (mixtral's and llama4's decode and mixed
steps with their sizes): ring depths from 3 stages to as many as fit on
the case's tile (``kraken_moe_gemm.TILES``), each forced into the plan
``kernels/kraken_moe_gemm.py::wgmma_plan`` builds for it, checked against
the plain version and timed by CUDA-graph replay (``chip_smoke.graph_ms``),
beside ``torch.bmm``.  Prints per shape the planner's pick, its time and how
much slower it is than the fastest plan.  Writes every timing to ``--out``.
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
                   default=ROOT / "build" / "moe_sweep.json")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("moe_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.moe_cases import MOE_CASES, moe_sizes
    from repro_torch.kernels import kraken_moe_gemm as mg
    from repro_torch.kernels import ref
    print(cs.card_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results, worst = [], 0.0
    for name, e, c, d, f, spec, _ in MOE_CASES:
        sizes = moe_sizes(spec, e)
        if not any(sizes):
            continue
        g = torch.Generator(device="cuda").manual_seed(0)
        w = torch.empty((e, d, f), dtype=torch.bfloat16, device="cuda")
        for i in range(e):
            w[i] = torch.randn((d, f), generator=g, device="cuda") \
                / math.sqrt(d)
        xs = torch.randn((e, c, d), generator=g,
                         device="cuda").to(torch.bfloat16)
        sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        live = (torch.arange(c, device="cuda")[None, :]
                < sz.clamp(0, c)[:, None])[..., None]
        want = ref.grouped_moe_gemm(xs, w, sz).float()
        xm = torch.where(live, xs, torch.zeros_like(xs))
        bmm_ms = cs.graph_ms(lambda: torch.bmm(xm, w), 10)
        pick = mg.plan(e, c, d, f, sms=sms)
        rows = []
        for stages in range(3, pick["stages"] + 1):
            q = {**pick, **mg.wgmma_plan(e, c, d, f, sms=sms, stages=stages)}
            err = (mg.run_plan(xs, w, sz, q).float()
                   - want).abs().max().item()
            if not err < 0.1:
                raise AssertionError(f"{mg.describe(q)}: err {err}")
            ms = cs.graph_ms(lambda q=q: mg.run_plan(xs, w, sz, q), 10)
            rows.append({"ms": ms, "stages": stages})
        rows.sort(key=lambda r: r["ms"])
        mine = next(r for r in rows if r["stages"] == pick["stages"])
        slower = mine["ms"] / rows[0]["ms"] - 1
        worst = max(worst, slower)
        print(f"{name} E={e} C={c} d={d} f={f}: torch.bmm {bmm_ms:.4f} ms; "
              f"planner {mg.describe(pick, sizes)}: {mine['ms']:.4f} ms, "
              f"{100 * slower:.1f}% over the fastest ({rows[0]['stages']} "
              f"stages: {rows[0]['ms']:.4f}); all: "
              + " ".join(f"{r['stages']}={r['ms']:.4f}" for r in rows),
              flush=True)
        results.append({"name": name, "shape": [e, c, d, f], "sizes": sizes,
                        "bmm_ms": bmm_ms, "pick": mine, "rows": rows})
        del w, xs, xm, want
        torch.cuda.empty_cache()
    print(f"moe_sweep: the planner's pick is at most {100 * worst:.1f}% "
          "over the fastest plan")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": cs.card_line(),
                                    "shapes": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
