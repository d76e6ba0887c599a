#!/usr/bin/env python3
"""Where the time of one ``paged_decode_attention`` call goes, on a machine
with one NVIDIA GPU.

    python3 tools/paged_sweep.py [--out build/paged_sweep]

yi-6b's heads (32 over 4 KV heads of 128) over bf16 pools of 16-entry
pages, 32 pages a slot, every slot at the same length: the device-only time
a call (``chip_smoke.graph_ms``: 20 calls captured in one CUDA graph) as the
pages each block walks grow, at 4 slots (8 splits: 1 to 4 pages a split)
and at 64 slots (no split: 1 to 32 pages a block), and at 4 slots with the
split forced off (one block per slot and head walks every page, no
combine).  The slope is one step's cost (a step scores two pages), the
intercept the launch, the block's prologue and, when split, the combine.
Prints one JSON line per point and writes them to ``<out>/sweep.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=ROOT / "build" / "paged_sweep")
    args = p.parse_args(argv)
    import torch

    import chip_smoke as cs
    from repro_torch.core.attention_cases import paged_pool
    from repro_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        raise SystemExit("paged_sweep needs an NVIDIA GPU")
    print(cs.card_line(), flush=True)
    h, kvh, d, ps, mp = 32, 4, 128, 16, 32
    rows = []

    def point(b, pages, *, choice=None):
        case = ("sweep", b, h, kvh, d, ps, mp, ("bfloat16",), 0,
                [pages * ps - 1] * b, (), (), False, 0.0)
        x = paged_pool(case, "bfloat16", 0)
        n = x["n_pages"]
        dev = torch.device("cuda", 0)
        put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        q = put(x["q"]).to(torch.bfloat16)
        k = put(x["k"]).to(torch.bfloat16)[:n]
        v = put(x["v"]).to(torch.bfloat16)[:n]
        kw = dict(pos_pages=put(x["pos"])[:n], page_table=put(x["table"]),
                  q_pos=put(x["q_pos"]), choice=choice)
        fn = lambda: pa.paged_decode_attention(q, k, v, **kw)  # noqa: E731
        ms = cs.graph_ms(fn, 20)
        plan = pa.plan(b, h, kvh, d, ps, mp, torch.bfloat16, choice=choice)
        per_block = -(-pages // plan["splits"])
        r = {"B": b, "pages_a_slot": pages, "splits": plan["splits"],
             "pages_a_block": per_block, "device_ms": ms,
             "plan": pa.describe(plan)}
        rows.append(r)
        print(json.dumps(r), flush=True)

    for pages in (8, 16, 24, 32):
        point(4, pages)
    for pages in (2, 4, 8, 16, 32):
        point(4, pages, choice=(1,))
    for pages in (1, 2, 4, 8, 16, 32):
        point(64, pages)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "sweep.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
