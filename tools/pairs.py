#!/usr/bin/env python3
"""Run ``chip_smoke.py`` from two checkouts in turns on one NVIDIA GPU --
parent, change, change, parent -- and print the same numbers from each
run's record.

    python3 tools/pairs.py --parent DIR --phases PHASES --keys KEYS
                           [--out build/pairs]

``DIR`` is the parent (e.g. a ``git archive`` of the parent commit unpacked
under ``build/``).  Each run is ``chip_smoke.py --phases PHASES`` and writes
its record to ``<out>/<n>_<label>/``; the kernels line it prints is kept in
the record as ``kernels_line``.  ``KEYS`` is a comma-separated list of
dotted paths into the record: a segment that is a number indexes a list, a
segment ``name=X`` takes a list's first element whose ``name`` is ``X``
(so ``moe_steps.decode.device_ms``, ``moe_serve.passes.1.tok_s``,
``kernels_line.kernels.name=grouped_moe_gemm.ms`` or
``moe_gemm.name=mixtral down mixed.ms``).  A path the record lacks reads as
null.  Prints one JSON line per run and writes them all to
``<out>/pairs.json``; exits 1 if a run failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def lookup(rec, path: str):
    """The value at the dotted ``path`` in ``rec``, or None."""
    node = rec
    for seg in path.split("."):
        if isinstance(node, list):
            if seg.isdigit():
                node = node[int(seg)] if int(seg) < len(node) else None
            elif seg.startswith("name="):
                node = next((x for x in node if isinstance(x, dict)
                             and x.get("name") == seg[5:]), None)
            else:
                node = None
        elif isinstance(node, dict):
            node = node.get(seg)
        else:
            node = None
        if node is None:
            return None
    return node


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, required=True)
    p.add_argument("--phases", required=True)
    p.add_argument("--keys", required=True)
    p.add_argument("--out", type=Path, default=ROOT / "build" / "pairs")
    args = p.parse_args(argv)
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    parent = args.parent.resolve()
    runs = [("parent", parent), ("change", ROOT), ("change", ROOT),
            ("parent", parent)]
    results, ok = [], True
    for n, (label, where) in enumerate(runs):
        rec_dir = out / f"{n}_{label}"
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py", "--phases", args.phases,
             "--out", str(rec_dir)], cwd=where, capture_output=True,
            text=True, timeout=1500)
        (out / f"{n}_{label}.log").write_text(proc.stdout + proc.stderr)
        rec_path = rec_dir / "chip_smoke.json"
        rec = json.loads(rec_path.read_text()) if rec_path.is_file() else {}
        rec["kernels_line"] = next(
            (json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith('{"kernels"')), None)
        r = {"run": n, "label": label, "rc": proc.returncode,
             "card": rec.get("card")}
        r.update({k: lookup(rec, k) for k in args.keys.split(",")})
        ok = ok and proc.returncode == 0
        results.append(r)
        print(json.dumps(r), flush=True)
    (out / "pairs.json").write_text(json.dumps(results, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
