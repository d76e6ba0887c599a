#!/usr/bin/env python3
"""Plant one fault at a time in a copy of ``csrc/kraken_gemm.cu`` and show
that the checks catch it, on a machine with one NVIDIA GPU.

    python3 tools/plant_gemm_faults.py [--out build/faults] [--only NAME]

For each fault of :data:`FAULTS`: copy ``src/``, ``chip_smoke.py``,
``pytest.ini`` and the card tests into ``<out>/<fault>/``, replace one piece
of the bf16 or the float32 kernel's source there, then run ``chip_smoke.py --phases
build,kernels`` and ``pytest -m cuda tests/test_torch_cuda.py -k gemm`` in
that copy.  Records per fault whether each failed, how many ``kernels``
cases missed ``GEMM_TOL`` and the largest atol a missing case needs (from
the phase's record; a fault that traps the launch leaves none), and how
many card tests failed.  Writes ``<out>/faults.json``; exits 1 if a fault
passed either check.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "src/repro_torch/csrc/kraken_gemm.cu"

# name -> (the source as it is, the source with the fault)
FAULTS = {
    "mbarrier phase bit flipped (consumer waits on the other parity)": (
        "    mbar_wait(&full[s], ph);\n",
        "    mbar_wait(&full[s], ph ^ 1);\n"),
    "last ring stage not drained (the consumers stop one k-step early)": (
        "  for (int i = 0; i < tl.ksteps; ++i) {\n    mbar_wait(&full[s], ph);",
        "  for (int i = 0; i < tl.ksteps - 1; ++i) {\n    mbar_wait(&full[s], ph);"),
    "MN-major swizzle off by one chunk (B read from the next 16 bytes)": (
        "desc_mn128(st + A_BYTES, KB * ROW)",
        "desc_mn128(st + A_BYTES + 16, KB * ROW)"),
    "one split partial dropped from the sum": (
        "for (int z = 1; z < split; ++z) s += part[z * count + i];",
        "for (int z = 1; z < split - 1; ++z) s += part[z * count + i];"),
    "float32 ring: a skipped stage (the prologue copies one step fewer)": (
        "  for (int s = 0; s < STAGES - 1; ++s) {\n    if (s < n) load_stage(",
        "  for (int s = 0; s < STAGES - 2; ++s) {\n    if (s < n) load_stage("),
    "float32 split out of order: split z sums split z + 1's run of K": (
        "  const int n = tl.ksteps, kb = tl.k0;",
        "  const int n = tl.ksteps, kb = (tl.z + 1) % p.split * p.kps;"),
    "silu (the activation) applied per partial": (
        "      float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];\n",
        "      float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];\n"
        "      if (p.split > 1) { v0 = activate(v0, act); v1 = activate(v1, act); }\n"),
}


def slug(name: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")[:40]


def plant(dest: Path, old: str, new: str, kernel: str = KERNEL) -> None:
    """Copy what the checks need into ``dest`` and replace ``old`` by
    ``new``, found exactly once, in its copy of ``kernel``."""
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(ROOT / "src", dest / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "tests").mkdir(parents=True)
    for rel in ("chip_smoke.py", "pytest.ini", "tests/conftest.py",
                "tests/test_torch_cuda.py"):
        shutil.copy(ROOT / rel, dest / rel)
    src = (dest / kernel).read_text()
    if src.count(old) != 1:
        raise SystemExit(f"fault site not found once in {kernel}: {old!r}")
    (dest / kernel).write_text(src.replace(old, new))


def run_fault(name: str, dest: Path) -> dict:
    smoke = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", "build,kernels",
         "--out", "record"], cwd=dest, capture_output=True, text=True,
        timeout=600)
    rec_path = dest / "record" / "chip_smoke.json"
    rows = json.loads(rec_path.read_text()).get("gemm", []) \
        if rec_path.is_file() else []
    bad = [r for r in rows if not r["ok"]]
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
         "no:cacheprovider", "tests/test_torch_cuda.py", "-k", "gemm"],
        cwd=dest, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": "src"})
    summary = (tests.stdout.strip().splitlines() or [""])[-1]
    failed = re.search(r"(\d+) failed", summary)
    passed = re.search(r"(\d+) passed", summary)
    tail = [ln for ln in (smoke.stdout + smoke.stderr).splitlines()
            if "Error" in ln or "error" in ln][-2:]
    return {
        "fault": name, "kernels_rc": smoke.returncode,
        "kernels_failed": smoke.returncode != 0,
        "cases_run": len(rows), "cases_missed": len(bad),
        "largest_atol_needed": (max(r["atol_needed"] for r in bad)
                                if bad else None),
        "worst_case": (None if not bad else
                       "{m}x{k}x{n} {dtype} {act} split {s}".format(
                           s=max(bad, key=lambda r: r["atol_needed"])
                           ["plan"].get("split"),
                           **max(bad, key=lambda r: r["atol_needed"]))),
        "error_lines": tail,
        "tests_failed": int(failed.group(1)) if failed else 0,
        "tests_passed": int(passed.group(1)) if passed else 0,
        "tests_summary": summary}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=ROOT / "build" / "faults")
    p.add_argument("--only", default=None,
                   help="run the faults whose name contains this")
    args = p.parse_args(argv)
    results = []
    for name, (old, new) in FAULTS.items():
        if args.only and args.only not in name:
            continue
        dest = args.out / slug(name)
        plant(dest, old, new)
        r = run_fault(name, dest)
        results.append(r)
        need = r["largest_atol_needed"]
        print(f"{name}: kernels {'FAILED' if r['kernels_failed'] else 'passed'}"
              f" ({r['cases_missed']} of {r['cases_run']} cases missed, "
              f"largest atol needed "
              f"{'-' if need is None else ('inf' if math.isinf(need) else f'{need:.3g}')}"
              f", worst {r['worst_case']}); card tests {r['tests_summary']}"
              f"{'; ' + ' | '.join(r['error_lines']) if r['error_lines'] and not r['cases_missed'] else ''}",
              flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "faults.json").write_text(json.dumps(results, indent=1))
    caught = [bool(r["kernels_failed"] and r["tests_failed"]) for r in results]
    print(f"faults: {sum(caught)} of {len(results)} caught by both checks")
    return 0 if all(caught) else 1


if __name__ == "__main__":
    sys.exit(main())
