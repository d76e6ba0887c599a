#!/usr/bin/env python3
"""Plant one fault at a time in a copy of ``csrc/grouped_moe_gemm.cu`` and
show that the checks catch it, on a machine with one NVIDIA GPU.

    python3 tools/plant_moe_faults.py [--out build/faults] [--only NAME]

For each fault of :data:`FAULTS`: copy ``src/``, ``chip_smoke.py``,
``pytest.ini`` and the card tests into ``<out>/<fault>/``, replace one piece
of the bf16 kernel's source there, then run ``chip_smoke.py --phases
moe_kernels`` (which builds the kernel at first use) and ``pytest -m cuda
tests/test_torch_cuda.py -k grouped_moe_gemm`` in that copy.  Records per
fault whether each failed, how many ``moe_kernels`` cases missed (their
tolerance, exact zeros in the dead rows or the same bits twice) and the
largest atol a missing case needs (from the phase's record; a fault that
traps the launch leaves none), and how many card tests failed.  Writes
``<out>/faults.json``; exits 1 if a fault passed either check.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

from plant_gemm_faults import plant, slug

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "src/repro_torch/csrc/grouped_moe_gemm.cu"

# name -> (the source as it is, the source with the fault)
FAULTS = {
    "dead rows not zeroed (the epilogue writes their products)": (
        "        if (!live) v0 = v1 = 0.f;\n",
        ""),
    "one split dropped from the sum": (
        "      for (int z = 1; z < split; ++z) {\n",
        "      for (int z = 1; z < split - 1; ++z) {\n"),
    "B's swizzle one chunk off (B read from the next 16 bytes)": (
        "desc_mn128(st + A_BYTES, KB * ROW)",
        "desc_mn128(st + A_BYTES + 16, KB * ROW)"),
    "the expert offset off by one (the next expert's weights)": (
        "w.n0 + nb * 64, k0, w.e,",
        "w.n0 + nb * 64, k0, (w.e + 1) % p.E,"),
    "last d stage not drained (the consumers stop one k-step early)": (
        "    for (int i = 0; i < w.ksteps; ++i) {\n      mbar_wait(&full[s], ph);",
        "    for (int i = 0; i < w.ksteps - 1; ++i) {\n      mbar_wait(&full[s], ph);"),
}


def run_fault(name: str, dest: Path) -> dict:
    smoke = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", "moe_kernels", "--out",
         "record"], cwd=dest, capture_output=True, text=True, timeout=900)
    rec_path = dest / "record" / "chip_smoke.json"
    rec = json.loads(rec_path.read_text()) if rec_path.is_file() else {}
    rows = rec.get("moe_gemm", [])
    bad = [r for r in rows if not r["ok"]]
    worst = max(bad, key=lambda r: r["atol_needed"]) if bad else None
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
         "no:cacheprovider", "tests/test_torch_cuda.py", "-k",
         "grouped_moe_gemm"],
        cwd=dest, capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": "src"})
    summary = (tests.stdout.strip().splitlines() or [""])[-1]
    failed = re.search(r"(\d+) failed", summary)
    passed = re.search(r"(\d+) passed", summary)
    tail = [ln for ln in (smoke.stdout + smoke.stderr).splitlines()
            if "Error" in ln or "error" in ln][-2:]
    return {
        "fault": name, "phase_rc": smoke.returncode,
        "phase_failed": smoke.returncode != 0,
        "cases_run": len(rows), "cases_missed": len(bad),
        "dead_rows_not_zero": sum(not r["dead_rows_zero"] for r in bad),
        "largest_atol_needed": worst["atol_needed"] if worst else None,
        "worst_case": (None if worst is None else
                       f"{worst['name']} {worst['dtype']}"),
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
        plant(dest, old, new, KERNEL)
        r = run_fault(name, dest)
        results.append(r)
        need = r["largest_atol_needed"]
        print(f"{name}: moe_kernels "
              f"{'FAILED' if r['phase_failed'] else 'passed'}"
              f" ({r['cases_missed']} of {r['cases_run']} cases missed, "
              f"{r['dead_rows_not_zero']} with dead rows not zero, largest "
              f"atol needed "
              f"{'-' if need is None else ('inf' if math.isinf(need) else f'{need:.3g}')}"
              f", worst {r['worst_case']}); card tests {r['tests_summary']}"
              f"{'; ' + ' | '.join(r['error_lines']) if r['error_lines'] and not r['cases_missed'] else ''}",
              flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "faults.json").write_text(json.dumps(results, indent=1))
    caught = [bool(r["phase_failed"] and r["tests_failed"]) for r in results]
    print(f"faults: {sum(caught)} of {len(results)} caught by both checks")
    return 0 if all(caught) else 1


if __name__ == "__main__":
    sys.exit(main())
