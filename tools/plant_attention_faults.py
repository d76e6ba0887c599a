#!/usr/bin/env python3
"""Plant one fault at a time in a copy of ``csrc/swa_attention.cu``,
``csrc/decode_attention.cu``, ``csrc/paged_attention.cu`` or the combine
they share (``csrc/flash_decode.cuh``) and show that the checks catch it, on
a machine with one NVIDIA GPU.

    python3 tools/plant_attention_faults.py [--out build/faults] [--only NAME]

For each fault of :data:`FAULTS`: copy ``src/``, ``chip_smoke.py``,
``pytest.ini`` and the card tests into ``<out>/<fault>/``, replace one piece
of a kernel source there, then run the checked kernel's ``chip_smoke.py``
phase (``swa_kernels``, ``dense_kernels`` or ``kernels``, which builds the
kernel at first use) and ``pytest -m cuda tests/test_torch_cuda.py -k
<kernel>`` in that copy.
Records per fault whether each failed, how many of the phase's cases missed
their tolerance and the largest atol a missing case needs (from the phase's
record; a fault that traps the launch leaves none), and how many card tests
failed.  Writes ``<out>/faults.json``; exits 1 if a fault passed either
check.
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
SWA = "src/repro_torch/csrc/swa_attention.cu"
DEC = "src/repro_torch/csrc/decode_attention.cu"
PAGED = "src/repro_torch/csrc/paged_attention.cu"
COMBINE = "src/repro_torch/csrc/flash_decode.cuh"
# checked kernel -> (chip_smoke.py phase, its record's keys, card tests' -k)
CHECKS = {"swa_attention": ("swa_kernels", ("swa_attention",),
                            "swa_attention"),
          "decode_attention": ("dense_kernels", ("dense_attention",
                                                 "dense_attention_serve"),
                               "decode_attention"),
          "paged_decode_attention": ("kernels", ("attention",),
                                     "paged_attention")}

_DROP_OLD = (
    "  for (int z = 0; z < splits; ++z) den = fmaf(cw[z], cw[splits + z], den);\n"
    "  for (int d = tid; d < D; d += NTHREADS) {\n"
    "    float num = 0.f;\n"
    "#pragma unroll 8\n"
    "    for (int z = 0; z < splits; ++z)")
_DROP_NEW = (
    "  for (int z = 0; z < splits - 1; ++z) den = fmaf(cw[z], cw[splits + z], den);\n"
    "  for (int d = tid; d < D; d += NTHREADS) {\n"
    "    float num = 0.f;\n"
    "#pragma unroll 8\n"
    "    for (int z = 0; z < splits - 1; ++z)")

# name -> (checked kernel, the source planted, the source as it is, the
# source with the fault)
FAULTS = {
    "mbarrier phase bit flipped (consumers wait on K's other parity)": (
        "swa_attention", SWA,
        "    mbar_wait(&kfull[s], ph);\n",
        "    mbar_wait(&kfull[s], ph ^ 1);\n"),
    "last ring stage not drained (consumers stop one kv tile early)": (
        "swa_attention", SWA,
        "  for (int kt = kt_lo; kt <= kt_hi; ++kt) {\n"
        "    const uint32_t st = smem_u32(ring + s * STAGE);",
        "  for (int kt = kt_lo; kt < kt_hi; ++kt) {\n"
        "    const uint32_t st = smem_u32(ring + s * STAGE);"),
    "V's swizzle off by one chunk (V read from the next 16 bytes)": (
        "swa_attention", SWA,
        "desc_mn128(st + KV_BYTES, KVBOX)",
        "desc_mn128(st + KV_BYTES + 16, KVBOX)"),
    "one split dropped from the combine": (
        "decode_attention", COMBINE, _DROP_OLD, _DROP_NEW),
    "combine without the rescale by e^(m_z - M)": (
        "decode_attention", COMBINE,
        "cw[z] = expf(cw[z] - mx);",
        "cw[z] = 1.f;"),
    "paged: a split with no live page writes m = 0": (
        "paged_decode_attention", PAGED,
        "            c == 0 ? NEG : 0.f;",
        "            0.f;"),
    "paged: one split dropped from the combine": (
        "paged_decode_attention", COMBINE, _DROP_OLD, _DROP_NEW),
    "paged: the window test removed": (
        "paged_decode_attention", PAGED,
        "live = kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);",
        "live = kp >= 0 && kp <= qp;"),
    "paged: the int8 scale read from the wrong KV head": (
        "paged_decode_attention", PAGED,
        "tma_load_2d(st + 2 * g.page, &ksmap, &full[s], 0, row);",
        "tma_load_2d(st + 2 * g.page, &ksmap, &full[s], 0, row - h + (h + 1) % p.KV);"),
    "paged: the ring's last page not waited for": (
        "paged_decode_attention", PAGED,
        "    for (int t = 0; t < np; ++t) mbar_wait(",
        "    for (int t = 0; t < np; ++t)\n"
        "      if (i0 + t < L - 1) mbar_wait("),
}


def run_fault(name: str, kernel: str, dest: Path) -> dict:
    phase, keys, select = CHECKS[kernel]
    smoke = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", phase, "--out",
         "record"], cwd=dest, capture_output=True, text=True, timeout=600)
    rec_path = dest / "record" / "chip_smoke.json"
    rec = json.loads(rec_path.read_text()) if rec_path.is_file() else {}
    rows = [r for key in keys for r in rec.get(key, [])]
    bad = [r for r in rows if not r["ok"]]
    worst = max(bad, key=lambda r: r["atol_needed"]) if bad else None
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
         "no:cacheprovider", "tests/test_torch_cuda.py", "-k", select],
        cwd=dest, capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": "src"})
    summary = (tests.stdout.strip().splitlines() or [""])[-1]
    failed = re.search(r"(\d+) failed", summary)
    passed = re.search(r"(\d+) passed", summary)
    tail = [ln for ln in (smoke.stdout + smoke.stderr).splitlines()
            if "Error" in ln or "error" in ln][-2:]
    return {
        "fault": name, "kernel": kernel, "phase": phase,
        "phase_rc": smoke.returncode, "phase_failed": smoke.returncode != 0,
        "cases_run": len(rows), "cases_missed": len(bad),
        "largest_atol_needed": worst["atol_needed"] if worst else None,
        "worst_case": (None if worst is None else
                       f"{worst.get('name', '')} {worst['dtype']} "
                       f"S={worst.get('s')} window={worst['window']}".strip()),
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
    for name, (kernel, source, old, new) in FAULTS.items():
        if args.only and args.only not in name:
            continue
        dest = args.out / slug(name)
        plant(dest, old, new, source)
        r = run_fault(name, kernel, dest)
        results.append(r)
        need = r["largest_atol_needed"]
        print(f"{name}: {r['phase']} "
              f"{'FAILED' if r['phase_failed'] else 'passed'}"
              f" ({r['cases_missed']} of {r['cases_run']} cases missed, "
              f"largest atol needed "
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
