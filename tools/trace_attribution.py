#!/usr/bin/env python3
"""Hold ``chip_smoke.device_trace``'s ``recurrence`` group, found between
marker kernels on the device, against the profiler's host ranges on the
same trace, on a machine with one NVIDIA GPU.

    python3 tools/trace_attribution.py [--out build/trace_attribution]

rwkv6-3b and zamba2-1.2b at full width and depth are served as
``chip_smoke.py``'s ``rwkv_serve`` and ``zamba_serve`` serve them (two
passes), then one more pass is traced with the host activity on as well
as the device's and with the range markers: the kernels launched inside a
``record_function("recurrence")`` range on the host (the profiler's event
tree, as ``chip_smoke.py`` found the group before) against the device
activity between the marker pairs in the profiler's Chrome trace
(``chip_smoke.trace_events``).  Per arch: both kernel sets, both groups'
device ms and the seconds each way takes (the host way's include the
profiler's parse of the trace into Python events); the sets must be equal
and the device ms within 2%.  Prints one JSON line per arch and writes
them to ``<out>/attribution.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: the largest relative gap between the two ways' device ms
GAP = 0.02


def _kernels_under(evt):
    """(name, device us) of every kernel a host event and the host events
    inside it launched."""
    for k in getattr(evt, "kernels", []):
        yield k.name, k.duration
    for child in getattr(evt, "cpu_children", []):
        yield from _kernels_under(child)


def host_ranges(prof, name: str) -> dict:
    """{kernel name: device us} launched inside the host ranges ``name``."""
    out: dict = {}
    for evt in prof.events():
        if evt.name == name and str(evt.device_type).endswith("CPU"):
            for kname, us in _kernels_under(evt):
                out[kname] = out.get(kname, 0.0) + us
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path,
                   default=ROOT / "build" / "trace_attribution")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("trace_attribution: no CUDA device", file=sys.stderr)
        return 2
    state: dict = {}
    cs.phase_build({"phases": ["build"]}, state)
    rows = []
    for key, (arch, table, attn_calls) in cs.RECURRENT.items():
        cs._release(state, *(f"{k}_{x}" for k in cs.RECURRENT
                             for x in ("engine", "params")))
        _, _, eng, _ = cs.serve_full_width(state, key, arch, table,
                                           attn_calls)
        rng = np.random.default_rng(2)

        def run():
            for n in cs.SERVE_LENS:
                eng.submit(rng.integers(0, eng.model.cfg.vocab_size, (n,)),
                           cs.SERVE_NEW)
            eng.run_until_idle()

        prof, wall = cs.profiled(run, ("recurrence",), host=True)
        t0 = time.perf_counter()
        new = cs.marked_kernels(cs.trace_events(prof),
                                ("recurrence",))["recurrence"]
        t_new = time.perf_counter() - t0
        t0 = time.perf_counter()
        old = host_ranges(prof, "recurrence")
        t_old = time.perf_counter() - t0
        ms_new, ms_old = sum(new.values()) / 1e3, sum(old.values()) / 1e3
        gap = abs(ms_new - ms_old) / max(ms_old, 1e-9)
        row = {"arch": arch, "traced_wall_s": wall,
               "kernels_same": sorted(new) == sorted(old),
               "only_markers": sorted(set(new) - set(old)),
               "only_host": sorted(set(old) - set(new)),
               "kernels": len(new), "ms_markers": ms_new, "ms_host": ms_old,
               "gap": gap, "post_s_markers": t_new, "post_s_host": t_old,
               "ok": sorted(new) == sorted(old) and gap <= GAP}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del prof
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "attribution.json").write_text(json.dumps(rows, indent=1))
    print(cs.card_line())
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
