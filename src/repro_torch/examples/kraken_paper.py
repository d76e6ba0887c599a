"""Walk through the paper's own results: the uniform dataflow on a real
layer, elastic grouping, and the Table V / VI reproduction.

    PYTHONPATH=src python -m repro_torch.examples.kraken_paper --device cpu

The dataflow simulator and the performance model are host numpy, so the
printed lines are the same whatever ``--device`` names (default ``cuda``,
which must exist, as for every entry point of the port).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch import device as _device
from repro_torch.configs.kraken_asic import CONFIG
from repro_torch.core import networks as N
from repro_torch.core import perf_model as P
from repro_torch.core.dataflow import (ElasticConfig, reference_conv,
                                       simulate_conv, simulate_matmul)


def report() -> None:
    """Print the walk-through (the reference example's lines)."""
    print(f"Kraken {CONFIG.R}x{CONFIG.C}: {CONFIG.num_pes} PEs, "
          f"peak {CONFIG.peak_gops_conv:.1f} Gops @ {CONFIG.freq_conv_mhz:.0f} MHz\n")

    # 1. The uniform dataflow, bit-for-bit: a strided conv through the engine.
    print("== uniform dataflow on a 5x5/s2 conv (Table IV regime) ==")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 16, 16, 8))
    k = rng.normal(size=(5, 5, 8, 12))
    res = simulate_conv(x, k, s_h=2, s_w=2, pad_h=(2, 2), pad_w=(2, 2),
                        R=7, C=24)
    ref = reference_conv(x, k, s_h=2, s_w=2, pad_h=(2, 2), pad_w=(2, 2))
    print(f"   elastic grouping: G={res.config.G} cores/group, "
          f"E={res.config.E} groups, {res.config.idle_cores} idle")
    print(f"   max |engine - conv oracle| = {np.abs(res.y - ref).max():.2e}")
    print(f"   issue cycles = {res.issue_cycles} "
          f"(closed-form Q would predict the same; see tests)\n")

    # 2. Matrix product as the degenerate case (Sec. IV-D).
    print("== matmul as degenerate conv ==")
    a = rng.normal(size=(7, 64))
    b = rng.normal(size=(64, 40))
    mm = simulate_matmul(a, b, R=7, C=24)
    print(f"   max err = {np.abs(mm.y - a @ b).max():.2e}, "
          f"cycles = {mm.issue_cycles}\n")

    # 3. Elastic grouping across the benchmark layer shapes.
    print("== elastic grouping across layer shapes (C=96) ==")
    for kw, sw, tag in [(11, 4, "AlexNet conv1"), (5, 1, "AlexNet conv2"),
                        (3, 1, "VGG 3x3"), (1, 1, "ResNet 1x1"),
                        (7, 2, "ResNet conv1")]:
        cfg = ElasticConfig.make(96, kw, sw)
        print(f"   {tag:15s} K_W={kw} S_W={sw}: G={cfg.G:2d} E={cfg.E:2d} "
              f"idle={cfg.idle_cores}")
    print()

    # 4. Tables V & VI.
    print("== Table V (conv @400 MHz) ==")
    paper_v = {"alexnet": (77.2, 336.6), "vgg16": (96.5, 17.5),
               "resnet50": (88.3, 64.2)}
    for net, (eff_p, fps_p) in paper_v.items():
        perf = P.analyze_network(N.get_network(net)["conv"])
        print(f"   {net:9s} eff {perf.efficiency * 100:5.1f}% (paper {eff_p}), "
              f"fps {perf.fps():6.1f} (paper {fps_p}), "
              f"MA {perf.memory_accesses / 1e6:6.2f}M, "
              f"AI {perf.arithmetic_intensity:6.1f}")
    print("== Table VI (FC @200 MHz, batch 7) ==")
    for net in paper_v:
        perf = P.analyze_network(N.get_network(net, fc_batch=7)["fc"],
                                 freq_mhz=P.F_FC_MHZ)
        print(f"   {net:9s} eff {perf.efficiency * 100:5.1f}%, "
              f"fps {perf.fps(batch=7):8.1f}, "
              f"MA/frame {perf.fc_memory_accesses_per_frame(7) / 1e6:6.2f}M")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    _device.resolve(p.parse_args(argv).device)
    report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
