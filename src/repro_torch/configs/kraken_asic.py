"""The paper's own configuration: the Kraken 7x96 engine and its benchmark
CNNs (AlexNet / VGG-16 / ResNet-50), Sec. VI-A.

A copy of ``repro.configs.kraken_asic``, so that the port does not import
the JAX package: the ASIC the paper-reproduction models
(:mod:`repro_torch.core.perf_model`, :mod:`repro_torch.core.dataflow`)
describe.  The LM architectures of this package are the workloads that
exercise the card's version of the same dataflow.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KrakenEngineConfig:
    R: int = 7                    # PE rows
    C: int = 96                   # cores
    freq_conv_mhz: float = 400.0
    freq_fc_mhz: float = 200.0
    bits: int = 8
    core_area_mm2: float = 7.3
    power_conv_w: float = 1.050
    power_fc_w: float = 0.613

    @property
    def num_pes(self) -> int:
        return self.R * self.C

    @property
    def peak_gops_conv(self) -> float:
        return 2.0 * self.num_pes * self.freq_conv_mhz * 1e6 / 1e9


CONFIG = KrakenEngineConfig()

# Alternate static configurations discussed in Sec. VI-A.
ALTERNATES = [
    KrakenEngineConfig(R=7, C=15),
    KrakenEngineConfig(R=7, C=24),
    KrakenEngineConfig(R=14, C=24),
]

BENCHMARK_CNNS = ("alexnet", "vgg16", "resnet50")
