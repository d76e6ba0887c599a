"""Three-term roofline from the ops a step dispatches.

    compute    = FLOPs            / (chips * peak FLOP/s)
    memory     = HBM bytes        / (chips * HBM bandwidth)
    collective = collective bytes / (chips * link bandwidth)

A port of ``repro.roofline.analysis``.  JAX reads FLOPs and bytes from
the compiled artifact; the port counts them with
:mod:`repro_torch.roofline.op_walk` and builds the roofline with
:func:`from_counts`.  Every count is per device.

Hardware constants: one NVIDIA H100 80GB HBM3 SXM5 at its 700 W limit,
from NVIDIA's H100 Tensor Core GPU datasheet (dense, without sparsity):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them,
1979 TOP/s int8, HBM3 at 3.35 TB/s, and NVLink 4 at 900 GB/s both
directions, 450 GB/s a direction.  A card held below 700 W runs slower
under load: write its name and limit beside any time set against these.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16 = 989e12      # FLOP/s, bf16 tensor cores, dense
PEAK_FP32 = 67e12       # FLOP/s, fp32 outside the tensor cores
PEAK_INT8 = 1979e12     # OP/s, int8 tensor cores, dense
PEAK_BYTES = 3.35e12    # B/s, HBM3
NVLINK_BW = 450e9       # B/s, NVLink 4, one direction of one card

PEAK_FLOPS = PEAK_BF16
HBM_BW = PEAK_BYTES
LINK_BW = NVLINK_BW

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    operand_bytes: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.operand_bytes.values())


def collective_stats(walk) -> CollectiveStats:
    """The collectives of an op walk (JAX's ``parse_collectives`` reads
    them from the HLO)."""
    return CollectiveStats(counts=dict(walk.coll_counts),
                           operand_bytes=dict(walk.coll_bytes_by_kind))


@dataclasses.dataclass
class Roofline:
    """All byte/FLOP fields are PER-DEVICE (the walk sees one rank's local
    ops).  ``model_flops`` is whole-model useful FLOPs for the step
    (6*N*D train / 2*N*D inference), normalized by ``chips`` where used."""

    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes accessed
    collective_bytes: float      # per-device collective operand bytes
    chips: int
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / total FLOPs: catches remat/redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful compute time / bound time."""
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        return t_useful / self.t_bound if self.t_bound else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def from_counts(walk, chips: int, model_flops: float) -> Roofline:
    """The roofline of an :class:`~repro_torch.roofline.op_walk.WalkResult`
    (JAX's ``from_compiled``): FLOPs, HBM bytes and collective bytes as the
    walk counted them, one rank's."""
    return Roofline(flops=float(walk.dot_flops),
                    hbm_bytes=float(walk.hbm_bytes),
                    collective_bytes=float(walk.coll_bytes), chips=chips,
                    model_flops=model_flops)
