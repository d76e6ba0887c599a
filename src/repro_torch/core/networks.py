"""CNN layer tables for the paper's benchmark networks (Table I).

A copy of ``repro.core.networks`` (pure Python), so that the port does not
import the JAX package.  AlexNet, VGG-16 and ResNet-50 are encoded layer by
layer with explicit input dims, kernel, stride, padding and groups.

Conventions: the *real* network dims are encoded (AlexNet conv1 takes the
227x227 input, unpadded, output 55x55).  ResNet-50 uses the v1 block
(stride 2 on the first 1x1 conv of stages 3-5).  Per the paper's Table I
footnote, (K,S)=(1,2) layers are processed as (1,1) convs on the
pre-subsampled input: a 1x1 kernel has no spatial overlap, so
subsample-then-conv is exact.  They are encoded that way (``H,W`` already
halved, ``S=1``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One convolutional or fully-connected layer.

    ``H, W`` are *input* spatial dims.  For ``kind == 'fc'`` the paper's
    mapping is used: ``N, H, C_i, C_o = 1, N_batch, C_i_fc, C_o_fc`` and
    ``W = K_H = K_W = S_H = S_W = 1``.
    """

    name: str
    kind: str  # 'conv' | 'fc'
    H: int
    W: int
    K_H: int
    K_W: int
    S_H: int
    S_W: int
    pad_h: tuple[int, int]
    pad_w: tuple[int, int]
    C_i: int
    C_o: int
    groups: int = 1
    N: int = 1
    repeat: int = 1  # identical layers collapsed (ResNet repeated blocks)

    # ---- derived shape helpers -------------------------------------------------
    @property
    def out_h(self) -> int:
        return (self.H + sum(self.pad_h) - self.K_H) // self.S_H + 1

    @property
    def out_w(self) -> int:
        return (self.W + sum(self.pad_w) - self.K_W) // self.S_W + 1

    @property
    def c_i_per_group(self) -> int:
        return self.C_i // self.groups

    @property
    def c_o_per_group(self) -> int:
        return self.C_o // self.groups

    # ---- operation counts (eqs. (3), (4)) ---------------------------------------
    @property
    def macs_with_zpad(self) -> int:
        """Eq. (3): MACs counting zero-padding taps, per `repeat` unit."""
        return (
            self.N
            * self.out_h
            * self.out_w
            * self.K_H
            * self.K_W
            * self.c_i_per_group
            * self.C_o
        )

    def _valid_tap_fraction_1d(self, size: int, out: int, k: int, s: int, pad: tuple[int, int]) -> int:
        """Sum over output positions of in-bounds kernel taps along one dim."""
        total = 0
        for o in range(out):
            start = o * s - pad[0]
            lo = max(0, -start)
            hi = min(k, size - start)
            total += max(0, hi - lo)
        return total

    @property
    def macs_valid(self) -> int:
        """Eq. (4): MACs excluding zero-padding taps, per `repeat` unit."""
        vh = self._valid_tap_fraction_1d(self.H, self.out_h, self.K_H, self.S_H, self.pad_h)
        vw = self._valid_tap_fraction_1d(self.W, self.out_w, self.K_W, self.S_W, self.pad_w)
        return self.N * vh * vw * self.c_i_per_group * self.C_o

    # ---- DRAM word counts for the *un-tiled* arrays (Table I) -------------------
    @property
    def m_x(self) -> int:
        return self.N * self.H * self.W * self.C_i

    @property
    def m_k(self) -> int:
        return self.K_H * self.K_W * self.c_i_per_group * self.C_o

    @property
    def m_y(self) -> int:
        return self.N * self.out_h * self.out_w * self.C_o


def fc(name: str, c_i: int, c_o: int, batch: int = 1) -> LayerSpec:
    """Fully-connected layer via the paper's Sec. IV-D mapping."""
    return LayerSpec(
        name=name, kind="fc", H=batch, W=1, K_H=1, K_W=1, S_H=1, S_W=1,
        pad_h=(0, 0), pad_w=(0, 0), C_i=c_i, C_o=c_o,
    )


def conv(name: str, hw: int, k: int, s: int, pad: int, c_i: int, c_o: int,
         groups: int = 1, repeat: int = 1) -> LayerSpec:
    return LayerSpec(
        name=name, kind="conv", H=hw, W=hw, K_H=k, K_W=k, S_H=s, S_W=s,
        pad_h=(pad, pad), pad_w=(pad, pad), C_i=c_i, C_o=c_o, groups=groups,
        repeat=repeat,
    )


# ---------------------------------------------------------------------------
# AlexNet (original grouped version; Krizhevsky et al. 2012)
# ---------------------------------------------------------------------------

def alexnet_conv(batch: int = 1) -> list[LayerSpec]:
    layers = [
        conv("conv1", 227, 11, 4, 0, 3, 96),
        conv("conv2", 27, 5, 1, 2, 96, 256, groups=2),
        conv("conv3", 13, 3, 1, 1, 256, 384),
        conv("conv4", 13, 3, 1, 1, 384, 384, groups=2),
        conv("conv5", 13, 3, 1, 1, 384, 256, groups=2),
    ]
    return [dataclasses.replace(l, N=batch) for l in layers]


def alexnet_fc(batch: int = 1) -> list[LayerSpec]:
    return [
        fc("fc6", 9216, 4096, batch),
        fc("fc7", 4096, 4096, batch),
        fc("fc8", 4096, 1000, batch),
    ]


# ---------------------------------------------------------------------------
# VGG-16
# ---------------------------------------------------------------------------

def vgg16_conv(batch: int = 1) -> list[LayerSpec]:
    cfg = [
        ("conv1_1", 224, 3, 64), ("conv1_2", 224, 64, 64),
        ("conv2_1", 112, 64, 128), ("conv2_2", 112, 128, 128),
        ("conv3_1", 56, 128, 256), ("conv3_2", 56, 256, 256), ("conv3_3", 56, 256, 256),
        ("conv4_1", 28, 256, 512), ("conv4_2", 28, 512, 512), ("conv4_3", 28, 512, 512),
        ("conv5_1", 14, 512, 512), ("conv5_2", 14, 512, 512), ("conv5_3", 14, 512, 512),
    ]
    return [
        dataclasses.replace(conv(n, hw, 3, 1, 1, ci, co), N=batch)
        for (n, hw, ci, co) in cfg
    ]


def vgg16_fc(batch: int = 1) -> list[LayerSpec]:
    return [
        fc("fc6", 25088, 4096, batch),
        fc("fc7", 4096, 4096, batch),
        fc("fc8", 4096, 1000, batch),
    ]


# ---------------------------------------------------------------------------
# ResNet-50 (v1; stride-2 on first 1x1 of stages conv3-conv5, footnote: (1,2)
# layers processed as (1,1) on the subsampled input)
# ---------------------------------------------------------------------------

def resnet50_conv(batch: int = 1) -> list[LayerSpec]:
    layers: list[LayerSpec] = [conv("conv1", 224, 7, 2, 3, 3, 64)]

    def bottleneck(stage: str, hw: int, c_in: int, c_mid: int, c_out: int,
                   blocks: int, downsample_from: int | None) -> None:
        # First block: (1,2) convs are encoded at the subsampled resolution.
        if downsample_from is not None:
            # stages 3..5: first 1x1 is (1,2) -> encoded as (1,1) at hw.
            layers.append(conv(f"{stage}_b1_a(1x1s2)", hw, 1, 1, 0, c_in, c_mid))
            layers.append(conv(f"{stage}_ds(1x1s2)", hw, 1, 1, 0, c_in, c_out))
        else:
            # stage 2: stride-1 first block (after the maxpool).
            layers.append(conv(f"{stage}_b1_a", hw, 1, 1, 0, c_in, c_mid))
            layers.append(conv(f"{stage}_ds", hw, 1, 1, 0, c_in, c_out))
        layers.append(conv(f"{stage}_b1_b", hw, 3, 1, 1, c_mid, c_mid))
        layers.append(conv(f"{stage}_b1_c", hw, 1, 1, 0, c_mid, c_out))
        if blocks > 1:
            layers.append(conv(f"{stage}_bN_a", hw, 1, 1, 0, c_out, c_mid, repeat=blocks - 1))
            layers.append(conv(f"{stage}_bN_b", hw, 3, 1, 1, c_mid, c_mid, repeat=blocks - 1))
            layers.append(conv(f"{stage}_bN_c", hw, 1, 1, 0, c_mid, c_out, repeat=blocks - 1))

    bottleneck("conv2", 56, 64, 64, 256, 3, None)
    bottleneck("conv3", 28, 256, 128, 512, 4, 56)
    bottleneck("conv4", 14, 512, 256, 1024, 6, 28)
    bottleneck("conv5", 7, 1024, 512, 2048, 3, 14)
    return [dataclasses.replace(l, N=batch) for l in layers]


def resnet50_fc(batch: int = 1) -> list[LayerSpec]:
    return [fc("fc", 2048, 1000, batch)]


NETWORKS: dict[str, dict[str, list[LayerSpec]]] = {}


def get_network(name: str, batch: int = 1, fc_batch: int | None = None) -> dict[str, list[LayerSpec]]:
    """Return {'conv': [...], 'fc': [...]} for a benchmark CNN."""
    fc_batch = batch if fc_batch is None else fc_batch
    table = {
        "alexnet": (alexnet_conv, alexnet_fc),
        "vgg16": (vgg16_conv, vgg16_fc),
        "resnet50": (resnet50_conv, resnet50_fc),
    }
    conv_fn, fc_fn = table[name]
    return {"conv": conv_fn(batch), "fc": fc_fn(fc_batch)}


def total_macs(layers: Iterable[LayerSpec], valid: bool = True) -> int:
    return sum((l.macs_valid if valid else l.macs_with_zpad) * l.repeat for l in layers)


def total_words(layers: Iterable[LayerSpec], which: str) -> int:
    attr = {"x": "m_x", "k": "m_k", "y": "m_y"}[which]
    return sum(getattr(l, attr) * l.repeat for l in layers)
