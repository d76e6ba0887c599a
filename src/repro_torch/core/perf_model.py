"""Exact analytical performance model of the Kraken engine (paper Sec. V).

A copy of ``repro.core.perf_model`` (pure Python), so that the port does
not import the JAX package; only the import of ``LayerSpec`` differs.  It
implements, as closed forms over the static configuration ``(R, C)``:

* clock cycles  ``Q_j``                      (eq. 17)
* performance efficiency ``E_j``, ``E``      (eqs. 18-19)
* DRAM accesses ``M_X^, M_K^, M_Y^, M^``     (eq. 20)
* arithmetic intensity ``AI``                (eqs. 21-22)
* bandwidth requirements                     (eqs. 23-25)

plus the Sec. VI-A static configuration search that selects ``R x C = 7x96``.
These are the paper's formulas for its ASIC, held against the paper's own
Tables V and VI by the JAX package's tests; the numbers are the ASIC's,
never the card's.

Grouped convolutions (AlexNet conv2/4/5) are processed per group: each group
is an independent convolution with ``C_i/g`` input and ``C_o/g`` output
channels; iteration counts add across groups.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

from repro_torch.core.networks import LayerSpec

# Implemented chip constants (Sec. VI-A).
KRAKEN_R = 7
KRAKEN_C = 96
F_CONV_MHZ = 400.0
F_FC_MHZ = 200.0
CORE_AREA_MM2 = 7.3
POWER_CONV_W = 1.050
POWER_FC_W = 0.613


@dataclasses.dataclass(frozen=True)
class LayerPerf:
    """Derived per-layer quantities for a static config (R, C)."""

    layer: LayerSpec
    R: int
    C: int
    G: int
    E: int
    T: int
    L: int
    F: int
    q_s: int
    q_c: int
    Q: int              # clock cycles (eq. 17), including `repeat`
    macs_valid: int     # including `repeat`
    m_x_hat: int        # tiled DRAM words, including `repeat`
    m_k_hat: int
    m_y_hat: int

    @property
    def efficiency(self) -> float:
        return self.macs_valid / (self.R * self.C * self.Q)

    @property
    def m_hat(self) -> int:
        return self.m_x_hat + self.m_k_hat + self.m_y_hat


def analyze_layer(layer: LayerSpec, R: int = KRAKEN_R, C: int = KRAKEN_C) -> LayerPerf:
    """Apply eqs. (5)-(17) and the M^ formulas of Sec. V to one layer."""
    # Elastic grouping (eqs. 5, 6).
    G = layer.K_W + layer.S_W - 1
    E = C // G
    # Shift factor (eq. 7).
    F = math.ceil(layer.K_H / layer.S_H) - 1
    # Blocks along H (eq. 8).  H is the *input* height.
    L = math.ceil(layer.H / (R * layer.S_H))
    # Iterations along C_o (eq. 9), per group; groups add.
    T_per_group = math.ceil(layer.c_o_per_group / (E * layer.S_W))
    T = T_per_group * layer.groups
    # Stall / configuration clocks (eqs. 15, 16).
    is_conv_kw = layer.kind == "conv" and layer.K_W != 1
    q_s = 1 if is_conv_kw else 0
    q_c = 0 if is_conv_kw else 1
    # Clock cycles (eq. 17).  C_i is per-group for grouped convs.
    c_i = layer.c_i_per_group
    Q_one = T * (q_c + layer.N * L * layer.W * (q_s + c_i * layer.K_H))
    # DRAM accesses of the tiled arrays (Sec. V-C).  FC mapping zeroes F.
    if layer.kind == "fc":
        m_x = T * layer.N * L * layer.W * layer.C_i * layer.S_H * R  # F = 0
    else:
        # Each group re-reads only its own C_i/g channels, T_per_group times.
        m_x = T_per_group * layer.N * L * layer.W * c_i * layer.S_H * (R + F) * layer.groups
    m_k = T_per_group * c_i * layer.K_H * layer.S_W * C * layer.groups
    # Full output pixels are released every S_W w-steps (Table IV): the
    # engine emits E*S_W*R words ceil(W/S_W) times per (t, n, l).
    m_y = T * layer.N * L * math.ceil(layer.W / layer.S_W) * E * layer.S_W * R
    rep = layer.repeat
    return LayerPerf(
        layer=layer, R=R, C=C, G=G, E=E, T=T, L=L, F=F, q_s=q_s, q_c=q_c,
        Q=Q_one * rep,
        macs_valid=layer.macs_valid * rep,
        m_x_hat=m_x * rep, m_k_hat=m_k * rep, m_y_hat=m_y * rep,
    )


@dataclasses.dataclass(frozen=True)
class NetworkPerf:
    layers: tuple[LayerPerf, ...]
    freq_mhz: float

    @property
    def total_cycles(self) -> int:
        return sum(l.Q for l in self.layers)

    @property
    def total_macs_valid(self) -> int:
        return sum(l.macs_valid for l in self.layers)

    @property
    def efficiency(self) -> float:
        """Overall performance efficiency (eq. 18)."""
        R, C = self.layers[0].R, self.layers[0].C
        return self.total_macs_valid / (R * C * self.total_cycles)

    @property
    def latency_ms(self) -> float:
        return self.total_cycles / (self.freq_mhz * 1e3)

    def fps(self, batch: int = 1) -> float:
        return batch * self.freq_mhz * 1e6 / self.total_cycles

    @property
    def gops(self) -> float:
        """Average valid Gops (2 ops per MAC)."""
        return 2.0 * self.total_macs_valid * self.freq_mhz * 1e6 / self.total_cycles / 1e9

    @property
    def peak_gops(self) -> float:
        R, C = self.layers[0].R, self.layers[0].C
        return 2.0 * R * C * self.freq_mhz * 1e6 / 1e9

    @property
    def memory_accesses(self) -> int:
        """M^(R,C): total tiled DRAM words per inference (eq. 20)."""
        return sum(l.m_hat for l in self.layers)

    @property
    def arithmetic_intensity(self) -> float:
        """AI = valid ops / DRAM words (eqs. 21-22)."""
        return 2.0 * self.total_macs_valid / self.memory_accesses

    def fc_memory_accesses_per_frame(self, batch: int) -> float:
        """Table VI per-frame accounting for FC layers at batch ``N^f``.

        The paper amortizes the rotated weights (and outputs) over the batch
        but charges the streamed activation words per pass; this reproduces
        its 12.2 / 27.0 / 0.5 M figures (see tests).
        """
        m_k = sum(l.m_k_hat for l in self.layers)
        m_x = sum(l.m_x_hat for l in self.layers)
        m_y = sum(l.m_y_hat for l in self.layers)
        return (m_k + m_y) / batch + m_x

    def fc_arithmetic_intensity(self, batch: int) -> float:
        ops_per_frame = 2.0 * self.total_macs_valid / batch
        return ops_per_frame / self.fc_memory_accesses_per_frame(batch)

    @property
    def gops_per_mm2(self) -> float:
        return self.gops / CORE_AREA_MM2

    def gops_per_w(self, power_w: float) -> float:
        return self.gops / power_w


def analyze_network(layers: Sequence[LayerSpec], R: int = KRAKEN_R, C: int = KRAKEN_C,
                    freq_mhz: float = F_CONV_MHZ) -> NetworkPerf:
    return NetworkPerf(tuple(analyze_layer(l, R, C) for l in layers), freq_mhz)


# ---------------------------------------------------------------------------
# Bandwidth requirements (Sec. V-E, eqs. 23-25), in words/clock.
# ---------------------------------------------------------------------------

def bandwidth_words_per_clock(layer: LayerSpec, R: int = KRAKEN_R, C: int = KRAKEN_C) -> dict[str, float]:
    p = analyze_layer(layer, R, C)
    if layer.kind == "fc":
        bw_x = float(R)  # R+F words, F=F'=0 -> per clock
        bw_k = layer.c_i_per_group * 1 * 1 * C / max(1, (1 + layer.c_i_per_group))
        bw_y = p.E * 1 * R / max(1, layer.c_i_per_group)
    else:
        f_prime = max(1, p.F)
        bw_x = (R + p.F) / f_prime
        per_iter_clocks = p.q_c + layer.N * p.L * layer.W * (p.q_s + layer.c_i_per_group * layer.K_H)
        bw_k = layer.c_i_per_group * layer.K_H * layer.S_W * C / max(1, per_iter_clocks)
        bw_y = p.E * layer.S_W * R / max(1, layer.c_i_per_group * layer.K_H + p.q_s)
    return {"x": bw_x, "k": bw_k, "y": bw_y}


# ---------------------------------------------------------------------------
# Sec. VI-A static configuration search.
# ---------------------------------------------------------------------------

def config_search(conv_layer_sets: Iterable[Sequence[LayerSpec]],
                  r_range: Iterable[int] = range(4, 17),
                  c_range: Iterable[int] = range(12, 129, 3),
                  pe_budget: int = 672) -> list[dict]:
    """Evaluate E and M^ over (R, C) pairs with R*C <= pe_budget.

    Reproduces the observation that 7x15 / 7x24 / 14x24 give slightly higher
    efficiency but far more memory accesses, and that 7x96 is the chosen
    optimum at the full PE budget.
    """
    sets = [list(s) for s in conv_layer_sets]
    out = []
    for R in r_range:
        for C in c_range:
            if R * C > pe_budget:
                continue
            effs, mas = [], []
            for layers in sets:
                perf = analyze_network(layers, R, C)
                effs.append(perf.efficiency)
                mas.append(perf.memory_accesses)
            out.append({
                "R": R, "C": C, "PEs": R * C,
                "mean_efficiency": sum(effs) / len(effs),
                "total_memory_accesses": sum(mas),
            })
    return out
