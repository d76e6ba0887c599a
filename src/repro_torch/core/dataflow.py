"""Faithful functional simulator of Kraken's uniform dataflow (paper Sec. IV).

A copy of ``repro.core.dataflow`` (NumPy only), so that the port does not
import the JAX package; only the import of ``LayerSpec`` differs.  It
reproduces the *data orchestration* of the engine -- pixel interleaving
(Table II), elastic grouping (eqs. 5-6), the per-column shift-accumulate of
the horizontal convolution (Tables III and IV), the output release
schedule, and the degenerate FC/matmul path (Sec. IV-D) -- as executable
NumPy code, and counts its issue cycles against the closed forms of
:mod:`repro_torch.core.perf_model` (eq. 17).  It runs no kernel.

The simulator is *functional*, not RTL: one simulation step corresponds to
one ``q_kc = 1 + C_i*K_H`` macro-cycle of the engine (the vertical
convolution + depthwise dot product of one input column), vectorized over
the R rows and E elastic groups.  The end-of-block early release of the last
``ceil(K_W/2)`` columns ("in the same clock, with implicit zero paddings")
is simulated as extra flush steps with zero partial sums, which is
mathematically identical.

Core-to-work assignment inside an elastic group of ``G = K_W + S_W - 1``
cores (derived from Tables III/IV; the printed Algorithm 1 is OCR-garbled in
the source so the tables are normative):

* at column step ``w``, core ``g`` serves output-channel offset
  ``s_w(g, w) = (g - w) mod S_W`` and kernel column ``k_w(g, w) = g - s_w``
  (idle when ``k_w >= K_W``),
* accumulators shift one core to the right every step:
  ``acc[g] <- sigma(g, w) + acc[g-1]``,
* the last ``S_W`` cores release output column ``o`` (channel offset
  ``s_w``) at step ``w = o*S_W + (K_W - 1) - pad_left``; released values
  retire (they do not shift further).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.networks import LayerSpec


# ---------------------------------------------------------------------------
# Pixel interleaving (Sec. IV-A, Table II): X -> X_hat and back.
# ---------------------------------------------------------------------------

def shift_factor(k_h: int, s_h: int) -> int:
    """Eq. (7)."""
    return math.ceil(k_h / s_h) - 1


def restructure_input(x: np.ndarray, r: int, k_h: int, s_h: int,
                      pad_h: tuple[int, int]) -> np.ndarray:
    """X -> X_hat: the DRAM layout consumed by the pixel shifter.

    ``x`` is [N, H, W, C].  Returns X_hat of shape
    [N, L, W, C, S_H, R + F]  (data beats ... [parallel words]),
    reproducing the paper's
    ``X:[N,H,W,C] -> X1(split) -> X2(pad) -> X3(reshape) -> X_hat(transpose)``
    chain.  Rows outside the (vertically zero-padded) input are zero.
    """
    n, h, w, c = x.shape
    f = shift_factor(k_h, s_h)
    out_h = (h + sum(pad_h) - k_h) // s_h + 1
    l_blocks = math.ceil(out_h / r)
    # The engine consumes, for output-row block l and intra-block row j of
    # R + F interleaved rows, input row (l*R + j)*S_H + phase - pad_top.
    xh = np.zeros((n, l_blocks, w, c, s_h, r + f), dtype=x.dtype)
    for l in range(l_blocks):
        for j in range(r + f):
            for phase in range(s_h):
                ih = (l * r + j) * s_h + phase - pad_h[0]
                if 0 <= ih < h:
                    xh[:, l, :, :, phase, j] = x[:, ih, :, :]
    return xh


def interleave_order(r: int, k_h: int, s_h: int) -> list[list[int]]:
    """Row indices held by each shift register over the S_H loads (Table II).

    Returns, for each load ``phase``, the list of ``R + F`` input-row offsets
    (relative to the block origin) that occupy registers ``R_0..R_{R+F-1}``.
    Reproduces Table II: for R,K_H,S_H = 4,7,2 the first load holds rows
    0,2,4,..,12 and the second load rows 1,3,..,11.
    """
    f = shift_factor(k_h, s_h)
    return [[j * s_h + phase for j in range(r + f)] for phase in range(s_h)]


# ---------------------------------------------------------------------------
# Elastic grouping (Sec. III-B).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    G: int
    E: int
    idle_cores: int

    @staticmethod
    def make(c: int, k_w: int, s_w: int) -> "ElasticConfig":
        g = k_w + s_w - 1
        e = c // g
        return ElasticConfig(G=g, E=e, idle_cores=c % g)


# ---------------------------------------------------------------------------
# The uniform dataflow simulator.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimResult:
    y: np.ndarray          # [N, out_h, out_w, C_o]
    issue_cycles: int      # counted macro-cycles * q_kc terms == eq. (17)
    config: ElasticConfig
    T: int
    L: int


def simulate_conv(x: np.ndarray, k: np.ndarray, *, s_h: int = 1, s_w: int = 1,
                  pad_h: tuple[int, int] = (0, 0), pad_w: tuple[int, int] = (0, 0),
                  R: int = 7, C: int = 96) -> SimResult:
    """Run the uniform dataflow for a convolutional layer.

    ``x``: [N, H, W, C_i] input, ``k``: [K_H, K_W, C_i, C_o] kernel.
    Returns the convolution output (cross-correlation, as eq. (1)) together
    with the counted issue cycles.
    """
    n, h, w_in, c_i = x.shape
    k_h, k_w, _, c_o = k.shape
    cfg = ElasticConfig.make(C, k_w, s_w)
    if cfg.E < 1:
        raise ValueError(
            f"engine needs C >= G = K_W + S_W - 1 cores (C={C}, G={cfg.G})")
    if pad_w[0] % s_w != 0:
        # The shift-accumulate release schedule only completes full tap
        # chains at steps w = K_W-1 (mod S_W); implicit left padding must be
        # a multiple of S_W (TF-style SAME padding satisfies this, e.g.
        # ResNet conv1 K=7,S=2 uses pads (2,3)).
        raise ValueError(
            f"uniform dataflow requires pad_left % S_W == 0 (got pad_left="
            f"{pad_w[0]}, S_W={s_w})")
    out_h = (h + sum(pad_h) - k_h) // s_h + 1
    out_w = (w_in + sum(pad_w) - k_w) // s_w + 1
    L = math.ceil(out_h / R)
    T = math.ceil(c_o / (cfg.E * s_w))

    # Vertical zero padding is materialized in X_hat (restructure step X2);
    # horizontal padding is implicit in the dataflow.
    x_pad_v = np.zeros((n, h + sum(pad_h), w_in, c_i), dtype=np.float64)
    x_pad_v[:, pad_h[0]: pad_h[0] + h] = x

    y = np.zeros((n, out_h, out_w, c_o), dtype=np.float64)

    # Flush steps: outputs up to w_o_max = (out_w-1)*s_w + k_w-1 - pad_left.
    last_release = (out_w - 1) * s_w + (k_w - 1) - pad_w[0]
    n_steps = max(w_in, last_release + 1)

    issue_cycles = 0
    q_kc_work = c_i * k_h           # MAC clocks per column step
    q_s = 1 if k_w != 1 else 0      # shift clock (eq. 15)
    q_c = 0 if k_w != 1 else 1      # config clock (eq. 16)

    g_idx = np.arange(cfg.G)

    for t in range(T):
        for l in range(L):
            rows_valid = (l * R + np.arange(R)) < out_h
            # acc[e][r, n, g]; one array per elastic group: [R, N, E, G]
            acc = np.zeros((R, n, cfg.E, cfg.G), dtype=np.float64)
            for w in range(n_steps):
                # --- per-core work assignment (Tables III/IV) -------------
                sw_of_core = (g_idx - w) % s_w          # [G]
                kw_of_core = g_idx - sw_of_core         # [G]
                core_active = (kw_of_core >= 0) & (kw_of_core < k_w) & (w < w_in)
                kw_safe = np.clip(kw_of_core, 0, k_w - 1)
                # output channel per (e, g): t*E*s_w + e*s_w + sw_of_core
                e_idx = np.arange(cfg.E)
                co_of = (t * cfg.E * s_w + e_idx[:, None] * s_w + sw_of_core[None, :])  # [E, G]
                chan_valid = co_of < c_o
                active_eg = core_active[None, :] & chan_valid       # [E, G]

                # --- sigma: vertical conv + depthwise dot product ---------
                sigma = np.zeros((R, n, cfg.E, cfg.G), dtype=np.float64)
                if w < w_in:
                    for ri in range(R):
                        if not rows_valid[ri]:
                            continue
                        base = (l * R + ri) * s_h
                        window = x_pad_v[:, base: base + k_h, w, :]      # [N,K_H,C_i]
                        co_safe = np.clip(co_of, 0, c_o - 1)
                        # weights [E, G, K_H, C_i]
                        kw_w = k[:, kw_safe, :, :]                       # [K_H,G,C_i,C_o]
                        kw_eg = np.transpose(kw_w, (1, 0, 2, 3))         # [G,K_H,C_i,C_o]
                        kw_sel = np.take_along_axis(
                            kw_eg[None].repeat(cfg.E, 0),                # [E,G,K_H,C_i,C_o]
                            co_safe[:, :, None, None, None], axis=-1,
                        )[..., 0]                                        # [E,G,K_H,C_i]
                        vals = np.einsum("nkc,egkc->neg", window, kw_sel)
                        sigma[ri] = np.where(active_eg[None], vals, 0.0)
                    issue_cycles += q_kc_work + q_s

                # --- shift-accumulate (one clock, riding q_s) -------------
                shifted = np.zeros_like(acc)
                shifted[..., 1:] = acc[..., :-1]
                acc = sigma + shifted

                # --- release (last S_W cores, every S_W steps) ------------
                rel = w - (k_w - 1) + pad_w[0]
                if rel >= 0 and rel % s_w == 0:
                    o = rel // s_w
                    if o < out_w:
                        for sw in range(s_w):
                            g_rel = cfg.G - s_w + sw
                            co = t * cfg.E * s_w + e_idx * s_w + (g_rel - w) % s_w
                            vals = acc[:, :, :, g_rel]                   # [R,N,E]
                            for e in range(cfg.E):
                                c_out = co[e]
                                if c_out >= c_o:
                                    continue
                                for ri in range(R):
                                    oh = l * R + ri
                                    if oh < out_h:
                                        y[:, oh, o, c_out] = vals[ri, :, e]
                            # retire released values
                            acc[:, :, :, g_rel] = 0.0
        issue_cycles += q_c  # one configuration clock per iteration (eq. 16)
    return SimResult(y=y, issue_cycles=issue_cycles, config=cfg, T=T, L=L)


def simulate_matmul(x: np.ndarray, k: np.ndarray, *, R: int = 7, C: int = 96) -> SimResult:
    """Sec. IV-D: matrix product as the degenerate case of the dataflow.

    ``x``: [H, C_i] (H = batch for FC), ``k``: [C_i, C_o].  The PE array
    computes [R, C] output blocks in C_i clocks each, over T*L iterations,
    with no shifting (q_s = 0) and one configuration clock per iteration
    (q_c = 1).
    """
    h, c_i = x.shape
    _, c_o = k.shape
    cfg = ElasticConfig.make(C, 1, 1)   # G = 1, E = C
    L = math.ceil(h / R)
    T = math.ceil(c_o / C)
    y = np.zeros((h, c_o), dtype=np.float64)
    issue_cycles = 0
    for t in range(T):
        for l in range(L):
            rows = slice(l * R, min((l + 1) * R, h))
            cols = slice(t * C, min((t + 1) * C, c_o))
            # C_i clocks of output-stationary accumulation.
            y[rows, cols] = x[rows] @ k[:, cols]
            issue_cycles += c_i
        issue_cycles += 1  # q_c
    return SimResult(y=y, issue_cycles=issue_cycles, config=cfg, T=T, L=L)


def simulate_layer(layer: LayerSpec, x: np.ndarray, k: np.ndarray,
                   R: int = 7, C: int = 96) -> SimResult:
    """Dispatch a LayerSpec through the uniform dataflow (grouped convs run
    per group, as the engine does)."""
    if layer.kind == "fc":
        return simulate_matmul(x, k, R=R, C=C)
    if layer.groups == 1:
        return simulate_conv(
            x, k, s_h=layer.S_H, s_w=layer.S_W, pad_h=layer.pad_h,
            pad_w=layer.pad_w, R=R, C=C)
    cig, cog = layer.c_i_per_group, layer.c_o_per_group
    parts, cycles = [], 0
    for g in range(layer.groups):
        res = simulate_conv(
            x[..., g * cig:(g + 1) * cig], k[:, :, :, g * cog:(g + 1) * cog],
            s_h=layer.S_H, s_w=layer.S_W, pad_h=layer.pad_h, pad_w=layer.pad_w,
            R=R, C=C)
        parts.append(res.y)
        cycles += res.issue_cycles
    return SimResult(y=np.concatenate(parts, axis=-1), issue_cycles=cycles,
                     config=parts and res.config, T=res.T, L=res.L)


def reference_conv(x: np.ndarray, k: np.ndarray, *, s_h: int = 1, s_w: int = 1,
                   pad_h: tuple[int, int] = (0, 0), pad_w: tuple[int, int] = (0, 0)
                   ) -> np.ndarray:
    """Pure-numpy oracle for eq. (1) (cross-correlation)."""
    n, h, w, c_i = x.shape
    k_h, k_w, _, c_o = k.shape
    xp = np.zeros((n, h + sum(pad_h), w + sum(pad_w), c_i))
    xp[:, pad_h[0]: pad_h[0] + h, pad_w[0]: pad_w[0] + w] = x
    out_h = (h + sum(pad_h) - k_h) // s_h + 1
    out_w = (w + sum(pad_w) - k_w) // s_w + 1
    y = np.zeros((n, out_h, out_w, c_o))
    for kh in range(k_h):
        for kw in range(k_w):
            patch = xp[:, kh: kh + out_h * s_h: s_h, kw: kw + out_w * s_w: s_w, :]
            y += np.einsum("nhwc,co->nhwo", patch, k[kh, kw])
    return y
