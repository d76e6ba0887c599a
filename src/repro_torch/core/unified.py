"""The uniform op abstraction: conv / FC / matmul / attention -> GEMM cells.

The port of ``repro.core.unified``: the paper's thesis as a data structure.
Kraken runs every layer kind on one dataflow, FC layers and matrix products
as degenerate convolutions; here every op lowers to a GEMM cell that
``kraken_gemm`` runs.  A :class:`GemmCell` is that intermediate
representation.  Lowering rules::

    conv   [N,H,W,Ci] * [KH,KW,Ci,Co] -> (N*OH*OW, Ci*KH*KW, Co)   (im2col)
    fc     [Nf,Ci] * [Ci,Co]          -> (Nf, Ci, Co)
    matmul [M,K] @ [K,N]              -> (M, K, N)
    attention: per-layer qkv/out projections + (batch*heads) score and
               context cells.

The lowering rules and the cell lists are the JAX module's, cell for cell:
:func:`serving_cells` is the work-list ``serve --autotune`` warms.  A
cell's tile plan is ``kraken_gemm``'s plan on the card
(:meth:`GemmCell.tile_plan`) under the tile policy, and its utilization
that plan's useful share of its padded ``M x K x N``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

from repro_torch.core import elastic

OpKind = Literal["conv", "fc", "matmul", "attn_score", "attn_context"]

#: one H100 SXM's published dense bf16 tensor-core peak and HBM3 rate, at
#: its 700 W limit (the napkin math of :class:`CellReport`)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12


@dataclasses.dataclass(frozen=True)
class GemmCell:
    """One GEMM on the uniform datapath: ``[m, k] @ [k, n]``, repeated
    ``batch`` times with independent operands (batch=1 for plain matmul)."""
    kind: OpKind
    m: int
    k: int
    n: int
    batch: int = 1
    name: str = ""

    @property
    def flops(self) -> int:
        return 2 * self.batch * self.m * self.k * self.n

    @property
    def macs(self) -> int:
        return self.batch * self.m * self.k * self.n

    def operand_words(self) -> int:
        """Minimal words moved if every operand is touched exactly once."""
        return self.batch * (self.m * self.k + self.k * self.n + self.m * self.n)

    def arithmetic_intensity(self, word_bytes: int = 2) -> float:
        """ops / byte at perfect reuse — the roofline upper bound for the cell."""
        return self.flops / (self.operand_words() * word_bytes)

    def tile_plan(self, mode: str | None = None, *, sms: int = 132,
                  dtype_name: str = "bfloat16") -> dict:
        """The cell's ``kraken_gemm`` plan on a card of ``sms`` SMs;
        ``mode`` as in :func:`elastic.choose_tiles` (None defers to the
        process-wide policy, so a warmed ``--tile-cache`` run replays its
        measured plans here too)."""
        import torch

        from repro_torch.kernels import kraken_gemm as kg
        choice = None
        if dtype_name == "bfloat16":
            choice = elastic.choose_tiles("gemm", (self.m, self.k, self.n),
                                          dtype_name=dtype_name, sms=sms,
                                          mode=mode)
        return kg.plan(self.m, self.k, self.n, dtype=getattr(torch, dtype_name),
                       sms=sms, choice=choice)

    def utilization(self, sms: int = 132) -> float:
        """The useful share of the tensor-core work the planner's bf16 plan
        issues: ``M x K x N`` over its padded tiles (whole BM x BN tiles,
        64-deep K steps) -- the card's counterpart of the paper's per-layer
        efficiency (eq. 19)."""
        q = self.tile_plan("model", sms=sms)
        issued = (q["mtiles"] * q["BM"]) * (q["nk"] * 64) * (q["ntiles"]
                                                             * q["BN"])
        return self.m * self.k * self.n / issued if issued else 0.0


# ---------------------------------------------------------------------------
# Lowering rules (the uniform dataflow's restructurings, Sec. IV)
# ---------------------------------------------------------------------------

def conv_cell(*, n: int, h: int, w: int, c_i: int, k_h: int, k_w: int,
              c_o: int, s_h: int = 1, s_w: int = 1,
              pad_h: tuple[int, int] = (0, 0),
              pad_w: tuple[int, int] = (0, 0), name: str = "") -> GemmCell:
    """conv -> im2col GEMM.  Output spatial dims follow the valid-window rule."""
    oh = (h + pad_h[0] + pad_h[1] - k_h) // s_h + 1
    ow = (w + pad_w[0] + pad_w[1] - k_w) // s_w + 1
    return GemmCell("conv", m=n * oh * ow, k=c_i * k_h * k_w, n=c_o, name=name)


def fc_cell(*, batch: int, c_i: int, c_o: int, name: str = "") -> GemmCell:
    """The paper's eq. (2): a conv with N,W,K_H,K_W,S_H,S_W = 1."""
    return GemmCell("fc", m=batch, k=c_i, n=c_o, name=name)


def matmul_cell(m: int, k: int, n: int, *, batch: int = 1,
                name: str = "") -> GemmCell:
    return GemmCell("matmul", m=m, k=k, n=n, batch=batch, name=name)


def attention_cells(*, batch: int, seq_q: int, seq_kv: int, d_model: int,
                    num_heads: int, num_kv_heads: int, head_dim: int,
                    causal: bool = True, window: int = 0,
                    name: str = "attn") -> list[GemmCell]:
    """A GQA attention layer as uniform GEMM cells.

    Projections are single large GEMMs over the flattened token dim; the
    score/context products are per-(batch*kv_head) cells.  ``causal`` halves
    the effective score/context work; a sliding ``window`` caps seq_kv —
    both folded into the *effective* k/n so the FLOP count matches what a
    masked flash kernel actually issues.
    """
    t = batch * seq_q
    cells = [
        matmul_cell(t, d_model, num_heads * head_dim, name=f"{name}_wq"),
        matmul_cell(t, d_model, num_kv_heads * head_dim, name=f"{name}_wk"),
        matmul_cell(t, d_model, num_kv_heads * head_dim, name=f"{name}_wv"),
    ]
    eff_kv = min(seq_kv, window) if window else seq_kv
    if causal and seq_q == seq_kv and not window:
        eff_kv = max(1, seq_kv // 2)  # average causal row length
    cells.append(GemmCell("attn_score", m=seq_q, k=head_dim, n=eff_kv,
                          batch=batch * num_heads, name=f"{name}_qk"))
    cells.append(GemmCell("attn_context", m=seq_q, k=eff_kv, n=head_dim,
                          batch=batch * num_heads, name=f"{name}_pv"))
    cells.append(matmul_cell(t, num_heads * head_dim, d_model,
                             name=f"{name}_wo"))
    return cells


def moe_cells(*, tokens: int, d_model: int, d_ff: int, n_experts: int,
              top_k: int, swiglu: bool = True,
              name: str = "moe") -> list[GemmCell]:
    """Top-k MoE FFN at perfect balance: each expert sees tokens*top_k/E."""
    per_expert = max(1, math.ceil(tokens * top_k / n_experts))
    n_in = 2 if swiglu else 1
    return (
        [GemmCell("matmul", m=tokens, k=d_model, n=n_experts,
                  name=f"{name}_router")]
        + [GemmCell("fc", m=per_expert, k=d_model, n=d_ff, batch=n_experts,
                    name=f"{name}_wi{i}") for i in range(n_in)]
        + [GemmCell("fc", m=per_expert, k=d_ff, n=d_model, batch=n_experts,
                    name=f"{name}_wo")]
    )


def ssm_cells(cfg, *, tokens: int, name: str = "ssm") -> list[GemmCell]:
    """The projection GEMMs of the attention-free mixers: the RWKV6
    time-mix + decay LoRA and channel-mix FFN (``family == "ssm"``), the
    Mamba2 in/out projections (``family == "hybrid"``), read off the
    layers' parameter specs (every 2-D spec but the depthwise conv taps is
    one ``x @ w`` through ``dense``)."""
    fam = getattr(cfg, "family", "")
    if fam == "ssm":
        from repro_torch.models.ssm import rwkv_channel_specs, rwkv_specs
        specs = {**rwkv_specs(cfg), **rwkv_channel_specs(cfg)}
    elif fam == "hybrid":
        from repro_torch.models.ssm import mamba_specs
        specs = mamba_specs(cfg)
    else:
        return []
    return [matmul_cell(tokens, s.shape[0], s.shape[1],
                        name=f"{name}_{pname}")
            for pname, s in specs.items()
            if len(s.shape) == 2 and "conv" not in pname]


def arch_cells(cfg, *, batch: int, seq_q: int, seq_kv: int | None = None,
               include_logits: bool = True, name: str = "") -> list[GemmCell]:
    """Lower one step of an architecture config to its unique GEMM cells:
    one representative layer's attention projections and score/context
    (skipped for attention-free archs), its mixer's projections, the FFN
    (dense or MoE), and optionally the logits matmul.  ``seq_q`` is tokens
    per sequence this step (1 for decode); ``seq_kv`` defaults to
    ``seq_q``."""
    seq_kv = seq_q if seq_kv is None else seq_kv
    t = batch * seq_q
    prefix = name or ("decode" if seq_q == 1 else "prefill")
    cells: list[GemmCell] = []
    if getattr(cfg, "num_heads", 0):
        window = getattr(cfg, "sliding_window", 0) or 0
        cells += attention_cells(
            batch=batch, seq_q=seq_q, seq_kv=seq_kv, d_model=cfg.d_model,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, causal=seq_q > 1, window=window,
            name=f"{prefix}_attn")
    cells += ssm_cells(cfg, tokens=t, name=f"{prefix}_ssm")
    if getattr(cfg, "num_experts", 0):
        cells += moe_cells(tokens=t, d_model=cfg.d_model,
                           d_ff=getattr(cfg, "moe_d_ff", 0) or cfg.d_ff,
                           n_experts=cfg.num_experts,
                           top_k=max(cfg.experts_per_token, 1),
                           swiglu=getattr(cfg, "mlp", "swiglu") == "swiglu",
                           name=f"{prefix}_moe")
    else:
        n_in = 2 if getattr(cfg, "mlp", "swiglu") == "swiglu" else 1
        cells += [matmul_cell(t, cfg.d_model, cfg.d_ff,
                              name=f"{prefix}_ffn_wi{i}") for i in range(n_in)]
        cells.append(matmul_cell(t, cfg.d_ff, cfg.d_model,
                                 name=f"{prefix}_ffn_wo"))
    if include_logits:
        cells.append(matmul_cell(t, cfg.d_model, cfg.vocab_size,
                                 name=f"{prefix}_logits"))
    return cells


# Cell kinds that run through kraken_gemm (ops.kraken_matmul) and so have a
# replayable tile plan; the score/context cells run in the attention
# kernels.
KRAKEN_GEMM_KINDS = ("conv", "fc", "matmul")


def tunable_cells(cells: list[GemmCell]) -> list[GemmCell]:
    return [c for c in cells if c.kind in KRAKEN_GEMM_KINDS]


def serving_cells(cfg, *, slots: int, prompt_len: int, cache_len: int,
                  prefill_batch: int = 1,
                  bucket_lens: list[int] | None = None) -> list[GemmCell]:
    """The serving work-list: one prefill per prompt-length bucket
    (``bucket_lens``; default just ``prompt_len``) at ``prefill_batch``
    sequences wide, and a ``slots``-wide one-token decode against a
    ``cache_len`` cache; only the cells ``kraken_gemm`` runs, deduplicated
    by (m, k, n) so that each unique cell is measured once."""
    lens = sorted(set(bucket_lens)) if bucket_lens else [prompt_len]
    cells: list[GemmCell] = []
    for blen in lens:
        cells += arch_cells(cfg, batch=prefill_batch, seq_q=blen,
                            name=f"prefill_{blen}")
    cells += arch_cells(cfg, batch=slots, seq_q=1, seq_kv=cache_len,
                        name="decode")
    return dedup_cells(tunable_cells(cells))


def dedup_cells(cells: list[GemmCell]) -> list[GemmCell]:
    """Keep the first cell of each unique GEMM shape (order-preserving)."""
    seen: set[tuple] = set()
    out = []
    for c in cells:
        key = (c.m, c.k, c.n)
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


# ---------------------------------------------------------------------------
# Execution: run a cell's op through the uniform kernel
# ---------------------------------------------------------------------------

def run_cell(cell: GemmCell, a, b, **kw):
    """``a @ b`` for a lowered cell through ``ops.kraken_matmul`` (the
    kernel on CUDA tensors, its plain version on CPU ones).

    ``a``: [m, k] (or [batch, m, k]); ``b``: [k, n] (or [batch, k, n]).
    The shapes are checked against the cell, so a lowering bug surfaces
    at the boundary."""
    import torch

    from repro_torch.kernels import ops
    if a.dim() == 3:
        if tuple(a.shape) != (cell.batch, cell.m, cell.k) or \
                tuple(b.shape) != (cell.batch, cell.k, cell.n):
            raise ValueError(f"{tuple(a.shape)} @ {tuple(b.shape)} for {cell}")
        return torch.stack([ops.kraken_matmul(x.contiguous(), y.contiguous(),
                                              **kw) for x, y in zip(a, b)])
    if tuple(a.shape) != (cell.m, cell.k) or tuple(b.shape) != (cell.k,
                                                                 cell.n):
        raise ValueError(f"{tuple(a.shape)} @ {tuple(b.shape)} for {cell}")
    return ops.kraken_matmul(a, b, **kw)


# ---------------------------------------------------------------------------
# Whole-layer summaries (napkin math)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CellReport:
    cell: GemmCell
    utilization: float

    @property
    def modeled_seconds_compute(self) -> float:
        """The cell's FLOPs at the bf16 peak times the plan's utilization."""
        return self.cell.flops / (PEAK_FLOPS * self.utilization)

    @property
    def modeled_seconds_memory(self) -> float:
        """The cell's bf16 operands, each moved once, at HBM's rate."""
        return self.cell.operand_words() * 2 / HBM_BW


def report(cells: list[GemmCell], sms: int = 132) -> list[CellReport]:
    """Each cell under the planner's own plan (never a cached or measured
    one: a reporting loop must not trigger measurement)."""
    return [CellReport(c, c.utilization(sms)) for c in cells]


def dominant_cell(cells: list[GemmCell]) -> GemmCell:
    return max(cells, key=lambda c: c.flops)
