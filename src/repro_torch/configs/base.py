"""Architecture config schema + input-shape cells.

One ``ArchConfig`` per assigned architecture lives in its own module in this
package; ``repro_torch.configs.registry`` maps ``--arch`` ids to them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_interleave: int = 1        # every Nth layer is MoE (1 = every layer)
    shared_expert: bool = False
    moe_d_ff: int = 0              # 0 -> d_ff
    capacity_factor: float = 1.25

    # --- attention pattern ---------------------------------------------------
    sliding_window: int = 0        # 0 = full attention
    local_global_period: int = 0   # gemma3: 6 -> 5 local + 1 global per period
    local_window: int = 0          # window of the local layers
    qkv_bias: bool = False         # qwen1.5-style

    # --- ssm / hybrid --------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    mamba_per_shared_attn: int = 0   # zamba2: mamba blocks per shared-attn call
    conv_kernel: int = 4

    # --- frontends (stubs per assignment) ------------------------------------
    cross_attn_period: int = 0     # llama3.2-vision: 1 cross layer per period
    frontend: str = ""             # 'audio_frames' | 'image_patches' | ''
    num_frontend_tokens: int = 0

    # --- numerics / misc ------------------------------------------------------
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp: str = "swiglu"            # swiglu | gelu
    positional: str = "rope"       # rope | sinusoidal
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    kv_cache_dtype: str = ""       # "" = compute dtype | "int8" (Sec. II-D
                                   # quantization on the decode memory floor;
                                   # dequant fuses into the flash-decode
                                   # Pallas kernel)

    # --- applicability -------------------------------------------------------
    subquadratic: bool = False     # may run the long_500k cell

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.moe_d_ff == 0 and self.num_experts:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # Parameter-count helpers (used for the bound and the docs), counted from
    # the port's own spec tree: nothing is allocated.
    def param_count(self) -> int:
        from repro_torch.models.model import Model
        return sum(n for _, n in Model(self).param_numels())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k of the expert banks)."""
        if not self.num_experts:
            return self.param_count()
        from repro_torch.models.model import Model
        active = 0
        for path, n in Model(self).param_numels():
            routed = (("moe_wi" in path or "moe_wo" in path)
                      and "shared" not in path)
            if routed:
                n = n * self.experts_per_token // self.num_experts
            active += n
        return active


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests.

    Keeps the structural pattern (MoE interleave, local:global period,
    cross-attn period, shared-attn cadence) at one full period, shrinks all
    widths.
    """
    period = max(cfg.local_global_period, cfg.cross_attn_period,
                 cfg.moe_interleave, 1)
    mamba_cadence = 2 if cfg.mamba_per_shared_attn else 0
    return dataclasses.replace(
        cfg,
        num_layers=max(period, 4 if mamba_cadence else 2),
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128,
        moe_d_ff=128 if cfg.num_experts else 0,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        local_window=min(cfg.local_window, 8) if cfg.local_window else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.ssm_heads else 0,
        mamba_per_shared_attn=mamba_cadence,
        num_frontend_tokens=min(cfg.num_frontend_tokens, 8) if cfg.num_frontend_tokens else 0,
    )
