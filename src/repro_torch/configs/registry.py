"""--arch registry: the 10 assigned architectures (exact dims from the
assignment) plus the paper's own ASIC benchmark networks.

Sources per the assignment brackets; unverifiable upstream details (e.g.
exact MoE interleave) follow the cited model family's public config and are
noted inline.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig

# --- MoE -------------------------------------------------------------------

MIXTRAL_8X22B = ArchConfig(
    # [arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
    # vocab=32768, 8 experts top-2, SWA.
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    num_experts=8, experts_per_token=2, moe_interleave=1,
    sliding_window=4096,
    rope_theta=1e6,
    subquadratic=True,   # every layer is SWA -> bounded KV state
)

LLAMA4_MAVERICK = ArchConfig(
    # [hf:meta-llama/Llama-4; unverified] 48L d_model=5120 40H (GQA kv=8)
    # d_ff=8192, vocab=202048, MoE 128e top-1, shared expert, MoE every 2nd
    # layer (maverick-style interleave; gives ~400B total / ~17B active).
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192,             # assigned d_ff (dense interleave layers)
    moe_d_ff=8192,         # expert width
    vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_interleave=2,
    shared_expert=True,
    rope_theta=5e5,
)

# --- audio -------------------------------------------------------------------

MUSICGEN_LARGE = ArchConfig(
    # [arXiv:2306.05284; hf] 48L d_model=2048 32H (kv=32 -> MHA) d_ff=8192
    # vocab=2048; decoder-only over EnCodec tokens; frontend stubbed to
    # precomputed frame embeddings per the assignment.
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    norm="layernorm", mlp="gelu", positional="sinusoidal",
    frontend="audio_frames", num_frontend_tokens=0,
)

# --- dense -------------------------------------------------------------------

YI_9B = ArchConfig(
    # [arXiv:2403.04652; hf] llama-arch GQA.
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, rope_theta=1e4,
)

YI_6B = ArchConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, rope_theta=1e4,
)

CODEQWEN_7B = ArchConfig(
    # [hf:Qwen/CodeQwen1.5-7B] qwen1.5-arch: MHA with QKV bias.
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416, qkv_bias=True, rope_theta=1e6,
)

GEMMA3_12B = ArchConfig(
    # [hf:google/gemma-3; unverified] 5:1 local:global, local window 1024,
    # 128k design context.  48L = 8 periods of (5 local + 1 global).
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15360, vocab_size=262144,
    local_global_period=6, local_window=1024,
    rope_theta=1e6, tie_embeddings=True,
)

# --- ssm ---------------------------------------------------------------------

RWKV6_3B = ArchConfig(
    # [arXiv:2404.05892; hf] Finch: data-dependent decay; head size 64.
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=8960, vocab_size=65536,
    ssm_heads=40, ssm_state=64, positional="none_",
    subquadratic=True,
)

# --- hybrid -------------------------------------------------------------------

ZAMBA2_1P2B = ArchConfig(
    # [arXiv:2411.15242; hf] Mamba2 backbone + one weight-shared attention
    # block invoked every 6 mamba blocks. 38 slots -> 36 scanned + 2 tail.
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_heads=64, mamba_per_shared_attn=6, conv_kernel=4,
    subquadratic=True,   # mamba state O(1); shared-attn KV sharded (DESIGN §5)
)

# --- vlm ----------------------------------------------------------------------

LLAMA32_VISION_11B = ArchConfig(
    # [hf:meta-llama/Llama-3.2-11B-Vision; unverified] cross-attn image
    # layers every 5th layer; vision tower stubbed to precomputed patch
    # embeddings (1601 patches projected to d_model).
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    cross_attn_period=5, frontend="image_patches", num_frontend_tokens=1601,
    rope_theta=5e5,
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        MIXTRAL_8X22B, LLAMA4_MAVERICK, MUSICGEN_LARGE, YI_9B, CODEQWEN_7B,
        GEMMA3_12B, YI_6B, RWKV6_3B, ZAMBA2_1P2B, LLAMA32_VISION_11B,
    ]
}

# Aliases matching the assignment ids exactly.
ALIASES = {
    "mixtral-8x22b": "mixtral-8x22b",
    "llama4-maverick-400b-a17b": "llama4-maverick-400b-a17b",
    "musicgen-large": "musicgen-large",
    "yi-9b": "yi-9b",
    "codeqwen1.5-7b": "codeqwen1.5-7b",
    "gemma3-12b": "gemma3-12b",
    "yi-6b": "yi-6b",
    "rwkv6-3b": "rwkv6-3b",
    "zamba2-1.2b": "zamba2-1.2b",
    "llama-3.2-vision-11b": "llama-3.2-vision-11b",
}


def get_arch(name: str) -> ArchConfig:
    return ARCHS[ALIASES.get(name, name)]


# long_500k applicability (DESIGN.md §5).
LONG_CONTEXT_OK = {"rwkv6-3b", "zamba2-1.2b", "mixtral-8x22b"}
LONG_CONTEXT_SKIP_REASON = {
    "llama4-maverick-400b-a17b": "full attention layers; 524k >> design context",
    "musicgen-large": "pure full attention",
    "yi-9b": "pure full attention",
    "yi-6b": "pure full attention",
    "codeqwen1.5-7b": "pure full attention",
    "gemma3-12b": "1-in-6 global layers are full attention with 128k design limit",
    "llama-3.2-vision-11b": "full self-attention layers",
}
