"""mixtral-8x22b: [moe] 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA [arXiv:2401.04088]."""

from repro_torch.configs.registry import MIXTRAL_8X22B as CONFIG

__all__ = ["CONFIG"]
