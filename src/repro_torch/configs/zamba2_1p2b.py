"""zamba2-1.2b: [hybrid] 38L d_model=2048 32H d_ff=8192 vocab=32000 ssm_state=64, Mamba2 + shared attn [arXiv:2411.15242]."""

from repro_torch.configs.registry import ZAMBA2_1P2B as CONFIG

__all__ = ["CONFIG"]
