"""rwkv6-3b: [ssm] 32L d_model=2560 attn-free d_ff=8960 vocab=65536, Finch data-dependent decay [arXiv:2404.05892]."""

from repro_torch.configs.registry import RWKV6_3B as CONFIG

__all__ = ["CONFIG"]
