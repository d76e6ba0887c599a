"""yi-9b: [dense] 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 [arXiv:2403.04652]."""

from repro_torch.configs.registry import YI_9B as CONFIG

__all__ = ["CONFIG"]
