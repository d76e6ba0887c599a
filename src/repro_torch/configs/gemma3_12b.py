"""gemma3-12b: [dense] 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144, 5:1 local:global, 128k [hf]."""

from repro_torch.configs.registry import GEMMA3_12B as CONFIG

__all__ = ["CONFIG"]
