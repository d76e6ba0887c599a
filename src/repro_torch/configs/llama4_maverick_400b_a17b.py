"""llama4-maverick-400b-a17b: [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1, early fusion [hf]."""

from repro_torch.configs.registry import LLAMA4_MAVERICK as CONFIG

__all__ = ["CONFIG"]
