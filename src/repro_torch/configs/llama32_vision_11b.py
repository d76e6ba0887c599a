"""llama-3.2-vision-11b: [vlm] 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, cross-attn image layers [hf]."""

from repro_torch.configs.registry import LLAMA32_VISION_11B as CONFIG

__all__ = ["CONFIG"]
