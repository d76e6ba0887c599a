"""codeqwen1.5-7b: [dense] 32L d_model=4096 32H d_ff=13440 vocab=92416, qwen1.5-arch [hf]."""

from repro_torch.configs.registry import CODEQWEN_7B as CONFIG

__all__ = ["CONFIG"]
