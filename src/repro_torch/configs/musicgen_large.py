"""musicgen-large: [audio] 48L d_model=2048 32H d_ff=8192 vocab=2048, decoder-only over EnCodec tokens [arXiv:2306.05284]."""

from repro_torch.configs.registry import MUSICGEN_LARGE as CONFIG

__all__ = ["CONFIG"]
