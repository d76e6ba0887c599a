"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built by
:mod:`._build`), their plain PyTorch versions (:mod:`.ref`) and the entry
points that dispatch between them (:mod:`.ops`)."""
