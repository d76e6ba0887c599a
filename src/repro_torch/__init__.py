"""PyTorch/CUDA port of ``repro``: the same modules under the same names,
run on an NVIDIA GPU, with every Pallas TPU kernel on the ported path
rewritten by hand in CUDA C++ for Hopper (``csrc/``).

This package imports ``torch`` and ``numpy`` and never ``jax`` or ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA without a device raises.
"""
