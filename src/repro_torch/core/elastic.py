"""Integer helpers of ``repro.core.elastic``, copied so that the port does
not import the JAX package.

Only ``ceil_div`` and ``round_up`` are here.  The TPU tile planner of that
module (``choose_tiles`` and its VMEM budget) is not: the port's kernels
pick their own tiles, and a Hopper tile planner is later work.
"""

from __future__ import annotations


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b
