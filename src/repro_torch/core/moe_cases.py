"""The grouped-GEMM shapes ``grouped_moe_gemm`` is checked and timed at.

``chip_smoke.py`` runs them on the card (phase ``moe_kernels``), the card
tests hold the kernel to its plain version at each, and
``tests/test_torch_moe_plan.py`` checks the kernel's plan for each on the
CPU, so all three read them from here.
"""

from __future__ import annotations

# the grouped GEMM cases at mixtral-8x22b's and llama4-maverick's widths:
# (name, E, C, d, f, sizes, uses per MoE layer at decode)
MOE_CASES = [
    # 4 decode tokens top-2 at capacity 1: 6 of 8 experts live
    ("mixtral gate|up decode", 8, 1, 6144, 16384, [1, 0, 1, 1, 0, 1, 1, 1], 2),
    ("mixtral down decode", 8, 1, 16384, 6144, [1, 0, 1, 1, 0, 1, 1, 1], 1),
    # 256 mixed-step tokens top-2 at capacity 80: one expert empty, one
    # past capacity
    ("mixtral gate|up mixed", 8, 80, 6144, 16384,
     [80, 75, 64, 0, 70, 50, 100, 73], 0),
    ("mixtral down mixed", 8, 80, 16384, 6144,
     [80, 75, 64, 0, 70, 50, 100, 73], 0),
    ("mixtral all empty", 8, 1, 6144, 16384, [0] * 8, 0),
    # llama4 maverick: 4 decode tokens top-1 over 128 experts at capacity 1
    # (one size past it), 256 mixed-step tokens at capacity 2
    ("llama4 gate|up decode", 128, 1, 5120, 8192, "decode", 0),
    ("llama4 down decode", 128, 1, 8192, 5120, "decode", 0),
    ("llama4 gate|up mixed", 128, 2, 5120, 8192, "mixed", 0),
    ("llama4 down mixed", 128, 2, 8192, 5120, "mixed", 0),
]
# the expert FFN's calls per MoE layer at the mixed step (gate, up; down)
MIXED_USES = {"mixtral gate|up mixed": 2, "mixtral down mixed": 1}

# the plan's corners and the contract's edges, in bf16: (name, E, C, d, f,
# sizes, the value put in the dead capacity rows).  A single live expert at
# mixtral's decode widths leaves the grid under-filled, so the kernel splits
# d (2 or 3 ways) and the second kernel sums; C 130 takes two m tiles of
# 128, the second one partly live; a negative size counts as 0 and one past
# C as C; Inf in the dead rows must reach no output; d 13 and f 9 (and d 24
# at f 40, which TMA takes) are under one tile; d and f not multiples of 8
# take the tile route, as do more experts than the live table holds.
MOE_EDGE = [
    ("mixtral down decode, one live expert: split", 8, 1, 16384, 6144,
     [0, 0, 0, 1, 0, 0, 0, 0], 99.0),
    ("mixtral gate|up decode, one live expert: split", 8, 1, 6144, 16384,
     [0, 0, 0, 0, 0, 0, 0, 1], 99.0),
    ("C 130: a second m tile, partly live; Inf", 3, 130, 256, 384,
     [130, 129, 64], float("inf")),
    ("negative, past-C and empty sizes", 4, 70, 512, 256, [-3, 71, 0, 65],
     99.0),
    ("Inf in the dead rows", 4, 80, 512, 256, [80, 17, 0, 64],
     float("inf")),
    ("Inf in the dead rows at decode, split", 8, 1, 4096, 512,
     [1, 0, 0, 0, 0, 0, 0, 0], float("inf")),
    ("d 24, f 40: under one tile", 4, 8, 24, 40, [8, 0, 3, 9], 99.0),
    ("d 13, f 9: the tile route", 2, 5, 13, 9, [5, 2], 99.0),
    ("f 100: the tile route", 3, 70, 64, 100, [70, 0, 65], 99.0),
    ("all empty", 8, 80, 6144, 1024, [0] * 8, 99.0),
]


def moe_sizes(spec, e: int, seed: int = 0) -> list[int]:
    """A case's per-expert sizes: a literal list, or llama4's routing of 4
    decode tokens ("decode", one expert past capacity 1) or 256 mixed-step
    tokens ("mixed") top-1 over ``e`` experts."""
    import numpy as np
    if not isinstance(spec, str):
        return list(spec)
    rng = np.random.default_rng(seed)
    if spec == "decode":
        sizes = np.zeros(e, np.int64)
        live = rng.choice(e, 4, replace=False)
        sizes[live] = 1
        sizes[live[0]] = 2
        return sizes.tolist()
    return np.bincount(rng.integers(0, e, 256), minlength=e).tolist()
