"""The conv shapes ``kraken_conv2d_direct`` is checked and timed at.

``chip_smoke.py`` runs every one of them on the card (phases
``conv_kernels`` and ``conv_nets``) and ``tests/test_torch_conv_plan.py``
checks the kernel's plan for each on the CPU, so both read them from here.
"""

from __future__ import annotations

from repro_torch.core.networks import get_network

# every conv layer of the paper's three networks at their published widths
# (Table I), one layer at a time as in the paper's Table V, at batch 1 and 32
CONV_NETS = ("alexnet", "vgg16", "resnet50")
CONV_BATCHES = (1, 32)
CONV_R = 7   # output rows per band: the paper's R

# edge cases: (name, N, H, W, C_i, K, S, padding, C_o, R, out dtype or None)
CONV_EDGE = [
    ("R 1, VGG 3x3", 1, 28, 28, 64, 3, 1, ((1, 1), (1, 1)), 64, 1, None),
    ("R 3, ragged C_o 96", 2, 28, 28, 64, 3, 1, ((1, 1), (1, 1)), 96, 3,
     None),
    ("AlexNet conv1 at R 1", 1, 227, 227, 3, 11, 4, ((0, 0), (0, 0)), 96, 1,
     None),
    ("AlexNet conv1 at R 3, N 2", 2, 227, 227, 3, 11, 4, ((0, 0), (0, 0)), 96,
     3, None),
    ("(H + pads - K) % S != 0", 2, 30, 28, 16, 3, 2, ((1, 1), (1, 1)), 40, 7,
     None),
    ("N 3, odd OH 13", 3, 13, 13, 32, 3, 1, ((1, 1), (1, 1)), 64, 7, None),
    ("C_i 100: ragged chunk, C_o 72", 1, 14, 14, 100, 3, 1, ((1, 1), (1, 1)),
     72, 7, None),
    ("C_i 35: odd, 2-byte band fill", 2, 12, 12, 35, 3, 1, ((1, 1), (1, 1)),
     40, 7, None),
    ("asymmetric padding, K 5 S 3", 2, 20, 17, 24, 5, 3, ((1, 2), (0, 1)), 48,
     3, None),
    ("R 16, K 7 S 2, C_i 3", 1, 64, 64, 3, 7, 2, ((3, 3), (3, 3)), 64, 16,
     None),
    ("bf16 in, f32 out", 2, 14, 14, 64, 3, 1, ((1, 1), (1, 1)), 64, 7,
     "float32"),
    ("split over C_i at b1, VGG-16 conv5_1", 1, 14, 14, 512, 3, 1,
     ((1, 1), (1, 1)), 512, 7, None),
    ("7x7 maps, N 3", 3, 7, 7, 512, 3, 1, ((1, 1), (1, 1)), 512, 7, None),
    ("C_i 3 packed, K 11 S 4, padded", 1, 99, 99, 3, 11, 4, ((2, 2), (2, 2)),
     72, 7, None),
    ("C_i 3 packed, K 3 S 1", 2, 30, 30, 3, 3, 1, ((1, 1), (1, 1)), 64, 7,
     None),
]

# an Inf in the input reaches exactly the outputs whose window holds it:
# (name, N, H, W, C_i, K, S, padding, C_o, R); the input is random with
# x[0, H // 2, W // 2, 0] = Inf.  The packed cases are sized so that the
# H100's plan puts the Inf past the window of some outputs in its tile,
# where their lanes read it under zero weights
CONV_NONFINITE = [
    ("Inf input, C_i 3 packed, K 3 S 1", 32, 20, 20, 3, 3, 1,
     ((1, 1), (1, 1)), 64, 7),
    ("Inf input, C_i 3 packed, K 11 S 4", 4, 99, 99, 3, 11, 4,
     ((2, 2), (2, 2)), 64, 7),
    ("Inf input, C_i 64, K 3 S 1", 1, 14, 14, 64, 3, 1, ((1, 1), (1, 1)),
     64, 7),
]


def conv_geometries() -> list[tuple]:
    """Every distinct per-group conv geometry of the three networks, in
    network order: (net, layer, H, W, C_i / groups, K, S, padding,
    C_o / groups)."""
    seen, out = set(), []
    for net in CONV_NETS:
        for sp in get_network(net)["conv"]:
            geo = (sp.H, sp.W, sp.c_i_per_group, sp.K_H, sp.S_H,
                   (sp.pad_h, sp.pad_w), sp.c_o_per_group)
            if (net, geo) not in seen:
                seen.add((net, geo))
                out.append((net, sp.name) + geo)
    return out
