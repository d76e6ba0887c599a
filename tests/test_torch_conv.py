"""The port's conv path against the JAX package's, on the CPU.

* ``repro_torch.core.networks`` against ``repro.core.networks``: every
  ``LayerSpec`` field and derived count of the conv and fc tables of
  AlexNet, VGG-16 and ResNet-50 at batch 1 and 7, and ``total_macs`` /
  ``total_words``; the copied ``ceil_div`` / ``round_up``.
* ``interleave_input`` / ``shift_factor`` against JAX's, and the Table II
  invariant (band row ``r + kh // S_H``, sub-row ``kh % S_H`` of block
  ``l`` holds input row ``(l*R + r)*S_H + kh``).
* ``ops.kraken_conv2d_direct`` on CPU tensors (the plain ``ref.conv2d``)
  against JAX's Pallas ``kraken_conv2d_direct`` in interpret mode on the
  paper geometries of ``tests/test_kraken_conv.py``, float32 and bfloat16,
  R 2 and 7; ``ops.kraken_conv2d`` (im2col -> ``kraken_matmul``) against
  JAX's im2col route with its Pallas GEMM in interpret mode on the cases of
  ``tests/test_kernels.py``; every conv layer of the three networks, per
  group, with the spatial size cut, through both routes against JAX's
  ``ref.conv2d``.
* The refusals: the kernel's wrapper takes no CPU tensor, and a ``bco``
  that is no c_o tile of the card's kernel (64, 128) is refused on every
  device.

Tolerances: float32 1e-5 (both sides sum fp32 products, in another order;
the weights are scaled by 1/sqrt(fan-in), so outputs are O(1)); bfloat16
within one output ulp of JAX's bf16 (both sides sum the same bf16 products
in fp32 and round once, so they differ only where the two fp32 sums fall on
either side of a rounding boundary).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import elastic as jelastic  # noqa: E402
from repro.core import networks as jnet  # noqa: E402
from repro.kernels import kraken_conv as jkc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.core import elastic, networks  # noqa: E402
from repro_torch.kernels import kraken_conv as kc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

NETS = ("alexnet", "vgg16", "resnet50")
F32_TOL = 1e-5
# (n, h, w, ci, kh, kw, co, sh, sw, ph, pw): tests/test_kraken_conv.py's
# PAPER_GEOMETRIES, every (K, S) class of Table I
PAPER_GEOMETRIES = [
    (1, 35, 35, 3, 11, 11, 8, 4, 4, (0, 0), (0, 0)),   # alexnet conv1
    (1, 27, 27, 8, 5, 5, 12, 1, 1, (2, 2), (2, 2)),    # alexnet conv2
    (2, 14, 14, 8, 3, 3, 16, 1, 1, (1, 1), (1, 1)),    # vgg/resnet 3x3
    (1, 28, 28, 4, 7, 7, 8, 2, 2, (3, 3), (3, 3)),     # resnet conv1
    (1, 14, 14, 8, 1, 1, 12, 1, 1, (0, 0), (0, 0)),    # resnet 1x1
    (1, 16, 16, 8, 3, 3, 8, 2, 2, (1, 1), (1, 1)),     # strided 3x3
]
# tests/test_kernels.py's im2col cases
IM2COL_CASES = [
    dict(n=2, h=8, w=8, ci=3, co=5, k=3, s=1, p=1),
    dict(n=1, h=16, w=16, ci=4, co=8, k=5, s=2, p=2),
    dict(n=2, h=7, w=9, ci=2, co=4, k=1, s=1, p=0),
    dict(n=1, h=12, w=12, ci=3, co=7, k=7, s=2, p=3),
]
DERIVED = ("out_h", "out_w", "c_i_per_group", "c_o_per_group",
           "macs_with_zpad", "macs_valid", "m_x", "m_k", "m_y")


def _inputs(shape_x, shape_k, seed):
    """x ~ N(0, 1) and HWIO weights scaled by 1/sqrt(K_H K_W C_i)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape_x).astype(np.float32)
    k = (rng.normal(size=shape_k)
         / np.sqrt(np.prod(shape_k[:3]))).astype(np.float32)
    return x, k


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers (8 significant bits) at |v|."""
    _, e = np.frexp(np.abs(v).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def _assert_within_one_bf16_ulp(got: np.ndarray, want: np.ndarray):
    got, want = got.astype(np.float32), want.astype(np.float32)
    assert got.shape == want.shape
    lim = np.maximum(_bf16_ulp(got), _bf16_ulp(want))
    over = np.abs(got - want) - lim
    assert (over <= 0).all(), (np.abs(got - want).max(), over.max())


@pytest.mark.parametrize("batch", [1, 7])
@pytest.mark.parametrize("name", NETS)
def test_networks_match_jax(name, batch):
    mine, theirs = networks.get_network(name, batch), jnet.get_network(
        name, batch)
    for part in ("conv", "fc"):
        assert len(mine[part]) == len(theirs[part])
        for a, b in zip(mine[part], theirs[part]):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            for attr in DERIVED:
                assert getattr(a, attr) == getattr(b, attr), (a.name, attr)
        for valid in (True, False):
            assert networks.total_macs(mine[part], valid) == jnet.total_macs(
                theirs[part], valid)
        for which in ("x", "k", "y"):
            assert networks.total_words(mine[part], which) == \
                jnet.total_words(theirs[part], which)


def test_frame_launch_counts():
    """One kernel call per group and per repeat: 8, 13 and 53 per frame."""
    calls = {name: sum(sp.groups * sp.repeat
                       for sp in networks.get_network(name)["conv"])
             for name in NETS}
    assert calls == {"alexnet": 8, "vgg16": 13, "resnet50": 53}


def test_elastic_helpers_match_jax():
    for a in range(0, 70):
        for b in (1, 3, 8, 16, 64):
            assert elastic.ceil_div(a, b) == jelastic.ceil_div(a, b)
            assert elastic.round_up(a, b) == jelastic.round_up(a, b)


@pytest.mark.parametrize("R,k_h,s_h", [(4, 7, 2), (7, 11, 4), (2, 3, 1),
                                       (7, 1, 1), (3, 5, 3)])
def test_interleave_matches_jax(R, k_h, s_h):
    x = np.random.default_rng(0).normal(size=(2, 29, 5, 3)).astype(
        np.float32)
    got, L, oh = kc.interleave_input(torch.from_numpy(x), R=R, k_h=k_h,
                                     s_h=s_h)
    want, jL, joh = jkc.interleave_input(jnp.asarray(x), R=R, k_h=k_h,
                                         s_h=s_h)
    assert (L, oh) == (jL, joh)
    assert kc.shift_factor(k_h, s_h) == jkc.shift_factor(k_h, s_h)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_interleave_matches_table2():
    """Table II: band row r + kh//S_H, sub-row kh%S_H of block l holds
    input row (l*R + r)*S_H + kh (zero past H)."""
    R, KH, SH, H = 4, 7, 2, 40
    x = torch.arange(H, dtype=torch.float32)[None, :, None, None]
    x_hat, L, oh = kc.interleave_input(x, R=R, k_h=KH, s_h=SH)
    f = kc.shift_factor(KH, SH)
    assert tuple(x_hat.shape) == (L, R + f, SH, 1, 1)
    for l in range(L):
        for r in range(R):
            for kh in range(KH):
                row = (l * R + r) * SH + kh
                got = float(x_hat[l, r + kh // SH, kh % SH, 0, 0])
                assert got == (float(row) if row < H else 0.0), (l, r, kh)


@pytest.mark.parametrize("R", [2, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAPER_GEOMETRIES,
                         ids=[f"k{c[4]}s{c[7]}" for c in PAPER_GEOMETRIES])
def test_direct_conv_matches_jax_interpret(case, dtype, R):
    n, h, w, ci, kh, kw, co, sh, sw, ph, pw = case
    x, k = _inputs((n, h, w, ci), (kh, kw, ci, co), seed=len(dtype) + R)
    jdt = getattr(jnp, dtype)
    want = jkc.kraken_conv2d_direct(
        jnp.asarray(x, jdt), jnp.asarray(k, jdt), stride=(sh, sw),
        padding=(ph, pw), R=R, interpret=True)
    tdt = getattr(torch, dtype)
    before = kc.launches
    got = ops.kraken_conv2d_direct(
        torch.from_numpy(x).to(tdt), torch.from_numpy(k).to(tdt),
        stride=(sh, sw), padding=(ph, pw), R=R)
    assert kc.launches == before       # a CPU tensor runs the plain version
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        _assert_within_one_bf16_ulp(got.float().numpy(), want)


def test_direct_conv_out_dtype_matches_jax():
    """bf16 in, float32 out: one rounding of the fp32 sum, to float32."""
    x, k = _inputs((2, 14, 14, 8), (3, 3, 8, 16), seed=5)
    xb, kb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    want = jkc.kraken_conv2d_direct(xb, kb, padding=((1, 1), (1, 1)),
                                    out_dtype=jnp.float32, interpret=True)
    got = ops.kraken_conv2d_direct(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16(),
        padding=((1, 1), (1, 1)), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("c", IM2COL_CASES,
                         ids=[f"k{c['k']}s{c['s']}" for c in IM2COL_CASES])
def test_im2col_conv_matches_jax(c):
    x, k = _inputs((c["n"], c["h"], c["w"], c["ci"]),
                   (c["k"], c["k"], c["ci"], c["co"]), seed=c["k"])
    pad = ((c["p"], c["p"]), (c["p"], c["p"]))
    stride = (c["s"], c["s"])
    want = jops.kraken_conv2d(jnp.asarray(x), jnp.asarray(k), stride=stride,
                              padding=pad, use_pallas=True, interpret=True)
    got = ops.kraken_conv2d(torch.from_numpy(x), torch.from_numpy(k),
                            stride=stride, padding=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("name", NETS)
def test_network_conv_layers_match_jax(name):
    """Every conv layer of the network at its published channels, kernel,
    stride and padding, one call per group, the spatial size cut to at most
    15 x 15 (20 for AlexNet conv1's 11 x 11 kernel): the direct route and
    the im2col route against JAX's ``ref.conv2d``, float32."""
    for i, sp in enumerate(networks.get_network(name)["conv"]):
        hw = min(sp.H, max(15, sp.K_H + 9))
        cig, cog = sp.c_i_per_group, sp.c_o_per_group
        x, k = _inputs((1, hw, hw, sp.C_i), (sp.K_H, sp.K_W, cig, sp.C_o),
                       seed=i)
        kw = dict(stride=(sp.S_H, sp.S_W), padding=(sp.pad_h, sp.pad_w))
        for g in range(sp.groups):
            xg = np.ascontiguousarray(x[..., g * cig:(g + 1) * cig])
            kg = np.ascontiguousarray(k[..., g * cog:(g + 1) * cog])
            want = np.asarray(jref.conv2d(jnp.asarray(xg), jnp.asarray(kg),
                                          **kw))
            for route in (ops.kraken_conv2d_direct, ops.kraken_conv2d):
                got = route(torch.from_numpy(xg), torch.from_numpy(kg), **kw)
                np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                           atol=F32_TOL,
                                           err_msg=f"{sp.name} {route}")


def test_kernel_wrapper_refuses_cpu_tensors():
    x, k = torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kc.kraken_conv2d_direct(x, k)


@pytest.mark.parametrize("fn", [ops.kraken_conv2d_direct,
                                kc.kraken_conv2d_direct])
def test_bco_other_than_none_is_refused(fn):
    """``bco`` is the card's c_o tile: None, 64 or 128, nothing else."""
    x, k = torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8)
    for bco in (96, 256, 0):
        with pytest.raises(ValueError, match="output-channel tiles 64 and 128"):
            fn(x, k, bco=bco)


@pytest.mark.parametrize("kw,match", [
    (dict(R=0), "R = 0"), (dict(R=kc.MAX_R + 1), "output rows"),
    (dict(stride=(0, 1)), "stride"),
    (dict(padding=((0, -1), (0, 0))), "padding"),
])
def test_bad_arguments_are_refused(kw, match):
    x, k = torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8)
    with pytest.raises(ValueError, match=match):
        ops.kraken_conv2d_direct(x, k, **kw)


def test_mismatched_shapes_are_refused():
    with pytest.raises(ValueError, match="C_i"):
        ops.kraken_conv2d_direct(torch.zeros(1, 8, 8, 4),
                                 torch.zeros(3, 3, 5, 8))
    with pytest.raises(ValueError, match="does not fit"):
        ops.kraken_conv2d_direct(torch.zeros(1, 2, 8, 4),
                                 torch.zeros(3, 3, 4, 8))
