"""The port's ``decode_attention`` and ``quantize_kv`` against the JAX
package's, on the CPU.

* The plain ``decode_attention`` (the CUDA kernel's plain version, which
  ``ops.kraken_decode_attention`` runs on CPU tensors) against JAX's Pallas
  ``decode_attention`` in interpret mode, on the rows that have a live
  entry, and against JAX's ``ref.decode_attention`` on every row: float32
  within 1e-5 (sums of at most 20 products, summed in another order), for
  float and int8 caches, shared and per-slot positions, a wrapped ring, a
  window and a ragged S that no KV block divides.
* A row with no live entry: the port gives exact zeros, as JAX's
  ``ref.decode_attention`` (its CPU path) does; the Pallas kernel's -1e30
  fill instead weighs every masked entry equally and averages V.  That
  difference is by design (ROADMAP Queue 3) and pinned here.
* ``quantize_kv`` bit for bit against JAX's, round-half-to-even ties,
  clipping and an all-zero row included.
* The CUDA wrapper refuses CPU tensors.  The kernel itself runs only on a
  card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it against
  the plain version there.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import quantize_kv as j_quantize_kv  # noqa: E402

from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
POS_EMPTY = -(2 ** 30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def dense_cache(rng, *, b, kvh, s, d, q_pos, empty_rows, shared, quant):
    """A dense numpy cache as decode leaves it: slot ``p % s`` holds
    position ``p`` for ``p <= q_pos[i]`` (a row whose q_pos passes s has
    wrapped its ring), every other slot empty; rows in ``empty_rows`` hold
    nothing.  ``shared``: one [S] position row for every slot instead.
    Returns (k, v, kv_pos, k_scale, v_scale)."""
    pos = np.full((b, s), POS_EMPTY, np.int32)
    for i in range(b):
        if i in empty_rows:
            continue
        for p in range(q_pos[i] + 1):
            pos[i, p % s] = p
    if shared:
        pos = pos[0]
    shape = (b, kvh, s, d)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) / 127).astype(np.float32)
        vs = (rng.random(shape[:3]) / 127).astype(np.float32)
        return k, v, pos, ks, vs
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return k, v, pos, None, None


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_matches_jax(quant, window, shared):
    rng = np.random.default_rng(zlib.crc32(repr((quant, window, shared)).encode()))
    b, h, kvh, s, d = 4, 4, 2, 20, 16
    # row 1 wraps the 20-slot ring; row 2 is empty (per-slot positions)
    q_pos = [11, 33, 6, 19] if not shared else [19, 19, 19, 19]
    empty = set() if shared else {2}
    k, v, pos, ks, vs = dense_cache(rng, b=b, kvh=kvh, s=s, d=d, q_pos=q_pos,
                                    empty_rows=empty, shared=shared,
                                    quant=quant)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    qp = np.asarray(q_pos, np.int32)
    jargs = dict(kv_pos=jnp.asarray(pos), q_pos=jnp.asarray(qp),
                 k_scale=None if ks is None else jnp.asarray(ks),
                 v_scale=None if vs is None else jnp.asarray(vs),
                 window=window)
    # block_s 8 leaves a ragged S = 20: three KV blocks, the last padded
    kernel = np.asarray(jops.kraken_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_s=8,
        use_pallas=True, interpret=True, **jargs))
    plain = np.asarray(jref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jargs))
    got = ops.kraken_decode_attention(
        _t(q), _t(k), _t(v), kv_pos=_t(pos), q_pos=_t(qp),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs), window=window).numpy()
    assert got.dtype == np.float32 and got.shape == (b, h, d)
    live = [i for i in range(b) if i not in empty]
    np.testing.assert_allclose(got[live], kernel[live], **TOL)
    np.testing.assert_allclose(got, plain, **TOL)
    for i in empty:
        # exact zeros in the port and in JAX's plain version; the Pallas
        # kernel averages V over the masked entries instead
        assert not got[i].any() and not plain[i].any()
        assert np.abs(kernel[i]).max() > 0.1


def test_scalar_q_pos_and_shared_positions_broadcast():
    rng = np.random.default_rng(1)
    k, v, pos, _, _ = dense_cache(rng, b=3, kvh=1, s=9, d=8, q_pos=[9] * 3,
                                  empty_rows=set(), shared=True, quant=False)
    q = rng.normal(size=(3, 2, 8)).astype(np.float32)
    want = np.asarray(jref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_pos=jnp.asarray(pos), q_pos=jnp.int32(7)))
    got = ref.decode_attention(_t(q), _t(k), _t(v), kv_pos=_t(pos),
                               q_pos=7).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _quant_inputs():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32) * 3.0
    # exact ties: amax 127 makes the scale 1.0, so x / scale lands on .5
    x[0, 0, 0] = np.linspace(-127.0, 127.0, 16)
    x[0, 0, 0, 1:15] = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5,
                                   4.5, 5.5, 6.5, 7.5, 8.5, 9.5, 10.5])
    x[0, 0, 1] = 0.0                         # all-zero row: the 1e-12 floor
    x[1, 2, 3] = 1e-20                       # below the floor
    x[1, 1] *= 1e6                           # large magnitudes
    return x


def test_quantize_kv_is_bit_equal_to_jax():
    x = _quant_inputs()
    jq, js = j_quantize_kv(jnp.asarray(x))
    tq, ts = ref.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    # half to even on the tie row, and the clip at +-127
    assert tq[0, 0, 0, 1:6].tolist() == [-2, -2, 0, 0, 2]
    assert tq.abs().max() == 127
    # the kernel module re-exports the same function
    assert tdec.quantize_kv is ref.quantize_kv


def test_quantize_kv_divides_by_the_scale():
    """x / scale and x * (1 / scale) round apart for some inputs: here
    2.2836976 over the scale of amax 3.6946445 is exactly 78.5 by division
    (78 after rounding half to even) and 78.50001 through the reciprocal
    (79).  The division is what JAX does."""
    x = np.zeros((1, 1, 1, 8), np.float32)
    x[0, 0, 0, :2] = [2.2836976051330566, 3.6946444511413574]
    tq, ts = ref.quantize_kv(_t(x))
    jq, _ = j_quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[0, 0, 0, 0] == 78
    recip = torch.round(_t(x) * (1.0 / ts)[..., None])
    assert recip[0, 0, 0, 0] == 79


def test_decode_attention_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention(
            torch.zeros((1, 2, 4)), torch.zeros((1, 1, 3, 4)),
            torch.zeros((1, 1, 3, 4)),
            kv_pos=torch.zeros((1, 3), dtype=torch.int32),
            q_pos=torch.zeros((1,), dtype=torch.int32))
