"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port runs each kernel's plain version (``repro_torch.kernels
.ref``); it must agree with the JAX kernel run in Pallas interpret mode on
the same numpy inputs.  The hand-written CUDA kernels themselves run only on
a card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them against
the plain versions there.  Also here: the fixed-shape scheme that stands in for JAX's
dropped out-of-range writes (the trash page), held against JAX's own pool
writes with sentinel table rows, padding rows and ``lengths == 0`` rows.
"""

import zlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.paged_attention import (paged_decode_attention as  # noqa: E402
                                           j_paged_decode_attention,
                                           use_paged_decode_mode)
from repro.models import layers as JL  # noqa: E402
from repro.serving import paged_kv as JP  # noqa: E402

from repro_torch import device as tdevice  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import kraken_gemm as tkg  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serving import paged_kv as TP  # noqa: E402

from test_torch_cuda import ring_pool  # noqa: E402  (the shared pool builder)

# float32 throughout; the sums are short (K <= 200, <= 64 cache entries), so
# the two frameworks' summation orders differ by a few ulps at most
TOL = dict(rtol=1e-5, atol=1e-5)
POS_EMPTY = -(2 ** 30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# kraken_gemm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 32, 24), (5, 13, 7), (37, 200, 123)])
@pytest.mark.parametrize("activation", [None, "relu", "silu", "gelu"])
@pytest.mark.parametrize("bias", [False, True])
def test_matmul_matches_pallas(shape, activation, bias):
    m, k, n = shape
    rng = np.random.default_rng(zlib.crc32(repr((shape, activation, bias)).encode()))
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    bv = rng.normal(size=(n,)).astype(np.float32) if bias else None
    want = np.asarray(jops.kraken_matmul(
        jnp.asarray(a), jnp.asarray(b),
        bias=None if bv is None else jnp.asarray(bv),
        activation=activation, use_pallas=True, interpret=True))
    got = ops.kraken_matmul(_t(a), _t(b), bias=None if bv is None else _t(bv),
                            activation=activation)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_matmul_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 17)[None, :]
    got = ref.matmul(x, torch.eye(17), activation="gelu")
    want = torch.nn.functional.gelu(x, approximate="tanh")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert (got - torch.nn.functional.gelu(x)).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# paged_decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_matches_pallas(window, quant):
    rng = np.random.default_rng(11 + window + 2 * quant)
    b, h, kvh, d, ps, mp = 4, 4, 2, 16, 4, 4
    q_pos = [9, 21, 6, 3]            # slot 1 wraps the 16-entry ring
    k, v, pos, table, ks, vs = ring_pool(rng, b=b, kvh=kvh, d=d, ps=ps, mp=mp,
                                     q_pos=q_pos, dead={2},
                                     sentinel_entry=(3, 0), quant=quant)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    qp = np.asarray(q_pos, np.int32)
    want = np.asarray(j_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        pos_pages=jnp.asarray(pos), page_table=jnp.asarray(table),
        q_pos=jnp.asarray(qp),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
        window=window, interpret=True))
    got = ops.kraken_paged_attention(
        _t(q), _t(k), _t(v), pos_pages=_t(pos), page_table=_t(table),
        q_pos=_t(qp), k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs), window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the all-dead slot gives exact zeros in both
    assert not got[2].any() and not want[2].any()


# ---------------------------------------------------------------------------
# dispatch, build and device rules
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tkg.kraken_gemm(a, torch.zeros((8, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(
            torch.zeros((1, 2, 4)), torch.zeros((2, 1, 2, 4)),
            torch.zeros((2, 1, 2, 4)),
            pos_pages=torch.zeros((2, 2), dtype=torch.int32),
            page_table=torch.zeros((1, 1), dtype=torch.int32),
            q_pos=torch.zeros((1,), dtype=torch.int32))


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert _build.library_path("kraken_gemm").name.startswith("kraken_gemm-")
    with pytest.raises(FileNotFoundError):
        _build.source("no_such_kernel")


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve(None)
    assert tdevice.resolve("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# out-of-range writes: the trash page against JAX's mode="drop"
# ---------------------------------------------------------------------------

CFG = SimpleNamespace(num_kv_heads=2, head_dim=8, kv_cache_dtype="")


def _pools(rng, *, n_slots=4, n_pages=9, ps=4, mp=2):
    """A JAX pool and its port twin with the same (random) contents;
    slot 3's table row is all sentinel."""
    table = np.full((n_slots, mp), n_pages, np.int32)
    table[:3] = rng.permutation(n_pages)[:3 * mp].reshape(3, mp)
    k = rng.normal(size=(n_pages, 2, ps, 8)).astype(np.float32)
    v = rng.normal(size=(n_pages, 2, ps, 8)).astype(np.float32)
    pos = rng.integers(0, 8, size=(n_pages, ps)).astype(np.int32)
    jpool = JL.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                            pos=jnp.asarray(pos), page_table=jnp.asarray(table))
    tpool = TP.make_pool(CFG, n_pages=n_pages, page_size=ps, max_pages=mp,
                         n_slots=n_slots, dtype=torch.float32, device="cpu")
    tpool.k[:n_pages] = _t(k)
    tpool.v[:n_pages] = _t(v)
    tpool.pos[:n_pages] = _t(pos)
    tpool.page_table.copy_(_t(table))
    return jpool, tpool


def _assert_pools_equal(jpool, tpool):
    n = tpool.n_pages
    for name in ("k", "v", "pos", "page_table"):
        got = getattr(tpool, name)
        got = got if name == "page_table" else got[:n]
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jpool, name)),
                                      err_msg=name)


def test_scatter_prefill_drops_like_jax():
    rng = np.random.default_rng(3)
    jpool, tpool = _pools(rng)
    bp, s = 5, 6
    k = rng.normal(size=(bp, 2, s, 8)).astype(np.float32)
    v = rng.normal(size=(bp, 2, s, 8)).astype(np.float32)
    # rows: a live slot, a wrapping chunk, a sentinel slot, padding (-1),
    # and a length-0 row
    slot_ids = np.asarray([0, 1, 3, -1, 2], np.int32)
    lengths = np.asarray([6, 6, 4, 6, 0], np.int32)
    starts = np.asarray([0, 5, 0, 0, 2], np.int32)
    jnew = JP.scatter_prefill(
        jpool, JL.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                          pos=jnp.zeros((s,), jnp.int32)),
        jnp.asarray(slot_ids), jnp.asarray(lengths), starts=jnp.asarray(starts))
    TP.scatter_prefill(tpool, TL.KVCache(k=_t(k), v=_t(v),
                                         pos=torch.zeros(s, dtype=torch.int32)),
                       _t(slot_ids), _t(lengths), starts=_t(starts))
    _assert_pools_equal(jnew, tpool)


def test_reset_and_copy_page_drop_like_jax():
    rng = np.random.default_rng(4)
    jpool, tpool = _pools(rng)
    ids = np.asarray([2, 9, 9, 5, 30], np.int32)       # sentinel + beyond
    jnew = JP.reset_pages(jpool, jnp.asarray(ids))
    TP.reset_pages(tpool, _t(ids))
    _assert_pools_equal(jnew, tpool)
    for src, dst, resume in ((3, 7, 5), (TP.COPY_NONE, TP.COPY_NONE, 0),
                             (9, 1, 4), (1, 9, 4)):
        args = [np.asarray([x], np.int32) for x in (src, dst, resume)]
        jnew = JP.copy_page(jnew, *map(jnp.asarray, args))
        TP.copy_page(tpool, *map(_t, args))
        _assert_pools_equal(jnew, tpool)


def test_paged_decode_drops_like_jax():
    """One decode write + attention through both packages: a live row, a
    row with lengths == 0 (its live table row must stay untouched), and a
    sentinel row (slot 3)."""
    rng = np.random.default_rng(5)
    jpool, tpool = _pools(rng)
    cfg = SimpleNamespace(num_kv_heads=2, head_dim=8, num_heads=4)
    q = rng.normal(size=(4, 4, 1, 8)).astype(np.float32)
    k = rng.normal(size=(4, 2, 1, 8)).astype(np.float32)
    v = rng.normal(size=(4, 2, 1, 8)).astype(np.float32)
    # every position reaches both pages of its slot's ring, so the kernel's
    # page-liveness skip and the plain gather see the same entries
    positions = np.asarray([[6], [5], [7], [5]], np.int32)
    lengths = np.asarray([1, 0, 1, 1], np.int32)
    with use_paged_decode_mode("interpret"):
        jout, jnew = JL._paged_decode(
            cfg, jpool, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            positions=jnp.asarray(positions), window=0,
            lengths=jnp.asarray(lengths))
    tout, tnew = TL._paged_decode(cfg, tpool, _t(q), _t(k), _t(v),
                                  positions=_t(positions), window=0,
                                  lengths=_t(lengths))
    _assert_pools_equal(jnew, tnew)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_gather_pool_view_clamps_like_jax():
    rng = np.random.default_rng(6)
    jpool, tpool = _pools(rng)
    want = JL._gather_pool_view(jpool, 4, 2, 8)
    got = TL._gather_pool_view(tpool, 4, 2, 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pool_carries_a_trash_page():
    pool = TP.make_pool(CFG, n_pages=5, page_size=4, max_pages=2, n_slots=3,
                        dtype=torch.float32, device="cpu")
    assert pool.k.shape[0] == 6 and pool.n_pages == 5
    assert (pool.page_table == 5).all() and (pool.pos == POS_EMPTY).all()
    int8 = SimpleNamespace(num_kv_heads=2, head_dim=8, kv_cache_dtype="int8")
    pool = TP.make_pool(int8, n_pages=5, page_size=4, max_pages=2, n_slots=3,
                        dtype=torch.float32, device="cpu")
    assert pool.quantized and pool.n_pages == 5
    assert pool.k.dtype == pool.v.dtype == torch.int8
    assert pool.k_scale.dtype == pool.v_scale.dtype == torch.float32
    assert tuple(pool.k.shape) == tuple(pool.v.shape) == (6, 2, 4, 8)
    assert tuple(pool.k_scale.shape) == tuple(pool.v_scale.shape) == (6, 2, 4)
    assert tuple(pool.pos.shape) == (6, 4)   # the trash page in every leaf
    assert (pool.page_table == 5).all() and (pool.pos == POS_EMPTY).all()
