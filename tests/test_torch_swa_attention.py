"""The port's windowed attention against the JAX package's, on the CPU.

* The plain ``sliding_window_attention`` (the oracle of the hand-written
  ``swa_attention`` kernel) against JAX's Pallas ``swa_attention`` in
  interpret mode, on ``tests/test_kernels.py``'s cases (GQA, a window past
  S, window 1), float32 within 1e-5 (both sum in fp32, in another order),
  and one bf16 case: the Pallas kernel rounds its probabilities to bf16
  before the value product and the oracle does not, so the two differ by
  about one bf16 ulp (2^-8 relative); 2e-2 absolute is below what one extra
  key at the window edge moves.
* The port's ``_gqa_sdpa_chunked`` against JAX's at S 2048, 4096 (where
  the window slice is taken) and a ragged 2500, for windows 0, 8 and 1000,
  float32 within 1e-5; and ``_gqa_sdpa``'s dispatch by length.
* ``ops.swa_attention`` on CPU tensors runs the plain version; the kernel's
  wrapper refuses CPU tensors, a window below 1 and a head dim it does not
  take, before anything is built.
* The gradient: the plain ``sliding_window_attention_bwd`` (the oracle of
  the hand-written ``swa_attention_bwd`` kernel, which recomputes P from
  the forward's ``lse``) against ``jax.vjp`` of JAX's
  ``repro.kernels.ref.sliding_window_attention`` with the KV heads
  ``jnp.repeat``ed as ``repro.kernels.ops.swa_attention`` does, on the
  cases above and a ragged S, float32 within 1e-5; the same against torch
  autograd through the plain forward; the plain ``lse`` against a float64
  log-sum-exp; ``ops.swa_attention`` under grad on CPU tensors recording
  ``SwaAttention``, whose two halves are the plain versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import swa_attention as tsw  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

RNG = np.random.default_rng(0)


def _qkv(b, h, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,hkv,s,d,win,bq,bkv", [
    (1, 2, 2, 256, 64, 64, 128, 128),
    (2, 4, 2, 256, 64, 100, 64, 64),      # GQA via the index map
    (1, 8, 2, 512, 128, 4096, 128, 128),  # window > seq (plain causal)
    (1, 2, 1, 256, 64, 1, 64, 32),        # window 1 (diagonal only)
])
def test_plain_swa_matches_jax_pallas_interpret(b, h, hkv, s, d, win, bq,
                                                bkv):
    q, k, v = _qkv(b, h, hkv, s, d)
    want = jops.swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=win, use_pallas=True, interpret=True,
                              block_q=bq, block_kv=bkv)
    got = ref.sliding_window_attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_plain_swa_matches_jax_pallas_interpret_bf16():
    q, k, v = _qkv(2, 4, 2, 256, 64, seed=1)
    want = jops.swa_attention(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)),
                              window=16, use_pallas=True, interpret=True)
    got = ref.sliding_window_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        window=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("s", [2048, 4096, 2500])
@pytest.mark.parametrize("window", [0, 8, 1000])
def test_chunked_sdpa_matches_jax(s, window):
    q, k, v = _qkv(1, 4, 2, s, 16, seed=s + window)
    pos = np.arange(s, dtype=np.int32)
    want = JL._gqa_sdpa_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window,
                                q_pos=jnp.asarray(pos),
                                kv_pos=jnp.asarray(pos), causal=True)
    tpos = torch.from_numpy(pos)
    got = TL._gqa_sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window=window,
                               q_pos=tpos, kv_pos=tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the chunked form is exact attention: the direct form agrees
    direct = TL._gqa_sdpa_direct(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window=window,
                                 q_pos=tpos, kv_pos=tpos)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sdpa_dispatches_by_length(monkeypatch):
    calls = []
    real = TL._gqa_sdpa_chunked

    def spy(*args, **kw):
        calls.append(args[0].shape[2])
        return real(*args, **kw)

    monkeypatch.setattr(TL, "_gqa_sdpa_chunked", spy)
    for s in (2047, 2048):
        q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 1, s, 8))
        pos = torch.arange(s, dtype=torch.int32)
        TL._gqa_sdpa(q, k, v, window=0, q_pos=pos, kv_pos=pos)
    assert calls == [2048]


def test_ops_dispatch_on_cpu_runs_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 4, 2, 200, 40))
    before = tsw.launches
    got = ops.swa_attention(q, k, v, window=16)
    want = ref.sliding_window_attention(q, k, v, window=16)
    assert torch.equal(got, want) and tsw.launches == before


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA"), ("window", "window"), ("head dim", "head dim"),
    ("big head dim", "head dim"), ("gqa", "H % KV"),
])
def test_wrapper_refuses(case, match):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 128, 64))
    window = 16
    if case == "window":
        window = 0
    elif case == "head dim":
        q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 128, 60))
    elif case == "big head dim":
        q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 128, 264))
    elif case == "gqa":
        q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 3, 128, 64))
    with pytest.raises(ValueError, match=match):
        tsw.swa_attention(q, k, v, window=window)


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

# tests/test_kernels.py's swa cases (GQA, a window past S, window 1) and a
# ragged S with D 40: (B, H, KV, S, D, window)
BWD_CASES = [(1, 2, 2, 256, 64, 64), (2, 4, 2, 256, 64, 100),
             (1, 8, 2, 512, 128, 4096), (1, 2, 1, 256, 64, 1),
             (2, 6, 2, 200, 40, 16)]


def _bwd_inputs(b, h, hkv, s, d, seed):
    q, k, v = _qkv(b, h, hkv, s, d, seed=seed)
    dout = np.random.default_rng(seed + 1).normal(
        size=(b, h, s, d)).astype(np.float32)
    return q, k, v, dout


def _plain_bwd(q, k, v, dout, window):
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = ref.sliding_window_attention(tq, tk, tv, window=window,
                                            return_lse=True)
    return ref.sliding_window_attention_bwd(tq, tk, tv, out, tdo, lse,
                                            window=window)


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_bwd_matches_jax_vjp(case):
    b, h, hkv, s, d, win = case
    q, k, v, dout = _bwd_inputs(b, h, hkv, s, d, seed=sum(case))

    def jf(q, k, v):
        rep = h // hkv
        return jref.sliding_window_attention(
            q, jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1),
            window=win)
    _, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = _plain_bwd(q, k, v, dout, win)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_bwd_matches_autograd(case):
    b, h, hkv, s, d, win = case
    q, k, v, dout = _bwd_inputs(b, h, hkv, s, d, seed=sum(case) + 7)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ref.sliding_window_attention(*xs, window=win)
    want = torch.autograd.grad(out, xs, torch.from_numpy(dout))
    for g, w in zip(_plain_bwd(q, k, v, dout, win), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_lse_is_the_rows_log_sum_exp(case):
    b, h, hkv, s, d, win = case
    q, k, v = _qkv(b, h, hkv, s, d, seed=3)
    out, lse = ref.sliding_window_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), window=win,
        return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    assert torch.equal(out, ref.sliding_window_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), window=win))
    rep = h // hkv
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                       np.repeat(k, rep, axis=1).astype(np.float64)) / np.sqrt(d)
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    logits = np.where((j <= i) & (j > i - win), logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ops_under_grad_records_swa_attention_function():
    """On CPU tensors under grad, ``ops.swa_attention`` is
    ``SwaAttention``: the plain forward (same bits) and the plain backward
    (same bits as calling it on the saved lse), nothing launched; without
    grad the direct call."""
    q, k, v, dout = _bwd_inputs(2, 4, 2, 200, 40, seed=11)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = (tsw.launches, tsw.bwd_launches)
    out = ops.swa_attention(*xs, window=16)
    assert type(out.grad_fn).__name__ == "SwaAttentionBackward"
    assert torch.equal(out.detach(), ref.sliding_window_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), window=16))
    # a non-contiguous cotangent, as autograd may hand one
    ct = torch.from_numpy(np.ascontiguousarray(
        dout.transpose(0, 1, 3, 2))).transpose(2, 3)
    assert not ct.is_contiguous()
    got = torch.autograd.grad(out, xs, ct)
    for g, w in zip(got, _plain_bwd(q, k, v, dout, 16)):
        assert torch.equal(g, w)
    assert (tsw.launches, tsw.bwd_launches) == before
    with torch.no_grad():
        assert ops.swa_attention(*xs, window=16).grad_fn is None
