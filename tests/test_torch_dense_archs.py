"""The three other dense archs the port builds -- gemma3-12b (5 local
layers of window 8 and 1 global per period, tied embeddings), codeqwen1.5-7b
(QKV bias, full multi-head) and yi-9b -- against the JAX package, on the
CPU.

Both packages run the same float32 smoke parameters (``repro``'s own init,
bridged) on the same numpy tokens.  Float32 throughout at two to six layers:
XLA and PyTorch sum each product in another order (about 1e-6 relative), so
logits and losses agree within ``rtol = atol = 1e-4`` and greedy tokens are
identical.

* ``forward`` at S 7 and S 256.  At S 256 gemma3's local layers take the
  cache-less window route (``kernels.swa_attention``, S % 128 == 0) where
  JAX off the TPU runs ``_gqa_sdpa``; at S 2048 its global layer takes the
  chunked attention on both sides.
* ``prefill`` + ``decode_step`` against JAX's forward
  (``tests/test_serving.py``'s ``test_prefill_decode_matches_forward``).
* Greedy engine tokens identical to the JAX engine (chunk 4, two slots for
  four requests); gemma3's state tree holds a ring of 8 and one of 32.
* ``Model.loss`` against JAX's ``(total, ce, aux)``, with and without a
  mask.
* The tied unembed is transposed once, and again only after the embedding
  changes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving import CacheConfig as JCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedEngine as JPagedEngine  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.layers import DEFAULT_KERNELS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import CacheConfig, EngineConfig, PagedEngine  # noqa: E402

ARCHS = ["gemma3-12b", "codeqwen1.5-7b", "yi-9b"]
TOL = dict(rtol=1e-4, atol=1e-4)
_SETUP: dict = {}


def setup(arch):
    """(jax model, jax params, port model, port params) for the float32
    smoke config of ``arch``; the port's model counts its window-kernel
    calls in ``model.swa_calls``."""
    if arch not in _SETUP:
        jcfg = dataclasses.replace(jsmoke(jget_arch(arch)), dtype="float32")
        cfg = dataclasses.replace(smoke_config(get_arch(arch)),
                                  dtype="float32")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        jmodel = JModel(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        calls = []

        def swa(q, k, v, *, window):
            calls.append(q.shape[2])
            return ops.swa_attention(q, k, v, window=window)

        model = Model(cfg, kernels=DEFAULT_KERNELS._replace(swa_attention=swa))
        model.swa_calls = calls
        params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        _SETUP[arch] = (jmodel, jparams, model, params)
    return _SETUP[arch]


def tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("s", [7, 256])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, s):
    jmodel, jparams, model, params = setup(arch)
    toks = tokens(2, s)
    want, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    model.swa_calls.clear()
    got, _, aux = model.forward(params, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0
    # gemma3's 5 local layers take the window route at S % 128 == 0 only
    local = 5 if arch == "gemma3-12b" and s % 128 == 0 else 0
    assert model.swa_calls == [s] * local


def test_gemma3_long_forward_matches_jax():
    """S 2048: the global layer runs the chunked attention on both sides
    (JAX's local layers too; the port's take the window route)."""
    jmodel, jparams, model, params = setup("gemma3-12b")
    toks = tokens(1, 2048, seed=2)
    want, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    model.swa_calls.clear()
    got, _, _ = model.forward(params, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert model.swa_calls == [2048] * 5


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_jax_forward(arch):
    jmodel, jparams, model, params = setup(arch)
    b, s, s0 = 2, 12, 7
    toks = tokens(b, s, seed=3)
    full, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    full = np.asarray(full)
    caches = model.init_caches(b, 16, device="cpu")
    first, caches = model.prefill(params, {
        "tokens": torch.as_tensor(toks[:, :s0]),
        "positions": torch.arange(s0, dtype=torch.int32)}, caches)
    np.testing.assert_allclose(first[:, 0].numpy(), full[:, s0 - 1], **TOL)
    for t in range(s0, s):
        logits, caches = model.decode_step(
            params, caches, torch.as_tensor(toks[:, t:t + 1]),
            torch.full((b,), t, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), full[:, t], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_token_identical_to_jax(arch):
    jmodel, jparams, model, params = setup(arch)
    jeng = JPagedEngine(jmodel, jparams, config=JEngineConfig(
        slots=2, chunk=4, cache=JCacheConfig(page_size=4, max_len=32)))
    teng = PagedEngine(model, params, config=EngineConfig(
        slots=2, chunk=4, cache=CacheConfig(page_size=4, max_len=32)))
    rng = np.random.default_rng(7)
    for n in (3, 5, 9, 12):
        p = rng.integers(0, 256, (n,)).astype(np.int32)
        jeng.submit(p, 5)
        teng.submit(p, 5)
    want, got = jeng.run_until_idle(), teng.run_until_idle()
    assert len(got) == 4 and got == want
    # gemma3: one pool group per ring length (window 8, full 32)
    assert len(teng.allocators) == (2 if arch == "gemma3-12b" else 1)
    for alloc in teng.allocators.values():
        assert alloc.free_pages == alloc.n_pages
        alloc.check()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch, masked):
    jmodel, jparams, model, params = setup(arch)
    toks = tokens(2, 9, seed=4)
    labels = tokens(2, 9, seed=5)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    if masked:
        mask = (np.arange(9)[None, :] < np.array([[9], [4]])).astype(
            np.float32)
        jbatch["mask"] = jnp.asarray(mask)
        batch["mask"] = torch.as_tensor(mask)
    jtotal, jparts = jmodel.loss(jparams, jbatch)
    total, parts = model.loss(params, batch)
    for got, want in ((total, jtotal), (parts["ce"], jparts["ce"]),
                      (parts["aux"], jparts["aux"])):
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_tied_unembed_is_transposed_once():
    _, _, model, params = setup("gemma3-12b")
    assert model.cfg.tie_embeddings and "unembed" not in params
    embed = params["embed"].clone()
    p = dict(params, embed=embed)
    toks = {"tokens": torch.as_tensor(tokens(1, 5))}
    first, _, _ = model.forward(p, toks)
    w = model.tied_unembed(embed)
    second, _, _ = model.forward(p, toks)
    assert model.tied_unembed(embed) is w            # one copy, reused
    assert torch.equal(first, second)
    assert torch.equal(w, embed.T) and w.is_contiguous()
    embed.mul_(2.0)                                  # an in-place update
    w2 = model.tied_unembed(embed)
    assert w2 is not w and torch.equal(w2, embed.T)
    third, _, _ = model.forward(p, toks)
    assert not torch.allclose(third, first)
