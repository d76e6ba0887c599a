"""The port's dense-cache path (``init_caches`` + ``prefill`` +
``decode_step``, the sequential serving path and the engine's oracle)
against the JAX package's, on the CPU.

Both packages run the same float32 smoke parameters (``repro``'s own init,
bridged) on the same tokens: two rows prefill a 12-token prompt, then
decode at their own positions (row 1 skips every other position, so the
two rows write different ring slots).  After every step the logits agree
within ``rtol = atol = 1e-4`` (float32, two layers; XLA and PyTorch sum
each product in another order, about 1e-6 relative), and so do the cache
leaves: positions exactly, K/V and scales within the same tolerance, and
int8 K/V exactly.  The JAX decode of an int8 cache runs its Pallas
``decode_attention`` in interpret mode (``ops.kraken_decode_attention``
with ``interpret=True``); every row there has live entries, where the two
agree.

Cases: yi-6b with float and int8 caches, with a cache longer and one
shorter than the positions (the ring wraps); mixtral (window 8) with
``cache_len`` 16 below the positions, as ``examples/long_context.py`` runs
it, in float and int8.  The port keeps one cache per layer (JAX's
``flat=True`` layout), so the JAX caches are built flat and compared leaf
by leaf.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
_SETUP: dict = {}


def setup_pair(arch, kv_dtype=""):
    """(jax model, jax params, port model, port params): the float32 smoke
    config of ``arch`` with ``kv_cache_dtype=kv_dtype``."""
    key = (arch, kv_dtype)
    if key not in _SETUP:
        kw = dict(dtype="float32", kv_cache_dtype=kv_dtype)
        jmodel = JModel(dataclasses.replace(jsmoke(jget_arch(arch)), **kw))
        model = Model(dataclasses.replace(smoke_config(get_arch(arch)), **kw))
        jparams = jmodel.init(jax.random.key(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        _SETUP[key] = (jmodel, jparams, model, params)
    return _SETUP[key]


def sequential_greedy(model, params, prompt, max_new, cache_len=32):
    """The port's per-request reference: prefill + per-slot decode over a
    dense cache, greedy (``tests/test_serving_engine.py``'s
    ``sequential_greedy``)."""
    caches = model.init_caches(1, cache_len, device="cpu")
    logits, caches = model.prefill(
        params, {"tokens": torch.as_tensor(prompt[None]),
                 "positions": torch.arange(len(prompt), dtype=torch.int32)},
        caches)
    seq = [int(torch.argmax(logits[0, -1]))]
    while len(seq) < max_new:
        pos = torch.full((1,), len(prompt) + len(seq) - 1, dtype=torch.int32)
        logits, caches = model.decode_step(
            params, caches, torch.tensor([[seq[-1]]], dtype=torch.int32), pos)
        seq.append(int(torch.argmax(logits[0])))
    return seq


def _jax_leaves(caches):
    return jax.tree.leaves(caches)


def _port_leaves(caches):
    """The port's cache tensors in ``jax.tree.leaves`` order (KVCache
    fields k, v, pos, k_scale, v_scale; dicts by sorted key)."""
    if isinstance(caches, dict):
        return [x for k in sorted(caches) for x in _port_leaves(caches[k])]
    if isinstance(caches, list):
        return [x for c in caches for x in _port_leaves(c)]
    return [t for t in (caches.k, caches.v, caches.pos, caches.k_scale,
                        caches.v_scale) if t is not None]


def _assert_caches_match(jcaches, tcaches):
    want, got = _jax_leaves(jcaches), _port_leaves(tcaches)
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape and str(g.dtype).endswith(str(w.dtype))
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, **TOL)


# positions reach 30: a 16-slot cache wraps its ring (mixtral's window-8
# ring wraps at any cache_len)
CASES = {
    # name: (arch, kv_cache_dtype, cache_len)
    "yi-fp": ("yi-6b", "", 32),
    "yi-int8": ("yi-6b", "int8", 32),
    "yi-int8-wraps": ("yi-6b", "int8", 16),
    "yi-fp-wraps": ("yi-6b", "", 16),
    "mixtral-fp-long-context": ("mixtral-8x22b", "", 16),
    "mixtral-int8-long-context": ("mixtral-8x22b", "int8", 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_jax(case, monkeypatch):
    arch, kv_dtype, cache_len = CASES[case]
    jmodel, jparams, model, params = setup_pair(arch, kv_dtype)
    b, s, steps = 2, 12, 10
    rng = np.random.default_rng(len(case))
    tokens = rng.integers(0, model.cfg.vocab_size, (b, s)).astype(np.int32)
    positions = np.arange(s, dtype=np.int32)
    jcaches = jmodel.init_caches(b, cache_len, flat=True)
    tcaches = model.init_caches(b, cache_len, device="cpu")
    _assert_caches_match(jcaches, tcaches)
    jlog, jcaches = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(tokens),
                  "positions": jnp.asarray(positions)}, jcaches)
    tlog, tcaches = model.prefill(
        params, {"tokens": torch.from_numpy(tokens),
                 "positions": torch.from_numpy(positions)}, tcaches)
    assert tuple(tlog.shape) == (b, 1, model.cfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_caches_match(jcaches, tcaches)

    # the JAX int8 decode through its Pallas kernel, in interpret mode
    monkeypatch.setattr(jops, "kraken_decode_attention", functools.partial(
        jops.kraken_decode_attention, interpret=True))
    for t in range(steps):
        tok = rng.integers(0, model.cfg.vocab_size, (b, 1)).astype(np.int32)
        pos = np.asarray([s + t, s + 2 * t], np.int32)
        jlog, jcaches = jmodel.decode_step(
            jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        tlog, tcaches = model.decode_step(
            params, tcaches, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _assert_caches_match(jcaches, tcaches)


def test_int8_decode_goes_through_the_kernel_entry_point():
    """The int8 dense decode calls ``Kernels.decode_attention`` once per
    layer per step (on the card: the hand-written kernel); a float cache
    never does (its decode is plain attention, as in JAX)."""
    for kv_dtype, want in (("int8", 2), ("", 0)):
        _, _, model, params = setup_pair("yi-6b", kv_dtype)
        calls = []

        def counting(*a, **kw):
            calls.append(1)
            return ops.kraken_decode_attention(*a, **kw)

        counted = Model(model.cfg, kernels=TL.DEFAULT_KERNELS._replace(
            decode_attention=counting))
        caches = counted.init_caches(1, 16, device="cpu")
        counted.prefill(params, {"tokens": torch.zeros((1, 3), dtype=torch.int32),
                                 "positions": torch.arange(3)}, caches)
        assert not calls
        counted.decode_step(params, caches, torch.zeros((1, 1), dtype=torch.int32),
                            torch.tensor([3], dtype=torch.int32))
        assert len(calls) == want == 2 * bool(kv_dtype)


def test_init_caches_int8_leaves_and_window_ring():
    _, _, model, _ = setup_pair("yi-6b", "int8")
    cfg = model.cfg
    caches = model.init_caches(2, 16, device="cpu")   # one cache per layer
    assert len(caches["slots"][0]) == cfg.num_layers
    for c in caches["slots"][0]:
        assert c.k.dtype == c.v.dtype == torch.int8
        assert tuple(c.k.shape) == (2, cfg.num_kv_heads, 16, cfg.head_dim)
        assert tuple(c.k_scale.shape) == (2, cfg.num_kv_heads, 16)
        assert c.quantized and c.v_scale.dtype == torch.float32
        assert (c.pos == TL.POS_EMPTY).all()
    # a window layer keeps a ring of min(window, cache_len) slots
    _, _, mix, _ = setup_pair("mixtral-8x22b")
    w = mix.cfg.sliding_window
    assert mix.init_caches(1, 32, device="cpu")["slots"][0][0].k.shape[2] == w
    assert mix.init_caches(1, w - 3, device="cpu")[
        "slots"][0][0].k.shape[2] == w - 3


def test_int8_prefill_attends_over_the_raw_kv():
    """Prefill attends over the prompt's raw K/V and only stores the
    quantized copy, so its logits do not depend on the cache dtype; the
    decode after it attends over the quantized cache (its own new token
    included), so there they do."""
    _, _, fp_model, params = setup_pair("yi-6b", "")
    _, _, q_model, _ = setup_pair("yi-6b", "int8")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, fp_model.cfg.vocab_size, (2, 9)).astype(np.int32))
    outs = []
    for model in (fp_model, q_model):
        caches = model.init_caches(2, 16, device="cpu")
        pre, caches = model.prefill(params, {"tokens": tokens,
                                             "positions": torch.arange(9)},
                                    caches)
        dec, _ = model.decode_step(params, caches, tokens[:, :1],
                                   torch.tensor([9, 9], dtype=torch.int32))
        outs.append((pre, dec))
    assert torch.equal(outs[0][0], outs[1][0])
    assert (outs[0][1] - outs[1][1]).abs().max() > 1e-4
