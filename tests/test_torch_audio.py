"""The port's audio family, musicgen-large, against the JAX package, on the
CPU.

Smoke width, float32, the parameters bridged from ``repro``'s own init:
two layers of LayerNorm (gamma and beta), MHA without RoPE, the gelu MLP
with biases, sinusoidal positions, and seeded audio frames added to the
token embeddings.

* ``layer_norm``, ``sinusoidal_pos_emb`` at shared ``[S]`` and per-slot
  ``[B, S]`` positions and the gelu MLP against JAX's functions, within
  ``rtol = atol = 1e-4`` (float32); the embedding in bfloat16 adds the
  sinusoid after its cast and then the frames, as JAX's does.
* ``forward`` with and without frames, and ``prefill`` with ``[B, S]``
  frames + ``decode_step`` with ``[B, 1]`` frames a step: logits and every
  cache leaf.
* The engine (frames are the dense path's alone: serving is text-only, as
  JAX's) token-identical to JAX's ``PagedEngine`` and to the port's
  sequential path at chunk 4 and 8, and the serve CLI at smoke width.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.musicgen_large import CONFIG as JCONFIG  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.musicgen_large import CONFIG  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

from test_torch_dense_cache import sequential_greedy, setup_pair  # noqa: E402
from test_torch_features import check_clean, programs, prompts  # noqa: E402
from test_torch_vlm import (check_config_and_params, engine_pair,  # noqa: E402
                            forward_pair, frontend, prefill_decode_pair,
                            serve_cli, tokens)

ARCH = "musicgen-large"
TOL = dict(rtol=1e-4, atol=1e-4)


def _slot0(jparams, params):
    """Layer 0's parameters, JAX's and the port's."""
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["slots"][0])
    tp = {k: w[0] for k, w in params["stack"]["slots"][0].items()}
    return jp, tp


def test_config_and_param_tree_match():
    check_config_and_params(ARCH, JCONFIG, CONFIG, [
        "stack/slots[0]/attn_norm_beta", "stack/slots[0]/mlp_norm_beta",
        "final_norm_beta", "stack/slots[0]/mlp_wi", "stack/slots[0]/mlp_bi",
        "stack/slots[0]/mlp_wo", "stack/slots[0]/mlp_bo"])
    cfg = setup_pair(ARCH)[2].cfg
    assert (cfg.norm, cfg.mlp, cfg.positional, cfg.frontend) == (
        "layernorm", "gelu", "sinusoidal", "audio_frames")


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5)
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # apply_norm takes the beta leaf under cfg.norm == "layernorm"
    jmodel, jparams, model, params = setup_pair(ARCH)
    jp, tp = _slot0(jparams, params)
    tp = dict(tp, attn_norm_beta=torch.from_numpy(b),
              attn_norm_gamma=torch.from_numpy(g))
    jp = dict(jp, attn_norm_beta=jnp.asarray(b), attn_norm_gamma=jnp.asarray(g))
    np.testing.assert_allclose(
        TL.apply_norm(model.cfg, tp, "attn_norm", torch.from_numpy(x)).numpy(),
        np.asarray(JL.apply_norm(jmodel.cfg, jp, "attn_norm",
                                 jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("shape", [(37,), (3, 9)], ids=["[S]", "[B, S]"])
def test_sinusoidal_pos_emb_matches_jax(shape):
    """Positions up to the card's serve ring (512).  XLA's and PyTorch's
    float32 ``exp`` round about one frequency in ten apart by an ulp (at
    most 6e-8 below 1), which moves the angle at position p by up to
    p * 6e-8: 3e-5 at 512, inside the tolerance; at a few thousand it is
    not, in either package against the exactly rounded value."""
    pos = np.random.default_rng(1).integers(0, 512, shape).astype(np.int32)
    want = JL.sinusoidal_pos_emb(jnp.asarray(pos), 2048)
    got = TL.sinusoidal_pos_emb(torch.from_numpy(pos), 2048)
    assert got.shape == shape + (2048,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gelu_mlp_matches_jax():
    """``mlp_wi`` + ``mlp_bi`` through the GEMM's bias and tanh-gelu
    epilogue, then ``mlp_wo`` + ``mlp_bo``; the biases seeded nonzero."""
    jmodel, jparams, model, params = setup_pair(ARCH)
    jp, tp = _slot0(jparams, params)
    rng = np.random.default_rng(2)
    for name in ("mlp_bi", "mlp_bo"):
        b = rng.standard_normal(tuple(tp[name].shape)).astype(np.float32)
        jp, tp = dict(jp, **{name: jnp.asarray(b)}), dict(
            tp, **{name: torch.from_numpy(b)})
    x = frontend(model.cfg, 2, 5, 3)
    want = JL.mlp(jmodel.cfg, jp, "mlp", jnp.asarray(x))
    got = TL.mlp(model.cfg, tp, "mlp", torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding_order_in_bfloat16():
    """Token embedding, plus the fp32 sinusoid cast to bf16, plus the
    frames cast to bf16, in JAX's order: the same bits as JAX's ``_embed``
    at shared and per-slot positions."""
    import dataclasses
    from repro.models.model import Model as JModel
    from repro_torch.models.model import Model
    jmodel, jparams, model, _ = setup_pair(ARCH)
    jm = JModel(dataclasses.replace(jmodel.cfg, dtype="bfloat16"))
    tm = Model(dataclasses.replace(model.cfg, dtype="bfloat16"))
    emb = np.asarray(jparams["embed"], np.float32)
    jp = {"embed": jnp.asarray(emb, jnp.bfloat16)}
    tp = params_from_numpy({"embed": emb}, device="cpu",
                           dtype=torch.bfloat16)
    toks = tokens((2, 6), 4)
    fe = frontend(model.cfg, 2, 6, 5)
    for pos in (np.arange(6, dtype=np.int32),
                np.asarray([[0, 1, 2, 3, 4, 5], [40, 41, 42, 43, 44, 45]],
                           np.int32)):
        want = jm._embed(jp, jnp.asarray(toks), jnp.asarray(pos),
                         jnp.asarray(fe))
        got = tm._embed(tp, torch.from_numpy(toks), torch.from_numpy(pos),
                        torch.from_numpy(fe))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("frames", [True, False])
def test_forward_matches_jax(frames):
    cfg = setup_pair(ARCH)[2].cfg
    fe = frontend(cfg, 2, 9, 6) if frames else None
    got, want = forward_pair(ARCH, tokens((2, 9), 9), fe)
    np.testing.assert_allclose(got, want, **TOL)
    if frames:
        plain, _ = forward_pair(ARCH, tokens((2, 9), 9), None)
        assert np.abs(plain - got).max() > 1e-3


def test_prefill_and_decode_with_frames_match():
    """Frames [2, 6, d] added during the prefill and [2, 1, d] at each
    decode step: logits and every KV cache leaf agree with JAX's."""
    cfg = setup_pair(ARCH)[2].cfg
    steps = [frontend(cfg, 2, 1, 20 + i) for i in range(3)]
    prefill_decode_pair(ARCH, frontend(cfg, 2, 6, 7), steps)


@pytest.mark.parametrize("chunk", [4, 8])
def test_engine_token_identical_to_jax(chunk):
    jeng, teng = engine_pair(ARCH, chunk)
    work = prompts([3, 5, 9, 12])
    for p in work:
        jeng.submit(p, 5)
        teng.submit(p, 5)
    want, got = jeng.run_until_idle(), teng.run_until_idle()
    assert len(got) == 4 and got == want
    _, _, model, params = setup_pair(ARCH)
    assert [got[i] for i in range(4)] == [
        sequential_greedy(model, params, p, 5) for p in work]
    assert programs(teng) == (1, 1, 1) and not teng.state.has_rows
    check_clean(teng)


def test_serve_cli_on_cpu():
    serve_cli(ARCH)
