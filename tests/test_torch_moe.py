"""The port's MoE path against the JAX package's, on the CPU.

* The plain ``grouped_moe_gemm`` (the CUDA kernel's plain version) against
  JAX's Pallas ``grouped_moe_gemm`` in interpret mode: float32 within
  1e-5 (sums of at most 40 products, summed in another order), int8 ->
  int32 exactly; rows ``>= sizes`` exactly zero, empty experts, ``sizes >
  C`` and garbage in the dead capacity rows included.
* ``moe_block`` against JAX's for the mixtral (top-2, renormalised) and
  llama4 (top-1, shared expert) smoke configs, JAX under both of its expert
  GEMM modes: y within 1e-5, the aux loss within 1e-6, and the same tokens
  dropped at capacity.
* Whole-model ``chunk_step`` / ``decode_step`` on the float32 MoE smoke
  configs: logits within 1e-4 (as ``test_torch_model.py``), greedy tokens
  identical, pool positions identical and K/V within 1e-4 at every live
  position.
* The port's engine against JAX's on mixtral smoke (window 8, so the 8-token
  ring wraps) at the default ``capacity_factor``, so that decode steps drop
  tokens: identical tokens for chunk None and 4, three programs, no new
  signature when warm.  JAX decodes through its Pallas paged-attention
  kernel in interpret mode there: its CPU-default dense-gather reference
  lets an idle slot attend to the clamped page, while the kernel and the
  port give it zeros -- and an idle row's routing takes expert capacity, so
  with MoE that difference could reach live tokens.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.kernels import kraken_moe_gemm as JMG  # noqa: E402
from repro.kernels.paged_attention import use_paged_decode_mode  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving import CacheConfig as JCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedEngine as JPagedEngine  # noqa: E402
from repro.serving.state import build_state_tree as jbuild  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.kernels import kraken_moe_gemm as tmg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import CacheConfig, EngineConfig, PagedEngine  # noqa: E402
from repro_torch.serving.state import build_state_tree  # noqa: E402

MOE_ARCHS = ("mixtral-8x22b", "llama4-maverick-400b-a17b")
GEMM_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
_SETUP: dict = {}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# grouped_moe_gemm
# ---------------------------------------------------------------------------

# (E, C, d, f, sizes): skewed with an empty expert, one size past C, all
# empty, and ragged widths
GEMM_CASES = {
    "skewed": (4, 8, 24, 40, [8, 0, 3, 1]),
    "size_past_capacity": (3, 5, 16, 24, [9, 2, 0]),
    "all_empty": (4, 6, 16, 16, [0, 0, 0, 0]),
    "ragged": (2, 7, 13, 9, [7, 4]),
}


def _gemm_operands(case, dtype, seed=0):
    e, c, d, f, sizes = GEMM_CASES[case]
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        xs = rng.integers(-128, 128, (e, c, d)).astype(np.int8)
        w = rng.integers(-128, 128, (e, d, f)).astype(np.int8)
        garbage = 99
    else:
        xs = rng.normal(size=(e, c, d)).astype(np.float32)
        w = rng.normal(size=(e, d, f)).astype(np.float32)
        garbage = 1e6
    for i, s in enumerate(sizes):        # the kernel must mask, not rely on
        xs[i, min(s, c):] = garbage      # zeros in the dead capacity rows
    return xs, w, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_grouped_gemm_matches_pallas(case, dtype):
    xs, w, sizes = _gemm_operands(case, dtype)
    want = np.asarray(JMG.grouped_moe_gemm(jnp.asarray(xs), jnp.asarray(w),
                                           jnp.asarray(sizes),
                                           interpret=True))
    got = ref.grouped_moe_gemm(_t(xs), _t(w), _t(sizes)).numpy()
    c = xs.shape[1]
    for i, s in enumerate(sizes):
        assert not got[i, min(s, c):].any()      # dead rows exactly zero
    if dtype == "int8":
        assert got.dtype == np.int32 == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, **GEMM_TOL)


def test_grouped_expert_ffn_matches_pallas():
    rng = np.random.default_rng(2)
    e, c, d, f = 4, 8, 16, 24
    buf = rng.normal(size=(e, c, d)).astype(np.float32)
    ws = [rng.normal(size=s).astype(np.float32) / 4
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    sizes = np.asarray([8, 0, 3, 1], np.int32)
    want = JMG.grouped_expert_ffn(jnp.asarray(buf), jnp.asarray(sizes),
                                  *map(jnp.asarray, ws), mode="interpret")
    got = ops.grouped_expert_ffn(_t(buf), _t(sizes), *map(_t, ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


def test_grouped_gemm_wrapper_refuses_cpu_tensors():
    xs, w, sizes = _gemm_operands("skewed", "float32")
    with pytest.raises(ValueError, match="CUDA"):
        tmg.grouped_moe_gemm(_t(xs), _t(w), _t(sizes))


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

def _cfg_pair(arch, **kw):
    jcfg = dataclasses.replace(jsmoke(jget_arch(arch)), dtype="float32", **kw)
    cfg = dataclasses.replace(smoke_config(get_arch(arch)), dtype="float32",
                              **kw)
    return jcfg, cfg


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("mode", ["interpret", "reference"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_jax(arch, mode, capacity_factor):
    jcfg, cfg = _cfg_pair(arch, capacity_factor=capacity_factor)
    rng = np.random.default_rng(3)
    params = {k: (0.1 * rng.normal(size=s.shape)).astype(np.float32)
              for k, s in TMOE.moe_specs(cfg, "moe").items()}
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    with JMG.use_moe_gemm_mode(mode):
        want = jax.jit(lambda p, xi: JMOE.moe_block(jcfg, p, "moe", xi))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tparams = {k: _t(v) for k, v in params.items()}
    got = TMOE.moe_block(cfg, tparams, "moe", _t(x))
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), **GEMM_TOL)
    np.testing.assert_allclose(got.aux_loss.numpy(), np.asarray(want.aux_loss),
                               rtol=1e-6, atol=1e-6)
    # the same tokens were kept, in the same capacity slots
    xt = x.reshape(-1, cfg.d_model)
    jbuf, (jlin, jkeep, _), _, jsizes = JMOE._route_and_dispatch(
        jcfg, jnp.asarray(params["moe_router"]), jnp.asarray(xt))
    tbuf, (tlin, tkeep, _), _, tsizes = TMOE._route_and_dispatch(
        cfg, tparams["moe_router"], _t(xt))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tlin.numpy(), np.asarray(jlin))
    np.testing.assert_array_equal(tsizes.numpy(), np.asarray(jsizes))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    if capacity_factor < 1:
        assert not tkeep.all()                   # drops really happened


def test_top_k_ties_take_the_lower_expert():
    """Equal router probabilities (a zero token) route to the lowest
    experts, as ``jax.lax.top_k`` orders ties."""
    _, cfg = _cfg_pair("mixtral-8x22b")
    router = torch.zeros((cfg.d_model, cfg.num_experts))
    xt = torch.zeros((3, cfg.d_model))
    _, (lin, keep, gates), _, sizes = TMOE._route_and_dispatch(cfg, router,
                                                               xt)
    cap = TMOE.expert_capacity(3, cfg)
    assert sizes.tolist()[:2] == [min(3, cap)] * 2 and sizes[2:].sum() == 0
    assert torch.allclose(gates, torch.full_like(gates, 0.5))


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def setup_pair(arch):
    """(jax model, jax params, port model, port params) for the float32
    smoke config of ``arch``, the port's parameters bridged from
    ``repro``'s own init."""
    if arch not in _SETUP:
        jcfg, cfg = _cfg_pair(arch)
        jmodel = JModel(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        _SETUP[arch] = (jmodel, jparams, Model(cfg), params)
    return _SETUP[arch]


def _assert_pools_match(jpools, tpools):
    """Every layer's pool: positions and tables exactly, K/V within the
    model tolerance at every live position."""
    for jcol, tcol in zip(jpools["slots"], tpools["slots"]):
        for jleaf, tleaf in zip(jcol, tcol):
            n = tleaf.n_pages
            pos = tleaf.pos[:n].numpy()
            np.testing.assert_array_equal(pos, np.asarray(jleaf.pos))
            np.testing.assert_array_equal(tleaf.page_table.numpy(),
                                          np.asarray(jleaf.page_table))
            live = pos >= 0
            for name in ("k", "v"):
                got = getattr(tleaf, name)[:n].numpy().transpose(0, 2, 1, 3)
                want = np.asarray(getattr(jleaf, name)).transpose(0, 2, 1, 3)
                np.testing.assert_allclose(got[live], want[live],
                                           **MODEL_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_configs_match(arch):
    jmodel, jparams, model, params = setup_pair(arch)
    full, jfull = get_arch(arch), jget_arch(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()
    tokens = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 7)).astype(np.int32)
    want, _, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    got, _, aux = model.forward(params, {"tokens": _t(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-6,
                               atol=1e-6)
    assert aux.item() > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_chunk_and_decode_steps_match(arch):
    """Two mixed steps (a prefill continuing, an idle row, a sentinel slot,
    a decoding row), then a decode step with a live mask."""
    jmodel, jparams, model, params = setup_pair(arch)
    slots, ps, max_len, chunk = 4, 4, 16, 5
    jtree = jbuild(jmodel, slots=slots, page_size=ps, max_len=max_len)
    ttree = build_state_tree(model, slots=slots, page_size=ps,
                             max_len=max_len, device="cpu")
    for s in (0, 1, 2):                          # slot 3 stays sentinel
        jtree.admit(s)
        ttree.admit(s)
    jpools = jtree.push_tables(jtree.init_device())
    tpools = ttree.push_tables(ttree.init_device())
    rng = np.random.default_rng(1)
    start = np.zeros((slots,), np.int32)
    for lengths in (np.asarray([5, 0, 3, 2], np.int32),
                    np.asarray([4, 2, 1, 0], np.int32)):
        tokens = rng.integers(0, 256, (slots, chunk)).astype(np.int32)
        positions = (start[:, None] + np.arange(chunk)).astype(np.int32)
        jlast, jgreedy, jpools = jmodel.chunk_step(
            jparams, jpools, jnp.asarray(tokens), jnp.asarray(positions),
            jnp.asarray(lengths), return_greedy=True)
        tlast, tgreedy, tpools = model.chunk_step(
            params, tpools, _t(tokens), _t(positions), _t(lengths),
            return_greedy=True)
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   **MODEL_TOL)
        np.testing.assert_array_equal(tgreedy.numpy(), np.asarray(jgreedy))
        _assert_pools_match(jpools, tpools)
        start = start + lengths

    tokens = rng.integers(0, 256, (slots, 1)).astype(np.int32)
    live = np.asarray([1, 0, 1, 0], np.int32)
    with use_paged_decode_mode("interpret"):
        jlogits, jpools = jmodel.decode_step(
            jparams, jpools, jnp.asarray(tokens), jnp.asarray(start),
            lengths=jnp.asarray(live))
    tlogits, tpools = model.decode_step(params, tpools, _t(tokens),
                                        _t(start), lengths=_t(live))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **MODEL_TOL)
    assert (tlogits.numpy().argmax(-1) == np.asarray(jlogits).argmax(-1)).all()
    _assert_pools_match(jpools, tpools)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("chunk", [None, 4])
def test_engine_token_identical_to_jax(chunk, monkeypatch):
    jmodel, jparams, model, params = setup_pair("mixtral-8x22b")
    assert model.cfg.sliding_window == 8
    jeng = JPagedEngine(jmodel, jparams, config=JEngineConfig(
        slots=2, chunk=chunk, decode_kernel="interpret",
        cache=JCacheConfig(page_size=4, max_len=32)))
    teng = PagedEngine(model, params, config=EngineConfig(
        slots=2, chunk=chunk, cache=CacheConfig(page_size=4, max_len=32)))
    dropped = []
    route = TMOE._route_and_dispatch

    def counting(cfg, router_w, xt):
        out = route(cfg, router_w, xt)
        dropped.append(int((~out[1][1]).sum()))
        return out

    monkeypatch.setattr(TMOE, "_route_and_dispatch", counting)
    programs = (teng._prefill, teng._decode, teng._reset)
    served = 0
    for lens, seed, max_new in (([3, 5, 9, 12], 7, 5),
                                ([7, 2, 11, 4, 6], 8, 4)):
        # the longest request outgrows the 8-token ring
        assert max(lens) + max_new > model.cfg.sliding_window
        for p in _prompts(lens, seed):
            jeng.submit(p, max_new)
            teng.submit(p, max_new)
        want, got = jeng.run_until_idle(), teng.run_until_idle()
        served += len(lens)
        assert got == want and len(got) == served
        # the second workload is served warm: still one signature each
        assert [p.retraces for p in programs] == [1, 1, 1]
        for alloc in teng.allocators.values():
            assert alloc.free_pages == alloc.n_pages
            alloc.check()
    assert sum(dropped) > 0          # capacity drops happened and matched
    assert teng.stats()["moe_gemm"] == "plain"


def test_serve_cli_mixtral_smoke_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--arch", "mixtral-8x22b", "--smoke", "--device",
                         "cpu", "--requests", "3", "--max-new", "3",
                         "--repeat", "2", "--chunk", "8", "--prompt-lens",
                         "3,9,17"])
    text = out.getvalue()
    assert rc == 0, text
    assert "pass 2: prefill retraces=0 decode retraces=0" in text
    assert "served 6/6 requests" in text
