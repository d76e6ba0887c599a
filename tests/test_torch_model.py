"""The port's model against the JAX model, on the yi-6b smoke config.

Both packages run the same float32 parameters -- ``repro``'s own
``Model(cfg).init(jax.random.key(0))``, bridged to torch -- on the same
numpy inputs.  Logits of ``forward``, ``chunk_step`` (idle rows and the
greedy chain included) and ``decode_step`` agree within ``rtol = atol =
1e-4``: float32 throughout, two layers, and the only difference is the
order in which XLA and PyTorch sum each product (about 1e-6 relative); the
greedy tokens are identical.  After each step the pools hold the same
positions exactly and the same K/V at every live position (within the same
tolerance: the K/V are products, summed in either order).  The JAX decode
step runs its Pallas kernel in interpret mode, whose dead-slot rule (a slot
with nothing live attends to nothing) is the port's.

Also here: every architecture of the registry builds its spec tree, state
tree and engine in the port, and the guard that ``src/repro_torch`` and
``chip_smoke.py`` import neither ``jax`` nor ``repro``.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.kernels.paged_attention import use_paged_decode_mode  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving.state import build_state_tree as jbuild  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ARCHS, get_arch, smoke_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import (CacheConfig, EngineConfig,  # noqa: E402
                                 PagedEngine)
from repro_torch.serving.state import build_state_tree  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]
_SETUP: dict = {}


def setup_yi():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    for the float32 yi-6b smoke config (``tests/test_serving_engine.py``'s
    fixture)."""
    if "yi" not in _SETUP:
        jcfg = dataclasses.replace(jsmoke(jget_arch("yi-6b")),
                                   dtype="float32")
        jmodel = JModel(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        cfg = dataclasses.replace(smoke_config(get_arch("yi-6b")),
                                  dtype="float32")
        model = Model(cfg)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        _SETUP["yi"] = (jcfg, jmodel, jparams, cfg, model, params)
    return _SETUP["yi"]


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(kw or TOL))


def test_configs_and_param_tree_match():
    jcfg, jmodel, jparams, cfg, model, params = setup_yi()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert get_arch("yi-6b").param_count() == jget_arch("yi-6b").param_count()
    assert cfg.param_count() == jcfg.param_count()
    jflat = {jax.tree_util.keystr(p): np.asarray(x).shape
             for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    n_port = sum(1 for _ in model.param_numels())
    assert n_port == len(jflat)
    assert tuple(params["stack"]["slots"][0]["attn_wq"].shape) == \
        jflat["['stack']['slots'][0]['attn_wq']"]


def test_init_draws_with_the_reference_scaling():
    _, _, _, cfg, model, _ = setup_yi()
    g = torch.Generator().manual_seed(0)
    p = model.init(g)
    wq = p["stack"]["slots"][0]["attn_wq"]          # [layers, d, h*hd]
    assert wq.dtype == torch.float32
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert (p["final_norm_gamma"] == 1).all()
    again = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["unembed"], p["unembed"])


def test_forward_logits_match():
    jcfg, jmodel, jparams, cfg, model, params = setup_yi()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 7))
    tokens = tokens.astype(np.int32)
    want, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    got, _, _ = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)


def _paired_pools(jmodel, model, *, slots, page_size, max_len, admit):
    jtree = jbuild(jmodel, slots=slots, page_size=page_size, max_len=max_len)
    ttree = build_state_tree(model, slots=slots, page_size=page_size,
                             max_len=max_len, device="cpu")
    for s in admit:
        jtree.admit(s)
        ttree.admit(s)
    return (jtree, jtree.push_tables(jtree.init_device()),
            ttree, ttree.push_tables(ttree.init_device()))


def _assert_pools_match(jpools, tpools):
    for jleaf, tleaf in zip(jpools["slots"][0], tpools["slots"][0]):
        n = tleaf.n_pages
        pos = tleaf.pos[:n].numpy()
        np.testing.assert_array_equal(pos, np.asarray(jleaf.pos))
        np.testing.assert_array_equal(tleaf.page_table.numpy(),
                                      np.asarray(jleaf.page_table))
        live = pos >= 0
        for name in ("k", "v"):
            got = getattr(tleaf, name)[:n].numpy().transpose(0, 2, 1, 3)
            want = np.asarray(getattr(jleaf, name)).transpose(0, 2, 1, 3)
            _close(got[live], want[live])


def test_chunk_and_decode_steps_match():
    """Two mixed steps (a prefill continuing, an idle row, a sentinel slot,
    a decoding row), then a decode step with a live mask: logits, greedy
    chain and pools agree."""
    jcfg, jmodel, jparams, cfg, model, params = setup_yi()
    slots, ps, max_len, chunk = 4, 4, 16, 5
    jtree, jpools, ttree, tpools = _paired_pools(
        jmodel, model, slots=slots, page_size=ps, max_len=max_len,
        admit=(0, 1, 2))                          # slot 3 stays sentinel
    rng = np.random.default_rng(1)
    start = np.asarray([0, 0, 0, 0], np.int32)
    steps = [np.asarray([5, 0, 3, 2], np.int32),   # row 1 idle; 3 sentinel
             np.asarray([4, 2, 1, 0], np.int32)]   # row 2 decodes
    for lengths in steps:
        tokens = rng.integers(0, cfg.vocab_size, (slots, chunk)).astype(np.int32)
        positions = (start[:, None] + np.arange(chunk)).astype(np.int32)
        jlast, jgreedy, jpools = jmodel.chunk_step(
            jparams, jpools, jnp.asarray(tokens), jnp.asarray(positions),
            jnp.asarray(lengths), return_greedy=True)
        tlast, tgreedy, tpools = model.chunk_step(
            params, tpools, torch.from_numpy(tokens),
            torch.from_numpy(positions), torch.from_numpy(lengths),
            return_greedy=True)
        _close(tlast, jlast)
        np.testing.assert_array_equal(tgreedy.numpy(), np.asarray(jgreedy))
        _assert_pools_match(jpools, tpools)
        start = start + lengths

    tokens = rng.integers(0, cfg.vocab_size, (slots, 1)).astype(np.int32)
    live = np.asarray([1, 0, 1, 0], np.int32)
    with use_paged_decode_mode("interpret"):
        jlogits, jpools = jmodel.decode_step(
            jparams, jpools, jnp.asarray(tokens), jnp.asarray(start),
            lengths=jnp.asarray(live))
    tlogits, tpools = model.decode_step(
        params, tpools, torch.from_numpy(tokens), torch.from_numpy(start),
        lengths=torch.from_numpy(live))
    _close(tlogits, jlogits)
    assert (np.asarray(tlogits).argmax(-1)
            == np.asarray(jlogits).argmax(-1)).all()
    _assert_pools_match(jpools, tpools)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_registry_arch_builds_its_specs_and_states(arch):
    """Every architecture of the registry runs in the port: its full-width
    spec tree has JAX's parameter count, and at smoke width its state tree
    holds one state per layer, builds its device leaves and an engine."""
    assert sum(n for _, n in Model(get_arch(arch)).param_numels()) \
        == jget_arch(arch).param_count()
    cfg = smoke_config(get_arch(arch))
    model = Model(cfg)
    assert PagedEngine.supports(model)
    tree = build_state_tree(model, slots=2, page_size=4, max_len=16,
                            device="cpu")
    n_layers = cfg.num_layers + (model.stack.n_periods
                                 if model.stack.has_shared else 0)
    assert len(list(tree.leaves())) == n_layers
    kinds = {s.kind for s in model.stack.pattern}
    assert tree.has_rows == bool(kinds & {"cross", "rwkv", "mamba"})
    pools = tree.init_device()
    assert len(pools["slots"]) == len(model.stack.pattern)
    params = model.init(torch.Generator().manual_seed(0))
    eng = PagedEngine(model, params, config=EngineConfig(
        slots=2, cache=CacheConfig(page_size=4, max_len=16)))
    assert eng.state.has_rows == tree.has_rows


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), \
                f"{path.relative_to(ROOT)} imports {name}"
