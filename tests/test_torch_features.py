"""The port's serving features as a whole, on the CPU: the option surface
against the JAX engine's, the copied host-only modules against their
originals, the seeded sampler, and the serve CLI's feature flags and
verify replays.

It also holds the helpers the feature suites share
(``tests/test_torch_prefix_cache.py``, ``test_torch_preemption.py``,
``test_torch_serving_faults.py``, ``test_torch_speculative.py``): the float32
smoke pair of ``tests/test_torch_dense_cache.py`` (``repro``'s own init,
bridged), one feature config built for both engines, and the replay through
``EngineConfig.verify_reference()``.

The sampler draws ``torch.multinomial`` over ``softmax(logits / T)`` from
the engine's generator; JAX draws threefry bits, so the tests compare
distributions: 200000 draws from fixed logits at T 0.8 lie within a total
variation of 0.01 of ``softmax(logits / T)`` (at this size the expected
distance is about 0.005, and the same draws are 0.06 from ``softmax(logits)``,
the T = 1 distribution, so the bound would catch a temperature not applied).
"""

import ast
import contextlib
import dataclasses
import io
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving as J  # noqa: E402

import repro_torch.serving as S  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

from test_torch_dense_cache import setup_pair  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def configs(*, slots=2, chunk=None, page_size=4, max_len=32, pool_pages=None,
            overcommit=1.0, prefix_cache=False, preempt=False, aging_s=30.0,
            speculate=0, drafter=None, deadline_s=None, watchdog=None,
            heartbeat=None, temperature=0.0, seed=0):
    """(JAX config, port config) of one feature set: the same fields."""
    def build(m):
        return m.EngineConfig(
            slots=slots, chunk=chunk, temperature=temperature, seed=seed,
            sched=m.SchedulerConfig(preempt=preempt, aging_s=aging_s),
            cache=m.CacheConfig(page_size=page_size, max_len=max_len,
                                pool_pages=pool_pages, overcommit=overcommit,
                                prefix_cache=prefix_cache),
            spec=m.SpecConfig(speculate=speculate, drafter=drafter),
            fault=m.FaultConfig(deadline_s=deadline_s, watchdog=watchdog,
                                heartbeat=heartbeat))
    return build(J), build(S)


def engines(arch, kv="", jax_decode_kernel=None, **kw):
    """(JAX engine, port engine) over the float32 smoke pair of ``arch``
    (int8 pools with ``kv="int8"``); ``jax_decode_kernel`` picks JAX's
    paged-decode mode."""
    jmodel, jparams, model, params = setup_pair(arch, kv)
    jcfg, tcfg = configs(**kw)
    jcfg = dataclasses.replace(jcfg, decode_kernel=jax_decode_kernel)
    return (J.PagedEngine(jmodel, jparams, config=jcfg),
            S.PagedEngine(model, params, config=tcfg))


def port_engine(arch, **kw):
    _, _, model, params = setup_pair(arch)
    return S.PagedEngine(model, params, config=configs(**kw)[1])


def prompts(lens, seed=7, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def replay(eng, subs):
    """Every submission ``(rid, prompt, max_new, priority)`` through a
    fresh engine on ``eng``'s config with ``verify_reference()``."""
    ref = S.PagedEngine(eng.model, eng.params,
                        config=eng.config.verify_reference())
    for rid, p, max_new, prio in subs:
        ref.submit(p, max_new, rid=rid, priority=prio)
    return ref.run_until_idle()


def check_clean(eng):
    """Post-drain invariants: allocators (and the prefix cache) pass their
    oracles, and without a cache every page is free."""
    for alloc in eng.allocators.values():
        alloc.check()
        if eng.prefix_cache is None:
            assert alloc.free_pages == alloc.n_pages
    if eng.prefix_cache is not None:
        eng.prefix_cache.check()


def programs(eng):
    return (eng._prefill.retraces, eng._decode.retraces, eng._reset.retraces)


# ---------------------------------------------------------------------------
# the option surface
# ---------------------------------------------------------------------------

OPTIONS = {
    "prefix_cache": dict(prefix_cache=True),
    "preempt": dict(preempt=True),
    "deadline": dict(deadline_s=1.0),
    "watchdog": dict(watchdog=True),
    "heartbeat": dict(heartbeat="hb.json"),
    "speculate": dict(speculate=2),
    "drafter": dict(speculate=2, drafter=S.NGramDrafter(max_n=2)),
    "temperature": dict(temperature=0.7, seed=3),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_every_jax_option_validates(option):
    """``validate()`` accepts every option the JAX one accepts and resolves
    it the same way."""
    jcfg, tcfg = configs(chunk=100, **OPTIONS[option])
    jres, tres = jcfg.validate(), tcfg.validate()
    for name in ("slots", "chunk", "step_budget", "temperature", "seed"):
        assert getattr(tres, name) == getattr(jres, name)
    assert tres.spec.speculate == jres.spec.speculate
    assert dataclasses.asdict(tres.cache) == dataclasses.asdict(jres.cache)
    ref = tres.verify_reference()
    assert not ref.sched.preempt and ref.spec == S.SpecConfig()
    assert ref.fault == S.FaultConfig()
    assert ref.cache == tres.cache and ref.temperature == tres.temperature


@pytest.mark.parametrize("bad, match", [
    (dict(speculate=-1), "speculate must be >= 0"),
    (dict(speculate=2, temperature=0.7), "greedy-only"),
    (dict(pool_pages=0), "pool_pages"),
])
def test_invalid_options_are_refused_like_jax(bad, match):
    jcfg, tcfg = configs(**bad)
    for cfg in (jcfg, tcfg):
        with pytest.raises(ValueError, match=match):
            cfg.validate()


def test_serving_exports_match_jax():
    """The port exports JAX's serving surface, less what it does not port
    (``JitCounter`` becomes ``ShapeCounter``)."""
    unported = {"JitCounter"}
    assert set(S.__all__) - set(J.__all__) == {"ShapeCounter"}
    assert set(J.__all__) - set(S.__all__) == unported
    for name in S.__all__:
        assert hasattr(S, name), name


# ---------------------------------------------------------------------------
# the copied host-only modules
# ---------------------------------------------------------------------------

class _Normalize(ast.NodeTransformer):
    """Drops docstrings and maps ``repro.`` imports to ``repro_torch.``."""

    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = _strip

    def visit_ImportFrom(self, node):
        if node.module and node.module.startswith("repro."):
            node.module = "repro_torch." + node.module[len("repro."):]
        return node


def _code(path, drop=()):
    tree = _Normalize().visit(ast.parse(path.read_text()))
    for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
        cls.body = [n for n in cls.body
                    if getattr(n, "name", None) not in drop]
    tree.body = [n for n in tree.body if not isinstance(n, ast.Import | ast.ImportFrom)
                 or not any(a.name in ("jax", "torch") for a in n.names)]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["runtime/fault_tolerance.py",
                                    "serving/speculative.py",
                                    "serving/watchdog.py",
                                    "serving/prefix_cache.py"])
def test_host_modules_are_copies(module):
    """The numpy-only modules are copies: the same code as the reference,
    docstrings aside, importing the port's classes."""
    assert _code(ROOT / "src/repro_torch" / module) == \
        _code(ROOT / "src/repro" / module)


def test_faults_is_a_copy_but_the_snapshot_walk():
    """``faults.py`` is the reference's code except ``maybe_corrupt``, which
    walks the port's snapshot of host tensors (its own tests below)."""
    drop = ("maybe_corrupt",)
    got = _code(ROOT / "src/repro_torch/serving/faults.py", drop)
    want = _code(ROOT / "src/repro/serving/faults.py", drop)
    got = got.replace("ImportFrom(module='repro_torch.serving.paged_kv', "
                      "names=[alias(name='snapshot_leaves')], level=0), ", "")
    assert got == want


# ---------------------------------------------------------------------------
# seeded sampling
# ---------------------------------------------------------------------------

def _fixed_logits(vocab=16):
    return torch.from_numpy(np.linspace(-2.0, 2.5, vocab)[::-1].copy()
                            ).float()


def test_sampler_matches_softmax_over_temperature():
    eng = port_engine("yi-6b", temperature=0.8, seed=5)
    logits = _fixed_logits()
    n = 200_000
    ids = eng._sample(logits.expand(n, -1))
    assert ids.shape == (n,) and ids.dtype.kind == "i"
    freq = np.bincount(ids, minlength=len(logits)) / n
    want = torch.softmax(logits / 0.8, dim=-1).numpy()
    assert 0.5 * np.abs(freq - want).sum() < 0.01
    # the bound has power: T = 1 is far outside it
    t1 = torch.softmax(logits, dim=-1).numpy()
    assert 0.5 * np.abs(freq - t1).sum() > 0.05


def test_sampling_is_seeded():
    """The same seed gives the same tokens, another seed others; greedy
    ignores the seed."""
    work = prompts([5, 9, 12, 6], seed=3)

    def serve(**kw):
        eng = port_engine("yi-6b", chunk=8, **kw)
        for i, p in enumerate(work):
            eng.submit(p, 8, rid=i)
        return eng.run_until_idle()

    a = serve(temperature=0.8, seed=1)
    assert a == serve(temperature=0.8, seed=1)
    assert a != serve(temperature=0.8, seed=2)
    assert serve(seed=1) == serve(seed=2) != a


def test_speculation_with_temperature_is_refused():
    with pytest.raises(ValueError, match="greedy"):
        port_engine("yi-6b", speculate=4, temperature=0.7)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def _serve(*flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--smoke", "--device", "cpu", "--requests", "4",
                         "--max-new", "6", "--chunk", "8", "--repeat", "2",
                         *flags])
    return rc, out.getvalue()


@pytest.mark.parametrize("flags, expect", [
    (["--prefix-cache", "--shared-prefix", "16"], "prefix hit rate="),
    (["--speculate", "4", "--verify-speculate"],
     "speculate token-identity: ok (8 requests)"),
    (["--slots", "2", "--preempt", "--priority", "1,1,0,0", "--stagger", "3",
      "--verify-preempt"], "preempt token-identity: ok (8 requests)"),
    (["--faults", "seed=0,n=8,ticks=40", "--watchdog", "--verify-faults"],
     "fault token-identity: ok"),
    (["--arch", "zamba2-1.2b", "--faults", "seed=1,n=6,ticks=30",
      "--watchdog", "--verify-faults"], "fault token-identity: ok"),
    (["--arch", "rwkv6-3b", "--slots", "2", "--preempt", "--priority",
      "1,1,0,0", "--stagger", "3", "--verify-preempt"],
     "preempt token-identity: ok (8 requests)"),
])
def test_serve_cli_features(flags, expect):
    """The smoke configs are bf16, where the mixed and the decode program
    may round a near-tie apart (zamba2-1.2b's fifth token of request 6 under
    ``--speculate 3`` ties exactly), so speculation's replay runs yi-6b
    here; the float32 suites hold every arch."""
    rc, text = _serve(*flags)
    assert rc == 0, text
    assert expect in text, text
    assert "pass 2: prefill retraces=0 decode retraces=0" in text
    if "--prefix-cache" in flags:
        rate = float(text.split("prefix hit rate=")[-1].split("%")[0])
        assert rate > 0, text
    if "--preempt" in flags:
        assert int(re.findall(r"preemptions=(\d+)", text)[-1]) > 0, text


def test_serve_cli_sampling_is_seeded():
    runs = [_serve("--temperature", "0.8", "--seed", s) for s in
            ("4", "4", "5")]
    outs = [[ln for ln in text.splitlines() if ln.startswith("req ")]
            for _, text in runs]
    assert all(rc == 0 for rc, _ in runs)
    assert outs[0] == outs[1] != outs[2]
