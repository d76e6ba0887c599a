"""The port's PagedEngine against the JAX PagedEngine.

Same float32 yi-6b smoke parameters (bridged from ``repro``'s own init),
same prompts: the port's greedy continuous batching must be token-identical
to JAX's (whose CPU default decode mode is its dense-gather reference), for
whole-prompt and chunked prefill.  Two slots for four requests, so slots
are freed and refilled mid-run.  Also: every page comes back and the
allocator's ``check()`` passes, the engine runs exactly three programs and a
warm engine sees no new argument signature, unported features are refused
by name, and the serve CLI runs end to end on the CPU.
"""

import ast
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import CacheConfig as JCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedEngine as JPagedEngine  # noqa: E402

from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import (FAILED, REJECTED, CacheConfig,  # noqa: E402
                                 EngineConfig, FaultConfig, PagedEngine,
                                 SchedulerConfig, SpecConfig)

from test_torch_model import setup_yi as setup_model_pair  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def setup_yi():
    """(jax model, jax params, port model, port params): the float32 yi-6b
    smoke fixture of ``tests/test_torch_model.py``."""
    _, jmodel, jparams, _, model, params = setup_model_pair()
    return jmodel, jparams, model, params


def prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def serve_both(jeng, teng, workload, max_new=5):
    for p in workload:
        jeng.submit(p, max_new)
        teng.submit(p, max_new)
    return jeng.run_until_idle(), teng.run_until_idle()


@pytest.mark.parametrize("chunk", [None, 4])
def test_engine_token_identical_to_jax(chunk):
    jmodel, jparams, model, params = setup_yi()
    jeng = JPagedEngine(jmodel, jparams, config=JEngineConfig(
        slots=2, chunk=chunk, cache=JCacheConfig(page_size=4, max_len=32)))
    teng = PagedEngine(model, params, config=EngineConfig(
        slots=2, chunk=chunk, cache=CacheConfig(page_size=4, max_len=32)))
    want, got = serve_both(jeng, teng, prompts([3, 5, 9, 12], seed=7))
    assert len(got) == 4 and got == want

    # every page is back and the accounting is clean
    for alloc in teng.allocators.values():
        assert alloc.free_pages == alloc.n_pages
        alloc.check()
    # exactly three programs, one signature each
    programs = (teng._prefill, teng._decode, teng._reset)
    assert [p.retraces for p in programs] == [1, 1, 1]
    assert teng.stats()["max_decode_stall"] == 0

    # a second, different workload on the warm engine: no new signature,
    # still token-identical
    want2, got2 = serve_both(jeng, teng, prompts([7, 2, 11, 4, 6], seed=8),
                             max_new=4)
    assert got2 == want2 and len(got2) == 9
    assert [p.retraces for p in programs] == [1, 1, 1]
    for alloc in teng.allocators.values():
        assert alloc.free_pages == alloc.n_pages
        alloc.check()


def test_chunked_prefill_equals_whole_prefill():
    """Every chunk width streams the same greedy tokens as whole-prompt
    prefill: a prompt split over many mixed steps (ring pages written chunk
    after chunk, decode rows riding along) is the same computation."""
    _, _, model, params = setup_yi()
    workload = prompts([3, 5, 9, 12, 17], seed=9)
    outs = {}
    for chunk in (None, 1, 3, 7):
        eng = PagedEngine(model, params, config=EngineConfig(
            slots=2, chunk=chunk, cache=CacheConfig(page_size=4, max_len=32)))
        for p in workload:
            eng.submit(p, 4)
        outs[chunk] = eng.run_until_idle()
        assert eng.stats()["max_decode_stall"] == 0
    assert len(outs[None]) == 5
    assert all(out == outs[None] for out in outs.values())


@pytest.mark.parametrize("config, item", [
    (EngineConfig(cache=CacheConfig(prefix_cache=True)), "9b"),
    (EngineConfig(sched=SchedulerConfig(preempt=True)), "9c"),
    (EngineConfig(fault=FaultConfig(deadline_s=1.0)), "9d"),
    (EngineConfig(fault=FaultConfig(watchdog=True)), "9d"),
    (EngineConfig(spec=SpecConfig(speculate=2)), "9e"),
    (EngineConfig(temperature=0.7), "9f"),
])
def test_unported_features_are_refused(config, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        config.validate()


def test_config_invariants_are_checked():
    with pytest.raises(ValueError, match="step_budget"):
        EngineConfig(slots=4, chunk=8, step_budget=5).validate()
    with pytest.raises(ValueError, match="slots"):
        EngineConfig(slots=0).validate()
    resolved = EngineConfig(slots=2, chunk=100,
                            cache=CacheConfig(max_len=32)).validate()
    assert (resolved.chunk, resolved.step_budget) == (32, 34)


def test_rejections_and_unservable_heads():
    _, _, model, params = setup_yi()
    eng = PagedEngine(model, params, config=EngineConfig(
        slots=2, cache=CacheConfig(page_size=4, max_len=16, pool_pages=2)))
    empty = eng.submit(np.zeros((0,), np.int32), 3)
    too_long = eng.submit(np.zeros((15,), np.int32), 3)
    assert empty.state == too_long.state == REJECTED
    # 16 tokens need 4 pages per slot, the pool holds 2: never servable
    r = eng.submit(np.ones((5,), np.int32), 2)
    assert eng.run_until_idle() == {}
    assert r.state == FAILED and eng.unservable == 1


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "3", "--repeat",
                         "2", "--chunk", "8", "--prompt-lens", "3,9,17"])
    text = out.getvalue()
    assert rc == 0, text
    assert "pass 2: prefill retraces=0 decode retraces=0" in text
    assert "served 6/6 requests" in text


def test_scheduler_is_a_copy():
    """The port keeps its own copy of the numpy-only scheduler; it must not
    drift from the reference's code."""
    def code(path):
        return ast.dump(ast.parse(path.read_text()))
    assert code(ROOT / "src/repro_torch/serving/scheduler.py") == \
        code(ROOT / "src/repro/serving/scheduler.py")
