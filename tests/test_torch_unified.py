"""The port's paper-faithful core against the JAX package, on the CPU.

* ``core/unified.py``: ``arch_cells``, ``serving_cells``, ``dedup_cells``
  and ``tunable_cells`` equal JAX's field for field for every registry
  arch at a decode and a prefill shape; a cell's tile plan is
  ``kraken_gemm``'s under the policy, its utilization that plan's useful
  share; ``run_cell`` runs through ``ops.kraken_matmul``.
* ``core/dataflow.py``, ``core/perf_model.py`` and
  ``configs/kraken_asic.py`` are copies: AST-equal to JAX's apart from
  their imports and module docstrings, and ``analyze_network`` (AlexNet,
  VGG-16, ResNet-50), ``simulate_conv`` and ``simulate_matmul`` on seeded
  inputs give JAX's results exactly.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.core import dataflow as j_dataflow  # noqa: E402
from repro.core import networks as j_networks  # noqa: E402
from repro.core import perf_model as j_perf  # noqa: E402
from repro.core import unified as j_unified  # noqa: E402

from repro_torch import tuning  # noqa: E402
from repro_torch.configs import ARCHS, kraken_asic  # noqa: E402
from repro_torch.core import dataflow, networks, perf_model  # noqa: E402
from repro_torch.core import unified  # noqa: E402
from repro_torch.kernels import kraken_gemm as kg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.tuning import cache as tcache  # noqa: E402
from repro_torch.tuning import search  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [dict(batch=4, seq_q=1, seq_kv=512), dict(batch=1, seq_q=64)]


def _fields(cells):
    return [dataclasses.astuple(c) for c in cells]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cells_equal_jax(arch):
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    for shape in SHAPES:
        got = unified.arch_cells(cfg, **shape)
        want = j_unified.arch_cells(jcfg, **shape)
        assert _fields(got) == _fields(want)
        assert _fields(unified.tunable_cells(got)) == _fields(
            j_unified.tunable_cells(want))
        assert _fields(unified.dedup_cells(got)) == _fields(
            j_unified.dedup_cells(want))
    kw = dict(slots=4, prompt_len=64, cache_len=512, prefill_batch=4,
              bucket_lens=[64, 17])
    assert _fields(unified.serving_cells(cfg, **kw)) == _fields(
        j_unified.serving_cells(jcfg, **kw))
    assert unified.dominant_cell(unified.arch_cells(cfg, **SHAPES[1])) \
        .flops == j_unified.dominant_cell(
            j_unified.arch_cells(jcfg, **SHAPES[1])).flops


def test_lowering_rules_equal_jax():
    kw = dict(n=2, h=17, w=15, c_i=3, k_h=5, k_w=3, c_o=8, s_h=2, s_w=1,
              pad_h=(1, 2), pad_w=(0, 1), name="c")
    assert dataclasses.astuple(unified.conv_cell(**kw)) == \
        dataclasses.astuple(j_unified.conv_cell(**kw))
    assert dataclasses.astuple(unified.fc_cell(batch=3, c_i=7, c_o=5)) == \
        dataclasses.astuple(j_unified.fc_cell(batch=3, c_i=7, c_o=5))
    akw = dict(batch=2, seq_q=8, seq_kv=8, d_model=64, num_heads=4,
               num_kv_heads=2, head_dim=16, window=4)
    assert _fields(unified.attention_cells(**akw)) == _fields(
        j_unified.attention_cells(**akw))
    mkw = dict(tokens=9, d_model=32, d_ff=48, n_experts=4, top_k=2,
               swiglu=False)
    assert _fields(unified.moe_cells(**mkw)) == _fields(
        j_unified.moe_cells(**mkw))
    c = unified.matmul_cell(4, 4096, 11008)
    jc = j_unified.matmul_cell(4, 4096, 11008)
    assert (c.flops, c.macs, c.operand_words(), c.arithmetic_intensity()) \
        == (jc.flops, jc.macs, jc.operand_words(), jc.arithmetic_intensity())


def test_cell_tile_plan_is_the_gemm_plan_under_the_policy():
    tuning.set_tile_mode(None)
    cache = tuning.set_tile_cache(tcache.TileCache(path=None))
    try:
        cell = unified.matmul_cell(4, 4096, 4096)
        q = cell.tile_plan()
        assert q == kg.plan(4, 4096, 4096)
        issued = q["mtiles"] * q["BM"] * q["nk"] * 64 * q["ntiles"] * q["BN"]
        assert cell.utilization() == 4 * 4096 * 4096 / issued
        pick = (q["BM"], q["BN"], q["split"])
        other = next((c["BM"], c["BN"], c["split"])
                     for c in search.shortlist(kg.candidates(4, 4096, 4096),
                                               kg.CHOICE, keep=pick)
                     if (c["BM"], c["BN"], c["split"]) != pick)
        search.autotune("gemm", (4, 4096, 4096), dtype_name="bfloat16",
                        sms=132, cache=cache,
                        timer=lambda ch: 1.0 + abs(ch[2] - other[2])
                        + abs(ch[0] - other[0]) + abs(ch[1] - other[1]))
        tuning.set_tile_mode("cached")
        got = cell.tile_plan()
        assert (got["BM"], got["BN"], got["split"]) == other
        assert cell.tile_plan("model") == q     # reports use the model
        [r] = unified.report([cell])
        assert r.utilization == cell.utilization()
        assert r.modeled_seconds_compute == cell.flops / (
            unified.PEAK_FLOPS * r.utilization)
        assert r.modeled_seconds_memory == cell.operand_words() * 2 / \
            unified.HBM_BW
        assert 0 < cell.utilization() <= 1
    finally:
        tuning.set_tile_mode(None)
        tuning.set_tile_cache(tcache.TileCache(path=None))


def test_run_cell_runs_through_kraken_matmul():
    g = torch.Generator().manual_seed(0)
    cell = unified.matmul_cell(5, 12, 7)
    a, b = torch.randn(5, 12, generator=g), torch.randn(12, 7, generator=g)
    torch.testing.assert_close(unified.run_cell(cell, a, b),
                               ref.matmul(a, b))
    bc = unified.GemmCell("attn_score", m=3, k=4, n=6, batch=2)
    a3, b3 = torch.randn(2, 3, 4, generator=g), torch.randn(2, 4, 6,
                                                           generator=g)
    torch.testing.assert_close(unified.run_cell(bc, a3, b3),
                               torch.stack([ref.matmul(a3[i], b3[i])
                                            for i in range(2)]))
    with pytest.raises(ValueError):
        unified.run_cell(cell, b, a)


def _body(path: Path) -> str:
    """The module's AST without its docstring and its imports."""
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body
                 if not isinstance(n, (ast.Import, ast.ImportFrom))
                 and not (isinstance(n, ast.Expr)
                          and isinstance(n.value, ast.Constant)
                          and isinstance(n.value.value, str))]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", ["core/dataflow.py", "core/perf_model.py",
                                 "configs/kraken_asic.py"])
def test_copied_modules_are_jax_s(rel):
    port = ROOT / "src" / "repro_torch" / rel
    assert _body(port) == _body(ROOT / "src" / "repro" / rel)
    imports = [n for n in ast.parse(port.read_text()).body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert all(not (isinstance(n, ast.ImportFrom) and n.module
                    and n.module.split(".")[0] in ("repro", "jax"))
               and not (isinstance(n, ast.Import)
                        and any(a.name.split(".")[0] in ("repro", "jax")
                                for a in n.names))
               for n in imports)


@pytest.mark.parametrize("net", ["alexnet", "vgg16", "resnet50"])
def test_analyze_network_equals_jax(net):
    got = perf_model.analyze_network(networks.get_network(net)["conv"])
    want = j_perf.analyze_network(j_networks.get_network(net)["conv"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.efficiency == want.efficiency
    bw = perf_model.bandwidth_words_per_clock(
        networks.get_network(net)["conv"][0])
    assert bw == j_perf.bandwidth_words_per_clock(
        j_networks.get_network(net)["conv"][0])


def test_config_search_equals_jax():
    sets = [networks.get_network(n)["conv"] for n in ("alexnet", "vgg16")]
    jsets = [j_networks.get_network(n)["conv"] for n in ("alexnet", "vgg16")]
    assert perf_model.config_search(sets, r_range=(7, 14),
                                    c_range=(24, 48, 96)) == \
        j_perf.config_search(jsets, r_range=(7, 14), c_range=(24, 48, 96))
    assert dataclasses.asdict(kraken_asic.CONFIG) == dataclasses.asdict(
        __import__("repro.configs.kraken_asic",
                   fromlist=["CONFIG"]).CONFIG)


@pytest.mark.parametrize("kw", [dict(s_h=1, s_w=1, pad_h=(1, 1), pad_w=(1, 1)),
                                dict(s_h=2, s_w=2),
                                dict(s_h=1, s_w=3, pad_h=(2, 1), pad_w=(0, 2))],
                         ids=["3x3 s1", "3x3 s2", "s 1x3 asymmetric"])
def test_simulate_conv_and_matmul_equal_jax(kw):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 11, 13, 3))
    k = rng.normal(size=(3, 3, 3, 5))
    got = dataflow.simulate_conv(x, k, R=3, C=12, **kw)
    want = j_dataflow.simulate_conv(x, k, R=3, C=12, **kw)
    np.testing.assert_array_equal(got.y, want.y)
    assert (got.issue_cycles, got.T, got.L) == (want.issue_cycles, want.T,
                                                want.L)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    np.testing.assert_allclose(got.y, dataflow.reference_conv(x, k, **kw),
                               rtol=1e-10, atol=1e-10)
    m = rng.normal(size=(6, 10))
    w = rng.normal(size=(10, 9))
    gm = dataflow.simulate_matmul(m, w, R=3, C=12)
    jm = j_dataflow.simulate_matmul(m, w, R=3, C=12)
    np.testing.assert_array_equal(gm.y, jm.y)
    assert gm.issue_cycles == jm.issue_cycles
