"""The op walk and the roofline of the port (``repro_torch.roofline``),
the counterparts of ``tests/test_hlo_walk.py``, on the CPU.

Eager dispatch unrolls every loop, so where JAX multiplies a scanned body
by its trip count the walk sees the body that many times.  FLOPs are
exact (integers); the walked matrix FLOPs of the smoke yi-6b prefill
forward equal ``hlo_walk.analyze(...).dot_flops`` of JAX's same forward,
exactly.  The collective case runs a fake 8-rank group in a subprocess (a
default process group is per process).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline.hlo_walk import analyze  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.roofline.op_walk import OpWalk, walk  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
M, K, N = 128, 256, 512


def test_plain_matmul():
    a, b = torch.randn(M, K), torch.randn(K, N)
    _, r = walk(lambda: a @ b)
    assert r.dot_flops == 2 * M * K * N
    assert r.hbm_bytes == 4 * (M * K + K * N + M * N)
    assert r.n_ops == 1


def test_loop_counts_each_trip():
    a, ws = torch.randn(M, K), torch.randn(7, K, K)

    def g():
        x = a
        for w in ws:
            x = x @ w
        return x
    _, r = walk(g)
    assert r.dot_flops == 7 * 2 * M * K * K


def test_grad_of_loop_counts_fwd_and_bwd():
    a = torch.randn(M, K)
    ws = torch.randn(7, K, K, requires_grad=True)

    def g():
        x = a
        for w in ws.unbind(0):
            x = torch.tanh(x @ w)
        return torch.autograd.grad(x.sum(), ws)
    _, r = walk(g)
    # forward (2MKK) + backward dx and dw per layer; the first layer's dx
    # is not needed (a is a constant)
    assert r.dot_flops == (7 + 7 + 6) * 2 * M * K * K


def test_view_ops_are_free():
    a = torch.randn(M, K)
    _, r = walk(lambda: a.reshape(-1).view(K, M)[:, :8].t().unsqueeze(0))
    assert r.hbm_bytes == 0 and r.dot_flops == 0
    # a reshape that must copy is a copy
    _, r = walk(lambda: a.t().reshape(-1))
    assert r.hbm_bytes == 2 * M * K * 4
    # an op that returns no tensor (DTensor's dispatch asks each local
    # tensor for its device) is a metadata query: free
    w = OpWalk()
    w._count(torch.ops.prim.device.default, (a,), {}, a.device)
    assert w.result.hbm_bytes == 0 and w.result.n_ops == 1


def test_gather_and_scatter_count_their_rows():
    table = torch.randn(1000, 64)
    idx = torch.tensor([3, 5, 7])
    _, r = walk(lambda: table[idx])
    assert r.hbm_bytes == idx.numel() * 8 + 2 * 3 * 64 * 4
    # a fill writes its output only
    _, r = walk(lambda: table.new_zeros(table.shape))
    assert r.hbm_bytes == table.numel() * 4
    cache = torch.zeros(1000, 64)
    rows = torch.randn(3, 64)
    _, r = walk(lambda: cache.index_put_((idx,), rows))
    assert r.hbm_bytes == 2 * (idx.numel() * 8 + rows.numel() * 4)


def test_dense_gemm_op_has_its_formula():
    from repro_torch.kernels import ops, ref
    a, b = torch.randn(M, K), torch.randn(K, N)
    _, r = walk(lambda: ops.dense_gemm(a, b, None, "silu",
                                       ops._route(ref.matmul)))
    assert r.dot_flops == 2 * M * K * N
    assert r.hbm_bytes == 4 * (M * K + K * N + M * N)


def test_live_bytes_peak():
    def g():
        x = torch.ones(1024)            # 4 KiB, lives
        y = x * 2                       # 4 KiB, lives
        del y
        z = x + 1                       # reuses the freed room
        return z
    _, r = walk(g)
    assert r.peak_live_bytes == 2 * 4096


def test_collectives_on_a_fake_group():
    code = textwrap.dedent("""
        import json, torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.roofline.op_walk import OpWalk
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        mesh = make_host_mesh(2, 4)
        out = {}
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(16, 32), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            p = DTensor.from_local(torch.empty(64, 32), mesh,
                                   [Replicate(), Partial()], run_check=False)
            with OpWalk() as w:
                x.redistribute(mesh, [Replicate(), Replicate()])
                p.redistribute(mesh, [Replicate(), Replicate()])
                p.redistribute(mesh, [Replicate(), Shard(0)])
        out = {"counts": w.result.coll_counts,
               "bytes": w.result.coll_bytes_by_kind,
               "flops": w.result.dot_flops}
        dist.destroy_process_group()
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    # the shard of 16x32 fp32 gathered over data; the 64x32 partial summed
    # over model, then reduce-scattered over model
    assert rec["counts"]["all-gather"] == 1
    assert rec["bytes"]["all-gather"] == 16 * 32 * 4
    assert rec["counts"]["all-reduce"] == 1
    assert rec["bytes"]["all-reduce"] == 64 * 32 * 4
    assert rec["counts"]["reduce-scatter"] == 1
    assert rec["bytes"]["reduce-scatter"] == 64 * 32 * 4
    assert rec["flops"] == 0


def test_prefill_forward_flops_match_hlo_walk():
    """The smoke yi-6b prefill forward at one device: the walked matrix
    FLOPs against the JAX walk of the compiled forward."""
    jcfg = dataclasses.replace(jsmoke(jget_arch("yi-6b")), dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    b, s = 2, 32
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (b, s)).astype(np.int32)

    def jfwd(p, t):
        return jm.forward(p, {"tokens": t}, mode="prefill")[0]
    txt = jax.jit(jfwd).lower(jp, jnp.asarray(tokens)).compile().as_text()
    want = analyze(txt).dot_flops

    cfg = dataclasses.replace(smoke_config(get_arch("yi-6b")),
                              dtype="float32")
    model = Model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    with torch.no_grad():
        _, r = walk(lambda: model.forward(
            params, {"tokens": torch.from_numpy(tokens)}, mode="prefill"))
    assert r.dot_flops == want > 0


def test_roofline_keys_and_terms_match_jax():
    w = OpWalk().result
    w.dot_flops, w.hbm_bytes, w.coll_bytes = 2e12, 3e9, 5e8
    r = analysis.from_counts(w, chips=4, model_flops=6e12)
    j = janalysis.Roofline(flops=2e12, hbm_bytes=3e9,
                           collective_bytes=5e8, chips=4, model_flops=6e12)
    assert r.as_dict().keys() == j.as_dict().keys()
    assert r.t_compute == 2e12 / 989e12
    assert r.t_memory == 3e9 / 3.35e12
    assert r.t_collective == 5e8 / 450e9
    assert r.bottleneck == "compute"
    assert r.t_bound == r.t_compute
    assert r.useful_flops_fraction == 6e12 / (2e12 * 4)
    assert r.roofline_fraction == pytest.approx(
        (6e12 / (4 * 989e12)) / r.t_bound)
    # the card's peaks have one home: chip_smoke reads these names
    assert (analysis.PEAK_BF16, analysis.PEAK_FP32, analysis.PEAK_INT8,
            analysis.PEAK_BYTES) == (989e12, 67e12, 1979e12, 3.35e12)


def test_softmax_combines_count_their_all_reduces():
    """The all-reduces that ``dist.all_reduce`` dispatches (``c10d`` ops)
    are collectives: the context-parallel attention's combine and a decode
    step's combine across a kv_seq-sharded cache each count one max of
    ``m`` and sums of ``l`` and ``acc``, with their local bytes, on a fake
    2x4 group (batch over data, the kv sequence over model)."""
    code = textwrap.dedent("""
        import json, torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch import sharding as Sh
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import layers as L
        from repro_torch.roofline.op_walk import OpWalk
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        mesh = make_host_mesh(2, 4)
        rules = dict(Sh.RULES_SINGLE_POD, attn_context_parallel="model")
        B, H, KV, S, D = 2, 4, 2, 2048, 16
        out = {}
        with FakeTensorMode():
            q, k, v = (torch.empty(B, n, S, D) for n in (H, KV, KV))
            pos = torch.arange(S)
            with Sh.use_mesh_and_rules(mesh, rules), OpWalk() as w:
                L._gqa_sdpa(q, k, v, window=0, q_pos=pos, kv_pos=pos)
            out["cp"] = (w.result.coll_counts,
                         w.result.coll_bytes_by_kind)
            rows = [Shard(0), Replicate()]
            cache = [Shard(0), Shard(2)]
            qd = DTensor.from_local(torch.empty(B // 2, H, 1, D), mesh, rows,
                                    run_check=False)
            kd, vd = (DTensor.from_local(torch.empty(B // 2, KV, S // 4, D),
                                         mesh, cache, run_check=False)
                      for _ in "kv")
            kp = DTensor.from_local(torch.zeros(B // 2, S // 4,
                                                dtype=torch.int32),
                                    mesh, [Shard(0), Shard(1)],
                                    run_check=False)
            qp = DTensor.from_local(torch.zeros(B // 2, 1, dtype=torch.int32),
                                    mesh, rows, run_check=False)
            with Sh.use_mesh_and_rules(mesh, Sh.RULES_SINGLE_POD), \\
                    OpWalk() as w:
                L._gqa_sdpa(qd, kd, vd, window=0, q_pos=qp, kv_pos=kp)
            out["decode"] = (w.result.coll_counts,
                             w.result.coll_bytes_by_kind)
        dist.destroy_process_group()
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    B, H, KV, S, D = 2, 4, 2, 2048, 16
    for name, sq in (("cp", S), ("decode", 1)):
        counts, nbytes = rec[name]
        # one max of m, one sum of l, one sum of acc, on rank 0's rows
        m = (B // 2) * H * sq * 4
        assert counts == {"all-gather": 0, "all-reduce": 3,
                          "reduce-scatter": 0, "all-to-all": 0,
                          "collective-permute": 0}, name
        assert nbytes["all-reduce"] == 2 * m + m * D, name
