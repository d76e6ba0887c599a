"""The port's multi-device code against the JAX package, on the CPU.

* **Specs**, on JAX ``AbstractMesh``es of 16x16 and 2x16x16 over every
  full-size config (nothing is allocated): the port's ``partition_spec``
  tuples and ``dropped_axes`` equal JAX's for every parameter and every
  flat cache leaf, under every rule table, under ``rules_for`` for every
  shape and pod count, and under ``zero1_param_rules``; the ``rules_for``
  dicts are equal; ``model_flops`` is equal for every arch and kind; the
  per-device bytes of a train cell's parameters and ZeRO-1 moments equal
  the sum of JAX's ``NamedSharding.shard_shape`` bytes.  All exact.
* **One 4-rank gloo group** (a subprocess, ``FileStore`` under the test's
  tmp dir, timeouts on init and on the process): on a 2x2 mesh the float32
  smoke yi-6b and mixtral-8x22b loss and gradients, and yi-6b's on 1x4
  (its 4 query heads sharded, its 2 KV heads not), through ``dense_gemm``'s
  sharding rule (every GEMM on a rank's local shards), against the
  unsharded port and JAX's ``value_and_grad`` through the bridge (loss
  within 1e-5 relative, each gradient leaf within ``GRAD_TOL`` of its
  largest entry; mixtral's against JAX's under the same mesh, since its
  MoE routes one dispatch group per data shard); one ZeRO-1 train step of two microbatches split from the
  data-sharded batch against JAX's jitted unsharded step (loss 1e-5, each
  parameter within ``GRAD_TOL`` of its largest entry); a JAX-written
  checkpoint restored onto 2x2 and then 4x1, every leaf exact and every
  shard of the expected shape; prefill + 4 decode steps of both archs with
  the caches sharded over batch and kv_seq against JAX (1e-4;
  mixtral's against JAX's under the same mesh); ``allreduce_compressed`` over the 4-rank
  model axis and the context-parallel attention (H 6 over 4 ranks, S 4096,
  no window and window 512) in forward and gradient against JAX's own
  under ``shard_map`` in one 8-device JAX subprocess (1e-5).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import sharding as JSh  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.launch import sharding_rules as JR  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models.layers import Spec as JSpec  # noqa: E402
from repro.models.model import Model as JModel, model_flops as jmodel_flops  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch import sharding as Sh  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_arch, smoke_config  # noqa: E402
from repro_torch.launch import sharding_rules as R  # noqa: E402
from repro_torch.models.model import (Model, _flatten, cache_leaves,  # noqa: E402
                                      model_flops)

ROOT = Path(__file__).resolve().parent.parent
GRAD_TOL = 1e-4   # of the leaf's largest |entry|
B_CACHE, S_CACHE = 128, 32768   # decode_32k's caches
MESHES = {"16x16": AbstractMesh((16, 16), ("data", "model")),
          "2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
TABLES = {"16x16": ("RULES_SINGLE_POD", "RULES_SP_SINGLE_POD"),
          "2x16x16": ("RULES_SINGLE_POD", "RULES_MULTI_POD",
                      "RULES_SP_SINGLE_POD", "RULES_SP_MULTI_POD")}


def _norm(spec) -> tuple:
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


_LEAVES: dict = {}


def leaves_of(arch):
    """((JAX leaves, port leaves) of the parameters, and of the decode
    caches): (shape, axes) each, in tree order."""
    if arch not in _LEAVES:
        jm, m = JModel(jget_arch(arch)), Model(get_arch(arch))
        jp = jax.tree_util.tree_leaves(
            jm._spec_tree(), is_leaf=lambda x: isinstance(x, JSpec))
        pp = [s for _, s in _flatten(m._spec_tree())]
        jc = [(tuple(s.shape), a) for s, a in zip(
            jax.tree.leaves(jm.cache_specs(B_CACHE, S_CACHE, flat=True)),
            jm.cache_axes_list(B_CACHE, S_CACHE, flat=True))]
        pc = [(tuple(t.shape), a) for (_, t), a in zip(
            cache_leaves(m.cache_specs(B_CACHE, S_CACHE)),
            m.cache_axes_list(B_CACHE, S_CACHE))]
        _LEAVES[arch] = (([(tuple(s.shape), s.axes) for s in jp],
                          [(tuple(s.shape), s.axes) for s in pp]), (jc, pc))
    return _LEAVES[arch]


def _specs(mod, mesh, rules, leaves):
    with mod.use_mesh_and_rules(mesh, rules):
        specs = [_norm(mod.partition_spec(s, a)) for s, a in leaves]
        dropped = [(n, d, tuple(m)) for n, d, m in mod.dropped_axes()]
    return specs, dropped


def _rule_cases(arch):
    """(label, mesh name, port rules, JAX rules) of every table, every
    ``rules_for`` and its ZeRO-1 form."""
    out = [(t, mname, getattr(Sh, t), getattr(JSh, t))
           for mname in MESHES for t in TABLES[mname]]
    for shape in SHAPES:
        for mp, mname in ((False, "16x16"), (True, "2x16x16")):
            r = R.rules_for(get_arch(arch), SHAPES[shape], multi_pod=mp)
            jr = JR.rules_for(jget_arch(arch), _jshape(shape), multi_pod=mp)
            out.append((f"rules_for {shape}", mname, r, jr))
            out.append((f"zero1 {shape}", mname, R.zero1_param_rules(r),
                        JR.zero1_param_rules(jr)))
    return out


def _jshape(name):
    from repro.configs import SHAPES as JSHAPES
    return JSHAPES[name]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_partition_specs_match_jax(arch):
    (jp, pp), (jc, pc) = leaves_of(arch)
    assert [s for s, _ in jp] == [s for s, _ in pp]
    assert jc == pc
    for label, mname, rules, jrules in _rule_cases(arch):
        mesh = MESHES[mname]
        for what, jl, pl in (("params", jp, pp), ("caches", jc, pc)):
            assert _specs(Sh, mesh, rules, pl) == _specs(
                JSh, mesh, jrules, jl), (arch, label, mname, what)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_rules_for_and_model_flops_match_jax(arch):
    for shape in SHAPES:
        for mp in (False, True):
            r = R.rules_for(get_arch(arch), SHAPES[shape], multi_pod=mp)
            assert r == JR.rules_for(jget_arch(arch), _jshape(shape),
                                     multi_pod=mp)
            assert R.zero1_param_rules(r) == JR.zero1_param_rules(r)
    for kind in ("train", "inference"):
        for tokens in (1, 128, 256 * 4096):
            assert model_flops(get_arch(arch), tokens, kind) == \
                jmodel_flops(jget_arch(arch), tokens, kind)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x22b", "gemma3-12b"])
def test_train_cell_bytes_per_device_match_jax(arch, multi_pod):
    """Parameters in bf16 under the train rules plus both fp32 moments
    under ZeRO-1's, per device."""
    mesh = MESHES["2x16x16" if multi_pod else "16x16"]
    (jp, pp), _ = leaves_of(arch)
    r = R.rules_for(get_arch(arch), SHAPES["train_4k"], multi_pod=multi_pod)
    jr = JR.rules_for(jget_arch(arch), _jshape("train_4k"),
                      multi_pod=multi_pod)

    def port_bytes(rules, size):
        return sum(np.prod(Sh.local_shape(s, mesh, Sh.partition_spec_of(
            mesh, rules, s, a))) * size for s, a in pp)

    def jax_bytes(rules, size):
        with JSh.use_mesh_and_rules(mesh, rules):
            return sum(np.prod(NamedSharding(mesh, JSh.partition_spec(
                s, a)).shard_shape(s)) * size for s, a in jp)

    got = port_bytes(r, 2) + 2 * port_bytes(R.zero1_param_rules(r), 4)
    want = jax_bytes(jr, 2) + 2 * jax_bytes(JR.zero1_param_rules(jr), 4)
    assert got == want > 0


def test_placements_split_pod_major():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert Sh.placements(mesh, (("pod", "data"), None, ("model",))) == (
        Shard(0), Shard(0), Shard(2))
    assert Sh.placements(mesh, (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        Sh.placements(mesh, (("data", "pod"),))
    assert Sh.local_shape((64, 8, 32), mesh,
                          (("pod", "data"), None, ("model",))) == (2, 8, 2)


# ---------------------------------------------------------------------------
# one 4-rank gloo group and one 8-device JAX process
# ---------------------------------------------------------------------------

_GLOO = r'''
import datetime, os, pickle, sys, dataclasses
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TMP = sys.argv[1]


def run(rank, world):
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(TMP, "store"), world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=180))
    try:
        out = work(rank)
        if rank == 0:
            with open(os.path.join(TMP, "port.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def work(rank):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import sharding as Sh
    from repro_torch import tree as T
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint.elastic import elastic_restore, reshard_tree
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.launch.sharding_rules import zero1_param_rules
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.optim import compress
    from repro_torch.optim.adamw import AdamW

    with open(os.path.join(TMP, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    m22 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                     mesh_dim_names=("data", "model"))
    m14 = DeviceMesh("cpu", torch.arange(4).reshape(1, 4),
                     mesh_dim_names=("data", "model"))
    rules = Sh.RULES_SINGLE_POD
    out = {}
    calls = []
    # on 1x4 the 4 query heads shard over model and the 2 KV heads do not
    for arch, mname, mesh in (("yi-6b", "2x2", m22),
                              ("mixtral-8x22b", "2x2", m22),
                              ("yi-6b", "1x4", m14)):
        cfg = dataclasses.replace(smoke_config(get_arch(arch)),
                                  dtype="float32")
        model = Model(cfg)
        counted = lambda a, b, **kw: (calls.append(1),
                                      ops.kraken_matmul(a, b, **kw))[1]
        model.kernels = model.kernels._replace(matmul=counted)
        batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
        params = reshard_tree(params_from_numpy(inp["params"][arch],
                                                device="cpu"),
                              model.param_axes(), mesh, rules)
        leaves = T.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        bd = {k: Sh.distribute(v, mesh, Sh.placements(
            mesh, Sh.partition_spec_of(mesh, rules, v.shape,
                                       ("batch", "seq"))))
              for k, v in batch.items()}
        n0 = len(calls)
        with Sh.use_mesh_and_rules(mesh, rules), Sh.mixing(leaves[0]):
            loss, aux = model.loss(params, bd)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        out[arch, mname] = {"loss": float(loss.full_tensor()),
                     "local_gemms": len(calls) - n0,
                     "grads": [g.full_tensor().numpy() for g in grads],
                     "embed_local": tuple(params["embed"].to_local().shape)}

    # prefill + decode under decode_32k's rules: the caches sharded over
    # batch (data) and kv_seq (model), each decode step's softmax combined
    # across the kv shards; mixtral's window-8 ring wraps
    from repro_torch.configs import SHAPES
    from repro_torch.launch.sharding_rules import rules_for
    dec = inp["decode"]
    out["decode"] = {}
    for arch in ("yi-6b", "mixtral-8x22b"):
        cfg = dataclasses.replace(smoke_config(get_arch(arch)),
                                  dtype="float32")
        model = Model(cfg)
        drules = rules_for(cfg, SHAPES["decode_32k"], multi_pod=False)
        plain = params_from_numpy(inp["params"][arch], device="cpu")
        logits = {}
        for label in ("plain", "mesh"):
            caches = model.init_caches(dec["batch"], dec["cache_len"],
                                       device="cpu")
            p, put = plain, (lambda t, ax: t)
            if label == "mesh":
                p = reshard_tree(plain, model.param_axes(), m22, drules)
                axes = iter(model.cache_axes_list(dec["batch"],
                                                  dec["cache_len"]))
                caches = S.map_cache(caches, lambda _, t: Sh.distribute(
                    t, m22, Sh.placements(m22, Sh.partition_spec_of(
                        m22, drules, t.shape, next(axes)))))
                put = lambda t, ax: Sh.distribute(t, m22, Sh.placements(
                    m22, Sh.partition_spec_of(m22, drules, t.shape, ax)))
            with Sh.use_mesh_and_rules(m22 if label == "mesh" else None,
                                       drules):
                lg, caches = model.prefill(p, {
                    "tokens": put(torch.from_numpy(dec["prompt"]),
                                  ("batch", "seq")),
                    "positions": torch.arange(dec["prompt"].shape[1])},
                    caches)
                seq = [lg]
                for tok, pos in zip(dec["tokens"], dec["pos"]):
                    lg, caches = model.decode_step(
                        p, caches, put(torch.from_numpy(tok), ("batch", None)),
                        put(torch.from_numpy(pos), ("batch",)))
                    seq.append(lg)
            logits[label] = [(t.full_tensor() if Sh.is_dtensor(t) else t)
                             .numpy() for t in seq]
        out["decode"][arch] = logits

    # one ZeRO-1 train step of yi-6b
    cfg = dataclasses.replace(smoke_config(get_arch("yi-6b")),
                              dtype="float32")
    model = Model(cfg)
    opt = AdamW(lr=1e-3)
    axes = model.param_axes()
    params = reshard_tree(params_from_numpy(inp["params"]["yi-6b"],
                                            device="cpu"), axes, m22, rules)
    ostate = opt.init(params, axes=axes, mesh=m22,
                      rules=zero1_param_rules(rules))
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    bd = {k: Sh.distribute(v, m22, Sh.placements(
        m22, Sh.partition_spec_of(m22, rules, v.shape, ("batch", "seq"))))
          for k, v in batch.items()}
    step = S.make_train_step(model, opt, num_microbatches=2, remat="none")
    with Sh.use_mesh_and_rules(m22, rules):
        params, ostate, met = step(params, ostate, bd)
    out["zero1"] = {"params": [p.detach().full_tensor().numpy()
                               for p in T.leaves(params)],
                    "loss": float(met["loss"]),
                    "grad_norm": float(met["grad_norm"]),
                    "m_local": [tuple(m.to_local().shape)
                                for m in T.leaves(ostate.m)],
                    "m_global": [tuple(m.shape)
                                 for m in T.leaves(ostate.m)]}

    # a JAX-written checkpoint onto 2x2, then 4x1
    specs = model.param_specs(lambda s: torch.empty(s.shape,
                                                    device="meta"))
    out["elastic"] = {}
    for name, shape in (("2x2", (2, 2)), ("4x1", (4, 1))):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                          mesh_dim_names=("data", "model"))
        tree, st, _ = elastic_restore(os.path.join(TMP, "ckpt"), specs,
                                      axes, mesh, rules)
        out["elastic"][name] = {
            "step": st, "full": [t.full_tensor().numpy()
                                 for t in T.leaves(tree)],
            "local": [tuple(t.to_local().shape) for t in T.leaves(tree)]}

    # the compressed all-reduce over the 4-rank model axis
    g = {"w": torch.from_numpy(inp["compress"][rank])}
    with Sh.use_mesh_and_rules(m14, rules):
        mean, _ = compress.allreduce_compressed(g, compress.init_state(g),
                                                "model")
    got = [torch.zeros_like(mean["w"]) for _ in range(4)]
    dist.all_gather(got, mean["w"])
    out["compress"] = [t.numpy() for t in got]

    # context-parallel attention, H 6 over 4 ranks
    cp = inp["cp"]
    q, k, v = (torch.from_numpy(cp[n]) for n in "qkv")
    pos = torch.arange(q.shape[2])
    cprules = dict(rules, attn_context_parallel="model")
    out["cp"] = {}
    for w in (0, 512):
        qq = q.clone().requires_grad_(True)
        with Sh.use_mesh_and_rules(m14, cprules):
            o = L._gqa_sdpa(qq, k, v, window=w, q_pos=pos, kv_pos=pos)
            gq, = torch.autograd.grad(torch.tanh(o).sum(), qq)
        out["cp"][w] = {"fwd": o.full_tensor().detach().numpy(),
                        "grad": gq.numpy()}
    return out


if __name__ == "__main__":
    mp.spawn(run, args=(4,), nprocs=4)
'''

_JAX8 = r'''
import functools, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import sharding as Sh
from repro.models import layers as L
from repro.optim import compress

TMP = sys.argv[1]
with open(TMP + "/inputs.pkl", "rb") as f:
    inp = pickle.load(f)


def make_mesh(shape, names):
    devs = jax.devices()[:int(np.prod(shape))]
    try:
        return jax.make_mesh(shape, names, devices=devs,
                             axis_types=(jax.sharding.AxisType.Auto,)
                             * len(shape))
    except (AttributeError, TypeError):
        return jax.make_mesh(shape, names, devices=devs)


out = {}
mesh = make_mesh((4,), ("pod",))
g = jnp.asarray(inp["compress"])


@functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("pod"),),
                   out_specs=P("pod"), check_vma=False)
def sync(local_g):
    grads = {"w": local_g[0]}
    mean, _ = compress.allreduce_compressed(
        grads, compress.init_state(grads), "pod")
    return mean["w"][None]


out["compress"] = np.asarray(sync(g))
mesh = make_mesh((1, 4), ("data", "model"))
rules = dict(Sh.RULES_SINGLE_POD, attn_context_parallel="model")
cp = inp["cp"]
q, k, v = (jnp.asarray(cp[n]) for n in "qkv")
pos = jnp.arange(q.shape[2])
out["cp"] = {}
for w in (0, 512):
    def f(q_):
        with Sh.use_mesh_and_rules(mesh, rules):
            return L._gqa_sdpa(q_, k, v, mask_mode="causal", window=w,
                               q_pos=pos, kv_pos=pos)
    fwd = jax.jit(f)(q)
    grad = jax.jit(jax.grad(lambda q_: jnp.sum(jnp.tanh(f(q_)))))(q)
    out["cp"][w] = {"fwd": np.asarray(fwd), "grad": np.asarray(grad)}

# mixtral under the 2x2 mesh: its MoE routes one dispatch group per data
# shard, each with its own capacity, so its values are the sharded ones
import dataclasses
from repro.configs import SHAPES, get_arch, smoke_config
from repro.launch.sharding_rules import rules_for
from repro.models.model import Model
mesh = make_mesh((2, 2), ("data", "model"))
cfg = dataclasses.replace(smoke_config(get_arch("mixtral-8x22b")),
                          dtype="float32")
model = Model(cfg)
params = jax.tree.map(jnp.asarray, inp["params"]["mixtral-8x22b"])


def loss(p, b):
    with Sh.use_mesh_and_rules(mesh, Sh.RULES_SINGLE_POD):
        return model.loss(p, b)


batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
(jl, _), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, batch)
out["moe_mesh"] = {"loss": float(jl),
                   "grads": [np.asarray(x) for x in jax.tree.leaves(jg)]}
drules = rules_for(cfg, SHAPES["decode_32k"], multi_pod=False)


def prefill(p, t, c):
    with Sh.use_mesh_and_rules(mesh, drules):
        return model.prefill(p, {"tokens": t,
                                 "positions": jnp.arange(t.shape[1])}, c)


def decode(p, c, t, pos):
    with Sh.use_mesh_and_rules(mesh, drules):
        return model.decode_step(p, c, t, pos)


dec = inp["decode"]
jc = model.init_caches(dec["batch"], dec["cache_len"], flat=True)
lg, jc = jax.jit(prefill)(params, jnp.asarray(dec["prompt"]), jc)
seq = [np.asarray(lg)]
for tok, pos in zip(dec["tokens"], dec["pos"]):
    lg, jc = jax.jit(decode)(params, jc, jnp.asarray(tok), jnp.asarray(pos))
    seq.append(np.asarray(lg))
out["moe_mesh_decode"] = seq
with open(TMP + "/jax.pkl", "wb") as f:
    pickle.dump(out, f)
'''


def _jax_setup(arch):
    jcfg = dataclasses.replace(jsmoke(jget_arch(arch)), dtype="float32")
    jm = JModel(jcfg)
    return jm, jm.init(jax.random.key(0))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Runs the gloo group and the 8-device JAX process side by side;
    returns (port results, JAX subprocess results, JAX in-process
    results)."""
    tmp = tmp_path_factory.mktemp("group")
    rng = np.random.default_rng(0)
    cfg = jsmoke(jget_arch("yi-6b"))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
        np.int32)}
    setups = {a: _jax_setup(a) for a in ("yi-6b", "mixtral-8x22b")}
    B, H, KV, S, D = 2, 6, 2, 4096, 16
    inp = {"batch": batch,
           "params": {a: jax.tree.map(np.asarray, p)
                      for a, (_, p) in setups.items()},
           "compress": (np.arange(4 * 64, dtype=np.float32).reshape(4, 64)
                        / 7.0 - rng.standard_normal((4, 64)).astype(
                            np.float32)),
           "cp": {n: rng.standard_normal(shape).astype(np.float32)
                  for n, shape in (("q", (B, H, S, D)), ("k", (B, KV, S, D)),
                                   ("v", (B, KV, S, D)))},
           "decode": {"batch": 4, "cache_len": 16,
                      "prompt": rng.integers(0, cfg.vocab_size, (4, 6))
                      .astype(np.int32),
                      "tokens": rng.integers(0, cfg.vocab_size, (4, 4, 1))
                      .astype(np.int32),
                      "pos": [np.asarray([6 + t, 6 + t, 6 + 2 * t, 6 + t],
                                         np.int32) for t in range(4)]}}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    jm, jp = setups["yi-6b"]
    jckpt.save(str(tmp / "ckpt"), 7, jp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OMP_NUM_THREADS="1")
    procs = {}
    for name, code in (("port", _GLOO), ("jax", _JAX8)):
        script = tmp / f"group_{name}.py"
        script.write_text(textwrap.dedent(code))
        procs[name] = subprocess.Popen(
            [sys.executable, str(script), str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    # JAX in this process meanwhile: the unsharded losses, gradients and
    # one train step
    want = {}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for arch, (jmodel, jparams) in setups.items():
        (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
            jparams, jb)
        want[arch] = {"loss": float(jl), "grads": jg}
    jopt = jadamw.AdamW(lr=1e-3)
    jstep = jax.jit(JS.make_train_step(jm, jopt, num_microbatches=2,
                                       remat="none"))
    new, _, jmet = jstep(jp, jopt.init(jp), jb)
    want["zero1"] = {"params": jax.tree.leaves(new),
                     "loss": float(jmet["loss"]),
                     "grad_norm": float(jmet["grad_norm"])}
    want["ckpt"] = jax.tree.leaves(jp)
    dec = inp["decode"]
    want["decode"] = {}
    for arch, (jmodel, jparams) in setups.items():
        jc = jmodel.init_caches(dec["batch"], dec["cache_len"], flat=True)
        lg, jc = jmodel.prefill(jparams, {
            "tokens": jnp.asarray(dec["prompt"]),
            "positions": jnp.arange(dec["prompt"].shape[1])}, jc)
        seq = [np.asarray(lg)]
        for tok, pos in zip(dec["tokens"], dec["pos"]):
            lg, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok),
                                        jnp.asarray(pos))
            seq.append(np.asarray(lg))
        want["decode"][arch] = seq

    res = {}
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        assert p.returncode == 0, (name, err[-4000:])
        with open(tmp / f"{name}.pkl", "rb") as f:
            res[name] = pickle.load(f)
    return res["port"], res["jax"], want, inp


def _close_leaves(got, want, tol=GRAD_TOL):
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(g - w).max()) <= tol * scale


@pytest.mark.parametrize("arch, mesh", [("yi-6b", "2x2"),
                                        ("mixtral-8x22b", "2x2"),
                                        ("yi-6b", "1x4")])
def test_sharded_loss_and_grads_match_jax(group, arch, mesh):
    """The loss and every gradient leaf against JAX's values: unsharded
    for yi-6b; for mixtral JAX's under the same 2x2 mesh, where the MoE
    routes one dispatch group per data shard with a capacity each (its
    loss is not the unsharded one).  Every GEMM ran on a rank's local
    shards through the ``dense_gemm`` op (its callable counted), the
    embedding is sharded over the vocab."""
    port, jx, want, _ = group
    got = port[arch, mesh]
    ref = jx["moe_mesh"] if arch == "mixtral-8x22b" else want[arch]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    _close_leaves(got["grads"], ref["grads"])
    if arch == "mixtral-8x22b":
        assert abs(ref["loss"] - want[arch]["loss"]) > 1e-4
    assert got["local_gemms"] > 0
    assert got["embed_local"] == (256 // int(mesh[-1]), 64)


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x22b"])
def test_sharded_decode_matches_jax(group, arch):
    """Prefill and 4 decode steps with the caches sharded over batch and
    kv_seq (2x2, decode_32k's rules): every step's logits against JAX's
    dense-cache path (1e-4, as ``tests/test_torch_dense_cache.py``) --
    unsharded for yi-6b, where they also equal the port's unsharded ones;
    under the same mesh for mixtral, whose MoE routes per data shard --
    and the port's unsharded logits against JAX's unsharded ones."""
    port, jx, want, _ = group
    got = port["decode"][arch]
    ref = (jx["moe_mesh_decode"] if arch == "mixtral-8x22b"
           else want["decode"][arch])
    assert len(got["mesh"]) == len(ref) == 5
    for g, p, w, u in zip(got["mesh"], got["plain"], ref,
                          want["decode"][arch]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(p, u, rtol=1e-4, atol=1e-4)


def test_zero1_step_matches_jax(group):
    port, _, want, _ = group
    got = port["zero1"]
    np.testing.assert_allclose(got["loss"], want["zero1"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["zero1"]["grad_norm"],
                               rtol=1e-4)
    _close_leaves(got["params"], want["zero1"]["params"])
    # the moments are sharded over data on the embed dim as well
    assert any(loc != glob and loc[0] * 2 == glob[0]
               for loc, glob in zip(got["m_local"], got["m_global"]))


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_jax_checkpoint_restores_onto_mesh(group, mesh):
    port, _, want, _ = group
    got = port["elastic"][mesh]
    assert got["step"] == 7
    for g, w in zip(got["full"], want["ckpt"]):
        np.testing.assert_array_equal(g, np.asarray(w))
    model = Model(smoke_config(get_arch("yi-6b")))
    d, m = (2, 2) if mesh == "2x2" else (4, 1)
    sizes = {"data": d, "model": m}
    want_local = [Sh.local_shape(s.shape, sizes, Sh.partition_spec_of(
        sizes, Sh.RULES_SINGLE_POD, s.shape, s.axes))
        for _, s in _flatten(model._spec_tree())]
    assert got["local"] == want_local
    # 2x2 shards the model dims; 4x1 keeps every parameter whole (the
    # rules shard no parameter over data)
    sharded = [g != tuple(w.shape) for g, w in zip(got["local"],
                                                   want["ckpt"])]
    assert any(sharded) == (mesh == "2x2")


def test_allreduce_compressed_matches_jax(group):
    port, jx, _, inp = group
    for r in range(4):     # every rank holds the same mean
        np.testing.assert_allclose(port["compress"][r], jx["compress"][0],
                                   rtol=1e-5, atol=1e-6)
    g = inp["compress"]
    bound = np.abs(g).max() / 127
    assert np.abs(port["compress"][0] - g.mean(0)).max() <= 1.5 * bound


@pytest.mark.parametrize("window", [0, 512])
def test_context_parallel_attention_matches_jax(group, window):
    port, jx, _, _ = group
    for what in ("fwd", "grad"):
        np.testing.assert_allclose(port["cp"][window][what],
                                   jx["cp"][window][what], atol=1e-5)
