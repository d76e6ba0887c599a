"""Training in the port against the JAX package, on the CPU.

Both packages run the same float32 smoke parameters (``repro``'s init,
bridged) on the same numpy batches.  XLA and PyTorch sum each product in
another order (about 1e-6 relative), so losses agree within 1e-5 and each
gradient leaf within ``GRAD_TOL`` of its largest entry.

* ``ops.KrakenMatmul``, the gradient of ``kraken_matmul``: gradcheck in
  float64 for every activation with and without a bias, and its dA, dB and
  dbias against autograd through ``ref.matmul`` in float32, with its
  launches counted (one forward, two backward products, one more to
  recompute the pre-activation of an activated call).
* The loss and every gradient leaf against ``jax.value_and_grad`` of
  ``Model.loss`` for yi-6b and one smoke config of each other family
  (mixtral-8x22b with its aux loss on the einsum path, rwkv6-3b,
  zamba2-1.2b, gemma3-12b tied with windows, llama-3.2-vision-11b with
  patches, musicgen-large with frames and the bias + gelu MLP); the three
  remat modes agree, and launch what each should.
* The windowed archs at S 128, where the cache-less forward takes
  ``swa_attention`` (S % 128 == 0): gemma3-12b's and mixtral-8x22b's smoke
  loss and gradients against JAX's (which differentiates its plain
  attention), through ``ops.SwaAttention`` on CPU tensors (the plain
  forward with its lse, the plain backward), with the calls counted (5
  local layers, 2 windowed ones); remat ``"full"`` and ``"dots"`` against
  ``"none"``, both calling each forward twice.
* ``_gqa_sdpa_chunked``'s gradient against JAX's at S 2048.
* Three AdamW train steps of JAX's jitted ``make_train_step`` against the
  port's, from the same bridged parameters and optimizer state: with the
  clip binding and not, and with 2 microbatches; ``cosine_schedule`` at
  every step; the sliced update against an unsliced one.
* Checkpoints written by either package restore in the other, bf16 leaves
  included; ``keep``, ``latest_step`` and an async write's error.
* ``data/pipeline.py`` is the reference's code; ``quantize`` and
  ``compress`` equal JAX's on seeded trees.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.optim import quantize as jquantize  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.bridge import adamw_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw, compress, quantize  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ACTS = [None, "relu", "silu", "gelu"]
ARCHS = ["yi-6b", "mixtral-8x22b", "rwkv6-3b", "zamba2-1.2b", "gemma3-12b",
         "llama-3.2-vision-11b", "musicgen-large"]
GRAD_TOL = 1e-4   # of the leaf's largest |entry|
_SETUP: dict = {}


def setup(arch):
    """(jax model, jax params, port config) for the float32 smoke config."""
    if arch not in _SETUP:
        jcfg = dataclasses.replace(jsmoke(jget_arch(arch)), dtype="float32")
        cfg = dataclasses.replace(smoke_config(get_arch(arch)),
                                  dtype="float32")
        jmodel = JModel(jcfg)
        _SETUP[arch] = (jmodel, jmodel.init(jax.random.key(0)), cfg)
    return _SETUP[arch]


def bridged(jparams):
    """A fresh port copy of JAX's parameters (the train steps update it in
    place)."""
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def make_batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "image_patches":
        out["frontend"] = rng.standard_normal(
            (b, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "audio_frames":
        out["frontend"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def counting(fn, calls):
    def run(*args, **kw):
        calls.append(kw.get("activation"))
        return fn(*args, **kw)
    return run


def port_grads(model, params, batch, remat="none"):
    leaves = T.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, aux = model.loss(params, to_torch(batch), remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), aux, grads


def assert_leaves_close(got_leaves, want_tree, tol=GRAD_TOL):
    want = list(T.leaves_with_path(jax.tree.map(np.asarray, want_tree)))
    assert len(got_leaves) == len(want)
    for g, (path, w) in zip(got_leaves, want):
        g = np.zeros_like(w) if g is None else g.detach().float().numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (path, err, scale)


# ---------------------------------------------------------------------------
# the Function
# ---------------------------------------------------------------------------

ACT64 = {"relu": lambda z: torch.clamp_min(z, 0.0),
         "silu": lambda z: z * torch.sigmoid(z),
         "gelu": lambda z: 0.5 * z * (1.0 + torch.tanh(
             0.7978845608028654 * (z + 0.044715 * z ** 3)))}


def plain64(a, b, *, bias=None, activation=None):
    """``ref.matmul``'s arithmetic in float64 (``ref.matmul`` itself
    rounds to fp32, too coarse for finite differences)."""
    out = a @ b
    if bias is not None:
        out = out + bias
    return out if activation is None else ACT64[activation](out)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_function_gradcheck(act, bias):
    g = torch.Generator().manual_seed(ACTS.index(act) * 2 + bias)
    a = torch.randn(5, 4, dtype=torch.float64, generator=g)
    b = torch.randn(4, 3, dtype=torch.float64, generator=g)
    c = torch.randn(3, dtype=torch.float64, generator=g) if bias else None
    args = [t.requires_grad_() for t in (a, b, c) if t is not None]

    def fn(*xs):
        return ops.kraken_matmul_grad(xs[0], xs[1],
                                      bias=xs[2] if bias else None,
                                      activation=act, matmul=plain64)
    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_function_matches_autograd_through_ref(act, bias):
    """At a ragged shape (M 65, K 27, N 123, which TMA refuses on the card
    once transposed), against autograd through the plain version; the
    backward launches its two products and, for an activation, the
    recomputed pre-activation."""
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((65, 27)), rng.standard_normal((27, 123))
    c = rng.standard_normal(123) if bias else None
    dy = rng.standard_normal((65, 123))

    def leaves():
        return [torch.tensor(x, dtype=torch.float32, requires_grad=True)
                if x is not None else None for x in (a, b, c)]

    ta, tb, tc = leaves()
    want = ref.matmul(ta, tb, bias=tc, activation=act)
    want_g = torch.autograd.grad(want, [t for t in (ta, tb, tc)
                                        if t is not None],
                                 torch.from_numpy(dy).float())
    calls = []
    ga, gb, gc = leaves()
    got = ops.kraken_matmul_grad(ga, gb, bias=gc, activation=act,
                                 matmul=counting(ref.matmul, calls))
    assert calls == [act]
    got_g = torch.autograd.grad(got, [t for t in (ga, gb, gc)
                                      if t is not None],
                                torch.from_numpy(dy).float())
    assert calls == [act] + ([None] if act else []) + [None, None]
    assert torch.equal(got, want)
    for x, y in zip(got_g, want_g):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_dense_takes_the_function_only_under_grad():
    """Without grad the serving paths' direct call; with it the Function."""
    x = torch.randn(3, 8)
    w = torch.randn(8, 4)
    calls = []
    kernels = L.DEFAULT_KERNELS._replace(matmul=counting(ref.matmul, calls))
    out = L.dense(x, w, kernels=kernels)
    assert out.grad_fn is None and len(calls) == 1
    w.requires_grad_(True)
    with torch.no_grad():
        assert L.dense(x, w, kernels=kernels).grad_fn is None
    out = L.dense(x, w, activation="silu", kernels=kernels)
    assert out.requires_grad
    out.sum().backward()
    # forward 3, then the recomputed pre-activation and dB (x needs none)
    assert calls == [None, None, "silu", None, None]


# ---------------------------------------------------------------------------
# loss and gradients against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jmodel, jparams, cfg = setup(arch)
    batch = make_batch(cfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    # the grouped expert kernel must not run under grad
    def no_moe_ffn(*args):
        raise AssertionError("grouped_expert_ffn under grad")
    model = Model(cfg, kernels=L.DEFAULT_KERNELS._replace(moe_ffn=no_moe_ffn))
    loss, aux, grads = port_grads(model, bridged(jparams), batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(jaux["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["aux"].detach()), float(jaux["aux"]),
                               rtol=1e-5, atol=1e-7)
    if cfg.num_experts:
        assert float(aux["aux"].detach()) > 0
    assert_leaves_close(grads, jg)


def test_remat_modes_agree():
    """yi-6b smoke: the three modes' gradients within 1e-6; "full"
    recomputes every dense call but the unembed, "dots" none."""
    _, jparams, cfg = setup("yi-6b")
    batch = make_batch(cfg, seed=3)
    results = {}
    for remat in ("none", "full", "dots"):
        calls = []
        model = Model(cfg, kernels=L.DEFAULT_KERNELS._replace(
            matmul=counting(ops.kraken_matmul, calls)))
        loss, _, grads = port_grads(model, bridged(jparams), batch, remat)
        results[remat] = (float(loss), grads, len(calls))
    per_layer = 7
    fwd = cfg.num_layers * per_layer + 1
    bwd = 2 * fwd + cfg.num_layers           # + the silu gate's z
    assert results["none"][2] == fwd + bwd
    assert results["dots"][2] == fwd + bwd
    assert results["full"][2] == 2 * fwd - 1 + bwd
    for remat in ("full", "dots"):
        assert results[remat][0] == results["none"][0]
        for g, w in zip(results[remat][1], results["none"][1]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(w.abs().max()))


# the windowed archs' swa_attention calls in one forward at S 128: gemma3's
# 5 local layers of its 6, mixtral's 2 (every layer windowed)
SWA_CALLS = {"gemma3-12b": 5, "mixtral-8x22b": 2}


@pytest.mark.parametrize("arch", sorted(SWA_CALLS))
def test_windowed_archs_grads_through_swa_attention(arch, monkeypatch):
    jmodel, jparams, cfg = setup(arch)
    batch = make_batch(cfg, b=2, s=128, seed=5)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    fwd, bwd = [], []
    real_bwd = ref.sliding_window_attention_bwd

    def counted_bwd(*args, **kw):
        bwd.append(kw["window"])
        return real_bwd(*args, **kw)
    monkeypatch.setattr(ref, "sliding_window_attention_bwd", counted_bwd)

    def counted(q, k, v, *, window):
        out = ops.swa_attention(q, k, v, window=window)
        fwd.append(type(out.grad_fn).__name__)
        return out

    model = Model(cfg, kernels=L.DEFAULT_KERNELS._replace(
        swa_attention=counted))
    results = {}
    for remat in ("none", "full", "dots"):
        fwd.clear()
        bwd.clear()
        results[remat] = port_grads(model, bridged(jparams), batch, remat)
        n = SWA_CALLS[arch]
        # both remats recompute the attention ("dots" keeps only the dense
        # GEMMs' outputs)
        assert fwd == ["SwaAttentionBackward"] * (n if remat == "none"
                                                  else 2 * n), remat
        assert bwd == [8] * n
    loss, aux, grads = results["none"]
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(jaux["ce"]),
                               rtol=1e-5)
    assert_leaves_close(grads, jg)
    for remat in ("full", "dots"):
        assert float(results[remat][0]) == float(loss)
        for g, w in zip(results[remat][2], grads):
            if w is None:
                assert g is None
                continue
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("window", [0, 300])
def test_chunked_attention_grad_matches_jax(window):
    s, rng = 2048, np.random.default_rng(window)
    q = rng.standard_normal((1, 2, s, 8)).astype(np.float32)
    k = rng.standard_normal((1, 1, s, 8)).astype(np.float32)
    v = rng.standard_normal((1, 1, s, 8)).astype(np.float32)
    ct = rng.standard_normal((1, 2, s, 8)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)

    def jf(q, k, v):
        out = JL._gqa_sdpa_chunked(q, k, v, window=window,
                                   q_pos=jnp.asarray(pos),
                                   kv_pos=jnp.asarray(pos), causal=True)
        return jnp.sum(out * ct)
    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tpos = torch.from_numpy(pos)
    out = L._gqa_sdpa_chunked(tq, tk, tv, window=window, q_pos=tpos,
                              kv_pos=tpos)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                              [tq, tk, tv])
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

STEP_CASES = {"clip": dict(grad_clip=1.0, micro=1),
              "noclip": dict(grad_clip=1e3, micro=1),
              "micro2": dict(grad_clip=1.0, micro=2)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case):
    opts = STEP_CASES[case]
    jmodel, jparams, cfg = setup("yi-6b")
    # Adam moves an entry by ~lr whatever its gradient's size, so a
    # gradient within rounding of zero turns rounding into an lr-sized
    # step: at 1e-3 the three steps stay within rounding of JAX's, at 1e-2
    # the third step's moments part by 3e-4
    lr = dict(peak_lr=1e-3, warmup=2, total=3)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(**lr),
                        grad_clip=opts["grad_clip"])
    opt = adamw.AdamW(lr=adamw.cosine_schedule(**lr),
                      grad_clip=opts["grad_clip"])
    jstep = jax.jit(JS.make_train_step(jmodel, jopt,
                                       num_microbatches=opts["micro"]))
    step = S.make_train_step(Model(cfg), opt, num_microbatches=opts["micro"])
    jst = jopt.init(jparams)
    params = bridged(jparams)
    st = adamw_state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    jp = jparams
    for i in range(3):
        batch = make_batch(cfg, b=4, seed=10 + i)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        params, st, m = step(params, st, to_torch(batch))
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        if case == "clip":
            assert float(m["grad_norm"]) > 1.0      # the clip binds
        if case == "noclip":
            assert float(m["grad_norm"]) < 1e3
    assert int(st.step) == int(jst.step) == 3
    assert_leaves_close(T.leaves(st.m), jst.m)
    assert_leaves_close(T.leaves(st.v), jst.v)
    assert_leaves_close(T.leaves(params), jp)


def test_cosine_schedule_matches_jax():
    jlr = jadamw.cosine_schedule(3e-4, warmup=20, total=100)
    lr = adamw.cosine_schedule(3e-4, warmup=20, total=100)
    for s in range(0, 110):
        np.testing.assert_allclose(
            float(lr(torch.tensor(s, dtype=torch.int32))),
            float(jlr(jnp.asarray(s, jnp.int32))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("periods", [False, True])
def test_sliced_update_equals_unsliced(monkeypatch, periods):
    """The update in slices of 7 elements gives the same bits as one slice
    a leaf; with ``periods`` both read each stacked leaf's gradient as the
    tuple of its periods, as the train step passes it (one period a slice,
    or a stack of them)."""
    _, jparams, cfg = setup("yi-6b")
    grads = bridged(jax.tree.map(lambda p: 0.5 * p + 0.01, jparams))
    out = []
    for size in (7, 1 << 30):
        monkeypatch.setattr(adamw, "SLICE", size)
        opt = adamw.AdamW(lr=1e-2)
        params = bridged(jparams)
        st = opt.init(params)
        g = grads
        if periods:
            g = {**grads, "stack": {**grads["stack"], "slots": [
                {k: w.unbind(0) for k, w in sp.items()}
                for sp in grads["stack"]["slots"]]}}
        for _ in range(2):
            params, st, m = opt.update(g, st, params)
        out.append((T.leaves(params), T.leaves(st.m), T.leaves(st.v),
                    float(m["grad_norm"])))
    np.testing.assert_allclose(out[0][3], out[1][3], rtol=1e-6)
    for a, b in zip(out[0][:3], out[1][:3]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _bf16_state(cfg, jparams):
    """JAX's (params in bf16, AdamW state) and the port's copy of them."""
    jp = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jparams)
    jst = jadamw.AdamW().init(jp)
    jst = jst._replace(step=jnp.asarray(7, jnp.int32),
                       m=jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5,
                                      jp))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                          dtype=torch.bfloat16)
    st = adamw_state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    return {"params": jp, "opt": jst}, {"params": p, "opt": st}


def _same(port_tree, jax_tree):
    got = list(T.leaves_with_path(port_tree))
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [k for k, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    _, jparams, cfg = setup("yi-6b")
    jtree, ptree = _bf16_state(cfg, jparams)
    d = str(tmp_path / "ck")
    if writer == "port":
        ckpt.save(d, 7, ptree, extra={"pipe_step": 7})
        tree, step, extra = jckpt.restore(d, jtree)
        _same(ptree, tree)
    else:
        jckpt.save(d, 7, jtree, extra={"pipe_step": 7})
        meta = T.map_leaves(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                  device="meta"), ptree)
        tree, step, extra = ckpt.restore(d, meta)
        _same(tree, jtree)
    assert step == 7 and extra == {"pipe_step": 7}


def test_checkpoint_keep_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, {"a": torch.zeros(2)})
    for s in range(1, 6):
        ckpt.save(d, s, {"a": torch.full((2,), float(s))}, keep=2)
    assert sorted(p.name for p in Path(d).iterdir()) == [
        "step_00000004", "step_00000005"]
    assert ckpt.latest_step(d) == 5
    tree, step, _ = ckpt.restore(d, {"a": torch.zeros(2)}, step=4)
    assert step == 4 and tree["a"].tolist() == [4.0, 4.0]
    with pytest.raises(KeyError):
        ckpt.restore(d, {"b": torch.zeros(2)})


def test_async_checkpoint_snapshots_and_raises_on_wait(tmp_path):
    d = tmp_path / "ck"
    w = ckpt.AsyncCheckpointer(str(d))
    t = torch.ones(3)
    w.save(1, {"t": t})
    t.add_(1.0)            # in place after the snapshot: not in the file
    w.wait()
    assert ckpt.restore(str(d), {"t": t})[0]["t"].tolist() == [1.0] * 3
    bad = tmp_path / "file"
    bad.write_text("")
    w = ckpt.AsyncCheckpointer(str(bad))     # a file, not a directory
    w.save(1, {"t": t})
    with pytest.raises(OSError):
        w.wait()
    w.wait()               # the error is raised once


# ---------------------------------------------------------------------------
# copies and counterparts
# ---------------------------------------------------------------------------

def _code(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    tree.body = [n for n in tree.body
                 if not isinstance(n, ast.Import | ast.ImportFrom)]
    return ast.dump(tree)


def test_pipeline_is_a_copy():
    assert _code(ROOT / "src/repro_torch/data/pipeline.py") == \
        _code(ROOT / "src/repro/data/pipeline.py")


def _seeded_tree(seed):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "stack": {"slots": [{
                "attn_norm_gamma": rng.standard_normal((2, 8)).astype(
                    np.float32),
                "attn_wq": rng.standard_normal((2, 8, 12)).astype(
                    np.float32)}]},
            "bias": rng.standard_normal((12,)).astype(np.float32)}


def test_quantize_matches_jax():
    tree = _seeded_tree(0)
    jq, jstats = jquantize.quantize_params(jax.tree.map(jnp.asarray, tree))
    q, stats = quantize.quantize_params(
        T.map_leaves(torch.from_numpy, tree))
    assert stats == jstats
    is_q = lambda x: isinstance(x, jquantize.QuantizedTensor)
    is_q_port = lambda x: isinstance(x, quantize.QuantizedTensor)
    want = jax.tree_util.tree_flatten_with_path(jq, is_leaf=is_q)[0]
    for path, w in want:
        key = jax.tree_util.keystr(path)
        g = dict(T.leaves_with_path(q, is_leaf=is_q_port)).get(key)
        if is_q(w):
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_allclose(g.scale.numpy(), np.asarray(w.scale),
                                       rtol=1e-7)
        else:
            assert not is_q_port(g)
    np.testing.assert_allclose(
        quantize.dequantize_params(q, torch.float32)["embed"].numpy(),
        np.asarray(jquantize.dequantize_params(jq, jnp.float32)["embed"]),
        rtol=1e-6)
    errs = quantize.quantization_error(T.map_leaves(torch.from_numpy, tree),
                                       q)
    jerrs = jquantize.quantization_error(jax.tree.map(jnp.asarray, tree), jq)
    assert errs.keys() == jerrs.keys()
    for k in errs:
        np.testing.assert_allclose(errs[k], jerrs[k], rtol=1e-5)


def test_compress_matches_jax():
    grads = [_seeded_tree(s) for s in (1, 2)]
    jst = jcompress.init_state(jax.tree.map(jnp.asarray, grads[0]))
    st = compress.init_state(T.map_leaves(torch.from_numpy, grads[0]))
    for g in grads:             # two rounds: the residual carries over
        jq, js, jst = jcompress.compress_grads(jax.tree.map(jnp.asarray, g),
                                               jst)
        q, s, st = compress.compress_grads(T.map_leaves(torch.from_numpy, g),
                                           st)
        for a, b in ((q, jq), (s, js), (st.error, jst.error)):
            for x, y in zip(T.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                           rtol=1e-6, atol=1e-7)
        for x, y in zip(T.leaves(compress.decompress_grads(q, s)),
                        jax.tree.leaves(jcompress.decompress_grads(jq, js))):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
