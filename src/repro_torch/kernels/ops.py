"""The entry points the model code calls, one per kernel.

The dispatch has exactly two cases, decided by where the input lies: a CUDA
tensor launches the hand-written kernel (or the wrapper raises); a CPU
tensor runs the kernel's plain version from :mod:`ref`.  There is no
fallback from one to the other, and no TPU tile plan.

Under a mesh the operands are DTensors.  The dense GEMM reaches its kernel
through the :func:`dense_gemm` op, whose DTensor sharding rule
(:func:`register_dense_gemm_sharding`) runs the kernel on each rank's local
shards; every other kernel refuses a DTensor on the card.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import kraken_conv as _conv
from repro_torch.kernels import kraken_gemm as _gemm
from repro_torch.kernels import kraken_moe_gemm as _moe
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import swa_attention as _swa
from repro_torch.kernels import ref
from repro_torch.sharding import is_dtensor


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        if is_dtensor(t):
            raise NotImplementedError(
                "this kernel has no DTensor sharding rule: under a mesh only "
                "the dense GEMM (through dense_gemm) runs on the card")
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def kraken_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  bias: torch.Tensor | None = None,
                  activation: str | None = None,
                  out_dtype=None) -> torch.Tensor:
    """Uniform-dataflow matmul: [M, K] @ [K, N] (+bias, +activation).
    The kernel writes ``a.dtype``; another ``out_dtype`` is refused on the
    card."""
    if _on_cuda(a):
        if out_dtype is not None and out_dtype != a.dtype:
            raise ValueError("kraken_gemm writes a.dtype only")
        return _gemm.kraken_gemm(a, b, bias=bias, activation=activation)
    return ref.matmul(a, b, bias=bias, activation=activation,
                      out_dtype=out_dtype)


def activation_grad(activation: str, z: torch.Tensor) -> torch.Tensor:
    """d act / dz in fp32 at the pre-activation ``z``, as JAX
    differentiates ``jax.nn.relu`` (0 at 0), ``jax.nn.silu`` and the tanh
    ``jax.nn.gelu`` that ``ref.matmul`` computes."""
    z = z.to(torch.float32)
    if activation == "relu":
        return (z > 0).to(torch.float32)
    if activation == "silu":
        s = torch.reciprocal(1.0 + torch.exp(-z))
        return s * (1.0 + z * (1.0 - s))
    if activation == "gelu":
        c, k = 0.7978845608028654, 0.044715
        t = torch.tanh(c * (z + k * z ** 3))
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * c * (
            1.0 + 3.0 * k * z * z)
    raise ValueError(activation)


# the ``matmul`` callables :func:`dense_gemm` has been handed, by index: a
# custom op's arguments are tensors and scalars, so it names its callable
_MATMULS: list = []


def _route(matmul) -> int:
    for i, f in enumerate(_MATMULS):
        if f is matmul:
            return i
    _MATMULS.append(matmul)
    return len(_MATMULS) - 1


@torch.library.custom_op("repro_torch::dense_gemm", mutates_args=())
def dense_gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None,
               activation: str | None, route: int) -> torch.Tensor:
    """``_MATMULS[route](a, b, bias=bias, activation=activation)`` as one
    dispatcher op: the forward of :class:`KrakenMatmul`, where a
    selective-checkpoint policy can see it (``remat="dots"`` saves its
    outputs, see :func:`save_dots`)."""
    return _MATMULS[route](a, b, bias=bias, activation=activation)


@dense_gemm.register_fake
def _dense_gemm_fake(a, b, bias, activation, route):
    return a.new_empty((a.shape[0], b.shape[1]))


_SHARDING_REGISTERED = False


def register_dense_gemm_sharding() -> None:
    """Register :func:`dense_gemm`'s DTensor sharding rule (once a
    process; the model code calls it when it meets a DTensor).  Per mesh
    dimension: everything replicated; ``a`` on rows and ``b`` replicated
    give the output on rows; ``a`` replicated and ``b`` on columns give the
    output on columns, the bias on the same columns; without a bias or an
    activation, ``a`` and ``b`` both on K give a ``Partial`` output (the
    epilogue is not linear in a partial sum, so with one K is gathered).
    DTensor then calls the op on each rank's local shards, so the kernel
    never sees a gathered global operand."""
    global _SHARDING_REGISTERED
    if _SHARDING_REGISTERED:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.dense_gemm.default)
    def _dense_gemm_sharding(a, b, bias, activation, route):
        r, has_bias = Replicate(), bias is not None
        out = [([r], [r, r, r if has_bias else None, None, None]),
               ([Shard(0)], [Shard(0), r, r if has_bias else None, None,
                             None]),
               ([Shard(1)], [r, Shard(1), Shard(0) if has_bias else None,
                             None, None])]
        if not has_bias and activation is None:
            out.append(([Partial()], [Shard(1), Shard(0), None, None, None]))
        return out

    _SHARDING_REGISTERED = True


def gemm(a, b, *, bias=None, activation=None, matmul=kraken_matmul):
    """``matmul(a, b, bias=, activation=)``; DTensor operands go through
    :func:`dense_gemm` and its sharding rule."""
    if is_dtensor(a) or is_dtensor(b):
        register_dense_gemm_sharding()
        return dense_gemm(a, b, bias, activation, _route(matmul))
    return matmul(a, b, bias=bias, activation=activation)


def save_dots(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``: the dense
    GEMMs' outputs are saved, everything else is recomputed (JAX's
    ``checkpoint_dots_with_no_batch_dims`` on the dense layers; the
    attention and MoE einsums are recomputed)."""
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.repro_torch.dense_gemm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


class KrakenMatmul(torch.autograd.Function):
    """:func:`kraken_matmul` with a gradient whose two products are
    ``kraken_matmul`` too: ``dA = dY' @ b.T`` and ``dB = a.T @ dY'``, with
    ``dY' = dY * act'(z)`` (fp32, cast to ``a.dtype``) and the bias
    gradient the fp32 column sum of ``dY'``.

    ``matmul`` is the ``Kernels`` entry the caller holds: the hand-written
    kernel on CUDA tensors, the plain version on CPU tensors.  The forward
    is the serving path's one fused launch (through :func:`dense_gemm`);
    the backward of a call with an activation launches once more to
    recompute the pre-activation ``z = a @ b + bias`` (rounded to
    ``a.dtype``, as the kernel writes it).  The kernel reads contiguous
    operands only, so ``b.T``, ``a.T`` and ``dY'`` are made contiguous
    before their launches."""

    @staticmethod
    def forward(ctx, a, b, bias, activation, matmul):
        if is_dtensor(a) or is_dtensor(b):
            register_dense_gemm_sharding()
        out = dense_gemm(a, b, bias, activation, _route(matmul))
        ctx.save_for_backward(a, b, bias)
        ctx.activation, ctx.matmul = activation, matmul
        return out

    @staticmethod
    def backward(ctx, dy):
        a, b, bias = ctx.saved_tensors

        def mm(x, y, bias=None):
            return gemm(x, y, bias=bias, matmul=ctx.matmul)

        dyp = dy.to(torch.float32)
        if ctx.activation is not None:
            z = mm(a, b, bias=bias)
            dyp = dyp * activation_grad(ctx.activation, z)
        g = dyp.to(a.dtype).contiguous()
        da = db = dbias = None
        if ctx.needs_input_grad[0]:
            da = mm(g, b.t().contiguous())
        if ctx.needs_input_grad[1]:
            db = mm(a.t().contiguous(), g).to(b.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = dyp.sum(dim=0).to(bias.dtype).reshape(bias.shape)
        return da, db, dbias, None, None


def kraken_matmul_grad(a: torch.Tensor, b: torch.Tensor, *,
                       bias: torch.Tensor | None = None,
                       activation: str | None = None,
                       matmul=kraken_matmul) -> torch.Tensor:
    """:func:`kraken_matmul` ``a [M, K] @ b [K, N]`` (+bias, +activation)
    recorded for autograd through :class:`KrakenMatmul`."""
    return KrakenMatmul.apply(a, b, bias, activation, matmul)


def kraken_conv2d_direct(x: torch.Tensor, k: torch.Tensor, *,
                         stride: tuple[int, int] = (1, 1),
                         padding: tuple[tuple[int, int], tuple[int, int]] = (
                             (0, 0), (0, 0)),
                         R: int = 7, bco: int | None = None,
                         out_dtype=None) -> torch.Tensor:
    """Direct Kraken-dataflow convolution: x [N, H, W, C_i] NHWC, k
    [K_H, K_W, C_i, C_o] HWIO -> NHWC, fp32 accumulation, cast once to
    ``out_dtype`` (default x's dtype).  ``R`` is the paper's row count, the
    output rows of one band (a tile on the card holds whole bands);
    ``bco`` is the card's c_o tile, 64 or 128 (None: the tile policy's)."""
    if _on_cuda(x):
        return _conv.kraken_conv2d_direct(x, k, stride=stride,
                                          padding=padding, R=R, bco=bco,
                                          out_dtype=out_dtype)
    _conv.check_args(x.shape, k.shape, stride=stride, padding=padding, R=R,
                     bco=bco)
    return ref.conv2d(x, k, stride=stride, padding=padding,
                      out_dtype=out_dtype)


def kraken_conv2d(x: torch.Tensor, k: torch.Tensor, *,
                  stride: tuple[int, int] = (1, 1),
                  padding: tuple[tuple[int, int], tuple[int, int]] = (
                      (0, 0), (0, 0)),
                  out_dtype=None) -> torch.Tensor:
    """Convolution by the uniform lowering conv -> im2col ->
    :func:`kraken_matmul` (``repro.kernels.ops.kraken_conv2d``).

    x: [N, H, W, C_i], k: [K_H, K_W, C_i, C_o] -> [N, OH, OW, C_o].  The
    patches are channel-major, (C_i, K_H, K_W), as JAX's
    ``conv_general_dilated_patches`` gives them, and the weight rows follow
    that order.
    """
    (s_h, s_w), ((pt, pb), (pl, pr)) = stride, padding
    n = x.shape[0]
    k_h, k_w, c_i, c_o = k.shape
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    patches = xp.unfold(1, k_h, s_h).unfold(2, k_w, s_w)  # [N,OH,OW,C,KH,KW]
    oh, ow = patches.shape[1], patches.shape[2]
    lhs = patches.reshape(n * oh * ow, c_i * k_h * k_w)
    rhs = k.permute(2, 0, 1, 3).reshape(c_i * k_h * k_w, c_o)
    out = kraken_matmul(lhs, rhs, out_dtype=out_dtype)
    return out.reshape(n, oh, ow, c_o)


def kraken_paged_attention(q, k_pages, v_pages, *, pos_pages, page_table,
                           q_pos, k_scale=None, v_scale=None,
                           window: int = 0) -> torch.Tensor:
    """One-token GQA attention straight off a (possibly int8) page pool."""
    if _on_cuda(q):
        return _pa.paged_decode_attention(
            q, k_pages, v_pages, pos_pages=pos_pages, page_table=page_table,
            q_pos=q_pos, k_scale=k_scale, v_scale=v_scale, window=window)
    return ref.paged_decode_attention(
        q, k_pages, v_pages, pos_pages=pos_pages, page_table=page_table,
        q_pos=q_pos, k_scale=k_scale, v_scale=v_scale, window=window)


def kraken_decode_attention(q, k, v, *, kv_pos, q_pos, k_scale=None,
                            v_scale=None, window: int = 0) -> torch.Tensor:
    """One-token GQA attention over a dense (possibly int8) KV cache."""
    if _on_cuda(q):
        return _dec.decode_attention(q, k, v, kv_pos=kv_pos, q_pos=q_pos,
                                     k_scale=k_scale, v_scale=v_scale,
                                     window=window)
    return ref.decode_attention(q, k, v, kv_pos=kv_pos, q_pos=q_pos,
                                k_scale=k_scale, v_scale=v_scale,
                                window=window)


class SwaAttention(torch.autograd.Function):
    """:func:`swa_attention` with a gradient, modelled on
    :class:`KrakenMatmul`.  On CUDA tensors the forward launches the
    ``swa_attention`` kernel with the rows' log-sum-exp and saves q, k, v,
    the output and the lse; the backward launches the hand-written
    ``swa_attention_bwd`` kernel on a contiguous ``dout`` (autograd may hand
    an expanded one).  On CPU tensors both halves are the plain versions
    (``ref.sliding_window_attention`` with ``return_lse``,
    ``ref.sliding_window_attention_bwd``).  A call the kernels do not take
    raises: nothing gives way to the plain version or to another
    attention."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        if _on_cuda(q):
            out, lse = _swa.swa_attention(q, k, v, window=window,
                                          return_lse=True)
        else:
            out, lse = ref.sliding_window_attention(q, k, v, window=window,
                                                    return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (_swa.swa_attention_bwd if _on_cuda(q)
               else ref.sliding_window_attention_bwd)
        dq, dk, dv = bwd(q, k, v, out, dout.contiguous(), lse,
                         window=ctx.window)
        return dq, dk, dv, None


def swa_attention(q, k, v, *, window: int) -> torch.Tensor:
    """Causal sliding-window attention over a whole sequence: q
    [B, H, S, D], k/v [B, KV, S, D]; token ``i`` attends to ``j`` iff
    ``i - window < j <= i``.  When autograd records (grad enabled and an
    operand requiring it) the call goes through :class:`SwaAttention`,
    whose backward is a kernel too; otherwise it is the direct call the
    serving paths make."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return SwaAttention.apply(q, k, v, window)
    if _on_cuda(q):
        return _swa.swa_attention(q, k, v, window=window)
    return ref.sliding_window_attention(q, k, v, window=window)


def grouped_expert_ffn(buf, sizes, wi_gate, wi_up, wo) -> torch.Tensor:
    """The MoE expert FFN over the ``[E, C, d]`` capacity buffer (``sizes``
    live rows per expert), as three grouped GEMMs."""
    if _on_cuda(buf):
        return _moe.grouped_expert_ffn(buf, sizes, wi_gate, wi_up, wo)
    return ref.grouped_expert_ffn(buf, sizes, wi_gate, wi_up, wo)
