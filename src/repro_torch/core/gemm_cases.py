"""The GEMM shapes ``kraken_gemm`` is checked and timed at: yi-6b's,
mixtral-8x22b's, gemma3-12b's, rwkv6-3b's, zamba2-1.2b's,
llama-3.2-vision-11b's and musicgen-large's, and the edge cases.

``chip_smoke.py`` runs them on the card (phases ``kernels``, ``moe_kernels``
and ``swa_kernels``) and ``tests/test_torch_gemm_plan.py`` checks the
kernel's plan for each on the CPU, so both read them from here.
"""

from __future__ import annotations

# kraken_gemm and grouped_moe_gemm against their plain versions, (atol,
# rtol) by dtype: bf16 sums fp32 products in another order and rounds once
# (one output ulp, 2^-8 of rtol, with room for the order); fp32 sums in
# another order only
GEMM_TOL = {"bfloat16": (3e-2, 2e-2), "float32": (1e-4, 1e-4)}

# yi-6b (``YI_6B``): d_model 4096, 32 heads / 4 KV heads of 128, d_ff 11008,
# vocab 64000, 32 layers; served at 4 slots x chunk 64
YI_LAYERS = 32
# (name, K, N, activation, calls per decode step)
GEMMS = [("wq|wo", 4096, 4096, None, 2 * YI_LAYERS),
         ("wk|wv", 4096, 512, None, 2 * YI_LAYERS),
         ("gate", 4096, 11008, "silu", YI_LAYERS),
         ("up", 4096, 11008, None, YI_LAYERS),
         ("down", 11008, 4096, None, YI_LAYERS),
         ("unembed", 4096, 64000, None, 1)]

# mixtral-8x22b served at full width and MOE_LAYERS of its 56 layers: its
# kraken_gemm shapes, (name, K, N, calls per decode step)
MOE_LAYERS = 8
MIXTRAL_GEMMS = [("wq|wo", 6144, 6144, 2 * MOE_LAYERS),
                 ("wk|wv", 6144, 1024, 2 * MOE_LAYERS),
                 ("unembed", 6144, 32768, 1)]

# gemma3-12b (``GEMMA3_12B``): 48 layers, d 3840, 16/8 heads of 240, d_ff
# 15360, vocab 262144 (tied).  The forward's kraken_gemm shapes at M =
# GEMMA_SEQ: (name, K, N, activation, calls per forward); 48 x (q, k, v, o,
# gate, up, down) + the tied unembed = 337
GEMMA_LAYERS, GEMMA_SEQ = 48, 4096
GEMMA_GEMMS = [("wq|wo", 3840, 3840, None, 2 * GEMMA_LAYERS),
               ("wk|wv", 3840, 1920, None, 2 * GEMMA_LAYERS),
               ("gate", 3840, 15360, "silu", GEMMA_LAYERS),
               ("up", 3840, 15360, None, GEMMA_LAYERS),
               ("down", 15360, 3840, None, GEMMA_LAYERS),
               ("unembed", 3840, 262144, None, 1)]

# rwkv6-3b (``RWKV6_3B``): 32 layers, d 2560, d_ff 8960, vocab 65536, the
# decay LoRA of rank max(32, d / 16) = 160; served at 4 slots x chunk 64.
# (name, K, N, activation, calls per decode step): per layer the time mix's
# r, k, v, g, o and the channel mix's r (2560 x 2560), the LoRA's first
# factor, the channel mix's k (its ReLU in the epilogue) and v; 32 x 9 + the
# unembed = 289
RWKV_LAYERS = 32
RWKV_GEMMS = [("r|k|v|g|o|cmix r", 2560, 2560, None, 6 * RWKV_LAYERS),
              ("lora a", 2560, 160, None, RWKV_LAYERS),
              ("cmix k", 2560, 8960, "relu", RWKV_LAYERS),
              ("cmix v", 8960, 2560, None, RWKV_LAYERS),
              ("unembed", 2560, 65536, None, 1)]

# zamba2-1.2b (``ZAMBA2_1P2B``): 38 Mamba2 layers (d 2048, inner 4096, 64
# heads, state 64: in_proj N = 2 * 4096 + 2 * 64 + 64 = 8384) and 6 calls
# of one shared attention + SwiGLU block (32/32 heads of 64, d_ff 8192),
# vocab 32000.  Per decode step: 38 x (in, out) + 6 x (q, k, v, o, gate,
# up, down) + the unembed = 119
ZAMBA_LAYERS, ZAMBA_SHARED_CALLS = 38, 6
ZAMBA_GEMMS = [("in_proj", 2048, 8384, None, ZAMBA_LAYERS),
               ("out_proj", 4096, 2048, None, ZAMBA_LAYERS),
               ("shared q|k|v|o", 2048, 2048, None, 4 * ZAMBA_SHARED_CALLS),
               ("shared gate", 2048, 8192, "silu", ZAMBA_SHARED_CALLS),
               ("shared up", 2048, 8192, None, ZAMBA_SHARED_CALLS),
               ("shared down", 8192, 2048, None, ZAMBA_SHARED_CALLS),
               ("unembed", 2048, 32000, None, 1)]

# llama-3.2-vision-11b (``LLAMA32_VISION_11B``): 40 layers = 8 periods of
# 4 self-attention layers and 1 cross-attention layer, d 4096, 32/8 heads
# of 128, d_ff 14336, vocab 128256 (untied).  The engine serves text only:
# a cross layer projects q and o (its K/V rows are frozen), so per step
# 32 x (q, k, v, o) + 8 x (q, o) + 40 x (gate, up, down) + the unembed =
# 265.  (name, K, N, activation, bias, calls per decode step)
VLM_LAYERS, VLM_CROSS, VLM_PATCHES = 40, 8, 1601
VLM_GEMMS = [("wq|wo", 4096, 4096, None, False, 2 * VLM_LAYERS),
             ("wk|wv", 4096, 1024, None, False, 2 * (VLM_LAYERS - VLM_CROSS)),
             ("gate", 4096, 14336, "silu", False, VLM_LAYERS),
             ("up", 4096, 14336, None, False, VLM_LAYERS),
             ("down", 14336, 4096, None, False, VLM_LAYERS),
             ("unembed", 4096, 128256, None, False, 1)]

# musicgen-large (``MUSICGEN_LARGE``): 48 layers, d 2048, 32/32 heads of
# 64, the gelu MLP 2048 -> 8192 -> 2048 with biases (bias and gelu in the
# first GEMM's epilogue, bias in the second's), vocab 2048 (untied).  Per
# step 48 x (q, k, v, o, wi, wo) + the unembed = 289
MUSICGEN_LAYERS = 48
MUSICGEN_GEMMS = [("q|k|v|o", 2048, 2048, None, False, 4 * MUSICGEN_LAYERS),
                  ("wi", 2048, 8192, "gelu", True, MUSICGEN_LAYERS),
                  ("wo", 8192, 2048, None, True, MUSICGEN_LAYERS),
                  ("unembed", 2048, 2048, None, False, 1)]

# the row counts the LM paths call kraken_gemm at: one row, decode at 4
# slots, the mixed step (4 slots x chunk 64), the forward
LM_ROWS = (1, 4, 256, GEMMA_SEQ)

# edge cases: (name, M, K, N, activation, bias).  Every epilogue runs on the
# two ragged shapes of ``RAGGED``; these add the plan's corners
GEMM_EDGE = [
    ("M 1, split over K", 1, 4096, 4096, None, False),
    ("M 4, wk|wv: split over K", 4, 4096, 512, None, True),
    ("M 65: a second row tile", 65, 4096, 512, "silu", True),
    ("K 27: A refused by TMA (VGG-16 conv1_1 im2col)", 3000, 27, 64, "relu",
     True),
    ("K 363: A refused by TMA, N 96 (AlexNet conv1)", 700, 363, 96, "relu",
     False),
    ("N 123: B refused by TMA, split", 4, 1000, 123, "gelu", True),
    ("ragged K 200, M 300", 300, 200, 4096, None, True),
    ("rwkv6 cmix k: the ReLU epilogue, M 4", 4, 2560, 8960, "relu", False),
    ("rwkv6 lora a: N 160, M 4", 4, 2560, 160, None, False),
    ("rwkv6 lora a: N 160, M 256", 256, 2560, 160, None, False),
    ("zamba2 in_proj: N 8384, M 4", 4, 2048, 8384, None, False),
    ("zamba2 in_proj: N 8384, M 256", 256, 2048, 8384, None, False),
    ("llama-3.2-vision cross K/V of 1601 patches", VLM_PATCHES, 4096, 1024,
     None, False),
    ("musicgen wi: bias + gelu, M 4", 4, 2048, 8192, "gelu", True),
    ("musicgen wi: bias + gelu, M 256", 256, 2048, 8192, "gelu", True),
    ("musicgen wo: bias, M 4", 4, 8192, 2048, None, True),
]
# (M, K, N) run with every activation, with and without bias: N 123 is
# refused by TMA (B filled), 136 and 72 are not
RAGGED = [(37, 200, 123), (5, 136, 72)]

# training (``ops.KrakenMatmul``): yi-6b at batch 8 x seq 128, so every
# forward product has M = TRAIN_M rows and the backward's dB = a.T @ dY'
# sums over them.  (name, K, N, activation, bias, forward calls per step):
# 32 x (q, k, v, o, gate, up, down) + the unembed = 225; each has a dA and
# a dB product, and each activated one relaunches to recompute its z
TRAIN_M = 1024
TRAIN_GEMMS = [("wq|wo", 4096, 4096, None, False, 2 * YI_LAYERS),
               ("wk|wv", 4096, 512, None, False, 2 * YI_LAYERS),
               ("gate", 4096, 11008, "silu", False, YI_LAYERS),
               ("up", 4096, 11008, None, False, YI_LAYERS),
               ("down", 11008, 4096, None, False, YI_LAYERS),
               ("unembed", 4096, 64000, None, False, 1)]
# the yi-100m of ``repro_torch.examples.train_lm`` (12 layers, d 768, 12/4
# heads of 64, d_ff 2048, vocab 16000, float32): its train step's cells at
# batch 8 x seq 256, (name, K, N, activation, bias, forward calls a step)
TRAIN_LM_M, TRAIN_LM_LAYERS = 8 * 256, 12
TRAIN_LM_GEMMS = [("wq|wo", 768, 768, None, False, 2 * TRAIN_LM_LAYERS),
                  ("wk|wv", 768, 256, None, False, 2 * TRAIN_LM_LAYERS),
                  ("gate", 768, 2048, "silu", False, TRAIN_LM_LAYERS),
                  ("up", 768, 2048, None, False, TRAIN_LM_LAYERS),
                  ("down", 2048, 768, None, False, TRAIN_LM_LAYERS),
                  ("unembed", 768, 16000, None, False, 1)]
# the other epilogues at their archs' widths, and a ragged shape whose
# transposed operands TMA refuses: (name, M, K, N, activation, bias)
TRAIN_EDGE = [("musicgen wi: bias + gelu", TRAIN_M, 2048, 8192, "gelu", True),
              ("rwkv6 cmix k: relu", TRAIN_M, 2560, 8960, "relu", False),
              *((f"ragged, {act or 'no act'}", 65, 27, 123, act, True)
                for act in (None, "relu", "silu", "gelu"))]


def train_launches(layers: int = YI_LAYERS, remat: str = "full") -> int:
    """``kraken_gemm`` launches of one yi-6b train step: the forward's 7 a
    layer + the unembed, under ``remat="full"`` every layer's again (the
    unembed is outside the checkpointed periods), two backward products a
    call and one recomputed z a silu gate."""
    return windowed_train_launches(layers, 0, remat)["kraken_gemm"]


def windowed_train_launches(layers: int, local: int, remat: str = "full", *,
                            dense: int = 7, gated: int = 1) -> dict:
    """Launches of one train step of a windowed arch at ``layers`` layers,
    ``local`` of them through ``swa_attention``: ``kraken_gemm``'s as
    :func:`train_launches` counts them for ``dense`` products a layer (7:
    q, k, v, o, the gate, up, down; mixtral's 4, its experts on the einsum
    path under grad) and ``gated`` silu gates a layer whose z is
    recomputed; the forward kernel once a local layer and again in the
    recompute of remat ``"full"`` or ``"dots"`` (which keeps the GEMMs'
    outputs, not the attention's), and the backward kernel once."""
    fwd = dense * layers + 1
    gemm = fwd + (fwd - 1 if remat == "full" else 0) + 2 * fwd + gated * layers
    return {"kraken_gemm": gemm,
            "swa_attention": local * (1 if remat == "none" else 2),
            "swa_attention_bwd": local}
