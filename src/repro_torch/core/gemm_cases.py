"""The GEMM shapes ``kraken_gemm`` is checked and timed at: yi-6b's,
mixtral-8x22b's, gemma3-12b's, rwkv6-3b's and zamba2-1.2b's, and the edge
cases.

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
]
# (M, K, N) run with every activation, with and without bias: N 123 is
# refused by TMA (B filled), 136 and 72 are not
RAGGED = [(37, 200, 123), (5, 136, 72)]
