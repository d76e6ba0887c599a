"""Per-cell logical-axis rule tables (the DP/TP/EP/SP strategy selector),
a port of ``repro.launch.sharding_rules``.

The *same* model code runs under every table; picking a table per
(arch x shape x mesh) is the framework analogue of Kraken's one-clock
reconfiguration — strategy is data, not code.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeCell


def _base(multi_pod: bool) -> dict:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "moe_groups": batch,   # MoE dispatch groups ride the token sharding
        "seq": None,
        # Megatron-style sequence parallelism: the residual stream between
        # blocks is sharded over the model axis (norms/adds run on 1/16th of
        # the tokens; the TP wo all-reduce becomes a reduce-scatter and the
        # pre-projection gather is an explicit all-gather of bf16
        # activations).  §Perf iteration 4.
        "act_seq": ("model",),
        "embed": None,
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": None,
        "qkv": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "expert_capacity": None,
        "moe_out_embed": None,   # serving: ("model",) -> RS'd MoE output
        "vocab": ("model",),
        "kv_seq": None,
        "layers": None,
        "conv_k": None,
        "frontend_seq": None,
    }


def rules_for(cfg: ArchConfig, cell: ShapeCell, *, multi_pod: bool) -> dict:
    r = _base(multi_pod)
    if (cfg.num_heads and cfg.num_heads % 16 and cfg.num_kv_heads % 16
            and cell.kind in ("train", "prefill")):
        # Heads don't divide the model axis (llama4/llama-3.2: 40H, 8KV):
        # GSPMD would replicate the whole attention computation 16x.
        # Context-parallel attention shards the kv sequence instead
        # (local_map flash partials + cross-shard softmax combine).
        r["attn_context_parallel"] = "model"
    if cell.kind == "train" and cfg.family == "moe":
        # FSDP / ZeRO-3: 140-400B param banks cannot replicate across DP
        # ranks; shard the embed dim of every weight over the data (and pod)
        # axes (GSPMD re-gathers per scan iteration, bounding live memory to
        # one layer's gathered weights).
        r["embed"] = ("pod", "data") if multi_pod else ("data",)
    if cell.kind in ("decode", "prefill"):
        # Serving weight storage, size-aware (§Perf cell-3 iteration 4):
        # models whose TP (model-axis) shard fits HBM keep weights resident
        # model-sharded only — no per-step weight re-gather.  Only the
        # 100B+ archs (mixtral, llama4) spread storage over the data axis
        # too, paying an all-gather per layer per step for fitting at all.
        tp_shard_bytes = cfg.param_count() * 2 / 16   # bf16 over model=16
        if tp_shard_bytes > 8e9:
            both = ("pod", "data", "model") if multi_pod else ("data", "model")
            r["mlp"] = both
            r["qkv"] = both
            r["vocab"] = both
        # NOTE (§Perf cell-2 iteration 6, REFUTED): mapping "moe_out_embed"
        # -> ("model",) here converts the MoE wo all-reduce (2.3e11 B) into
        # an all-gather (0.6e11 B), but GSPMD pays for it by materializing
        # full-f [E, f, C] tensors (+1.2e12 B of HBM traffic) — net worse on
        # the memory-bound cell.  Left unmapped (replicated d).
    if cell.kind == "decode":
        # KV caches dominate decode memory; shard their sequence dim over the
        # tensor axis (heads rarely divide 16 for GQA kv<=8).
        r["kv_seq"] = ("model",)
        if cell.global_batch == 1:
            # long-context: batch unshardable; lean on model+seq sharding.
            r["batch"] = None
    return r


def zero1_param_rules(rules: dict) -> dict:
    """ZeRO-1: optimizer moments additionally sharded over the data axis on
    the embed dim (which params keep replicated)."""
    r = dict(rules)
    r["embed"] = ("data",)
    return r
