"""Architecture registry of the port: the reference's ten configurations and
their reduced smoke variants.

`get_config(arch_id)`  -> the published configuration.
`get_reduced(arch_id)` -> the same family and topology, shrunk for CPU
                          tests exactly as `repro.configs.get_reduced`
                          shrinks it (2-5 layers, narrow widths, tiny vocab).
"""

from __future__ import annotations

import dataclasses

from ..models.lm import ModelConfig
from . import (
    deepseek_v2_236b,
    gemma_2b,
    llava_next_34b,
    mamba2_2_7b,
    moonshot_v1_16b_a3b,
    qwen2_0_5b,
    qwen3_32b,
    stablelm_3b,
    whisper_small,
    zamba2_1_2b,
)

ARCHS: dict[str, ModelConfig] = {
    c.CONFIG.arch_id: c.CONFIG
    for c in (
        deepseek_v2_236b,
        moonshot_v1_16b_a3b,
        llava_next_34b,
        qwen3_32b,
        gemma_2b,
        qwen2_0_5b,
        stablelm_3b,
        zamba2_1_2b,
        whisper_small,
        mamba2_2_7b,
    )
}

ARCH_IDS = tuple(ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_reduced(arch_id: str) -> ModelConfig:
    """Family-faithful reduced config for CPU tests (the reference's
    reductions)."""
    cfg = get_config(arch_id)
    kw: dict = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
    )
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, d_model=64, n_heads=4, q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16
        )
        kw["n_kv_heads"] = 4
    if cfg.moe is not None:
        # capacity_factor high enough that nothing drops at smoke scale, so
        # gather and dense dispatch agree exactly
        kw["moe"] = dataclasses.replace(
            cfg.moe, d_model=64, d_ff=32, n_experts=8, top_k=2,
            n_shared=min(cfg.moe.n_shared, 1), capacity_factor=16.0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_model=64, d_state=16, head_dim=16, chunk=16)
        kw["n_heads"] = 8  # d_inner(128) / head_dim(16)
        kw["n_kv_heads"] = 2 if cfg.family == "hybrid" else 8
        kw["head_dim"] = 16
    if cfg.family == "hybrid":
        kw["n_layers"] = 5
        kw["attn_every"] = 2
        kw["n_heads"] = 4
        kw["n_kv_heads"] = 2
    if cfg.family == "encdec":
        kw["n_enc_layers"] = 2
        kw["enc_positions"] = 24
    if cfg.family == "vlm":
        kw["vision_patches"] = 8
    return cfg.replace(**kw)
