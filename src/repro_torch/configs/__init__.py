"""Architecture registry of the port: the configurations whose families are
ported, and their reduced smoke variants.

`get_config(arch_id)`  -> the published configuration.
`get_reduced(arch_id)` -> the same family and topology, shrunk for CPU
                          tests exactly as `repro.configs.get_reduced`
                          shrinks it.

The reference's other architectures (moe, mla, encdec, vlm, and the dense
configs not listed here) raise `KeyError` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses

from ..models.lm import ModelConfig
from . import mamba2_2_7b, qwen2_0_5b, zamba2_1_2b

ARCHS: dict[str, ModelConfig] = {
    c.CONFIG.arch_id: c.CONFIG for c in (qwen2_0_5b, zamba2_1_2b, mamba2_2_7b)
}

ARCH_IDS = tuple(ARCHS)

#: the reference's architectures the port does not carry yet
NOT_PORTED = (
    "deepseek-v2-236b", "moonshot-v1-16b-a3b", "llava-next-34b", "qwen3-32b",
    "gemma-2b", "stablelm-3b", "whisper-small",
)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet (ROADMAP Queue 1 item 7: the other "
            f"configs); available: {sorted(ARCHS)}"
        )
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_reduced(arch_id: str) -> ModelConfig:
    """Family-faithful reduced config for CPU tests (the reference's
    reductions for the dense, ssm and hybrid families)."""
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
    return cfg.replace(**kw)
