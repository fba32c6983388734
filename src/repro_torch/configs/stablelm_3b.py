"""stablelm-3b [dense] — LayerNorm, partial rotary (25%), MHA.
[hf:stabilityai/stablelm-2-1_6b; unverified]  (As `repro.configs.stablelm_3b`.)"""

from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab=50304,
    norm="layernorm",
    rope_fraction=0.25,
)
