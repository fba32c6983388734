"""qwen2-0.5b [dense] — GQA kv=2, QKV bias.  [arXiv:2407.10671; hf]
(As `repro.configs.qwen2_0_5b`.)"""

from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
)
