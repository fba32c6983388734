"""qwen3-32b [dense] — qk_norm, GQA kv=8.  [hf:Qwen/Qwen3-8B; hf]  (As `repro.configs.qwen3_32b`.)"""

from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
)
