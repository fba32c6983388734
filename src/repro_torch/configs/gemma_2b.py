"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1), embeddings scaled by
sqrt(d_model), (1+w) RMSNorm.  [arXiv:2403.08295; hf]  (As `repro.configs.gemma_2b`.)"""

from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    act="gelu",
    embed_scale=True,
    norm_offset=1.0,
)
