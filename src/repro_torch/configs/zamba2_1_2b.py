"""zamba2-1.2b [hybrid] — Mamba2 backbone + one SHARED attention+MLP block
applied every 6 SSM layers (weights shared across invocations).
ssm_state=64.  [arXiv:2411.15242; hf]  (As `repro.configs.zamba2_1_2b`.)"""

from ..models.lm import ModelConfig
from ..models.ssm import SSMSpec

D_MODEL = 2048

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=D_MODEL,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    attn_every=6,
    ssm=SSMSpec(d_model=D_MODEL, d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
)
