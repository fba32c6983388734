"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.
ssm_state=128.  [arXiv:2405.21060; unverified]  (As
`repro.configs.mamba2_2_7b`.)"""

from ..models.lm import ModelConfig
from ..models.ssm import SSMSpec

D_MODEL = 2560

CONFIG = ModelConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=D_MODEL,
    n_heads=80,  # d_inner / head_dim
    n_kv_heads=80,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    ssm=SSMSpec(d_model=D_MODEL, d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
)
