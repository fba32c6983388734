"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6 (+2 shared).
[hf:moonshotai/Moonlight-16B-A3B; hf]  (As `repro.configs.moonshot_v1_16b_a3b`.)"""

from ..models.lm import ModelConfig
from ..models.moe import MoESpec

D_MODEL = 2048

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=D_MODEL,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    moe=MoESpec(d_model=D_MODEL, d_ff=1408, n_experts=64, top_k=6, n_shared=2),
)
