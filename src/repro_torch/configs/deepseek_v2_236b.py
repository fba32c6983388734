"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]  (As `repro.configs.deepseek_v2_236b`.)"""

from ..models.lm import ModelConfig
from ..models.mla import MLASpec
from ..models.moe import MoESpec

D_MODEL = 5120

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=D_MODEL,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab=102400,
    mla=MLASpec(
        d_model=D_MODEL,
        n_heads=128,
        q_lora=1536,
        kv_lora=512,
        d_nope=128,
        d_rope=64,
        d_v=128,
    ),
    moe=MoESpec(d_model=D_MODEL, d_ff=1536, n_experts=160, top_k=6, n_shared=2),
)
