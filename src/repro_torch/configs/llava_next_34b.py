"""llava-next-34b [vlm] — anyres tiling; backbone only, the vision tower is
a STUB: the caller provides precomputed patch embeddings (576 patches =
one 24x24 tile) prepended to the text tokens.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  (As `repro.configs.llava_next_34b`.)"""

from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
    vision_patches=576,
)
