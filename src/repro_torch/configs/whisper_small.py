"""whisper-small [audio] — enc-dec; the conv frontend is a STUB:
the caller provides precomputed frame embeddings (1500, d_model).
LayerNorm, plain GELU MLP, attention biases, learned positions.
[arXiv:2212.04356; unverified]  (As `repro.configs.whisper_small`.)"""

from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="encdec",
    n_layers=12,  # decoder layers
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    norm="layernorm",
    gated_mlp=False,
    act="gelu",
    qkv_bias=True,
    enc_positions=1500,
)
