"""Deterministic synthetic token pipeline.

Generates reproducible (tokens, labels) batches keyed by (seed, step) —
every DP host can materialize exactly its shard without coordination, which
is what makes speculative re-execution of a gradient shard value-identical
on a different host: the batch shard is a pure function of (seed, step,
shard_index), not of the host.

Counterpart of `repro.data.pipeline`: the same numpy generator
`default_rng((seed, step))` and the same draws, so the tokens, the labels
and the vlm / encdec bfloat16 extras are bit-equal to the reference's.
`device` (None means the card) places the tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models.lm import ModelConfig


def _bf16(x: np.ndarray, device) -> torch.Tensor:
    """float64 draws rounded to bfloat16 through float32, as `jnp.asarray(x,
    jnp.bfloat16)` rounds them with x64 off."""
    return torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=torch.bfloat16)


@dataclasses.dataclass
class SyntheticTokenPipeline:
    config: ModelConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    device: object = None  # where the batches go; None means the card

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def batch(self, step: int) -> dict:
        """Global batch for `step` (host-independent, reproducible)."""
        rng = np.random.default_rng((self.seed, step))
        cfg = self.config
        text = self.seq_len - (cfg.vision_patches if cfg.family == "vlm" else 0)
        # zipfian-ish token distribution so losses move like real text
        ranks = rng.zipf(1.3, size=(self.batch_size, text + 1))
        tokens_all = np.clip(ranks, 1, cfg.vocab - 1).astype(np.int32)
        batch = {
            "tokens": torch.from_numpy(np.ascontiguousarray(tokens_all[:, :-1])).to(self.device),
            "labels": torch.from_numpy(np.ascontiguousarray(tokens_all[:, 1:])).to(self.device),
        }
        if cfg.family == "vlm":
            batch["vision_embeds"] = _bf16(
                rng.standard_normal((self.batch_size, cfg.vision_patches, cfg.d_model)), self.device
            )
        if cfg.family == "encdec":
            batch["enc_embeds"] = _bf16(
                rng.standard_normal((self.batch_size, cfg.enc_positions, cfg.d_model)), self.device
            )
        return batch

    def shard(self, step: int, index: int, n_shards: int) -> dict:
        """Shard `index` of the global batch — computable by any host."""
        full = self.batch(step)
        size = self.batch_size // n_shards
        return {k: v[index * size : (index + 1) * size] for k, v in full.items()}


def make_batch_specs(cfg: ModelConfig, batch_size: int, seq_len: int) -> dict:
    """Stand-ins of a batch's tensors: meta tensors of its shapes and dtypes
    (the reference's `jax.ShapeDtypeStruct`s), which allocate nothing."""
    text = seq_len - (cfg.vision_patches if cfg.family == "vlm" else 0)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {
        "tokens": meta((batch_size, text), torch.int32),
        "labels": meta((batch_size, text), torch.int32),
    }
    if cfg.family == "vlm":
        specs["vision_embeds"] = meta((batch_size, cfg.vision_patches, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        specs["enc_embeds"] = meta((batch_size, cfg.enc_positions, cfg.d_model), torch.bfloat16)
    return specs
