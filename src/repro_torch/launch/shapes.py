"""Assigned input shapes and per-(arch x shape) applicability.

  train_4k     seq 4096,   global_batch 256   (training)
  prefill_32k  seq 32768,  global_batch 32    (inference prefill)
  decode_32k   seq 32768,  global_batch 128   (one token, 32k KV cache)
  long_500k    seq 524288, global_batch 1     (long-context decode;
               SSM/hybrid archs only — full-attention archs skip, see
               DESIGN.md §4)

Counterpart of `repro.launch.shapes`.  The stand-ins are meta-device
tensors of each input's shape and dtype, which allocate nothing; the
decode cache's come from a short prefill on the meta device, grown to
the cell's length.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.lm import ModelConfig, build_model


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SHAPE_NAMES = tuple(SHAPES)


def applicability(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k requires sub-quadratic attention (SSM/hybrid only)"
    return True, ""


#: text tokens of the prefill that gives a decode cell's cache its shapes
#: (at least an SSM's conv width less one, which its conv state keeps)
SHORT_PREFILL = 64


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch(cfg: ModelConfig, B: int, S: int, labels: bool) -> dict:
    text = S - cfg.vision_patches if cfg.family == "vlm" else S
    batch = {"tokens": _meta((B, text), torch.int32)}
    if labels:
        batch["labels"] = _meta((B, text), torch.int32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = _meta((B, cfg.vision_patches, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        batch["enc_embeds"] = _meta((B, cfg.enc_positions, cfg.d_model), torch.bfloat16)
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """Meta-tensor stand-ins for every model input of this cell.

    train/prefill -> batch dict; decode -> {cache, tokens, position} where
    the cache comes from a prefill of at most `SHORT_PREFILL` text tokens on
    the meta device, grown to the full cache length (`Model.grow_cache`):
    the shapes of a prefill at full length (SSM states carry no length, the
    encoder's cross kv is the encoder's), where tracing that prefill, even
    on meta tensors, took minutes for the 32k-token cells.  No allocation;
    through the plain routes, since the kernels run on the card only, and
    the cache's shapes do not depend on the route.
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        return _batch(cfg, B, S, labels=shape.kind == "train")

    model = build_model(cfg.replace(attn_impl="chunked", ssm_impl="jnp"))
    params = model.init(device="meta")
    short = min(S, cfg.vision_patches + SHORT_PREFILL if cfg.family == "vlm" else SHORT_PREFILL)
    _, cache = model.prefill(params, _batch(cfg, B, short, labels=False))
    return {
        "cache": model.grow_cache(cache, S),
        "tokens": _meta((B,), torch.int32),
        "position": _meta((), torch.int32),
    }
