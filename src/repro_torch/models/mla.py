"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), in PyTorch.

Counterpart of `repro.models.mla`.  Queries and KV are projected through
low-rank latents; the KV cache keeps only the (kv_lora + rope) latent per
token.

Prefill (`mla_full`) pads v from d_v to the query's qk_dim and runs the
online-softmax loop for impl="chunked" and the materialized scores for any
other impl, "kernel" included, as the reference runs `_sdpa_ref` for its
"pallas": the flash kernel is not compiled for qk_dim = 192.  The scale is
1/sqrt(qk_dim), from the padded q.

Decode routes:
  * "naive"    — decompress the whole latent cache through w_ukv each step.
  * "absorbed" — absorb w_uk into the query and w_uv into the output, so
    attention runs in latent space.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .attention import NEG_INF, _sdpa_chunked, _sdpa_ref
from .common import Init, apply_rope, rms_norm


@dataclasses.dataclass(frozen=True)
class MLASpec:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_dim(self) -> int:
        return self.d_nope + self.d_rope

    @property
    def cache_dim(self) -> int:
        return self.kv_lora + self.d_rope


def init_mla(init: Init, spec: MLASpec):
    H = spec.n_heads
    with init.scope("mla"):
        init.param("w_dq", (spec.d_model, spec.q_lora), ("fsdp", None))
        init.param("q_norm", (spec.q_lora,), (None,), init="ones")
        init.param("w_uq", (spec.q_lora, H * spec.qk_dim), ("fsdp", "model"))
        init.param("w_dkv", (spec.d_model, spec.kv_lora + spec.d_rope), ("fsdp", None))
        init.param("kv_norm", (spec.kv_lora,), (None,), init="ones")
        init.param("w_ukv", (spec.kv_lora, H * (spec.d_nope + spec.d_v)), ("fsdp", "model"))
        init.param("w_o", (H * spec.d_v, spec.d_model), ("model", "fsdp"))


def _q_proj(params, spec: MLASpec, x, positions):
    B, S, _ = x.shape
    cq = rms_norm(torch.matmul(x, params["mla/w_dq"]), params["mla/q_norm"])
    q = torch.matmul(cq, params["mla/w_uq"]).reshape(B, S, spec.n_heads, spec.qk_dim)
    q_nope, q_pe = q[..., : spec.d_nope], q[..., spec.d_nope:]
    return q_nope, apply_rope(q_pe, positions, spec.rope_theta)


def _latent_proj(params, spec: MLASpec, x, positions):
    """x -> (c_kv (B,S,R) normalized, k_pe (B,S,dr) rotated)."""
    ckv_full = torch.matmul(x, params["mla/w_dkv"])
    c_kv = rms_norm(ckv_full[..., : spec.kv_lora], params["mla/kv_norm"])
    k_pe = ckv_full[..., spec.kv_lora:][:, :, None, :]  # (B,S,1,dr)
    return c_kv, apply_rope(k_pe, positions, spec.rope_theta)[:, :, 0, :]


def _decompress(params, spec: MLASpec, c_kv):
    B, S, _ = c_kv.shape
    kv = torch.matmul(c_kv, params["mla/w_ukv"]).reshape(B, S, spec.n_heads, spec.d_nope + spec.d_v)
    return kv[..., : spec.d_nope], kv[..., spec.d_nope:]  # k_nope, v


def mla_full(params, spec: MLASpec, x, positions, impl: str = "kernel"):
    """Prefill.  Returns (out, (c_kv, k_pe)), the latent cache."""
    B, S, _ = x.shape
    H = spec.n_heads
    q_nope, q_pe = _q_proj(params, spec, x, positions)
    c_kv, k_pe = _latent_proj(params, spec, x, positions)
    k_nope, v = _decompress(params, spec, c_kv)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, spec.d_rope)], dim=-1)
    sdpa = _sdpa_chunked if impl == "chunked" else _sdpa_ref
    if v.shape[-1] == q.shape[-1]:
        out = sdpa(q, k, v, causal=True)
    else:  # pad v to qk_dim, as the reference does for one fused kernel, then slice
        out = sdpa(q, k, F.pad(v, (0, spec.qk_dim - spec.d_v)), causal=True)[..., : spec.d_v]
    out = out.reshape(B, S, H * spec.d_v)
    return torch.matmul(out, params["mla/w_o"]), (c_kv, k_pe)


def mla_decode(params, spec: MLASpec, x, cache_ckv, cache_kpe, position: int, impl: str = "naive"):
    """One-token decode against the latent cache.  Returns (out, ckv, kpe):
    new caches with the token's latents written at `position` (the inputs
    are not modified)."""
    B = x.shape[0]
    H = spec.n_heads
    pos = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q_nope, q_pe = _q_proj(params, spec, x, pos)  # (B,1,H,·)
    c_new, kpe_new = _latent_proj(params, spec, x, pos)
    ckv = cache_ckv.clone()
    kpe = cache_kpe.clone()
    ckv[:, position:position + 1] = c_new.to(ckv.dtype)
    kpe[:, position:position + 1] = kpe_new.to(kpe.dtype)
    S = ckv.shape[1]
    valid = (torch.arange(S, device=x.device) <= position)[None, None, :]
    scale = 1.0 / math.sqrt(spec.qk_dim)

    if impl == "naive":
        k_nope, v = _decompress(params, spec, ckv)  # (B,S,H,·): the whole cache
        s_nope = torch.einsum("bqhd,bshd->bhs", q_nope, k_nope)
        s_pe = torch.einsum("bqhd,bsd->bhs", q_pe, kpe)
        scores = (s_nope + s_pe).float() * scale
        probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
        out = torch.einsum("bhs,bshd->bhd", probs.to(x.dtype), v)
    elif impl == "absorbed":
        w_ukv = params["mla/w_ukv"].reshape(spec.kv_lora, H, spec.d_nope + spec.d_v)
        w_uk = w_ukv[..., : spec.d_nope]  # (R,H,dn)
        w_uv = w_ukv[..., spec.d_nope:]  # (R,H,dv)
        q_lat = torch.einsum("bqhd,rhd->bhr", q_nope, w_uk)  # absorbed into the latent
        s_nope = torch.einsum("bhr,bsr->bhs", q_lat, ckv)
        s_pe = torch.einsum("bqhd,bsd->bhs", q_pe, kpe)
        scores = (s_nope + s_pe).float() * scale
        probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
        out_lat = torch.einsum("bhs,bsr->bhr", probs.to(x.dtype), ckv)
        out = torch.einsum("bhr,rhd->bhd", out_lat, w_uv)
    else:
        raise ValueError(impl)
    out = out.reshape(B, 1, H * spec.d_v)
    return torch.matmul(out, params["mla/w_o"]), ckv, kpe
