"""Grouped-query attention (MHA / GQA / MQA) with optional qk-norm, QKV bias
and partial rotary embeddings, in PyTorch.

Counterpart of `repro.models.attention`.  Paths share one parameterization:
  * `attend_full`   — prefill over a whole sequence.  impl="kernel" calls
    the hand-written CUDA flash kernel (`repro_torch.kernels.
    flash_attention`; its plain version on the CPU) and is the port's
    counterpart of the reference's impl="pallas"; impl="chunked" is the
    online-softmax loop over KV blocks; impl="ref" materializes the scores.
  * `attend_cross`  — queries against (k, v) that `encode_kv` computed once
    from the encoder's states (the encdec family); "ref" or "chunked".
  * `attend_decode` — one query token against a KV cache.
Softmax math in float32, with the reference's casts.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from .common import Init, apply_rope, rms_norm

NEG_INF = -(2.0**30)


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    causal: bool = True
    use_rope: bool = True

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def init_attention(init: Init, spec: AttentionSpec):
    with init.scope("attn"):
        init.param("wq", (spec.d_model, spec.q_dim), ("fsdp", "model"))
        init.param("wk", (spec.d_model, spec.kv_dim), ("fsdp", "model"))
        init.param("wv", (spec.d_model, spec.kv_dim), ("fsdp", "model"))
        init.param("wo", (spec.q_dim, spec.d_model), ("model", "fsdp"))
        if spec.qkv_bias:
            init.param("bq", (spec.q_dim,), ("model",), init="zeros")
            init.param("bk", (spec.kv_dim,), ("model",), init="zeros")
            init.param("bv", (spec.kv_dim,), ("model",), init="zeros")
        if spec.qk_norm:
            init.param("q_norm", (spec.head_dim,), (None,), init="ones")
            init.param("k_norm", (spec.head_dim,), (None,), init="ones")


def _project_qkv(params, spec: AttentionSpec, x, positions):
    B, S, _ = x.shape
    q = torch.matmul(x, params["attn/wq"])
    k = torch.matmul(x, params["attn/wk"])
    v = torch.matmul(x, params["attn/wv"])
    if spec.qkv_bias:
        q = q + params["attn/bq"]
        k = k + params["attn/bk"]
        v = v + params["attn/bv"]
    q = q.reshape(B, S, spec.n_heads, spec.head_dim)
    k = k.reshape(B, S, spec.n_kv_heads, spec.head_dim)
    v = v.reshape(B, S, spec.n_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = rms_norm(q, params["attn/q_norm"])
        k = rms_norm(k, params["attn/k_norm"])
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta, spec.rope_fraction)
        k = apply_rope(k, positions, spec.rope_theta, spec.rope_fraction)
    return q, k, v


def _expand_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _scale(head_dim: int) -> float:
    return 1.0 / math.sqrt(head_dim)


def _per_shard(sdpa):
    """`sdpa(q, k, v, ...)` that, on DTensors, runs on each rank's own batch
    rows and heads: k and v (and q) are placed with their batch (0) and
    head (2) dims on q's shards and every other dim replicated, a local
    slice where they were replicated.  (With k and v replicated, as GQA's
    kv heads are where they do not divide the model axis, each product of
    the loop flattens (batch, heads) into one dim, which DTensor shards
    only on its leading part: it gathered q, and every rank of the model
    axis ran every head.)  A tensor already on those placements is passed
    as it is: an identity redistribution would pin its gradient's
    placements.  On plain tensors, `sdpa` itself."""

    @functools.wraps(sdpa)
    def run(q, k, v, *args, **kwargs):
        if torch.distributed.is_available():
            from torch.distributed.tensor import DTensor, Replicate, Shard

            if isinstance(q, DTensor):
                mesh = q.device_mesh
                pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in q.placements]
                return sdpa(*(t if list(t.placements) == pl else t.redistribute(mesh, pl) for t in (q, k, v)),
                            *args, **kwargs)
        return sdpa(q, k, v, *args, **kwargs)

    return run


@_per_shard
def _sdpa_ref(q, k, v, causal: bool, q_offset: int = 0):
    """(B,Sq,H,D) x (B,Sk,H,D) -> (B,Sq,H,D), scores materialized (oracle)."""
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * _scale(D)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Sk, device=q.device)[None, :]
        scores = torch.where(ki <= qi, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


@_per_shard
def _sdpa_chunked(q, k, v, causal: bool, block: int = 512):
    """Online softmax over KV blocks: per-step memory O(B·H·Sq·block)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    nb = -(-Sk // block)
    pad = nb * block - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = _scale(D)
    dev = q.device
    qi = torch.arange(Sq, device=dev)[:, None]
    # the running buffers are made like q, so that on DTensors they lie on
    # q's shards (zeros made from a shape alone are replicated: every rank
    # would build the whole batch's buffers)
    acc = torch.zeros_like(q, dtype=torch.float32).transpose(1, 2)  # (B, H, Sq, D)
    m_run = torch.full_like(acc[..., 0], NEG_INF)
    l_run = torch.zeros_like(acc[..., 0])
    for j in range(nb):
        kj = k[:, j * block:(j + 1) * block]
        vj = v[:, j * block:(j + 1) * block]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kj).float() * scale
        ki = j * block + torch.arange(block, device=dev)[None, :]
        mask = ki < Sk
        if causal:
            mask = mask & (ki <= qi)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vj.float())
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attend_full(params, spec: AttentionSpec, x, positions, impl: str = "kernel"):
    """Full-sequence attention (prefill).  Returns (out, (k, v))."""
    q, k, v = _project_qkv(params, spec, x, positions)
    n_rep = spec.n_heads // spec.n_kv_heads
    ke, ve = _expand_kv(k, n_rep), _expand_kv(v, n_rep)
    if impl == "ref":
        out = _sdpa_ref(q, ke, ve, spec.causal)
    elif impl == "chunked":
        out = _sdpa_chunked(q, ke, ve, spec.causal)
    elif impl == "kernel":
        from ..kernels import ops as kops

        out = kops.flash_attention(q.contiguous(), ke.contiguous(), ve.contiguous(), causal=spec.causal)
    else:
        raise ValueError(impl)
    B, S = x.shape[:2]
    out = out.reshape(B, S, spec.q_dim)
    return torch.matmul(out, params["attn/wo"]), (k, v)


def attend_cross(params, spec: AttentionSpec, x, kv, impl: str = "ref"):
    """Cross attention: queries from x, (k, v) precomputed from the encoder."""
    B, S, _ = x.shape
    q = torch.matmul(x, params["attn/wq"])
    if spec.qkv_bias:
        q = q + params["attn/bq"]
    q = q.reshape(B, S, spec.n_heads, spec.head_dim)
    k, v = kv
    n_rep = spec.n_heads // spec.n_kv_heads
    ke, ve = _expand_kv(k, n_rep), _expand_kv(v, n_rep)
    if impl == "chunked":
        out = _sdpa_chunked(q, ke, ve, causal=False)
    else:
        out = _sdpa_ref(q, ke, ve, causal=False)
    return torch.matmul(out.reshape(B, S, spec.q_dim), params["attn/wo"])


def encode_kv(params, spec: AttentionSpec, x_enc):
    """Cross-attention (k, v) from the encoder's states, computed once."""
    B, S, _ = x_enc.shape
    k = torch.matmul(x_enc, params["attn/wk"])
    v = torch.matmul(x_enc, params["attn/wv"])
    if spec.qkv_bias:
        k = k + params["attn/bk"]
        v = v + params["attn/bv"]
    return (
        k.reshape(B, S, spec.n_kv_heads, spec.head_dim),
        v.reshape(B, S, spec.n_kv_heads, spec.head_dim),
    )


def attend_decode(params, spec: AttentionSpec, x, cache_k, cache_v, position: int):
    """One-token decode.  x: (B,1,d); cache_{k,v}: (B,S_max,KV,D) with valid
    entries < position.  Returns (out, new_k, new_v): new caches with the
    token's k and v written at `position` (the inputs are not modified)."""
    B = x.shape[0]
    pos = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, spec, x, pos)
    ck = cache_k.clone()
    cv = cache_v.clone()
    ck[:, position:position + 1] = k_new.to(ck.dtype)
    cv[:, position:position + 1] = v_new.to(cv.dtype)
    n_rep = spec.n_heads // spec.n_kv_heads
    ke, ve = _expand_kv(ck, n_rep), _expand_kv(cv, n_rep)
    S = ck.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, ke).float() * _scale(spec.head_dim)
    valid = (torch.arange(S, device=x.device) <= position)[None, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(x.dtype), ve)
    out = out.reshape(B, 1, spec.q_dim)
    return torch.matmul(out, params["attn/wo"]), ck, cv
