"""Model assembly: decoder-only LMs of the dense, ssm and hybrid families,
in PyTorch.

Counterpart of `repro.models.lm`.  One `ModelConfig` describes an
architecture; `build_model` returns a `Model` with

    init(seed, device)                -> params
    forward(params, tokens)           -> (logits, cache, aux)
    prefill(params, batch)            -> (last logits, cache)
    decode_step(params, cache, tokens, position) -> (logits, cache)
    grow_cache(cache, target_len)     -> cache with room for target_len
    generate(params, batch, steps)    -> greedy tokens

Parameters are plain dicts of tensors keyed by the reference's paths:
`params["top"]` (embed, unembed, final_norm/w), `params["layers"]` (one
dict per layer, where the reference stacks them along a leading axis and
scans) and, for the hybrid, `params["shared_attn"]`.  The reference's
`lax.scan` over layers is a Python loop.  `attn_impl` and `ssm_impl`
default to "kernel", the hand-written CUDA kernels (the reference's
"pallas"); "chunked" / "ref" and "jnp" keep its other routes.  The moe,
mla, encdec and vlm families are not ported yet (ROADMAP Queue 1 item 7)
and raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import attention as attn_mod
from . import mlp as mlp_mod
from . import ssm as ssm_mod
from .common import Init, layer_norm, pad_vocab, rms_norm

FAMILIES = ("dense", "ssm", "hybrid")
_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 7: moe, mla, encdec, vlm)"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | ssm | hybrid (moe | encdec | vlm not ported yet)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_offset: float = 0.0  # gemma's (1+w) RMSNorm
    act: str = "silu"
    gated_mlp: bool = True
    embed_scale: bool = False
    ssm: Optional[ssm_mod.SSMSpec] = None
    attn_every: int = 0  # hybrid: one shared attention block every attn_every ssm layers
    attn_impl: str = "kernel"  # kernel | chunked | ref
    ssm_impl: str = "kernel"  # kernel | jnp
    param_dtype: Any = torch.bfloat16

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def attn_spec(self) -> attn_mod.AttentionSpec:
        return attn_mod.AttentionSpec(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias,
            qk_norm=self.qk_norm,
            rope_theta=self.rope_theta,
            rope_fraction=self.rope_fraction,
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Total parameter count, from an init on the meta device (no
        allocation)."""
        params = build_model(self).init(device="meta")
        leaves = list(params["top"].values()) + list(params.get("shared_attn", {}).values())
        leaves += [t for layer in params["layers"] for t in layer.values()]
        return sum(t.numel() for t in leaves)


# ---------------------------------------------------------------------------
# norms and layer blocks
# ---------------------------------------------------------------------------


def _init_norm(init: Init, cfg: ModelConfig, name: str):
    with init.scope(name):
        init.param("w", (cfg.d_model,), init="zeros" if cfg.norm_offset else "ones")
        if cfg.norm == "layernorm":
            init.param("b", (cfg.d_model,), init="zeros")


def _apply_norm(params, cfg: ModelConfig, x, name: str):
    if cfg.norm == "layernorm":
        return layer_norm(x, params[f"{name}/w"], params[f"{name}/b"])
    return rms_norm(x, params[f"{name}/w"], offset=1.0 if cfg.norm_offset else 0.0)


def _init_transformer_layer(init: Init, cfg: ModelConfig):
    _init_norm(init, cfg, "ln_attn")
    attn_mod.init_attention(init, cfg.attn_spec)
    _init_norm(init, cfg, "ln_mlp")
    if cfg.gated_mlp:
        mlp_mod.init_gated_mlp(init, cfg.d_model, cfg.d_ff)
    else:
        mlp_mod.init_plain_mlp(init, cfg.d_model, cfg.d_ff)


def _init_ssm_layer(init: Init, cfg: ModelConfig):
    _init_norm(init, cfg, "ln_ssm")
    ssm_mod.init_ssm(init, cfg.ssm)


def _ffn_apply(lp, cfg: ModelConfig, h):
    if cfg.gated_mlp:
        return mlp_mod.gated_mlp(lp, h, act=cfg.act)
    return mlp_mod.plain_mlp(lp, h, act=cfg.act)


def _transformer_layer_full(lp, cfg: ModelConfig, h, positions):
    a, kv = attn_mod.attend_full(
        lp, cfg.attn_spec, _apply_norm(lp, cfg, h, "ln_attn"), positions, cfg.attn_impl
    )
    h = h + a
    return h + _ffn_apply(lp, cfg, _apply_norm(lp, cfg, h, "ln_mlp")), kv


def _transformer_layer_decode(lp, cfg: ModelConfig, h, cache, position):
    hn = _apply_norm(lp, cfg, h, "ln_attn")
    a, ck, cv = attn_mod.attend_decode(lp, cfg.attn_spec, hn, cache[0], cache[1], position)
    h = h + a
    return h + _ffn_apply(lp, cfg, _apply_norm(lp, cfg, h, "ln_mlp")), (ck, cv)


def _ssm_layer_full(lp, cfg: ModelConfig, h):
    out, state = ssm_mod.ssm_full(lp, cfg.ssm, _apply_norm(lp, cfg, h, "ln_ssm"), impl=cfg.ssm_impl)
    return h + out, state


def _ssm_layer_decode(lp, cfg: ModelConfig, h, state):
    out, cs, ss = ssm_mod.ssm_decode(lp, cfg.ssm, _apply_norm(lp, cfg, h, "ln_ssm"), *state)
    return h + out, (cs, ss)


# ---------------------------------------------------------------------------
# the Model facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Model:
    config: ModelConfig

    def init(self, seed: int = 0, device=None) -> dict:
        """Random parameters from one generator seeded with `seed`, on
        `device` (None means the card; "meta" allocates nothing)."""
        cfg = self.config
        dev = resolve_device(device)
        g = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(int(seed))
        init = Init(g, dtype=cfg.param_dtype, device=dev)
        init.param("embed", (cfg.padded_vocab, cfg.d_model), init="embed")
        init.param("unembed", (cfg.d_model, cfg.padded_vocab))
        _init_norm(init, cfg, "final_norm")
        params = {"top": init.params}
        layer_fn = _init_transformer_layer if cfg.family == "dense" else _init_ssm_layer
        params["layers"] = []
        for _ in range(cfg.n_layers):
            init = Init(g, dtype=cfg.param_dtype, device=dev)
            layer_fn(init, cfg)
            params["layers"].append(init.params)
        if cfg.family == "hybrid":
            init = Init(g, dtype=cfg.param_dtype, device=dev)
            _init_transformer_layer(init, cfg)
            params["shared_attn"] = init.params
        return params

    # ------------------------------------------------------------ embedding
    def _embed(self, params, tokens):
        cfg = self.config
        h = F.embedding(tokens, params["top"]["embed"])
        if cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(h.dtype)
        return h

    def _logits(self, params, h):
        h = _apply_norm(params["top"], self.config, h, "final_norm")
        return torch.matmul(h, params["top"]["unembed"])

    # -------------------------------------------------------------- forward
    def forward(self, params, tokens):
        """Full-sequence forward -> (logits, cache, aux).  The cache layout
        matches decode_step so prefill can hand off directly."""
        cfg = self.config
        h = self._embed(params, tokens)
        B, S, _ = h.shape
        positions = torch.arange(S, device=h.device).expand(B, S)
        if cfg.family == "dense":
            kv = []
            for lp in params["layers"]:
                h, kv_l = _transformer_layer_full(lp, cfg, h, positions)
                kv.append(kv_l)
            return self._logits(params, h), kv, 0.0
        if cfg.family == "ssm":
            states = []
            for lp in params["layers"]:
                h, st = _ssm_layer_full(lp, cfg, h)
                states.append(st)
            return self._logits(params, h), states, 0.0
        return self._forward_hybrid(params, h, positions)

    def _hybrid_segments(self):
        cfg = self.config
        segs, start = [], 0
        while start < cfg.n_layers:
            end = min(start + cfg.attn_every, cfg.n_layers)
            segs.append((start, end))
            start = end
        return segs

    def _forward_hybrid(self, params, h, positions):
        cfg = self.config
        ssm_states, attn_caches = [], []
        shared = params["shared_attn"]
        for a, b in self._hybrid_segments():
            states = []
            for lp in params["layers"][a:b]:
                h, st = _ssm_layer_full(lp, cfg, h)
                states.append(st)
            ssm_states.append(states)
            h, kv = _transformer_layer_full(shared, cfg, h, positions)
            attn_caches.append(kv)
        return self._logits(params, h), (ssm_states, attn_caches), 0.0

    # -------------------------------------------------------------- serving
    def prefill(self, params, batch):
        logits, cache, _ = self.forward(params, batch["tokens"])
        return logits[:, -1], cache

    def decode_step(self, params, cache, tokens, position: int):
        """tokens: (B,) int; position: the write offset.  Returns
        (logits (B, padded vocab), new cache)."""
        cfg = self.config
        h = self._embed(params, tokens[:, None])
        if cfg.family == "dense":
            new = []
            for lp, c in zip(params["layers"], cache):
                h, nc = _transformer_layer_decode(lp, cfg, h, c, position)
                new.append(nc)
            return self._logits(params, h)[:, 0], new
        if cfg.family == "ssm":
            new = []
            for lp, st in zip(params["layers"], cache):
                h, ns = _ssm_layer_decode(lp, cfg, h, st)
                new.append(ns)
            return self._logits(params, h)[:, 0], new
        ssm_states, attn_caches = cache
        new_ssm, new_attn = [], []
        shared = params["shared_attn"]
        for i, (a, b) in enumerate(self._hybrid_segments()):
            seg = []
            for lp, st in zip(params["layers"][a:b], ssm_states[i]):
                h, ns = _ssm_layer_decode(lp, cfg, h, st)
                seg.append(ns)
            new_ssm.append(seg)
            h, nc = _transformer_layer_decode(shared, cfg, h, attn_caches[i], position)
            new_attn.append(nc)
        return self._logits(params, h)[:, 0], (new_ssm, new_attn)

    def grow_cache(self, cache, target_len: int):
        """Pad the seq axis of every KV buffer to `target_len` (SSM states
        are seq-free and pass through)."""
        cfg = self.config

        def pad_seq(x):
            cur = x.shape[1]
            return x if cur >= target_len else F.pad(x, (0, 0, 0, 0, 0, target_len - cur))

        if cfg.family == "dense":
            return [tuple(pad_seq(c) for c in kv) for kv in cache]
        if cfg.family == "ssm":
            return cache
        ssm_states, attn_caches = cache
        return ssm_states, [tuple(pad_seq(c) for c in kv) for kv in attn_caches]

    def generate(self, params, batch, steps: int):
        """Greedy generation (prefill + decode): (B, steps) tokens."""
        prompt_len = batch["tokens"].shape[1]
        logits, cache = self.prefill(params, batch)
        cache = self.grow_cache(cache, prompt_len + steps)
        toks = []
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for i in range(steps):
            toks.append(tok)
            if i == steps - 1:
                break
            logits, cache = self.decode_step(params, cache, tok, prompt_len + i)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.stack(toks, dim=1)


def build_model(config: ModelConfig) -> Model:
    if config.family not in FAMILIES:
        raise NotImplementedError(f"model family {config.family!r} {_NOT_PORTED}")
    return Model(config)
