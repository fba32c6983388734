"""Model assembly: decoder-only LMs (dense / MoE / MLA / SSM / hybrid),
encoder-decoder (Whisper) and VLM (LLaVA backbone with a stub frontend), in
PyTorch.

Counterpart of `repro.models.lm`.  One `ModelConfig` describes an
architecture; `build_model` returns a `Model` with

    init(seed, device)                -> params
    param_axes()                      -> logical sharding axes of params
    forward(params, tokens, vision_embeds=None, enc_embeds=None)
                                      -> (logits, cache, aux)
    loss(params, batch)               -> (total, {"ce", "aux"})
    prefill(params, batch)            -> (last logits, cache)
    decode_step(params, cache, tokens, position) -> (logits, cache)
    grow_cache(cache, target_len)     -> cache with room for target_len
    cache_axes(cache)                 -> logical sharding axes of a cache
    generate(params, batch, steps)    -> greedy tokens

Parameters are plain dicts of tensors keyed by the reference's paths:
`params["top"]` (embed, unembed, final_norm), `params["layers"]` (one dict
per layer, where the reference stacks them along a leading axis and
scans), `params["shared_attn"]` for the hybrid, and `params["enc_layers"]`
(one dict per encoder layer) and `params["extra"]` (enc_pos, dec_pos,
enc_final_norm) for the encdec family.  The reference's `lax.scan` over
layers is a Python loop.  `attn_impl` and `ssm_impl` default to "kernel",
the hand-written CUDA kernels (the reference's "pallas"); "chunked" / "ref"
and "jnp" keep its other routes.  The kernels have no backward pass and
refuse autograd, so training takes "chunked" and "jnp", the reference's
defaults (`launch/train.py` sets them).  As in the reference, MLA prefill runs
the materialized scores for "kernel", the whisper encoder runs "ref"
whatever `attn_impl` says, and cross attention runs "ref".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .. import tree
from ..device import resolve_device
from . import attention as attn_mod
from . import mla as mla_mod
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import Init, layer_norm, pad_vocab, rms_norm


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
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
    embed_scale: bool = False  # gemma: embeddings scaled by sqrt(d_model)
    mla: Optional[mla_mod.MLASpec] = None
    moe: Optional[moe_mod.MoESpec] = None
    ssm: Optional[ssm_mod.SSMSpec] = None
    attn_every: int = 0  # hybrid: one shared attention block every attn_every ssm layers
    n_enc_layers: int = 0  # encdec (whisper)
    enc_positions: int = 1500  # frame embeddings from the (stub) conv frontend
    vision_patches: int = 0  # vlm: patch embeddings prepended to the text tokens
    attn_impl: str = "kernel"  # kernel | chunked | ref
    moe_impl: str = "gather"  # gather | dense
    mla_decode_impl: str = "naive"  # naive | absorbed
    ssm_impl: str = "kernel"  # kernel | jnp
    param_dtype: Any = torch.bfloat16
    # callable applied to the residual stream at every norm's input; the
    # sharding plans (launch/steps.py) pin it to the batch axes there
    activation_constraint: Any = None

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
            use_rope=self.family != "encdec",
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Total parameter count, from an init on the meta device (no
        allocation)."""
        return sum(t.numel() for t in tree.leaves(build_model(self).init(device="meta")))

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        per_expert = 3 * m.d_ff * m.d_model
        return total - (m.n_experts - m.top_k) * per_expert * self.n_layers


# ---------------------------------------------------------------------------
# norms and layer blocks
# ---------------------------------------------------------------------------


def _init_norm(init: Init, cfg: ModelConfig, name: str):
    with init.scope(name):
        init.param("w", (cfg.d_model,), (None,), init="zeros" if cfg.norm_offset else "ones")
        if cfg.norm == "layernorm":
            init.param("b", (cfg.d_model,), (None,), init="zeros")


def _apply_norm(params, cfg: ModelConfig, x, name: str):
    if cfg.activation_constraint is not None:
        x = cfg.activation_constraint(x)
    if cfg.norm == "layernorm":
        return layer_norm(x, params[f"{name}/w"], params[f"{name}/b"])
    return rms_norm(x, params[f"{name}/w"], offset=1.0 if cfg.norm_offset else 0.0)


def _init_transformer_layer(init: Init, cfg: ModelConfig, cross: bool = False):
    _init_norm(init, cfg, "ln_attn")
    attn_mod.init_attention(init, cfg.attn_spec)
    if cross:
        _init_norm(init, cfg, "ln_cross")
        with init.scope("cross"):
            attn_mod.init_attention(init, dataclasses.replace(cfg.attn_spec, causal=False))
    _init_norm(init, cfg, "ln_mlp")
    if cfg.moe is not None:
        moe_mod.init_moe(init, cfg.moe)
    elif cfg.gated_mlp:
        mlp_mod.init_gated_mlp(init, cfg.d_model, cfg.d_ff)
    else:
        mlp_mod.init_plain_mlp(init, cfg.d_model, cfg.d_ff)


def _init_mla_layer(init: Init, cfg: ModelConfig):
    _init_norm(init, cfg, "ln_attn")
    mla_mod.init_mla(init, cfg.mla)
    _init_norm(init, cfg, "ln_mlp")
    if cfg.moe is not None:
        moe_mod.init_moe(init, cfg.moe)
    else:
        mlp_mod.init_gated_mlp(init, cfg.d_model, cfg.d_ff)


def _init_ssm_layer(init: Init, cfg: ModelConfig):
    _init_norm(init, cfg, "ln_ssm")
    ssm_mod.init_ssm(init, cfg.ssm)


def _ffn_apply(lp, cfg: ModelConfig, h):
    """Returns (delta, aux)."""
    if cfg.moe is not None:
        return moe_mod.moe_ffn(lp, cfg.moe, h, impl=cfg.moe_impl)
    if cfg.gated_mlp:
        return mlp_mod.gated_mlp(lp, h, act=cfg.act), 0.0
    return mlp_mod.plain_mlp(lp, h, act=cfg.act), 0.0


def _transformer_layer_full(lp, cfg: ModelConfig, h, positions):
    hn = _apply_norm(lp, cfg, h, "ln_attn")
    if cfg.mla is not None:
        a, kv = mla_mod.mla_full(lp, cfg.mla, hn, positions, cfg.attn_impl)
    else:
        a, kv = attn_mod.attend_full(lp, cfg.attn_spec, hn, positions, cfg.attn_impl)
    h = h + a
    f, aux = _ffn_apply(lp, cfg, _apply_norm(lp, cfg, h, "ln_mlp"))
    return h + f, kv, aux


def _transformer_layer_decode(lp, cfg: ModelConfig, h, cache, position):
    hn = _apply_norm(lp, cfg, h, "ln_attn")
    if cfg.mla is not None:
        a, c0, c1 = mla_mod.mla_decode(lp, cfg.mla, hn, cache[0], cache[1], position, cfg.mla_decode_impl)
    else:
        a, c0, c1 = attn_mod.attend_decode(lp, cfg.attn_spec, hn, cache[0], cache[1], position)
    h = h + a
    f, _ = _ffn_apply(lp, cfg, _apply_norm(lp, cfg, h, "ln_mlp"))
    return h + f, (c0, c1)


def _cross_params(lp) -> dict:
    return {k[len("cross/"):]: v for k, v in lp.items() if k.startswith("cross/")}


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
        dev = resolve_device(device)
        g = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(int(seed))
        return self._declare(g, dev)[0]

    def param_axes(self) -> dict:
        """Each parameter's logical sharding axes, in `init`'s structure
        (`layers` a list per layer), from a declaration on the meta device
        (nothing allocated).  A per-layer leaf's axes are the reference's
        without its leading "layers" entry: the port does not stack layers."""
        return self._declare(None, torch.device("meta"))[1]

    def _declare(self, g, dev) -> tuple[dict, dict]:
        """(params, axes) of every parameter, drawn from `g` on `dev`."""
        cfg = self.config
        params: dict = {}
        axes: dict = {}

        def block(fn, *args, **kw) -> tuple[dict, dict]:
            init = Init(g, dtype=cfg.param_dtype, device=dev)
            fn(init, *args, **kw)
            return init.params, init.specs

        def put(key, blocks):
            if isinstance(blocks, list):
                params[key], axes[key] = [b[0] for b in blocks], [b[1] for b in blocks]
            else:
                params[key], axes[key] = blocks

        def top(init: Init):
            init.param("embed", (cfg.padded_vocab, cfg.d_model), ("model", "fsdp"), init="embed")
            init.param("unembed", (cfg.d_model, cfg.padded_vocab), ("fsdp", "model"))
            _init_norm(init, cfg, "final_norm")

        put("top", block(top))
        if cfg.family in ("dense", "moe", "vlm"):
            layer_fn = _init_mla_layer if cfg.mla is not None else _init_transformer_layer
            put("layers", [block(layer_fn, cfg) for _ in range(cfg.n_layers)])
        elif cfg.family in ("ssm", "hybrid"):
            put("layers", [block(_init_ssm_layer, cfg) for _ in range(cfg.n_layers)])
            if cfg.family == "hybrid":
                put("shared_attn", block(_init_transformer_layer, cfg.replace(moe=None)))
        elif cfg.family == "encdec":
            plain = cfg.replace(moe=None)
            put("enc_layers", [block(_init_transformer_layer, plain) for _ in range(cfg.n_enc_layers)])
            put("layers", [block(_init_transformer_layer, plain, cross=True) for _ in range(cfg.n_layers)])

            def extra(init: Init):
                init.param("enc_pos", (cfg.enc_positions, cfg.d_model), (None, "fsdp"), init="embed")
                init.param("dec_pos", (65536, cfg.d_model), (None, "fsdp"), init="embed")
                _init_norm(init, cfg, "enc_final_norm")

            put("extra", block(extra))
        else:
            raise ValueError(cfg.family)
        return params, axes

    # ------------------------------------------------------------ embedding
    def _embed(self, params, tokens):
        cfg = self.config
        h = F.embedding(tokens, params["top"]["embed"])
        if cfg.activation_constraint is not None and _is_partial(h):
            # a lookup in a vocabulary-sharded table (the serving plans'):
            # its partial rows are reduced once, here, onto the pinned
            # placements, since DTensor can reduce a masked partial only
            # once and the residual stream reads it twice
            h = cfg.activation_constraint(h)
        if cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(h.dtype)
        return h

    def _logits(self, params, h):
        h = _apply_norm(params["top"], self.config, h, "final_norm")
        return torch.matmul(h, params["top"]["unembed"])

    # -------------------------------------------------------------- forward
    def forward(self, params, tokens, vision_embeds=None, enc_embeds=None):
        """Full-sequence forward -> (logits, cache, aux).  The cache layout
        matches decode_step so prefill can hand off directly.  The vlm
        family prepends `vision_embeds` (B, vision_patches, d_model) to the
        tokens; the encdec family encodes `enc_embeds` (B, frames, d_model)."""
        cfg = self.config
        h = self._embed(params, tokens)
        if cfg.family == "vlm":
            if vision_embeds is None:
                raise ValueError("the vlm family needs vision_embeds")
            h = torch.cat([vision_embeds.to(h.dtype), h], dim=1)
        B, S, _ = h.shape
        positions = torch.arange(S, device=h.device).expand(B, S)
        if cfg.family == "encdec":
            if enc_embeds is None:
                raise ValueError("the encdec family needs enc_embeds")
            return self._forward_encdec(params, h, enc_embeds)
        if cfg.family in ("dense", "moe", "vlm"):
            kv, aux = [], 0.0
            for lp in params["layers"]:
                h, kv_l, aux_l = _transformer_layer_full(lp, cfg, h, positions)
                kv.append(kv_l)
                aux = aux + aux_l
            return self._logits(params, h), kv, aux
        if cfg.family == "ssm":
            states = []
            for lp in params["layers"]:
                h, st = _ssm_layer_full(lp, cfg, h)
                states.append(st)
            return self._logits(params, h), states, 0.0
        if cfg.family == "hybrid":
            return self._forward_hybrid(params, h, positions)
        raise ValueError(cfg.family)

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
        shared, shared_cfg = params["shared_attn"], cfg.replace(moe=None)
        for a, b in self._hybrid_segments():
            states = []
            for lp in params["layers"][a:b]:
                h, st = _ssm_layer_full(lp, cfg, h)
                states.append(st)
            ssm_states.append(states)
            h, kv, _ = _transformer_layer_full(shared, shared_cfg, h, positions)
            attn_caches.append(kv)
        return self._logits(params, h), (ssm_states, attn_caches), 0.0

    def _forward_encdec(self, params, h_dec, enc_embeds):
        cfg = self.config
        enc_cfg = cfg.replace(moe=None)
        extra = params["extra"]
        cross_spec = dataclasses.replace(enc_cfg.attn_spec, causal=False)
        # encoder: bidirectional, learned positions, always the "ref" route
        he = enc_embeds.to(h_dec.dtype) + extra["enc_pos"][None, : enc_embeds.shape[1]]
        pos_e = torch.arange(he.shape[1], device=he.device).expand(he.shape[:2])
        for lp in params["enc_layers"]:
            a, _ = attn_mod.attend_full(lp, cross_spec, _apply_norm(lp, enc_cfg, he, "ln_attn"), pos_e, "ref")
            he = he + a
            f, _ = _ffn_apply(lp, enc_cfg, _apply_norm(lp, enc_cfg, he, "ln_mlp"))
            he = he + f
        he = _apply_norm(extra, cfg, he, "enc_final_norm")
        cross_kvs = [attn_mod.encode_kv(_cross_params(lp), cross_spec, he) for lp in params["layers"]]

        # decoder
        S = h_dec.shape[1]
        h = h_dec + extra["dec_pos"][None, :S]
        pos_d = torch.arange(S, device=h.device).expand(h.shape[:2])
        self_kv = []
        for lp, ckv in zip(params["layers"], cross_kvs):
            a, kv = attn_mod.attend_full(
                lp, enc_cfg.attn_spec, _apply_norm(lp, enc_cfg, h, "ln_attn"), pos_d, cfg.attn_impl
            )
            h = h + a
            h = h + attn_mod.attend_cross(
                _cross_params(lp), cross_spec, _apply_norm(lp, enc_cfg, h, "ln_cross"), ckv
            )
            f, _ = _ffn_apply(lp, enc_cfg, _apply_norm(lp, enc_cfg, h, "ln_mlp"))
            h = h + f
            self_kv.append(kv)
        return self._logits(params, h), (self_kv, cross_kvs), 0.0

    # ----------------------------------------------------------------- loss
    def loss(self, params, batch):
        """Next-token CE (fp32) + 0.01 * the MoE aux -> (total, {"ce",
        "aux"}).  batch: {tokens, labels, [vision_embeds | enc_embeds]}.
        Labels below 0 are masked; the logsumexp runs over the padded
        vocabulary, as in the reference."""
        cfg = self.config
        logits, _, aux = self.forward(
            params, batch["tokens"], vision_embeds=batch.get("vision_embeds"),
            enc_embeds=batch.get("enc_embeds"),
        )
        labels = batch["labels"]
        if cfg.family == "vlm":  # logits cover [vision; text]; loss on text
            logits = logits[:, cfg.vision_patches:]
        logits = logits.float()
        mask = (labels >= 0).float()
        safe = torch.clamp(labels, min=0).long()
        # the gold logit is a one-hot sum over the vocabulary, placed as the
        # logits are: with the vocabulary sharded (DTensor), each rank sums
        # its own shard, `lse - gold` reduces the partial sums, and the
        # backward stays on the shard (a gather's backward builds a zero
        # tensor of the global logits' shape).  On plain tensors the sum
        # adds zeros to the gold logit, so it equals the gather bit for bit
        lse = _logsumexp(logits)
        gold = torch.where(_vocab_ids(logits) == safe[..., None], logits, 0.0).sum(dim=-1, keepdim=True)
        ce = torch.sum((lse - gold)[..., 0] * mask) / torch.clamp(torch.sum(mask), min=1.0)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # -------------------------------------------------------------- serving
    def prefill(self, params, batch):
        logits, cache, _ = self.forward(
            params, batch["tokens"], vision_embeds=batch.get("vision_embeds"),
            enc_embeds=batch.get("enc_embeds"),
        )
        return logits[:, -1], cache

    def decode_step(self, params, cache, tokens, position: int):
        """tokens: (B,) int; position: the write offset.  Returns
        (logits (B, padded vocab), new cache)."""
        cfg = self.config
        h = self._embed(params, tokens[:, None])
        if cfg.family in ("dense", "moe", "vlm"):
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
        if cfg.family == "hybrid":
            ssm_states, attn_caches = cache
            new_ssm, new_attn = [], []
            shared, shared_cfg = params["shared_attn"], cfg.replace(moe=None)
            for i, (a, b) in enumerate(self._hybrid_segments()):
                seg = []
                for lp, st in zip(params["layers"][a:b], ssm_states[i]):
                    h, ns = _ssm_layer_decode(lp, cfg, h, st)
                    seg.append(ns)
                new_ssm.append(seg)
                h, nc = _transformer_layer_decode(shared, shared_cfg, h, attn_caches[i], position)
                new_attn.append(nc)
            return self._logits(params, h)[:, 0], (new_ssm, new_attn)
        if cfg.family == "encdec":
            self_kv, cross_kvs = cache
            enc_cfg = cfg.replace(moe=None)
            cross_spec = dataclasses.replace(enc_cfg.attn_spec, causal=False)
            h = h + params["extra"]["dec_pos"][position:position + 1][None]
            new_self = []
            for lp, (ck, cv), ckv in zip(params["layers"], self_kv, cross_kvs):
                hn = _apply_norm(lp, enc_cfg, h, "ln_attn")
                a, nk, nv = attn_mod.attend_decode(lp, enc_cfg.attn_spec, hn, ck, cv, position)
                h = h + a
                h = h + attn_mod.attend_cross(
                    _cross_params(lp), cross_spec, _apply_norm(lp, enc_cfg, h, "ln_cross"), ckv
                )
                f, _ = _ffn_apply(lp, enc_cfg, _apply_norm(lp, enc_cfg, h, "ln_mlp"))
                h = h + f
                new_self.append((nk, nv))
            return self._logits(params, h)[:, 0], (new_self, cross_kvs)
        raise ValueError(cfg.family)

    def cache_axes(self, cache):
        """Logical sharding axes in the cache's structure (a list per layer
        of (k, v), or of the SSM's (conv, state), and so on by family), the
        reference's `Model.cache_axes` without its leading "layers" entry."""
        cfg = self.config
        kv = ("batch", None, "heads", None)
        ssm = (("batch", None, "model"), ("batch", "heads", None, None))
        if cfg.family in ("dense", "moe", "vlm"):
            if cfg.mla is not None:
                lat = ("batch", None, None)
                return [(lat, lat) for _ in cache]
            return [(kv, kv) for _ in cache]
        if cfg.family == "ssm":
            return [ssm for _ in cache]
        if cfg.family == "hybrid":
            ssm_states, attn_caches = cache
            return [[ssm for _ in seg] for seg in ssm_states], [(kv, kv) for _ in attn_caches]
        if cfg.family == "encdec":
            self_kv, cross_kvs = cache
            return [(kv, kv) for _ in self_kv], [(kv, kv) for _ in cross_kvs]
        raise ValueError(cfg.family)

    def grow_cache(self, cache, target_len: int):
        """Pad the seq axis (axis 1) of every KV buffer and MLA latent to
        `target_len`; SSM states are seq-free and the encdec cross KV is
        fixed by the encoder, so both pass through."""
        cfg = self.config

        def pad_seq(x):
            cur = x.shape[1]
            if cur >= target_len:
                return x
            return F.pad(x, (0, 0) * (x.ndim - 2) + (0, target_len - cur))

        if cfg.family in ("dense", "moe", "vlm"):
            return [tuple(pad_seq(c) for c in kv) for kv in cache]
        if cfg.family == "ssm":
            return cache
        if cfg.family == "hybrid":
            ssm_states, attn_caches = cache
            return ssm_states, [tuple(pad_seq(c) for c in kv) for kv in attn_caches]
        if cfg.family == "encdec":
            self_kv, cross = cache
            return [tuple(pad_seq(c) for c in kv) for kv in self_kv], cross
        raise ValueError(cfg.family)

    def generate(self, params, batch, steps: int):
        """Greedy generation (prefill + decode): (B, steps) tokens.  The vlm
        family's positions count its vision patches first."""
        prompt_len = batch["tokens"].shape[1]
        if self.config.family == "vlm":
            prompt_len += self.config.vision_patches
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


def _logsumexp(logits):
    """logsumexp over the last (vocabulary) dim, keepdim.  On DTensor
    logits whose vocabulary is sharded it is the stable form reduced
    across the shards: a max (detached: the gradient stays exact) and a
    sum of exps, each all-reduced at (B, S) size and replicated over the
    vocabulary's mesh dims, where `torch.logsumexp` would all-gather the
    whole vocabulary onto every rank.  (Left partial, the sum is
    reduce-scattered over the batch, and the backward then moves the
    exps' shards onto it.)  On plain tensors, and where no mesh dim of
    more than one rank shards the vocabulary (nothing to gather; the
    stable form would round differently), `torch.logsumexp`."""
    if torch.distributed.is_available():
        from torch.distributed.tensor import DTensor, Replicate, Shard

        if isinstance(logits, DTensor) and any(
                isinstance(p, Shard) and p.dim == logits.ndim - 1 and logits.device_mesh.size(i) > 1
                for i, p in enumerate(logits.placements)):

            def reduced(x):
                return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p for p in x.placements])

            m = reduced(logits.detach().amax(dim=-1, keepdim=True))
            return m + torch.log(reduced(torch.exp(logits - m).sum(dim=-1, keepdim=True)))
    return torch.logsumexp(logits, dim=-1, keepdim=True)


def _is_partial(x) -> bool:
    """Whether `x` is a DTensor holding partial sums on some mesh dim."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor) and any(p.is_partial() for p in x.placements)


def _vocab_ids(logits):
    """Each logit's index in the vocabulary, broadcastable against `logits`.
    On DTensor logits it is a DTensor of their shape and placements whose
    local shard is a view of that shard's own ids, so that comparing it
    with the labels keeps the one-hot on the logits' shards."""
    if torch.distributed.is_available():
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        if isinstance(logits, DTensor):
            mesh = logits.device_mesh
            placements = [Replicate() if p.is_partial() else p for p in logits.placements]
            shape, offset = compute_local_shape_and_global_offset(logits.shape, mesh, placements)
            local = torch.arange(offset[-1], offset[-1] + shape[-1], device=logits.to_local().device)
            return DTensor.from_local(local.expand(shape), mesh, placements, shape=logits.shape,
                                      stride=logits.stride())
    return torch.arange(logits.shape[-1], device=logits.device)


def build_model(config: ModelConfig) -> Model:
    return Model(config)
