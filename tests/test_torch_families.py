"""The port's moe, MLA, encdec and vlm families and the seven configs that
use them (`repro_torch.models.lm`, `repro_torch.configs`) against the JAX
reference, on the CPU.

Both packages get the same parameters: the reference initialises each
reduced config in float32, and `convert.model_params_from_reference`
carries its tree across (`top`, `layers`, `enc_layers`, `extra`).  Tokens
and the vlm's patch / the encdec's frame embeddings come from numpy.
Tolerances, as in tests/test_torch_models.py (both sides compute in
float32 and differ in summation order only):
- forward logits rtol = atol = 1e-4, the reference on its Pallas route
  (interpret mode; MLA prefill and the whisper encoder take the
  materialized scores on both sides), the port on "kernel" (the plain
  versions on the CPU); the MoE aux at rel 1e-5;
- prefill + decode_step logits teacher-forced along the reference's greedy
  tokens, 1e-4, with greedy tokens equal wherever the reference's top-2
  logit gap exceeds 1e-3;
- the full configs' parameter counts exactly (meta init against the
  reference's abstract init).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models.lm import build_model as jbuild
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import impl_from_reference, model_params_from_reference
from repro_torch.launch.serve import RequestFn
from repro_torch.models.lm import build_model

NEW = ("gemma-2b", "stablelm-3b", "qwen3-32b", "moonshot-v1-16b-a3b", "deepseek-v2-236b",
       "whisper-small", "llava-next-34b")
KEY = jax.random.PRNGKey(0)
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    jparams, _ = jbuild(jget_reduced(arch).replace(param_dtype=jnp.float32)).init(KEY)
    return jparams, jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)


def _pair(arch, **kw):
    """(reference model, its params, port model, the same params) in
    float32; `kw` sets the reference's routes, the port takes the matching
    ones."""
    jparams, numpy_tree = _reference_params(arch)
    jcfg = jget_reduced(arch).replace(param_dtype=jnp.float32, **kw)
    cfg = get_reduced(arch).replace(param_dtype=torch.float32, **{k: impl_from_reference(v) for k, v in kw.items()})
    return jbuild(jcfg), jparams, build_model(cfg), model_params_from_reference(numpy_tree, cfg, "cpu")


def _extras(cfg, batch, seed):
    """The family's numpy inputs beside the tokens (none, patches or frames)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"vision_embeds": rng.standard_normal((batch, cfg.vision_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"enc_embeds": rng.standard_normal((batch, cfg.enc_positions, cfg.d_model)).astype(np.float32)}
    return {}


def _batches(cfg, toks, extras):
    jb = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extras.items()}}
    tb = {"tokens": torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in extras.items()}}
    return jb, tb


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", NEW)
def test_reduced_forward_matches_reference_float32(arch):
    jmodel, jparams, model, params = _pair(arch, attn_impl="pallas")
    cfg = model.config
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb, tb = _batches(cfg, toks, _extras(cfg, B, 2))
    jlogits, jcache, jaux = jax.jit(jmodel.forward)(
        jparams, jb["tokens"], vision_embeds=jb.get("vision_embeds"), enc_embeds=jb.get("enc_embeds"))
    logits, cache, aux = model.forward(
        params, tb["tokens"], vision_embeds=tb.get("vision_embeds"), enc_embeds=tb.get("enc_embeds"))
    prefix = cfg.vision_patches if cfg.family == "vlm" else 0
    assert logits.shape == (B, prefix + S, cfg.padded_vocab)
    _close(logits, jlogits, 1e-4)
    if cfg.moe is not None:
        assert float(aux) == pytest.approx(float(jaux), rel=1e-5) and float(aux) > 0
    # the cache: per layer (k, v), or (c_kv, k_pe) latents for MLA; for
    # encdec, the decoder's (k, v) and the cross (k, v) of every layer
    if cfg.family == "encdec":
        (self_kv, cross_kv), (jself, jcross) = cache, jcache
        _close(self_kv[-1][0], jself[0][-1], 1e-4)
        _close(cross_kv[-1][1], jcross[1][-1], 1e-4)
        assert len(cross_kv) == cfg.n_layers and cross_kv[0][0].shape[1] == cfg.enc_positions
    else:
        for i, (a, b) in enumerate(cache):
            _close(a, jcache[0][i], 1e-4)
            _close(b, jcache[1][i], 1e-4)
        if cfg.mla is not None:
            assert cache[0][0].shape == (B, S, cfg.mla.kv_lora) and cache[0][1].shape == (B, S, cfg.mla.d_rope)


@pytest.mark.parametrize("arch", NEW)
def test_decode_teacher_forced_along_reference_generate(arch):
    jmodel, jparams, model, params = _pair(arch)
    cfg = model.config
    steps, prompt = 4, np.random.default_rng(3).integers(0, cfg.vocab, (1, 10)).astype(np.int32)
    jb, tb = _batches(cfg, prompt, _extras(cfg, 1, 4))
    offset = prompt.shape[1] + (cfg.vision_patches if cfg.family == "vlm" else 0)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jb)
    jcache = jmodel.grow_cache(jcache, offset + steps)
    logits, cache = model.prefill(params, tb)
    cache = model.grow_cache(cache, offset + steps)
    if cfg.family == "encdec":  # the cross KV does not grow
        assert cache[1][0][0].shape[1] == cfg.enc_positions and cache[0][0][0].shape[1] == offset + steps
    jdecode = jax.jit(jmodel.decode_step)
    jtoks, clear = [], []
    for i in range(steps):
        _close(logits, jlogits, 1e-4)
        ref = np.asarray(jlogits[0], np.float32)
        top2 = np.sort(ref)[-2:]
        clear.append(top2[1] - top2[0] > 1e-3)
        jtoks.append(np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32))
        if clear[-1]:
            assert int(torch.argmax(logits[0])) == int(jtoks[-1][0])
        if i == steps - 1:
            break
        tok = jtoks[-1]
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok), offset + i)
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok.copy()), offset + i)
    out = model.generate(params, tb, steps=steps)
    assert out.shape == (1, steps) and out.dtype == torch.int32
    if all(clear):
        assert out[0].tolist() == [int(t[0]) for t in jtoks]


def test_moe_dense_route_and_absorbed_mla_decode_match_reference():
    """The other routes of a whole model: moe_impl="dense" and
    mla_decode_impl="absorbed" on the reduced deepseek (MLA + MoE)."""
    jmodel, jparams, model, params = _pair("deepseek-v2-236b", moe_impl="dense", mla_decode_impl="absorbed")
    toks = np.random.default_rng(5).integers(0, model.config.vocab, (1, 9)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :-1])})
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :-1])})
    _close(logits, jlogits, 1e-4)
    jdec, _ = jax.jit(jmodel.decode_step)(jparams, jmodel.grow_cache(jcache, 9), jnp.asarray(toks[:, -1]), 8)
    dec, _ = model.decode_step(params, model.grow_cache(cache, 9), torch.from_numpy(toks[:, -1].copy()), 8)
    _close(dec, jdec, 1e-4)


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_param_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert ARCH_IDS == JARCH_IDS
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small"])
def test_request_fn_draws_the_reference_extras_and_serves_greedy_tokens(arch):
    """`RequestFn` draws each request's patch or frame embeddings from its
    generator as the reference's serve does (standard normal, bfloat16),
    and serves the tokens `generate` gives on those inputs."""
    cfg = get_reduced(arch).replace(param_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    prompt, steps = 6, 3
    rng, mirror = np.random.default_rng(0), np.random.default_rng(0)
    serve_fn = RequestFn(model, params, prompt, steps, "cpu", rng)
    key, n = ("vision_embeds", cfg.vision_patches) if cfg.family == "vlm" else ("enc_embeds", cfg.enc_positions)
    for _ in range(2):
        toks = np.arange(prompt) % cfg.vocab
        got = serve_fn(toks)
        draw = jnp.asarray(mirror.standard_normal((1, n, cfg.d_model)), jnp.bfloat16)  # the reference's extras()
        extras = {key: torch.from_numpy(np.asarray(draw, np.float32)).to(torch.bfloat16)}
        want = model.generate(params, {"tokens": torch.as_tensor(toks[None], dtype=torch.int32), **extras}, steps)
        assert got.tolist() == want[0].tolist()
    assert serve_fn.logits_finite and len(serve_fn.prefill_s) == 2
    with pytest.raises(ValueError, match="rng"):
        RequestFn(model, params, prompt, steps, "cpu")
