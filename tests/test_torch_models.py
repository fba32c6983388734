"""The port's model stack (`repro_torch.models`, `repro_torch.configs`)
against the JAX reference, on the CPU.

Both packages get the same parameters: the reference initialises a reduced
config, and `convert.model_params_from_reference` carries its tree across
as numpy float32.  Tokens come from numpy.  Tolerances:
- float32 (`param_dtype=float32` on both sides): forward logits rtol = atol
  = 1e-4, against the reference's Pallas kernels (interpret mode) and
  against its default routes; prefill + decode_step logits teacher-forced
  along the reference's greedy `generate` tokens, 1e-4; greedy tokens equal
  wherever the reference's top-2 logit gap exceeds 1e-3.  Both sides
  compute in float32 and differ in summation order only.
- bfloat16 (the configs' own dtype): max|Δ| / max|ref| < 0.05, the
  reference's own decode-vs-forward bound (tests/test_models.py), because
  the two frameworks round to bfloat16 at different places: whole-model
  logits for the dense and ssm families; for the hybrid, each block (an
  SSM layer, the shared attention block) and the port's own
  prefill-then-decode contract.  The hybrid's whole-model logits are held
  only to 0.25, a guard against gross faults: with random weights the
  hybrid in bfloat16 turns one changed rounding anywhere into logit
  differences of about 10% (the reference's own bfloat16 logits lie that
  far from its float32 logits; chip_smoke.py measures the same response
  to an epsilon-sized nudge of the embeddings), and the two frameworks
  round to bfloat16 at many different places (XLA's bfloat16 silu rounds
  after each of its steps, torch's once).
- numerics (norms, rope, activations): rtol = atol = 1e-6 in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import common as jcommon
from repro.models.lm import build_model as jbuild
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import impl_from_reference, model_params_from_reference
from repro_torch.models import common
from repro_torch.models.lm import build_model
from repro_torch.models.ssm import ssd_chunked

KEY = jax.random.PRNGKey(0)
B, S = 2, 24


@functools.lru_cache(maxsize=None)
def _reference_params(arch, dtype):
    jparams, _ = jbuild(jget_reduced(arch).replace(param_dtype=getattr(jnp, dtype))).init(KEY)
    return jparams, jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)


def _pair(arch, dtype="float32", **kw):
    """(reference model, its params, port model, the same params); `kw`
    sets the reference's routes, and the port takes the matching ones."""
    jparams, numpy_tree = _reference_params(arch, dtype)
    jcfg = jget_reduced(arch).replace(param_dtype=getattr(jnp, dtype), **kw)
    port_kw = {k: impl_from_reference(v) for k, v in kw.items()}
    cfg = get_reduced(arch).replace(param_dtype=getattr(torch, dtype), **port_kw)
    return jbuild(jcfg), jparams, build_model(cfg), model_params_from_reference(numpy_tree, cfg, "cpu")


def _jforward(jmodel, jparams, toks):
    return jax.jit(jmodel.forward)(jparams, jnp.asarray(toks))


def _tokens(vocab, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def test_numerics_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16), np.float32)
    w, b = rng.standard_normal(16, np.float32), rng.standard_normal(16, np.float32)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    for off in (0.0, 1.0):
        _close(common.rms_norm(tx, tw, offset=off), jcommon.rms_norm(x, w, offset=off), 1e-6)
    _close(common.layer_norm(tx, tw, tb), jcommon.layer_norm(x, w, b), 1e-6)
    for act in ("silu", "gelu", "relu"):
        _close(common.ACTIVATIONS[act](tx), jcommon.ACTIVATIONS[act](x), 1e-6)
    pos = np.broadcast_to(np.arange(5), (2, 5)).astype(np.int32)
    for theta, frac in ((10000.0, 1.0), (1e6, 0.25)):
        got = common.apply_rope(tx, torch.from_numpy(pos.copy()), theta, frac)
        _close(got, jcommon.apply_rope(x, jnp.asarray(pos), theta, frac), 1e-5)
    assert common.pad_vocab(32000) == jcommon.pad_vocab(32000) == 32256


def test_configs_match_reference():
    import dataclasses

    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro_torch.configs import ARCH_IDS

    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        for port, ref in ((get_config(arch), jget_config(arch)), (get_reduced(arch), jget_reduced(arch))):
            for field in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
                          "resolved_head_dim", "padded_vocab", "qkv_bias", "qk_norm", "rope_theta",
                          "rope_fraction", "norm", "norm_offset", "act", "gated_mlp", "embed_scale",
                          "attn_every", "n_enc_layers", "enc_positions", "vision_patches", "moe_impl",
                          "mla_decode_impl"):
                assert getattr(port, field) == getattr(ref, field), (arch, field)
            assert dataclasses.asdict(port.attn_spec) == dataclasses.asdict(ref.attn_spec), arch
            for spec in ("moe", "mla"):
                a, b = getattr(port, spec), getattr(ref, spec)
                assert (a is None) == (b is None), (arch, spec)
                if a is not None:
                    assert dataclasses.asdict(a) == dataclasses.asdict(b), (arch, spec)
            if ref.ssm is not None:
                for field in ("d_state", "d_conv", "expand", "head_dim", "n_groups", "chunk", "in_dim"):
                    assert getattr(port.ssm, field) == getattr(ref.ssm, field), (arch, field)
    assert get_config("zamba2-1.2b").param_count() == jget_config("zamba2-1.2b").param_count()
    assert get_config("zamba2-1.2b").attn_impl == get_config("zamba2-1.2b").ssm_impl == "kernel"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        jget_config("no-such-arch")
    # an unknown family raises at init, as the reference's does
    with pytest.raises(ValueError, match="bogus"):
        build_model(get_reduced("qwen2-0.5b").replace(family="bogus")).init(device="meta")
    with pytest.raises(ValueError, match="bogus"):
        jbuild(jget_reduced("qwen2-0.5b").replace(family="bogus")).init(KEY, abstract=True)
    assert impl_from_reference("pallas") == "kernel" and impl_from_reference("chunked") == "chunked"


def test_init_draws_the_reference_distributions():
    full = build_model(get_config("zamba2-1.2b")).init(device="meta")  # shapes only
    assert len(full["layers"]) == 38 and set(full["shared_attn"]) >= {"attn/wq", "mlp/w_down"}
    assert full["top"]["embed"].shape == (32256, 2048) and full["top"]["embed"].dtype == torch.bfloat16
    assert full["layers"][0]["ssm/w_in"].shape == (2048, 8384)
    assert full["layers"][0]["ssm/A_log"].dtype == torch.float32
    cfg = get_reduced("zamba2-1.2b").replace(vocab=4096)
    params = build_model(cfg).init(seed=0, device="cpu")
    top, layer = params["top"], params["layers"][0]
    assert float(top["embed"].float().std()) == pytest.approx(0.02, rel=0.02)
    assert float(top["unembed"].float().std()) == pytest.approx(64**-0.5, rel=0.02)
    assert float(layer["ssm/w_in"].float().std()) == pytest.approx(64**-0.5, rel=0.05)
    assert torch.all(layer["ssm/D"] == 1) and torch.all(layer["ssm/A_log"] == 0)
    again = build_model(cfg).init(seed=0, device="cpu")
    assert torch.equal(again["layers"][4]["ssm/w_out"], params["layers"][4]["ssm/w_out"])


@pytest.mark.parametrize("jimpl", [dict(attn_impl="pallas", ssm_impl="pallas"), {}], ids=["pallas", "default"])
def test_reduced_zamba2_forward_matches_reference_float32(jimpl):
    jmodel, jparams, model, params = _pair("zamba2-1.2b", **jimpl)
    toks = _tokens(model.config.vocab)
    logits, (ssm_states, attn_caches), _ = model.forward(params, torch.from_numpy(toks))
    jlogits, (jssm, jattn), _ = _jforward(jmodel, jparams, toks)
    assert logits.shape == (B, S, model.config.padded_vocab)
    _close(logits, jlogits, 1e-4)
    assert len(attn_caches) == len(jattn) == 3 and len(ssm_states) == 3
    for (k, v), (jk, jv) in zip(attn_caches, jattn):
        _close(k, jk, 1e-4)
        _close(v, jv, 1e-4)
    _close(ssm_states[-1][-1][1], jssm[-1][1][-1], 1e-4)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_reduced_dense_and_ssm_forward_match_reference_float32(arch):
    jmodel, jparams, model, params = _pair(arch)
    toks = _tokens(model.config.vocab, seed=1)
    _close(model.forward(params, torch.from_numpy(toks))[0], _jforward(jmodel, jparams, toks)[0], 1e-4)


@pytest.mark.parametrize("attn,ssm", [("ref", "jnp"), ("chunked", "jnp")])
def test_other_routes_match_reference(attn, ssm):
    jmodel, jparams, model, params = _pair("zamba2-1.2b", attn_impl=attn, ssm_impl=ssm)
    toks = _tokens(model.config.vocab, seed=2)
    _close(model.forward(params, torch.from_numpy(toks))[0], _jforward(jmodel, jparams, toks)[0], 1e-4)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen2-0.5b", "mamba2-2.7b"])
def test_decode_teacher_forced_along_reference_generate(arch):
    jmodel, jparams, model, params = _pair(arch)
    steps, prompt = 5, _tokens(model.config.vocab, seed=3, shape=(1, 12))
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(prompt)})
    jcache = jmodel.grow_cache(jcache, prompt.shape[1] + steps)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)})
    cache = model.grow_cache(cache, prompt.shape[1] + steps)
    jtoks, clear = [], []
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        _close(logits, jlogits, 1e-4)
        ref = np.asarray(jlogits[0], np.float32)
        top2 = np.sort(ref)[-2:]
        clear.append(top2[1] - top2[0] > 1e-3)
        # the reference's greedy token, as its `generate` picks it
        jtoks.append(np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32))
        if clear[-1]:
            assert int(torch.argmax(logits[0])) == int(jtoks[-1][0])
        if i == steps - 1:
            break
        tok = jtoks[-1]
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok), prompt.shape[1] + i)
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok.copy()), prompt.shape[1] + i)
    out = model.generate(params, {"tokens": torch.from_numpy(prompt)}, steps=steps)
    assert out.shape == (1, steps) and out.dtype == torch.int32
    if all(clear):
        assert out[0].tolist() == [int(t[0]) for t in jtoks]


@pytest.mark.parametrize("jimpl", ["pallas", "jnp"])
def test_reduced_mamba2_long_prompt_matches_reference(jimpl):
    """The SSM serving path at more chunks than a cluster of the Hopper
    ssd_scan holds: reduced mamba2-2.7b (chunk 16) on a 200-token prompt,
    13 chunks, the last one ragged.  The port's main path (ssm_impl
    "kernel", the plain scan on the CPU) against the reference's Pallas
    kernel (interpret mode) and its jnp route: prefill logits, every
    layer's final SSM and conv states, then decode_steps teacher-forced
    along the reference's greedy tokens, 1e-4 in float32."""
    jmodel, jparams, _, params = _pair("mamba2-2.7b", ssm_impl=jimpl)
    model = build_model(get_reduced("mamba2-2.7b").replace(param_dtype=torch.float32))
    assert model.config.ssm_impl == "kernel" and model.config.ssm.chunk == 16
    prompt = _tokens(model.config.vocab, seed=8, shape=(1, 200))
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(prompt)})
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)})
    jconv, jstate = jcache
    assert len(cache) == model.config.n_layers == jstate.shape[0]
    for i, (conv, state) in enumerate(cache):
        _close(state, jstate[i], 1e-4)
        _close(conv, jconv[i], 1e-4)
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(4):
        _close(logits, jlogits, 1e-4)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok), prompt.shape[1] + i)
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok.copy()), prompt.shape[1] + i)
    _close(logits, jlogits, 1e-4)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen2-0.5b", "mamba2-2.7b"])
def test_reduced_bfloat16_within_the_reference_decode_bound(arch):
    jmodel, jparams, model, params = _pair(arch, dtype="bfloat16")
    toks = _tokens(model.config.vocab, seed=4)
    logits, _, _ = model.forward(params, torch.from_numpy(toks))
    assert logits.dtype == torch.bfloat16
    whole = 0.25 if arch == "zamba2-1.2b" else 0.05  # see the module docstring
    assert _rel(logits, _jforward(jmodel, jparams, toks)[0]) < whole
    # the port's own prefill-then-decode contract (tests/test_models.py)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :-1])})
    dec, _ = model.decode_step(params, model.grow_cache(cache, S), torch.from_numpy(toks[:, -1]), S - 1)
    assert _rel(dec, logits[:, -1].float().numpy()) < 0.05


def test_hybrid_blocks_bfloat16_within_the_reference_decode_bound():
    from repro.models import attention as jattention
    from repro.models import ssm as jssm
    from repro_torch.models import attention, ssm

    jmodel, jparams, model, params = _pair("zamba2-1.2b", dtype="bfloat16")
    x = np.random.default_rng(6).standard_normal((B, S, model.config.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jssm_full = jax.jit(jssm.ssm_full, static_argnums=1, static_argnames="impl")
    for i in range(model.config.n_layers):
        jlp = jax.tree.map(lambda a: a[i], jparams["layers"])
        out, (conv, h) = ssm.ssm_full(params["layers"][i], model.config.ssm, tx)
        jout, (jconv, jh) = jssm_full(jlp, jmodel.config.ssm, jx, impl="pallas")
        assert _rel(out, jout) < 0.05 and _rel(h, jh) < 0.05 and _rel(conv, jconv) < 0.05
    out, _ = attention.attend_full(params["shared_attn"], model.config.attn_spec, tx, torch.from_numpy(pos.copy()))
    jout, _ = jattention.attend_full(jparams["shared_attn"], jmodel.config.attn_spec, jx, jnp.asarray(pos), "pallas")
    assert _rel(out, jout) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(dtype):
    rng = np.random.default_rng(5)
    Bt, Sq, H, P, G, N, Q = 2, 50, 4, 8, 2, 8, 16
    x, B_, C_ = (rng.standard_normal(s, np.float32) for s in ((Bt, Sq, H, P), (Bt, Sq, G, N), (Bt, Sq, G, N)))
    dt = np.logaddexp(rng.standard_normal((Bt, Sq, H)), 0.0).astype(np.float32)
    A, D = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32), np.ones(H, np.float32)
    h0 = rng.standard_normal((Bt, H, P, N), np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y, h = ssd_chunked(*(torch.from_numpy(a).to(td) for a in (x,)), torch.from_numpy(dt), torch.from_numpy(A),
                       torch.from_numpy(B_).to(td), torch.from_numpy(C_).to(td), torch.from_numpy(D), Q,
                       h0=torch.from_numpy(h0))
    jy, jh = jssd_chunked(jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B_, jd),
                          jnp.asarray(C_, jd), jnp.asarray(D), Q, h0=jnp.asarray(h0))
    if dtype == "float32":
        _close(y, jy, 1e-4)
        _close(h, jh, 1e-4)
    else:
        assert _rel(y, jy) < 0.05 and _rel(h, jh) < 0.05
