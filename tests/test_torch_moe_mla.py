"""The port's MoE FFN (`repro_torch.models.moe`) and MLA
(`repro_torch.models.mla`) against the JAX reference, on the CPU, in
float32.

Both packages get the same parameters (the reference's `Tape` init, carried
across as numpy float32) and the same numpy inputs.  The cases are those of
tests/test_moe.py and tests/test_mla.py, run on both packages.  Tolerances:
- MoE, gather and dense routes: outputs rtol = atol = 1e-5 against the
  reference's same route, also where the gather route drops assignments
  (capacity factors 0.1 and 1.25: the port must drop the same ones, which it does
  only if it routes and slots every assignment as the reference does);
  aux rel 1e-6; router weights 1e-6 and ids equal.  Both sides compute in
  float32 and differ in summation order only.
- MLA: `mla_full` (every route) and naive / absorbed `mla_decode` at
  rtol = atol = 1e-4, the model tests' float32 bound; the port's own
  absorbed-vs-naive identity at 1e-4 and decode-vs-full at 2e-3, as the
  reference's tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models.common import Tape
from repro_torch.models import mla, moe

KEY = jax.random.PRNGKey(0)


def _to_port(params):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params.items()}


def _moe_setup(capacity_factor=16.0, n_shared=1):
    kw = dict(d_model=32, d_ff=16, n_experts=8, top_k=2, n_shared=n_shared, capacity_factor=capacity_factor)
    tape = Tape(KEY, dtype=jnp.float32)
    jmoe.init_moe(tape, jmoe.MoESpec(**kw))
    return jmoe.MoESpec(**kw), tape.params, moe.MoESpec(**kw), _to_port(tape.params)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _both(impl, x, capacity_factor=16.0, n_shared=1, zero=()):
    jspec, jparams, spec, params = _moe_setup(capacity_factor, n_shared)
    for k in zero:
        jparams = {**jparams, k: jnp.zeros_like(jparams[k])}
        params = {**params, k: torch.zeros_like(params[k])}
    jy, jaux = jmoe.moe_ffn(jparams, jspec, jnp.asarray(x), impl=impl)
    y, aux = moe.moe_ffn(params, spec, torch.from_numpy(x), impl=impl)
    return y, aux, np.asarray(jy), float(jaux)


def test_init_moe_has_the_reference_keys_shapes_and_a_float32_router():
    _, jparams, spec, _ = _moe_setup()
    from repro_torch.models.common import Init

    init = Init(torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    moe.init_moe(init, spec)
    assert {k: tuple(v.shape) for k, v in init.params.items()} == {k: v.shape for k, v in jparams.items()}
    assert init.params["moe/router"].dtype == torch.float32 and init.params["moe/w_up"].dtype == torch.bfloat16


def test_router_matches_reference():
    jspec, jparams, spec, params = _moe_setup()
    x = _x((2, 16, 32), 1)
    jw, jids, jaux = jmoe._router(jparams, jspec, jnp.asarray(x), "moe")
    w, ids, aux = moe._router(params, spec, torch.from_numpy(x), "moe")
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw, 1e-6)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("capacity_factor,shape", [(16.0, (2, 16, 32)), (0.1, (2, 64, 32)), (1.25, (2, 64, 32))],
                         ids=["no-drop", "drops-0.1", "published-1.25"])
def test_gather_matches_reference(capacity_factor, shape):
    """The same outputs where nothing drops and where capacity drops
    assignments: the port drops the reference's assignments."""
    x = _x(shape, 3)
    y, aux, jy, jaux = _both("gather", x, capacity_factor)
    _close(y, jy, 1e-5)
    assert float(aux) == pytest.approx(jaux, rel=1e-6)
    jspec, jparams, spec, params = _moe_setup(capacity_factor)
    _, ids, _ = moe._router(params, spec, torch.from_numpy(x), "moe")
    T = shape[0] * shape[1]
    cap = moe.capacity(spec, T, shape[1])
    pos, keep = moe._slots(ids.reshape(-1), spec.n_experts, cap)
    # the reference's slotting: the cumulative one-hot count, in token order
    jids = np.asarray(jmoe._router(jparams, jspec, jnp.asarray(x), "moe")[1]).reshape(-1)
    onehot = np.eye(spec.n_experts, dtype=np.int64)[jids]
    want_pos = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    assert np.array_equal(pos.numpy(), want_pos) and np.array_equal(keep.numpy(), want_pos < cap)
    assert cap == max(1, min(T, int(capacity_factor * T * spec.top_k / spec.n_experts)))
    assert bool((~keep).any()) == (capacity_factor < 16.0)  # drops, except at the no-drop factor


@pytest.mark.parametrize("n_shared", [0, 1])
def test_dense_matches_reference(n_shared):
    y, aux, jy, jaux = _both("dense", _x((2, 16, 32), 1), n_shared=n_shared)
    _close(y, jy, 1e-5)
    assert float(aux) == pytest.approx(jaux, rel=1e-6)


def test_gather_matches_dense_no_drop():
    """With capacity that never drops, gather == dense (tests/test_moe.py)."""
    _, _, spec, params = _moe_setup()
    x = torch.from_numpy(_x((2, 16, 32), 1))
    y_g, aux_g = moe.moe_ffn(params, spec, x, impl="gather")
    y_d, aux_d = moe.moe_ffn(params, spec, x, impl="dense")
    torch.testing.assert_close(y_g, y_d, atol=1e-4, rtol=1e-4)
    assert float(aux_g) == pytest.approx(float(aux_d))


def test_decode_token_never_dropped():
    """S = 1 takes the no-drop capacity: gather == dense at a hostile factor,
    and == the reference's gather."""
    x = _x((16, 1, 32), 2)
    y, _, jy, _ = _both("gather", x, capacity_factor=0.01)
    y_d, _, _, _ = _both("dense", x, capacity_factor=0.01)
    torch.testing.assert_close(y, y_d, atol=1e-4, rtol=1e-4)
    _close(y, jy, 1e-5)


def test_capacity_drops_tokens():
    """A tiny capacity at a prefill shape drops (gather != dense) but stays
    finite, as the reference's does."""
    x = _x((2, 64, 32), 3)
    y_g, _, jy_g, _ = _both("gather", x, capacity_factor=0.1)
    y_d, _, _, _ = _both("dense", x, capacity_factor=0.1)
    assert bool(torch.isfinite(y_g).all())
    assert not torch.allclose(y_g, y_d, atol=1e-4)
    _close(y_g, jy_g, 1e-5)


def test_aux_loss_balanced_router_is_one():
    """A zero router gives uniform probabilities and aux = 1 whatever the
    tie-break (torch.topk's order among ties is not JAX's, so only aux is
    compared)."""
    _, aux, _, jaux = _both("dense", _x((2, 128, 32), 4), n_shared=0, zero=("moe/router",))
    assert float(aux) == pytest.approx(1.0, rel=1e-3)
    assert float(aux) == pytest.approx(jaux, rel=1e-6)


def test_shared_experts_always_on():
    """Zeroing the routed experts leaves exactly the shared experts' output."""
    x = _x((1, 8, 32), 5)
    y, _, jy, _ = _both("gather", x, zero=("moe/w_gate", "moe/w_up", "moe/w_down"))
    assert float(y.abs().max()) > 0
    _close(y, jy, 1e-5)
    _, _, spec, params = _moe_setup()
    torch.testing.assert_close(y, moe._shared_experts(params, spec, torch.from_numpy(x), "moe"))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA_KW = dict(d_model=64, n_heads=4, q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16)


def _mla_setup():
    tape = Tape(KEY, dtype=jnp.float32)
    jmla.init_mla(tape, jmla.MLASpec(**MLA_KW))
    return jmla.MLASpec(**MLA_KW), tape.params, mla.MLASpec(**MLA_KW), _to_port(tape.params)


def _pos(B, S):
    return np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)


@pytest.mark.parametrize("jimpl,impl", [("ref", "ref"), ("chunked", "chunked"), ("pallas", "kernel")])
def test_mla_full_matches_reference(jimpl, impl):
    jspec, jparams, spec, params = _mla_setup()
    B, S = 2, 12
    x, pos = _x((B, S, 64), 1), _pos(B, S)
    jout, (jckv, jkpe) = jmla.mla_full(jparams, jspec, jnp.asarray(x), jnp.asarray(pos), impl=jimpl)
    out, (ckv, kpe) = mla.mla_full(params, spec, torch.from_numpy(x), torch.from_numpy(pos.copy()), impl=impl)
    _close(out, jout, 1e-4)
    _close(ckv, jckv, 1e-4)
    _close(kpe, jkpe, 1e-4)
    assert ckv.shape == (B, S, spec.kv_lora) and kpe.shape == (B, S, spec.d_rope)


@pytest.mark.parametrize("impl", ["naive", "absorbed"])
def test_mla_decode_matches_reference(impl):
    jspec, jparams, spec, params = _mla_setup()
    B, S = 2, 12
    x, pos = _x((B, S, 64), 1), _pos(B, S)
    _, (jckv, jkpe) = jmla.mla_full(jparams, jspec, jnp.asarray(x), jnp.asarray(pos), impl="ref")
    jckv, jkpe = (jnp.pad(a, ((0, 0), (0, 1), (0, 0))) for a in (jckv, jkpe))
    ckv, kpe = (torch.from_numpy(np.array(a)) for a in (jckv, jkpe))
    x_new = _x((B, 1, 64), 2)
    jout, jc, jk = jmla.mla_decode(jparams, jspec, jnp.asarray(x_new), jckv, jkpe, S, impl=impl)
    out, c, k = mla.mla_decode(params, spec, torch.from_numpy(x_new), ckv, kpe, S, impl=impl)
    _close(out, jout, 1e-4)
    _close(c, jc, 1e-4)
    _close(k, jk, 1e-4)
    assert float(ckv[:, S].abs().max()) == 0  # the input cache is not written


def test_absorbed_equals_naive_decode():
    """Matrix absorption is an algebraic identity (tests/test_mla.py)."""
    _, _, spec, params = _mla_setup()
    B, S = 2, 12
    x = torch.from_numpy(_x((B, S, 64), 1))
    _, (ckv, kpe) = mla.mla_full(params, spec, x, torch.from_numpy(_pos(B, S).copy()), impl="ref")
    ckv, kpe = (torch.nn.functional.pad(a, (0, 0, 0, 1)) for a in (ckv, kpe))
    x_new = torch.from_numpy(_x((B, 1, 64), 2))
    out_naive, _, _ = mla.mla_decode(params, spec, x_new, ckv, kpe, S, impl="naive")
    out_abs, _, _ = mla.mla_decode(params, spec, x_new, ckv, kpe, S, impl="absorbed")
    torch.testing.assert_close(out_naive, out_abs, atol=1e-4, rtol=1e-4)


def test_latent_cache_is_compressed():
    _, _, spec, _ = _mla_setup()
    assert spec.cache_dim == spec.kv_lora + spec.d_rope
    assert spec.cache_dim < 2 * spec.n_heads * (spec.d_nope + spec.d_rope) / 3


@pytest.mark.parametrize("impl", ["naive", "absorbed"])
def test_decode_matches_full_forward_last_position(impl):
    _, _, spec, params = _mla_setup()
    B, S = 2, 10
    x = torch.from_numpy(_x((B, S, 64), 4))
    pos = torch.from_numpy(_pos(B, S).copy())
    out_full, _ = mla.mla_full(params, spec, x, pos, impl="ref")
    _, (ckv, kpe) = mla.mla_full(params, spec, x[:, : S - 1], pos[:, : S - 1], impl="ref")
    ckv, kpe = (torch.nn.functional.pad(a, (0, 0, 0, 1)) for a in (ckv, kpe))
    out_dec, _, _ = mla.mla_decode(params, spec, x[:, S - 1:], ckv, kpe, S - 1, impl=impl)
    torch.testing.assert_close(out_dec, out_full[:, -1:], atol=2e-3, rtol=2e-3)
