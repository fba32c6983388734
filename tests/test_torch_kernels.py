"""The port's kernels (`repro_torch.kernels`) against the JAX reference.

On the CPU the wrappers take their plain PyTorch versions, which are held
to the reference's oracles (`repro.kernels.ref`) and to the Pallas kernels
in interpret mode, on the cases of tests/test_kernels.py: kw_queue slots
exactly and floats to 1e-5; residual_sample max to 1e-6 and sum to 1e-5.
The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet.vector import lindley as jlindley
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.fleet.vector import lindley
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.kw_queue import kw_queue_plain
from repro_torch.kernels.residual_sampler import residual_sample_plain

KW_CASES = [(4, 37, 1), (8, 64, 3), (13, 48, 4), (1, 200, 2)]


def _kw_inputs(B, J, c, seed=0, lam=0.5):
    """tests/test_kernels.py's inputs, as numpy."""
    ka, ks = jax.random.split(jax.random.PRNGKey(seed))
    arr = jnp.cumsum(jax.random.exponential(ka, (B, J)) / lam, axis=1)
    svc = 0.5 + jax.random.exponential(ks, (B, J))
    speeds = jnp.sort(0.5 + jax.random.uniform(jax.random.PRNGKey(seed + 1), (c,)))[::-1]
    return tuple(np.array(z, np.float32) for z in (arr, svc, speeds))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _assert_kw_equal(outs, outs_ref):
    for a, b in zip(outs[:3], outs_ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert np.array_equal(outs[3].numpy(), np.asarray(outs_ref[3]))
    assert outs[3].dtype == torch.int32


@pytest.mark.parametrize("B,J,c", KW_CASES)
def test_kw_queue_plain_matches_reference_and_pallas(B, J, c):
    arr, svc, speeds = _kw_inputs(B, J, c)
    outs = kw_queue_plain(*_t(arr, svc, speeds))
    _assert_kw_equal(outs, jref.kw_queue_ref(*_j(arr, svc, speeds)))
    _assert_kw_equal(outs, jops.kw_queue(*_j(arr, svc, speeds)))
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = ops.kw_queue.launches
    for a, b in zip(ops.kw_queue(*_t(arr, svc, speeds)), outs):
        assert torch.equal(a, b)
    assert ops.kw_queue.launches == before
    assert ref.kw_queue_ref is kw_queue_plain


def test_kw_queue_heterogeneous_speeds_scale_service():
    arr, svc, _ = _kw_inputs(5, 40, 3, seed=9)
    speeds = np.array([2.0, 1.0, 0.5], np.float32)
    starts, fins, scaled, slots = kw_queue_plain(*_t(arr, svc, speeds))
    _assert_kw_equal((starts, fins, scaled, slots), jref.kw_queue_ref(*_j(arr, svc, speeds)))
    sl = slots.numpy()
    assert sl.min() >= 0 and sl.max() < 3
    np.testing.assert_allclose(scaled.numpy(), svc / speeds[sl], rtol=1e-5)
    np.testing.assert_allclose((fins - starts).numpy(), scaled.numpy(), rtol=1e-5, atol=1e-5)


def test_kw_queue_c1_is_lindley():
    arr, svc, _ = _kw_inputs(7, 60, 1, seed=3)
    starts, fins, _, slots = kw_queue_plain(*_t(arr, svc, np.ones(1, np.float32)))
    assert torch.all(slots == 0)
    s_lin, f_lin = lindley(*_t(arr, svc))
    np.testing.assert_allclose(starts.numpy(), s_lin.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(fins.numpy(), f_lin.numpy(), rtol=1e-5, atol=1e-4)
    s_ref, f_ref = jax.vmap(jlindley)(*_j(arr, svc))
    np.testing.assert_allclose(f_lin.numpy(), np.asarray(f_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_lin.numpy(), np.asarray(s_ref), rtol=1e-5, atol=1e-5)


RES_CASES = [(33, 50, 3, 1000), (8, 16, 1, 100), (100, 205, 4, 488)]


@pytest.mark.parametrize("m,s,k,n", RES_CASES)
def test_residual_sample_plain_matches_reference_and_pallas(m, s, k, n):
    u = np.array(jax.random.uniform(jax.random.PRNGKey(7), (m, s, k)), np.float32)
    xs = np.array(jnp.sort(jax.random.exponential(jax.random.PRNGKey(8), (n,))), np.float32)
    mx, sm = residual_sample_plain(*_t(u, xs))
    for mx_r, sm_r in (jref.residual_sample_ref(*_j(u, xs)), jops.residual_sample(*_j(u, xs))):
        np.testing.assert_allclose(mx.numpy(), np.asarray(mx_r), rtol=1e-6)
        np.testing.assert_allclose(sm.numpy(), np.asarray(sm_r), rtol=1e-5)
    before = ops.residual_sample.launches
    got = ops.residual_sample(*_t(u, xs))
    assert torch.equal(got[0], mx) and torch.equal(got[1], sm)
    assert ops.residual_sample.launches == before


def test_residual_sample_is_min_of_replicas_distribution():
    """Draws follow F̄_Y = F̄_X^{r+1} (eq. 7): min of r+1 Exp(1) is Exp(r+1)."""
    n, m, s, r = 2000, 400, 100, 2
    rng = np.random.default_rng(1)
    xs = np.sort(rng.exponential(1.0, n)).astype(np.float32)
    u = rng.random((m, s, r + 1), dtype=np.float32)
    _, sm = residual_sample_plain(*_t(u, xs))
    assert float(sm.mean()) / s == pytest.approx(1 / 3, rel=0.05)


def test_build_commands_target_hopper_without_fast_math(tmp_path):
    compiles, link, lib = build.compile_commands("nvcc", tmp_path)
    assert len(compiles) == len(build.sources()) == 2  # one nvcc per source
    for cmd in (*compiles, link):
        assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
        assert not any("fast" in part for part in cmd)
    assert "-shared" in link and lib.parent == tmp_path


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails makes `load_library` raise; nothing loads."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "false")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        build.load_library()
    assert build._lib is None
