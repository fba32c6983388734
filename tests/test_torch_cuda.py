"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips where `torch.cuda.is_available()`
is false.  The file imports neither JAX nor the JAX package, so on a
machine with a card and no JAX it runs on its own:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: kw_queue slots exact and floats rtol = atol = 1e-5 (the kernel
does the plain version's IEEE operations, so it is expected to be exact);
residual_sample max exact and sum rtol 1e-5 (another summation order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Empirical, SingleForkPolicy
from repro_torch.fleet import vector
from repro_torch.kernels import ops
from repro_torch.kernels.kw_queue import kw_queue_plain
from repro_torch.kernels.residual_sampler import residual_sample_plain

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _kw_inputs(B, J, c, seed=0):
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(2.0, (B, J)), axis=1).astype(np.float32)
    svc = (0.5 + rng.exponential(1.0, (B, J))).astype(np.float32)
    speeds = np.sort(0.5 + rng.random(c))[::-1].astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(z)) for z in (arr, svc, speeds))


@pytest.mark.parametrize("B,J,c", [(4, 37, 1), (8, 64, 3), (13, 48, 4), (1, 200, 2), (70, 300, 32)])
def test_kw_queue_kernel_matches_plain_on_card(B, J, c):
    dev = _card()
    args = tuple(t.to(dev) for t in _kw_inputs(B, J, c))
    before = ops.kw_queue.launches
    got = ops.kw_queue(*args)
    torch.cuda.synchronize()
    assert ops.kw_queue.launches == before + 1
    want = kw_queue_plain(*args)
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_kw_queue_kernel_refuses_more_slots_than_it_holds():
    dev = _card()
    a, s, _ = _kw_inputs(2, 8, 1)
    with pytest.raises(ValueError, match="at most"):
        ops.kw_queue(a.to(dev), s.to(dev), torch.ones(33, device=dev))


@pytest.mark.parametrize("m,s,k,n", [(33, 50, 3, 1000), (8, 16, 1, 100), (100, 205, 4, 488)])
def test_residual_sample_kernel_matches_plain_on_card(m, s, k, n):
    dev = _card()
    rng = np.random.default_rng(m)
    u = torch.from_numpy(rng.random((m, s, k), dtype=np.float32)).to(dev)
    xs = torch.from_numpy(np.sort(rng.exponential(1.0, n)).astype(np.float32)).to(dev)
    before = ops.residual_sample.launches
    mx, sm = ops.residual_sample(u, xs)
    torch.cuda.synchronize()
    assert ops.residual_sample.launches == before + 1
    mx_p, sm_p = residual_sample_plain(u, xs)
    assert torch.equal(mx, mx_p)
    torch.testing.assert_close(sm, sm_p, rtol=1e-5, atol=0.0)


def test_frontier_on_card_agrees_with_the_cpu_path():
    """The same seed drives different generators on the two devices, so the
    two runs agree within Monte-Carlo error, not bit for bit."""
    dev = _card()
    x = np.random.default_rng(0).exponential(1.0, 400) + 1.0
    pols = [SingleForkPolicy(0.0, 0), SingleForkPolicy(0.1, 1), SingleForkPolicy(0.2, 1, False)]
    rows = {d: vector.frontier(Empirical(x), pols, (0.3,), 8, 200, m_trials=24, c=3, seed=1, device=d)
            for d in ("cpu", dev)}
    for a, b in zip(rows["cpu"], rows[dev]):
        sigma = np.hypot(a["sojourn_std_err"], b["sojourn_std_err"])
        assert abs(a["mean_sojourn"] - b["mean_sojourn"]) / sigma < 5.0
    res = vector.trace_kill_rollout(x, pols[2], 0.3, 8, 200, 24, c=3, device=dev)
    assert np.isfinite(res.mean_sojourn)
