"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips where `torch.cuda.is_available()`
is false.  The file imports neither JAX nor the JAX package, so on a
machine with a card and no JAX it runs on its own:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: kw_queue slots exact and floats rtol = atol = 1e-5 (the kernel
does the plain version's IEEE operations, so it is expected to be exact;
the segment-parallel cases hold it bit-equal);
residual_sample max exact and sum rtol 1e-5 (another summation order);
flash_attention and ssd_scan at the JAX package's own kernel tolerances
(tests/test_kernels.py): flash 2e-5 in float32 and 2e-2 in bfloat16, ssd
1e-3 in float32 and atol 2e-1 / rtol 5e-2 in bfloat16 (both sides sum in
float32 in another order; bfloat16 outputs round once more).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Empirical, SingleForkPolicy
from repro_torch.fleet import vector
from repro_torch.kernels import kw_queue as kwk
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain, kernel_path
from repro_torch.kernels.kw_queue import kw_queue_plain
from repro_torch.kernels.residual_sampler import residual_sample_plain
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ssd_scan import ssd_scan_plain

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


def _kw_load_inputs(B, J, c, load, seed, ints=False):
    """Queues at offered `load` (λ·E[s] / Σ speeds); with `ints`, integer
    arrivals and services on unit speeds, so free times tie."""
    rng = np.random.default_rng(seed)
    if ints:
        speeds = np.ones(c, np.float32)
        svc = rng.integers(1, 4, (B, J)).astype(np.float32)  # mean 2
        gaps = rng.integers(0, 2 * int(round(2 / (load * c))) + 1, (B, J))
    else:
        speeds = np.sort(0.5 + 1.5 * rng.random(c))[::-1].astype(np.float32)
        svc = (0.5 + rng.exponential(1.0, (B, J))).astype(np.float32)
        gaps = rng.exponential(1.5 / (load * float(speeds.sum())), (B, J))
    arr = np.cumsum(gaps, axis=1).astype(np.float32)
    return arr, svc, speeds


def _kw_bit_equal(arr, svc, speeds, dev, path=None, seg=None):
    """kw_queue on the card bit-equal to kw_queue_plain: through the
    wrapper (one counted launch, on the path `kernel_path` names), or,
    with `path`, through that kernel path (`seg`: path tma's segment)."""
    args = tuple(torch.from_numpy(np.ascontiguousarray(z)).to(dev) for z in (arr, svc, speeds))
    if path is None:
        before, by_path = ops.kw_queue.launches, dict(ops.kw_queue.launches_by_path)
        got = ops.kw_queue(*args)
        torch.cuda.synchronize()
        assert ops.kw_queue.launches == before + 1
        taken = kwk.kernel_path(*arr.shape, len(speeds), aligned=True)
        assert ops.kw_queue.launches_by_path[taken] == by_path[taken] + 1
    else:
        got = kwk.launch(*args, path, seg=seg)
        torch.cuda.synchronize()
    for a, b in zip(got, kw_queue_plain(*args)):
        assert torch.equal(a, b)


# (B, J, c, load, ints, unsorted): the main path's shape; saturated at
# c = 4 and c = 1; one row out of FIFO order; integer times (ties); B = 1
# with J = 4096 (parallel over segments only); J below one segment
KW_FIXUP_CASES = [
    (512, 2048, 4, 0.7, False, False),
    (64, 2048, 4, 1.2, False, False),
    (64, 2048, 1, 1.2, False, False),
    (64, 1000, 4, 0.5, False, True),
    (64, 777, 3, 0.7, True, False),
    (1, 4096, 4, 0.7, False, False),
    (16, 100, 4, 0.7, False, False),
]


@pytest.mark.parametrize("B,J,c,load,ints,unsorted", KW_FIXUP_CASES)
def test_kw_queue_segment_parallel_kernel_is_bit_equal_on_card(B, J, c, load, ints, unsorted):
    dev = _card()
    arr, svc, speeds = _kw_load_inputs(B, J, c, load, seed=B + J + c, ints=ints)
    if unsorted:
        arr[3, 10:J:7] -= 3.0
    _kw_bit_equal(arr, svc, speeds, dev)


@pytest.mark.parametrize("seg", [1, 32, 64, 128, 256, 5000])
def test_kw_queue_kernel_any_segment_length_on_card(seg, monkeypatch):
    """Both paths at any segment length: two_launch at SEGMENT_JOBS = seg,
    tma at seg rounded down to a multiple of 4 (4 at least)."""
    dev = _card()
    monkeypatch.setattr(kwk, "SEGMENT_JOBS", seg)
    arr, svc, speeds = _kw_load_inputs(40, 1000, 4, 0.85, seed=seg)
    arr[5, 100:900:3] -= 2.0
    _kw_bit_equal(arr, svc, speeds, dev, path="two_launch")
    _kw_bit_equal(arr, svc, speeds, dev, path="tma", seg=max(4, seg - seg % 4))


# tests/test_torch_kernels.py's cases of the CPU twin of the algorithm
# (B, J, c, L, load, ints, unsorted), run here with SEGMENT_JOBS = L, and its
# searched cases (seed, load, speeds, unsorted row) at B = 4, J = 300, L = 8
KW_TWO_PASS_CASES = [
    (6, 300, 4, 64, 0.5, False, False), (6, 256, 3, 64, 0.85, False, False),
    (4, 200, 4, 32, 1.5, False, False), (5, 150, 3, 32, 0.7, True, False),
    (4, 40, 3, 64, 0.7, False, False), (1, 500, 1, 64, 0.5, False, False),
    (3, 120, 32, 32, 0.7, False, False), (5, 160, 4, 32, 0.5, False, True),
    (6, 400, 3, 16, 0.95, False, False), (4, 600, 2, 16, 0.9, False, True),
]
KW_TWO_PASS_HARD = [(1, 0.9, (2.0, 1.0, 1.0), None), (0, 0.8, (4.0, 2.0, 1.0), "every 7th"),
                    (0, 0.9, (4.0, 2.0, 1.0, 0.5), "one")]


@pytest.mark.parametrize("B,J,c,L,load,ints,unsorted", KW_TWO_PASS_CASES)
def test_kw_queue_kernel_on_the_cpu_twins_cases_on_card(B, J, c, L, load, ints, unsorted, monkeypatch):
    """The CPU twins' cases: path two_launch at SEGMENT_JOBS = L, path tma
    at segments of L (where J is a multiple of 4) and through the wrapper."""
    dev = _card()
    monkeypatch.setattr(kwk, "SEGMENT_JOBS", L)
    arr, svc, speeds = _kw_load_inputs(B, J, c, load, seed=B * J + c, ints=ints)
    if unsorted:
        arr[1, 10:J:7] -= 3.0
    _kw_bit_equal(arr, svc, speeds, dev, path="two_launch")
    if J % 4 == 0:
        _kw_bit_equal(arr, svc, speeds, dev, path="tma", seg=L)
    _kw_bit_equal(arr, svc, speeds, dev)


@pytest.mark.parametrize("seed,load,speeds,unsorted", KW_TWO_PASS_HARD)
def test_kw_queue_kernel_reruns_on_card(seed, load, speeds, unsorted, monkeypatch):
    dev = _card()
    monkeypatch.setattr(kwk, "SEGMENT_JOBS", 8)
    arr, svc, _ = _kw_load_inputs(4, 300, len(speeds), load, seed=seed)
    if unsorted == "every 7th":
        arr[1, 10:300:7] -= 3.0
    elif unsorted == "one":
        arr[1, 150] -= 30.0
    sp = np.array(speeds, np.float32)
    _kw_bit_equal(arr, svc, sp, dev, path="two_launch")
    _kw_bit_equal(arr, svc, sp, dev, path="tma", seg=8)
    _kw_bit_equal(arr, svc, sp, dev)


# path tma at the main paths' shape classes (B, J, c): frontier and DAG
# stages, the fleet gates' chaos lane and row 1, a re-plan, phase paper's
# c = 1 frontier; at loads below, near and above saturation
KW_TMA_CLASSES = [(512, 2048, 4), (512, 2048, 1), (144, 600, 2), (96, 384, 3), (232, 192, 3), (64, 300, 1)]


@pytest.mark.parametrize("load", [0.7, 0.85, 1.2])
@pytest.mark.parametrize("B,J,c", KW_TMA_CLASSES)
def test_kw_queue_tma_path_at_the_main_path_classes_is_bit_equal_on_card(B, J, c, load):
    dev = _card()
    assert kwk.kernel_path(B, J, c, aligned=True) == "tma"
    arr, svc, speeds = _kw_load_inputs(B, J, c, load, seed=B + J + c)
    _kw_bit_equal(arr, svc, speeds, dev)


# (B, J, c, load, seg, unsorted): a row longer than one block's segments at
# the plan's cut (L raised until K <= 256) and at a forced 12 (raised too);
# J <= 256; more rows than SMs (rows grouped in a block); c = 32; an
# unsorted row
KW_TMA_EDGES = [
    (2, 8192, 4, 0.85, None, False), (2, 4096, 3, 0.9, 12, False), (40, 100, 4, 0.7, None, False),
    (300, 192, 3, 0.9, None, False), (70, 300, 32, 0.7, None, False), (64, 1000, 4, 0.5, None, True),
    (8, 4, 2, 0.7, None, False),
]


@pytest.mark.parametrize("B,J,c,load,seg,unsorted", KW_TMA_EDGES)
def test_kw_queue_tma_path_edges_are_bit_equal_on_card(B, J, c, load, seg, unsorted):
    dev = _card()
    plan = kwk.tma_plan(B, J, c, seg=seg)
    assert plan is not None and plan.R * plan.K <= kwk.TMA_THREADS
    arr, svc, speeds = _kw_load_inputs(B, J, c, load, seed=B * J + c)
    if unsorted:
        arr[3, 10:J:7] -= 3.0
    _kw_bit_equal(arr, svc, speeds, dev, path="tma", seg=seg)
    _kw_bit_equal(arr, svc, speeds, dev)


def test_kw_queue_unaligned_rows_and_views_take_the_two_launch_path_on_card():
    dev = _card()
    # J not a multiple of 4: no TMA map has rows of that pitch
    arr, svc, speeds = _kw_load_inputs(16, 602, 2, 0.8, seed=5)
    assert kwk.kernel_path(16, 602, 2, aligned=True) == "two_launch"
    _kw_bit_equal(arr, svc, speeds, dev)
    # views 4 bytes off a 16-byte boundary
    arr, svc, speeds = _kw_load_inputs(16, 600, 2, 0.8, seed=6)
    a = torch.empty(16 * 600 + 1, device=dev)[1:].view(16, 600)
    s = torch.empty(16 * 600 + 1, device=dev)[1:].view(16, 600)
    a.copy_(torch.from_numpy(arr))
    s.copy_(torch.from_numpy(svc))
    sp = torch.from_numpy(speeds).to(dev)
    by_path = dict(ops.kw_queue.launches_by_path)
    got = ops.kw_queue(a, s, sp)
    assert ops.kw_queue.launches_by_path["two_launch"] == by_path["two_launch"] + 1
    for x, y in zip(got, kw_queue_plain(a, s, sp)):
        assert torch.equal(x, y)


def test_kw_queue_tma_stats_and_shared_memory_on_card():
    """The kernel's own stats: a saturated queue is walked after one round,
    a light one is settled by rounds; the wrapper's shared-memory count is
    the kernel's."""
    dev = _card()
    from repro_torch.kernels.build import load_library

    lib = load_library()
    for B, J, c in KW_TMA_CLASSES:
        p = kwk.tma_plan(B, J, c)
        assert lib.kw_queue_tma_smem_bytes(p.R, p.K, c, p.tile, p.tiles) == p.smem
    read = {}
    for load in (0.5, 1.2):
        arr, svc, speeds = _kw_load_inputs(64, 2048, 4, load, seed=11)
        args = tuple(torch.from_numpy(z).to(dev) for z in (arr, svc, speeds))
        plan = kwk.tma_plan(64, 2048, 4, kwk.n_sms(dev))
        stats = torch.zeros((plan.blocks, 8), dtype=torch.int64, device=dev)
        got = kwk.launch(*args, "tma", stats=stats)
        for a, b in zip(got, kw_queue_plain(*args)):
            assert torch.equal(a, b)
        st = stats.cpu()
        assert bool((st[:, 1] >= st[:, 0]).all() and (st[:, 4] >= st[:, 3]).all() and (st[:, 3] >= st[:, 2]).all())
        read[load] = st
    assert int(read[1.2][:, 7].min()) >= plan.K // 2  # every row walked
    assert int(read[0.5][:, 7].sum()) < int(read[1.2][:, 7].sum()) // 10


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


def _residual_check(u, xs):
    before = ops.residual_sample.launches
    mx, sm = ops.residual_sample(u, xs)
    torch.cuda.synchronize()
    assert ops.residual_sample.launches == before + 1
    mx_p, sm_p = residual_sample_plain(u, xs)
    assert torch.equal(mx, mx_p)
    torch.testing.assert_close(sm, sm_p, rtol=1e-5, atol=0.0)


# (m, s, k, n): the main path's shape; rows of 84 bytes (s·k·4 not a
# multiple of 16) with full chunks and ragged rows; m not a multiple of the
# chunk's rows; k = 1; a trace of 160 KB in shared memory
@pytest.mark.parametrize("m,s,k,n", [(32768, 103, 3, 1026), (1000, 7, 3, 100), (1001, 103, 3, 1026),
                                     (5000, 50, 1, 1000), (2048, 103, 3, 40000)])
def test_residual_sample_streamed_kernel_on_card(m, s, k, n):
    dev = _card()
    rng = np.random.default_rng(n + m)
    u = torch.from_numpy(rng.random((m, s, k), dtype=np.float32)).to(dev)
    xs = torch.from_numpy(np.sort(rng.exponential(1.0, n)).astype(np.float32)).to(dev)
    _residual_check(u, xs)


def test_residual_sample_reads_unaligned_uniforms_on_card():
    dev = _card()
    rng = np.random.default_rng(5)
    m, s, k = 777, 103, 3
    flat = torch.from_numpy(rng.random(m * s * k + 1, dtype=np.float32)).to(dev)
    u = flat[1:].view(m, s, k)
    assert u.data_ptr() % 16 != 0
    xs = torch.from_numpy(np.sort(rng.exponential(1.0, 1026)).astype(np.float32)).to(dev)
    _residual_check(u, xs)


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


# (B, S, H, D, causal, dtype): tests/test_kernels.py's FLASH_CASES, then the
# shape of one Zamba2-1.2B prefill of 1024 tokens, then head dim 16 (the
# reduced configs')
FLASH_CASES = [
    (2, 256, 4, 64, True, torch.float32),
    (1, 512, 2, 128, True, torch.float32),
    (2, 200, 4, 64, True, torch.float32),
    (1, 128, 8, 64, False, torch.float32),
    (2, 256, 4, 64, True, torch.bfloat16),
    (1, 384, 4, 256, True, torch.bfloat16),
    (1, 96, 2, 80, True, torch.float32),
    (1, 1024, 32, 64, True, torch.bfloat16),
    (1, 12, 4, 16, True, torch.bfloat16),
    (2, 100, 4, 16, False, torch.float32),
]


@pytest.mark.parametrize("B,S,H,D,causal,dtype", FLASH_CASES)
def test_flash_attention_kernel_matches_plain_on_card(B, S, H, D, causal, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S + D)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(dtype) for _ in range(3))
    _flash_check(q, k, v, causal, 2e-2 if dtype == torch.bfloat16 else 2e-5)


def test_flash_attention_kernel_refuses_head_dims_it_was_not_built_for():
    dev = _card()
    q = torch.randn((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, q, q)


# (Bt, S, H, P, G, N, chunk, dtype): tests/test_kernels.py's SSD_CASES, then
# the shape of one Zamba2-1.2B SSM layer's prefill of 1024 tokens
SSD_CASES = [
    (2, 256, 4, 32, 1, 16, 64, torch.float32),
    (1, 128, 8, 64, 1, 64, 128, torch.float32),
    (1, 100, 4, 16, 2, 8, 32, torch.float32),
    (2, 192, 4, 32, 4, 16, 64, torch.float32),
    (1, 256, 4, 64, 1, 128, 128, torch.bfloat16),
    (1, 1024, 64, 64, 1, 64, 128, torch.bfloat16),
]


def _ssd_inputs(Bt, S, H, P, G, N, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((Bt, S, H, P), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((Bt, S, H), generator=g, device=dev))
    A = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
    B = torch.randn((Bt, S, G, N), generator=g, device=dev).to(dtype)
    C = torch.randn((Bt, S, G, N), generator=g, device=dev).to(dtype)
    return x, dt, A, B, C, torch.ones((H,), device=dev)


@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk,dtype", SSD_CASES)
def test_ssd_scan_kernel_matches_plain_on_card(Bt, S, H, P, G, N, chunk, dtype):
    dev = _card()
    args = _ssd_inputs(Bt, S, H, P, G, N, dtype, dev)
    before = ops.ssd_scan.launches
    y, h = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32 and h.shape == (Bt, H, P, N)
    y_p, h_p = ssd_scan_plain(*args, chunk=chunk)
    atol, rtol = (2e-1, 5e-2) if dtype == torch.bfloat16 else (1e-3, 1e-3)
    torch.testing.assert_close(y.float(), y_p.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(h, h_p, rtol=rtol, atol=atol)


def test_ssd_scan_kernel_refuses_widths_it_does_not_take():
    dev = _card()
    args = _ssd_inputs(1, 16, 2, 256, 1, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="up to"):
        ops.ssd_scan(*args, chunk=16)


# (B, Sq, Sk, H, D, causal): shapes that only the bf16 tensor-core kernels'
# ragged, non-causal, D = 80 / 128 / 256 and Sq != Sk paths reach; then the
# Hopper kernel's edges: every head dim it takes at lengths that are not a
# multiple of its 64-row query tiles or its key tiles (128, 64 at D = 256),
# Sq != Sk both ways, and grids of many more items than the card's 132 SMs
# (each block then works through several: neighbouring tiles, an odd tile
# on its own, causal and not, D = 256's extra key tile that one
# warpgroup skips)
FLASH_BF16_CASES = [
    (2, 200, 200, 4, 64, True),
    (1, 256, 256, 4, 64, False),
    (1, 200, 200, 2, 80, True),
    (2, 320, 320, 2, 128, True),
    (1, 300, 300, 2, 256, False),
    (1, 96, 200, 4, 64, False),
    (1, 200, 96, 4, 64, True),
    (1, 64, 1000, 2, 128, True),
    (1, 333, 333, 2, 64, True),
    (2, 201, 201, 2, 80, True),
    (1, 333, 333, 2, 80, False),
    (2, 190, 190, 3, 128, True),
    (1, 250, 250, 2, 256, True),
    (1, 100, 300, 2, 128, True),
    (1, 300, 100, 2, 128, True),
    (1, 77, 333, 2, 256, False),
    (1, 333, 77, 2, 80, True),
    (4, 512, 512, 16, 64, True),
    (2, 1024, 1024, 24, 128, False),
    (4, 300, 300, 40, 64, True),
    (1, 300, 300, 4, 128, True),
    (2, 512, 512, 40, 256, True),
    (3, 300, 300, 60, 80, False),
]


def _flash_check(q, k, v, causal, tol, path=None):
    """One call against the plain version, counted once in all and once on
    its path (`kernel_path`'s, or `path` where given)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    path = path or kernel_path(q.shape[3], q.dtype, aligned)
    before = ops.flash_attention.launches
    by_path = dict(ops.flash_attention.launches_by_path)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert ops.flash_attention.launches_by_path == {**by_path, path: by_path[path] + 1}
    assert got.dtype == q.dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", FLASH_BF16_CASES)
def test_flash_attention_bf16_tensor_core_cases_on_card(B, Sq, Sk, H, D, causal):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + D)
    q = torch.randn((B, Sq, H, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, Sk, H, D), generator=g, device=dev).bfloat16() for _ in range(2))
    _flash_check(q, k, v, causal, 2e-2)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_bf16_reads_unaligned_inputs_on_card(D):
    """Contiguous views that start 2 bytes past a 16-byte boundary, which no
    TMA map can describe, take the mma.sync kernel's element-by-element
    copies instead of cp.async."""
    dev = _card()
    shape = (1, 130, 2, D)
    n = int(np.prod(shape))
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(n + 1, generator=g, device=dev).bfloat16()[1:].view(shape)
               for _ in range(3))
    assert q.data_ptr() % 16 != 0
    _flash_check(q, k, v, True, 2e-2, path="mma_sync")


def test_float32_inputs_keep_the_exact_paths_on_card():
    """float32 at the serve shapes goes through the CUDA-core kernels, at
    2e-5 (flash) and 1e-3 (ssd)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((1, 1024, 32, 64), generator=g, device=dev) for _ in range(3))
    _flash_check(q, k, v, True, 2e-5)
    args = _ssd_inputs(1, 1024, 64, 64, 1, 64, torch.float32, dev)
    _ssd_check(args, 128, 1e-3, 1e-3)


def _ssd_check(args, chunk, atol, rtol, path=None):
    """One call against the plain version, counted once in all (whatever
    the CUDA launches) and once on its path (`kernel_path`'s, or `path`
    where given)."""
    x, B, C = args[0], args[3], args[4]
    Bt, S, H, P = x.shape
    N = B.shape[3]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, B, C))
    path = path or ssd.kernel_path(P, N, -(-S // chunk), x.dtype, aligned, chunk)
    before = ops.ssd_scan.launches
    by_path = dict(ops.ssd_scan.launches_by_path)
    y, h = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert ops.ssd_scan.launches_by_path == {**by_path, path: by_path[path] + 1}
    assert y.dtype == x.dtype and h.dtype == torch.float32 and h.shape == (Bt, H, P, N)
    y_p, h_p = ssd_scan_plain(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), y_p.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(h, h_p, rtol=rtol, atol=atol)
    return y, h


# (Bt, S, H, P, G, N, chunk): the bf16 chunk-parallel kernels with G > 1
# and a ragged last chunk, chunk 64, N = 128, P = N = 128, one chunk,
# widths that are not multiples of 8 (element-by-element copies) or 16
# (zero-padded tiles)
SSD_BF16_CASES = [
    (1, 100, 4, 16, 2, 8, 32),
    (2, 192, 4, 32, 4, 16, 64),
    (1, 256, 4, 64, 1, 128, 128),
    (1, 300, 2, 128, 1, 128, 128),
    (1, 128, 8, 64, 1, 64, 128),
    (2, 90, 6, 20, 3, 12, 48),
    (1, 1000, 4, 64, 2, 64, 100),
]


@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", SSD_BF16_CASES)
def test_ssd_scan_bf16_chunk_parallel_cases_on_card(Bt, S, H, P, G, N, chunk):
    dev = _card()
    _ssd_check(_ssd_inputs(Bt, S, H, P, G, N, torch.bfloat16, dev, seed=S + P), chunk, 2e-1, 5e-2)


# (Bt, S, H, P, G, N): the Hopper kernel (chunk 128) at zamba2-1.2b's serve
# shape, mamba2-2.7b's geometry, a ragged last chunk, one chunk (whole and
# ragged), G = 2, Bt = 2, P = 128 with N = 64 and 128, and every cluster
# size from 1 to 8 chunks
SSD_WGMMA_CASES = [
    (1, 1024, 64, 64, 1, 64),
    (1, 1024, 80, 64, 1, 128),
    (1, 1000, 4, 64, 1, 64),
    (1, 128, 8, 64, 1, 64),
    (1, 100, 4, 64, 1, 128),
    (1, 512, 4, 64, 2, 64),
    (2, 512, 4, 64, 1, 64),
    (2, 700, 6, 64, 3, 128),
    (1, 384, 2, 128, 1, 64),
    (1, 300, 2, 128, 1, 128),
    (1, 256, 3, 64, 1, 64),
    (1, 640, 3, 64, 1, 64),
    (1, 768, 2, 64, 2, 128),
    (1, 896, 5, 64, 1, 64),
]


@pytest.mark.parametrize("Bt,S,H,P,G,N", SSD_WGMMA_CASES)
def test_ssd_scan_wgmma_tma_cases_on_card(Bt, S, H, P, G, N):
    """The Hopper kernel against the plain version, and the mma_sync kernel
    on the same inputs through `launch`."""
    dev = _card()
    args = _ssd_inputs(Bt, S, H, P, G, N, torch.bfloat16, dev, seed=S + P + N)
    assert ssd.kernel_path(P, N, -(-S // 128), torch.bfloat16, True) == "wgmma_tma"
    y, h = _ssd_check(args, 128, 2e-1, 5e-2, path="wgmma_tma")
    y_m, h_m = ssd.launch(*args, 128, "mma_sync")
    torch.cuda.synchronize()
    y_p, h_p = ssd_scan_plain(*args, chunk=128)
    torch.testing.assert_close(y_m.float(), y_p.float(), rtol=5e-2, atol=2e-1)
    torch.testing.assert_close(h_m, h_p, rtol=5e-2, atol=2e-1)
    # the two bf16 kernels round alike (hi + lo splits, float32 sums)
    torch.testing.assert_close(h, h_m, rtol=1e-3, atol=1e-3)


def test_ssd_scan_more_chunks_than_a_cluster_holds_on_card():
    """Ten chunks of 128: a cluster of 8 blocks walks them in two groups,
    the second with two chunks, on the Hopper kernel."""
    dev = _card()
    args = _ssd_inputs(1, 1280, 4, 64, 1, 64, torch.bfloat16, dev, seed=11)
    assert ssd.kernel_path(64, 64, 10, torch.bfloat16, True) == "wgmma_tma"
    _ssd_check(args, 128, 2e-1, 5e-2, path="wgmma_tma")


# (Bt, S, H, P, G, N): the Hopper kernel's group walk, a cluster of 8
# blocks over more chunks: 9 (whole and ragged), 16, 17 (ragged), 32 and
# 256 (S = 32768), Bt = 2, G < H, every (P, N), and mamba2-2.7b's serve
# shape at 4096 tokens
SSD_GROUP_CASES = [
    (1, 1152, 4, 64, 1, 64),
    (1, 1100, 2, 64, 1, 64),
    (2, 2048, 4, 64, 2, 128),
    (1, 2100, 3, 128, 1, 64),
    (2, 4096, 4, 128, 2, 128),
    (1, 32768, 2, 64, 1, 128),
    (1, 4096, 80, 64, 1, 128),
]


@pytest.mark.parametrize("Bt,S,H,P,G,N", SSD_GROUP_CASES)
def test_ssd_scan_hopper_kernel_walks_groups_of_chunks_on_card(Bt, S, H, P, G, N):
    dev = _card()
    args = _ssd_inputs(Bt, S, H, P, G, N, torch.bfloat16, dev, seed=S + P + N + Bt)
    assert ssd.kernel_path(P, N, -(-S // 128), torch.bfloat16, True) == "wgmma_tma"
    _ssd_check(args, 128, 2e-1, 5e-2, path="wgmma_tma")


def _ssd_carry_inputs(Bt, S, H, P, G, N, dev, seed=0):
    """bf16 inputs whose state outlives a chunk, as trained weights keep
    it: dt·A sums to about -1 over 128 steps, and dt is gated by e^N(0, 1)
    over spans of 64 steps, so most chunks decay by 0.1 to 0.8, each by its
    own amount (`_ssd_inputs`'s decay, about e^-100 a chunk, leaves only
    the last chunk's own state in h)."""
    x, dt, A, B, C, D = _ssd_inputs(Bt, S, H, P, G, N, torch.bfloat16, dev, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    gate = torch.randn((Bt, -(-S // 64), H), generator=g, device=dev).exp()
    return x, dt * gate.repeat_interleave(64, dim=1)[:, :S], A / 170.0, B, C, D


# (Bt, S, H, P, G, N): the Hopper kernel with state carried across chunks:
# one cluster of 8 (no walk), then the walk at 9, 17 (ragged), 32 and 256
# chunks, Bt = 2, G < H, every (P, N), and mamba2-2.7b's serve shape
SSD_CARRY_CASES = [
    (1, 1024, 4, 64, 1, 64),
    (1, 1152, 4, 64, 1, 64),
    (2, 2100, 4, 64, 2, 128),
    (1, 4096, 3, 128, 1, 64),
    (2, 4096, 4, 128, 2, 128),
    (1, 32768, 2, 64, 1, 128),
    (1, 4096, 80, 64, 1, 128),
]


@pytest.mark.parametrize("Bt,S,H,P,G,N", SSD_CARRY_CASES)
def test_ssd_scan_hopper_kernel_carries_state_across_chunks_on_card(Bt, S, H, P, G, N):
    """y and h_final against the plain version where the state entering
    a chunk matters: h_final differs from the last chunk's own state by
    more than the tolerance, so a kernel that dropped the carried history,
    or decayed it by another chunk's decay, would fail."""
    dev = _card()
    args = _ssd_carry_inputs(Bt, S, H, P, G, N, dev, seed=S + P + N + Bt)
    assert ssd.kernel_path(P, N, -(-S // 128), torch.bfloat16, True) == "wgmma_tma"
    _, h_p = ssd_scan_plain(*args, chunk=128)
    start = (-(-S // 128) - 1) * 128
    _, h_last = ssd_scan_plain(*(t[:, start:] if t.dim() > 1 else t for t in args), chunk=128)
    assert not torch.allclose(h_p, h_last, rtol=5e-2, atol=2e-1)
    _ssd_check(args, 128, 2e-1, 5e-2, path="wgmma_tma")


def test_ssd_scan_hopper_kernel_holds_clusters_of_eight_on_card():
    """At least one cluster fits at every chunk count; past 8 chunks the
    clusters stay of 8 blocks."""
    dev = _card()
    for P, N in ((64, 64), (64, 128), (128, 64), (128, 128)):
        eight = ssd.hopper_clusters(P, N, 8, dev)
        assert eight >= 1
        for nc in (9, 17, 32, 256):
            assert ssd.hopper_clusters(P, N, nc, dev) == eight


def test_ssd_scan_bf16_unaligned_serve_shape_takes_mma_sync_on_card():
    """A view 2 bytes past a 16-byte boundary at a shape the Hopper kernel
    takes otherwise: no TMA map describes it, so the mma_sync kernel."""
    dev = _card()
    x, dt, A, B, C, D = _ssd_inputs(1, 512, 4, 64, 1, 64, torch.bfloat16, dev, seed=7)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    flat[1:] = x.reshape(-1)
    x = flat[1:].view(x.shape)
    assert x.data_ptr() % 16 != 0
    _ssd_check((x, dt, A, B, C, D), 128, 2e-1, 5e-2, path="mma_sync")


def test_ssd_scan_bf16_reads_unaligned_inputs_on_card():
    dev = _card()
    x, dt, A, B, C, D = _ssd_inputs(1, 200, 4, 64, 1, 64, torch.bfloat16, dev)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    x, B, C = shifted(x), shifted(B), shifted(C)
    assert x.data_ptr() % 16 != 0
    _ssd_check((x, dt, A, B, C, D), 64, 2e-1, 5e-2)


# ------------------------------------------------------- the DAG path
def _stage_inputs(cells, m, J, seed=3):
    """Shared (cells, m, J) arrivals and two stages' gang makespans."""
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0, (m, J)), axis=1)[None] / np.array([0.3, 0.6, 0.9])[:cells, None, None]
    T0 = 0.5 + rng.exponential(1.0, (cells, m, J))
    T1 = 0.3 + rng.exponential(0.8, (cells, m, J))
    return tuple(torch.from_numpy(np.ascontiguousarray(z, dtype=np.float32)) for z in (arr, T0, T1))


def _two_stage_paths(dev, arr, T0, T1):
    from repro_torch.dag.rollout import stage_queue

    arr, T0, T1 = (z.to(dev) for z in (arr, T0, T1))
    st0, fi0, sl0 = stage_queue(arr, T0, 3, in_order=True)
    st1, fi1, sl1 = stage_queue(fi0, T1, 2)
    return (st0, fi0, st1, fi1), (sl0, sl1)


def test_dag_stage_composition_on_card_matches_the_cpu():
    """The DAG's stage step (stable sort by barrier release → batched_queue
    → scatter back) on the card (the CUDA kw_queue) and on the CPU
    (kw_queue_plain), with the same releases and makespans."""
    dev = _card()
    arr, T0, T1 = _stage_inputs(3, 8, 700)
    before = ops.kw_queue.launches
    card_f, card_s = _two_stage_paths(dev, arr, T0, T1)
    torch.cuda.synchronize()
    assert ops.kw_queue.launches == before + 2
    cpu_f, cpu_s = _two_stage_paths(torch.device("cpu"), arr, T0, T1)
    for a, b in zip(card_s, cpu_s):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(card_f, cpu_f):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    # the reduce stage's releases really were out of job order
    assert bool((cpu_f[1].diff(dim=-1) < 0).any())


def test_dag_critical_attribution_on_card_matches_the_cpu():
    """`_critical_attribution` of a fan-in DAG on the same arrays: shares
    telescope to the sojourn on both sides."""
    from repro_torch.dag.rollout import _critical_attribution

    dev = _card()
    rng = np.random.default_rng(5)
    arr = np.cumsum(rng.exponential(1.0, (2, 4, 300)), axis=-1)
    f1 = arr + rng.exponential(1.0, arr.shape)
    f2 = arr + rng.exponential(1.0, arr.shape)
    f2[..., ::7] = f1[..., ::7]  # ties: the first predecessor wins
    r3 = np.maximum(f1, f2)
    f3 = r3 + rng.exponential(0.5, arr.shape)
    arrays = [torch.from_numpy(z.astype(np.float32)) for z in (arr, f1, f2, r3, f3)]
    plan = ((4, 2, (), None), (4, 2, (), None), (2, 2, (0, 1), None))

    def attr(d):
        a, f1, f2, r3, f3 = (z.to(d) for z in arrays)
        return _critical_attribution(a, [a, a, r3], [f1, f2, f3], plan, (2,))

    soj_g, attrs_g = attr(dev)
    soj_c, attrs_c = attr("cpu")
    torch.testing.assert_close(soj_g.cpu(), soj_c, rtol=1e-6, atol=0.0)
    for g, c in zip(attrs_g, attrs_c):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(sum(attrs_c), soj_c, rtol=1e-5, atol=1e-5)


def test_device_histogram_on_card_matches_the_cpu():
    """`cell_histograms` on the card against the CPU: counts equal but for
    values within an ulp of a bin edge (at most 0.1% of them move to a
    neighbouring bin); min, max and sum within rtol 1e-6."""
    from repro_torch.obs.device import DEFAULT_HIST, cell_histograms

    dev = _card()
    rng = np.random.default_rng(9)
    x = torch.from_numpy(np.exp(rng.normal(0.5, 1.5, (6, 4096))).astype(np.float32))
    cg, ag = cell_histograms(x.to(dev), DEFAULT_HIST)
    cc, ac = cell_histograms(x, DEFAULT_HIST)
    assert float(cg.sum()) == x.numel()
    moved = float((cg.cpu() - cc).abs().sum()) / 2
    assert moved <= 1e-3 * x.numel()
    torch.testing.assert_close(ag.cpu(), ac, rtol=1e-6, atol=0.0)


def test_sections_hold_their_kernels_in_a_profiler_trace_on_card(monkeypatch):
    """One frontier call on the card under torch.profiler, recorder on: each
    section is a range of its name in the profiler's trace, the card's
    kernels were launched inside the evaluator's and the queue's ranges, and
    a chunk's or the draws' launches lie inside the evaluator's."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    dev = _card()
    x = np.random.default_rng(0).exponential(1.0, 500) + 1.0
    pols = [SingleForkPolicy(0.1, 1, True), SingleForkPolicy(0.2, 1, False)]

    monkeypatch.setattr(vector, "cell_chunk_size", lambda *a, **k: 1)  # 4 cells, 2 laws: 2 chunks

    def call():
        return vector.frontier(x, pols, (0.1, 0.2), 40, 256, m_trials=4, c=2, device=dev)

    call()
    rec = obs.enable(obs.Recorder())
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
    finally:
        obs.disable()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    names = {s.name for s in rec.spans}
    ranges = {n: [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "cpu_op" and e.get("name") == n] for n in names}
    assert all(len(ranges[n]) == len(rec.spans_named(n)) for n in names)
    kernels = {e["args"]["correlation"] for e in events if e.get("cat") == "kernel"}
    launches = [e["ts"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in kernels]

    def inside(name):
        return [t for t in launches if any(a <= t <= b for a, b in ranges[name])]

    assert len(ranges["evaluator.chunk"]) == 2
    for name in ("evaluator", "evaluator.draws", "evaluator.chunk", "queue", "stats"):
        assert inside(name), name
    assert set(inside("evaluator.draws")) | set(inside("evaluator.chunk")) <= set(inside("evaluator"))
    assert set(inside("queue")) <= set(inside("stats"))


# the controller's re-plan queues: policy_search at search_jobs = 192 (one
# launch, J <= SEGMENT_JOBS), 29 candidates x 8 trials = 232 rows, c = 3
# (REGIME_SHIFT's 48 slots / 16 tasks) and c = 4 (32 replicas / 8 requests)
@pytest.mark.parametrize("c,load", [(3, 0.5), (3, 0.95), (4, 0.7), (4, 1.2)])
def test_kw_queue_at_the_replan_shapes_is_bit_equal_on_card(c, load):
    dev = _card()
    arr, svc, _ = _kw_load_inputs(232, 192, c, load, seed=c * 10 + int(load * 10))
    _kw_bit_equal(arr, svc, np.ones(c, np.float32), dev)


def test_adaptive_controller_replans_on_card_within_5_sigma_of_the_cpu(monkeypatch):
    """`FleetSim(REGIME_SHIFT, adapt=True)` with the controller on the card:
    it re-plans through kw_queue, and its first re-plan's rows agree with
    the same `policy_search` call on the CPU within 5 combined standard
    errors (another random stream)."""
    from repro_torch.fleet import REGIME_SHIFT, FleetConfig, FleetSim

    dev = _card()
    sc = REGIME_SHIFT
    searches = []
    inner = vector.policy_search

    def recorded(*args, **kwargs):
        rows = inner(*args, **kwargs)
        searches.append((args, kwargs, rows))
        return rows

    monkeypatch.setattr(vector, "policy_search", recorded)
    before = ops.kw_queue.launches
    rep = FleetSim(FleetConfig(capacity=sc.capacity, adapt=True, seed=sc.seed, device=dev)).run(sc.workload(200))
    assert rep.controller.device.type == "cuda"
    assert len(rep.controller.history) >= 1 and len(searches) == len(rep.controller.history)
    assert ops.kw_queue.launches - before == len(searches)
    args, kwargs, rows = searches[0]
    cpu = inner(*args, **{**kwargs, "device": "cpu"})
    assert [r["label"] for r in cpu] == [r["label"] for r in rows]
    for a, b in zip(rows, cpu):
        sigma = np.hypot(a["sojourn_std_err"], b["sojourn_std_err"])
        assert abs(a["mean_sojourn"] - b["mean_sojourn"]) / sigma < 5.0
