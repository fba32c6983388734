"""The port's kernels (`repro_torch.kernels`) against the JAX reference.

On the CPU the wrappers take their plain PyTorch versions, which are held
to the reference's oracles (`repro.kernels.ref`) and to the Pallas kernels
in interpret mode, on the cases of tests/test_kernels.py: kw_queue slots
exactly and floats to 1e-5; residual_sample max to 1e-6 and sum to 1e-5;
flash_attention at that file's tolerances (2e-5 in float32, 2e-2 in
bfloat16); ssd_scan at its tolerances (1e-3 in float32; atol 2e-1, rtol
5e-2 in bfloat16, where the reference's chunked path rounds its
intermediates to bfloat16 and the kernels do not).
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
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.fleet.vector import lindley
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import PATHS, flash_attention_plain, kernel_path
from repro_torch.kernels import kw_queue as kwk
from repro_torch.kernels.kw_queue import kw_queue_plain
from repro_torch.kernels.residual_sampler import residual_sample_plain
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ssd_scan import ssd_scan_plain

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


def _kw_step(free, a, s, speeds):
    """One job of every queue, as csrc/kw_queue.cu takes it: the lowest idle
    slot, else the lowest earliest-freeing one, then s / its speed."""
    B, c = free.shape
    lane = torch.arange(c).expand(B, c)
    first_idle = torch.where(free <= a[:, None], lane, c).amin(1)
    soonest = torch.where(free == free.amin(1, keepdim=True), lane, c).amin(1)
    slot = torch.where(first_idle < c, first_idle, soonest)[:, None]
    svc = s / speeds[slot[:, 0]]
    start = torch.maximum(a, free.gather(1, slot)[:, 0])
    fin = start + svc
    return free.scatter(1, slot, fin[:, None]), (start, fin, svc, slot[:, 0].int())


def _kw_agree(x, y, a, equiv):
    """The kernel's agreement test: where `equiv`, a slot idle at `a` in
    both states counts as equal; otherwise the raw bits must agree."""
    def bits(z):
        return torch.where(equiv[:, None] & (z <= a[:, None]), a[:, None], z).view(torch.int32)
    return (bits(x) == bits(y)).all(1)


def _kw_run(arr, svc, speeds, j0, j1, tru, outs, agree_with=None):
    """Row i of a batch runs jobs j0[i] .. j1[i] - 1 from tru[i], writing
    its outputs into `outs`.  With `agree_with` (a (n,) mask of rows whose
    arrivals never decrease from this segment to their end), csrc/
    kw_queue.cu's `rerun`: beside it a run from all slots idle, and it stops
    after the four jobs (counted from j0) in which the two first agree.
    Returns (stop: the job where they agreed, else j1; the second run's
    state there; the first's state after its last job; the end of the jobs
    written)."""
    n, c = tru.shape
    rows = torch.arange(n)
    spec = torch.full((n, c), -torch.inf)
    spec_at = spec.clone()
    stop = j1.clone()
    wrote = j0.clone()
    agreed = torch.zeros(n, dtype=torch.bool)
    going = j0 < j1
    for t in range(int((j1 - j0).max()) if n else 0):
        j = torch.minimum(j0 + t, j1 - 1)
        going &= j0 + t < j1
        a, s = arr[rows, j], svc[rows, j]
        if agree_with is not None:
            first = going & ~agreed & _kw_agree(tru, spec, a, agree_with)
            stop[first], spec_at[first] = j[first], spec[first]
            agreed |= first
            spec, _ = _kw_step(spec, a, s, speeds)
        stepped, o = _kw_step(tru, a, s, speeds)
        tru = torch.where(going[:, None], stepped, tru)
        for out, v in zip(outs, o):
            out[rows[going], j[going]] = v[going]
        wrote = torch.where(going, j + 1, wrote)
        if t % 4 == 3:
            going &= ~agreed
    return stop, spec_at, tru, wrote


def _kw_walk(arr, svc, speeds, j0, j1, check, ref, equiv, tru, outs):
    """csrc/kw_queue.cu's `walk` for a batch: row i steps tru[i] over jobs
    j0[i] .. j1[i] - 1, writing its outputs, four jobs at a time; before job
    check[i] it compares the state with ref[i] and, if they agree, finishes
    those four jobs and stops.  Returns (stop: check[i] where they agreed,
    else j1[i]; the state after the last job run)."""
    n, _ = tru.shape
    rows = torch.arange(n)
    stop = j1.clone()
    going = j0 < j1
    hit = torch.zeros(n, dtype=torch.bool)
    for t in range(int((j1 - j0).max()) if n else 0):
        j = torch.minimum(j0 + t, j1 - 1)
        going &= j0 + t < j1
        a, s = arr[rows, j], svc[rows, j]
        hit |= going & (j == check) & _kw_agree(tru, ref, a, equiv)
        stepped, o = _kw_step(tru, a, s, speeds)
        tru = torch.where(going[:, None], stepped, tru)
        for out, v in zip(outs, o):
            out[rows[going], j[going]] = v[going]
        done = going & hit & ((t % 4 == 3) | (j0 + t + 1 == j1))
        stop[done] = check[done]
        going &= ~done
    return stop, tru


def _kw_two_pass(arr, svc, speeds, L, warp=32):
    """csrc/kw_queue.cu's algorithm on the CPU, step for step.  Kernel 1:
    every segment of L jobs speculated from all slots idle (segment 0 from
    zeros), then re-run from its predecessor's speculative end state where
    that predecessor is in the same warp of `warp` (queue, segment) lanes.
    Kernel 2: per queue, in order, the segments whose predecessor's true
    end state differed from its speculation are walked from the true state.
    Returns the outputs, kernel 1's fix-up records (B, K) (-1: none ran;
    else 2·(the job where its runs agreed, from the segment's start) +
    agreed) and the per-segment sorted flags (B, K)."""
    B, J = arr.shape
    c = speeds.shape[0]
    K = -(-J // L)
    outs = (torch.empty_like(arr), torch.empty_like(arr), torch.empty_like(arr),
            torch.empty((B, J), dtype=torch.int32))
    q = torch.arange(B).repeat_interleave(K)
    k = torch.arange(K).repeat(B)
    j0 = k * L
    j1 = torch.clamp(j0 + L, max=J)
    a_pad = torch.cat([torch.full((B, 1), -torch.inf), arr], 1)
    # per segment, the arrivals never decrease, counting the step from the job before
    rises = a_pad[:, 1:] >= a_pad[:, :-1]
    flags = torch.stack([rises[:, kk * L:min(J, kk * L + L)].all(1) for kk in range(K)], 1)
    pair_arr, pair_svc = arr[q], svc[q]

    # kernel 1 a: the speculative runs
    start = torch.where(k[:, None] == 0, 0.0, -torch.inf).expand(B * K, c).clone()
    spec_outs = tuple(torch.empty((B * K, J), dtype=o.dtype) for o in outs)
    _, _, ends, _ = _kw_run(pair_arr, pair_svc, speeds, j0, j1, start, spec_outs)
    # kernel 1 b: the fix-up from the predecessor's speculation, in-warp
    lane = torch.arange(B * K) % warp
    runs = (k > 0) & (lane > 0)
    last = lane + (K - 1 - k)
    rest_sorted = torch.stack([flags[q[i], k[i]:].all() for i in range(B * K)])
    equiv = (last < warp) & rest_sorted
    fixed = tuple(o[runs] for o in spec_outs)
    stop, spec_at, end_state, wrote = _kw_run(
        pair_arr[runs], pair_svc[runs], speeds, j0[runs], j1[runs], torch.roll(ends, 1, 0)[runs],
        fixed, agree_with=equiv[runs])
    agreed = stop < j1[runs]
    info = torch.full((B * K,), -1)
    info[runs] = 2 * (stop - j0[runs]) + agreed.long()
    held = torch.zeros_like(ends)
    held[runs] = torch.where(agreed[:, None], spec_at, end_state)
    for o, so, fo in zip(outs, spec_outs, fixed):
        for i in range(B * K):
            o[q[i], j0[i]:j1[i]] = so[i, j0[i]:j1[i]]
        for i, p in enumerate(torch.nonzero(runs)[:, 0].tolist()):
            o[q[p], j0[p]:wrote[i]] = fo[i, j0[p]:wrote[i]]
    info, ends, held = info.view(B, K), ends.view(B, K, c), held.view(B, K, c)

    # kernel 2: per queue, in order; `known` says what the true end state of
    # the segment before is: 0 equivalent to its E, 1 its `held` record, 2
    # in `true` after a walk
    last_unsorted = torch.tensor([max([kk for kk in range(K) if not flags[b, kk]], default=-1)
                                  for b in range(B)])
    true = ends[:, 0]
    known = torch.zeros(B, dtype=torch.long)
    for kk in range(1, K):
        inf = info[:, kk]
        agreed = (inf & 1).bool()
        stands = (inf >= 0) & (known == 0)
        new_known = torch.where(agreed, 0, 1)
        r = torch.nonzero(~stands)[:, 0]
        if len(r):
            a0 = torch.full((len(r),), kk * L)
            a1 = torch.full((len(r),), min(J, kk * L + L))
            start = torch.where((known[r] == 0)[:, None], ends[r, kk - 1],
                                torch.where((known[r] == 1)[:, None], held[r, kk - 1], true[r]))
            check = torch.where((inf[r] >= 0) & agreed[r], a0 + (inf[r] >> 1), -1)
            sub = tuple(o[r] for o in outs)
            st, tr = _kw_walk(arr[r], svc[r], speeds, a0, a1, check, held[r, kk],
                              kk > last_unsorted[r], start, sub)
            for o, so in zip(outs, sub):
                o[r] = so
            true[r] = tr
            nk = torch.where(st < a1, 0, 2)
            if kk + 1 < K:
                at_end = _kw_agree(tr, ends[r, kk], arr[r, a1[0]], kk + 1 > last_unsorted[r])
                nk = torch.where((st == a1) & at_end, 0, nk)
            new_known[r] = nk
        known = new_known
    return outs, info, flags


def _kw_load_inputs(B, J, c, load, seed, ints=False):
    """Arrivals and services at offered `load` (λ·E[s] / Σ speeds); with
    `ints`, integer arrivals and services on unit speeds, so free times
    tie."""
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


# (B, J, c, L, load, ints, unsorted row): low, heavy and saturated loads;
# ties; J < L; J not a multiple of L; c = 1, 2, 3, 4, 32; B = 1; more than
# 32 segments a queue (segments whose predecessor is in another warp); an
# unsorted row that the second kernel re-runs
KW_TWO_PASS_CASES = [
    (6, 300, 4, 64, 0.5, False, False),
    (6, 256, 3, 64, 0.85, False, False),
    (4, 200, 4, 32, 1.5, False, False),
    (5, 150, 3, 32, 0.7, True, False),
    (4, 40, 3, 64, 0.7, False, False),
    (1, 500, 1, 64, 0.5, False, False),
    (3, 120, 32, 32, 0.7, False, False),
    (5, 160, 4, 32, 0.5, False, True),
    (6, 400, 3, 16, 0.95, False, False),
    (4, 600, 2, 16, 0.9, False, True),
]


def _check_two_pass(arr, svc, speeds, L):
    want = kw_queue_plain(*_t(arr, svc, speeds))
    _assert_kw_equal(want, jref.kw_queue_ref(*_j(arr, svc, speeds)))
    outs, info, flags = _kw_two_pass(*_t(arr, svc, speeds), L)
    for got, w in zip(outs, want):
        assert torch.equal(got, w)
    return info, flags


@pytest.mark.parametrize("B,J,c,L,load,ints,unsorted", KW_TWO_PASS_CASES)
def test_kw_queue_two_pass_fixup_is_bit_equal(B, J, c, L, load, ints, unsorted):
    arr, svc, speeds = _kw_load_inputs(B, J, c, load, seed=B * J + c, ints=ints)
    if unsorted:  # one row out of FIFO order: only raw-state coupling is sound
        arr[1, 10:J:7] -= 3.0
    info, flags = _check_two_pass(arr, svc, speeds, L)
    assert bool(flags.all()) is not unsorted
    if load <= 0.7 and J > L and c <= 4:
        # the early stop is covered: fix-ups agreed, most of them early
        # (with 32 slots the states rarely agree within a segment)
        ran = info[info >= 0]
        agreed = ran[(ran & 1) == 1]
        assert agreed.numel() >= ran.numel() // 2 > 0
        assert float((agreed >> 1).float().mean()) < L / 2


# (seed, load, speeds, unsorted row), B = 4, J = 300, L = 8 (38 segments a
# queue, across two warps): heavy loads with short segments, where the
# second kernel re-runs many segments; the unsorted rows were found by a
# search for inputs where treating idle slots of an unsorted row as equal,
# in the second kernel's walk or end test or in the first kernel's fix-up,
# gives wrong outputs
KW_TWO_PASS_HARD = [(1, 0.9, (2.0, 1.0, 1.0), None), (0, 0.8, (4.0, 2.0, 1.0), "every 7th"),
                    (0, 0.9, (4.0, 2.0, 1.0, 0.5), "one")]


@pytest.mark.parametrize("seed,load,speeds,unsorted", KW_TWO_PASS_HARD)
def test_kw_queue_two_pass_reruns_are_bit_equal(seed, load, speeds, unsorted):
    arr, svc, _ = _kw_load_inputs(4, 300, len(speeds), load, seed=seed)
    if unsorted == "every 7th":
        arr[1, 10:300:7] -= 3.0
    elif unsorted == "one":
        arr[1, 150] -= 30.0
    _check_two_pass(arr, svc, np.array(speeds, np.float32), 8)


def _kw_rerun_rows(arr, svc, speeds, q, j0, j1, nw, old, equiv, outs):
    """csrc/kw_queue.cu's `tma_rerun` for a batch of segments: segment i
    (row q[i], jobs j0[i] .. j1[i] - 1) re-runs from nw[i] beside the run
    whose outputs are in `outs`, its state rebuilt from old[i] and those
    outputs' slots and finishes, four jobs at a time, writing the new
    outputs; before each four the states are tested at the first one's
    arrival, and a segment that agrees stops after those four.  Returns
    (agreed, the new runs' end states)."""
    n, c = nw.shape
    nw, old = nw.clone(), old.clone()
    agreed = torch.zeros(n, dtype=torch.bool)
    going = j0 < j1
    hit = torch.zeros(n, dtype=torch.bool)
    for t in range(int((j1 - j0).max()) if n else 0):
        j = torch.minimum(j0 + t, j1 - 1)
        going &= j0 + t < j1
        a, s = arr[q, j], svc[q, j]
        if t % 4 == 0:
            hit = going & _kw_agree(nw, old, a, equiv)
        old_slot, old_fin = outs[3][q, j].long(), outs[1][q, j]
        stepped, o = _kw_step(nw, a, s, speeds)
        nw = torch.where(going[:, None], stepped, nw)
        for out, v in zip(outs, o):
            out[q[going], j[going]] = v[going]
        rebuilt = old.scatter(1, old_slot[:, None], old_fin[:, None])
        old = torch.where(going[:, None], rebuilt, old)
        done = going & hit & ((t % 4 == 3) | (j0 + t + 1 == j1))
        agreed |= done
        going &= ~done
    return agreed, nw


def _kw_walk_rows(arr, svc, speeds, q, j0, j1, tr, outs):
    """csrc/kw_queue.cu's `tma_walk` for a batch: segment i (row q[i], jobs
    j0[i] .. j1[i] - 1) stepped from tr[i], writing its outputs into
    `outs`; returns the end states."""
    for t in range(int((j1 - j0).max())):
        j = torch.minimum(j0 + t, j1 - 1)
        going = j0 + t < j1
        stepped, o = _kw_step(tr, arr[q, j], svc[q, j], speeds)
        tr = torch.where(going[:, None], stepped, tr)
        for out, v in zip(outs, o):
            out[q[going], j[going]] = v[going]
    return tr


def _kw_one_launch(arr, svc, speeds, L, R, max_rounds=8):
    """csrc/kw_queue.cu's path "tma" (`kw_tma_kernel`) on the CPU, step for
    step: segments of L jobs speculated from all slots idle (segment 0 from
    zeros); then rounds, in every block of R rows at once, in which each
    segment whose predecessor's end state changed re-runs from it, while a
    block's round settles (re-runs without a change to pass on) at least
    two segments a row, at most `max_rounds`; then, in a block where
    rounds stopped paying, one walker a row steps in order every segment
    whose predecessor changed, testing its end state against the recorded
    one at the next arrival.  Returns the outputs and, per block, (rounds, re-runs in rounds, walked
    segments)."""
    B, J = arr.shape
    c = speeds.shape[0]
    K = -(-J // L)
    outs = (torch.empty_like(arr), torch.empty_like(arr), torch.empty_like(arr),
            torch.empty((B, J), dtype=torch.int32))
    q = torch.arange(B).repeat_interleave(K)
    k = torch.arange(K).repeat(B)
    block = q // R
    n_blocks = -(-B // R)
    j0 = k * L
    j1 = torch.clamp(j0 + L, max=J)
    a_pad = torch.cat([torch.full((B, 1), -torch.inf), arr], 1)
    rises = a_pad[:, 1:] >= a_pad[:, :-1]
    flags = torch.stack([rises[:, kk * L:min(J, kk * L + L)].all(1) for kk in range(K)], 1)
    last_unsorted = torch.tensor([max([kk for kk in range(K) if not flags[b, kk]], default=-1)
                                  for b in range(B)])
    equiv = k > last_unsorted[q]

    # a. the speculative runs
    init = torch.where(k[:, None] == 0, 0.0, -torch.inf).expand(B * K, c).clone()
    spec = tuple(torch.empty((B * K, J), dtype=o.dtype) for o in outs)
    _, _, end, _ = _kw_run(arr[q], svc[q], speeds, j0, j1, init, spec)
    for o, so in zip(outs, spec):
        for i in range(B * K):
            o[q[i], j0[i]:j1[i]] = so[i, j0[i]:j1[i]]

    def rerun(sel):
        """Re-runs the segments `sel` from their predecessors' end states."""
        nw = end[sel - 1].clone()
        agreed, fresh = _kw_rerun_rows(arr, svc, speeds, q[sel], j0[sel], j1[sel], nw, init[sel],
                                       equiv[sel], outs)
        init[sel] = nw
        end[sel[~agreed]] = fresh[~agreed]
        return agreed

    # b. rounds, block by block
    stats = torch.zeros((n_blocks, 3), dtype=torch.long)
    chg = torch.zeros(B * K, dtype=torch.bool)
    going = torch.ones(n_blocks, dtype=torch.bool) if K > 1 else torch.zeros(n_blocks, dtype=torch.bool)
    walk = torch.zeros(n_blocks, dtype=torch.bool)
    pend = k > 0
    rnd = 0
    while bool(going.any()):
        rnd += 1
        pend &= going[block]
        sel = torch.nonzero(pend)[:, 0]
        spawned = torch.zeros(B * K, dtype=torch.bool)
        if len(sel):
            agreed = rerun(sel)
            spawned[sel] = ~agreed & (k[sel] + 1 < K)
        n_ran = torch.zeros(n_blocks, dtype=torch.long).index_add_(0, block, pend.long())
        n_spawned = torch.zeros(n_blocks, dtype=torch.long).index_add_(0, block, spawned.long())
        stats[going, 0] += 1
        stats[:, 1] += n_ran
        chg = torch.where(going[block], spawned, chg)
        stop = going & (n_spawned == 0)
        walk |= going & ~stop & ((rnd >= max_rounds) | (n_ran - n_spawned < 2 * R))
        going &= ~stop & ~walk
        pend = (k > 0) & torch.roll(chg, 1) & going[block]

    # c. the walk: in each walking row, in order, every segment whose
    # predecessor changed, the recursion alone from the exact state (the
    # walk's own, or the recorded end state before it), then its end state
    # against the recorded one at the next arrival
    walkers = torch.nonzero(walk[block] & (k == 0))[:, 0]
    held = torch.zeros(len(walkers), dtype=torch.bool)
    tr = torch.zeros((len(walkers), c))
    for kk in range(1, K):
        u = walkers + kk
        held &= chg[u - 1]
        sel = torch.nonzero(chg[u - 1])[:, 0]
        if not len(sel):
            continue
        us = u[sel]
        tr[sel] = _kw_walk_rows(arr, svc, speeds, q[us], j0[us], j1[us],
                                torch.where(held[sel, None], tr[sel], end[us - 1]), outs)
        if kk + 1 < K:
            same = _kw_agree(tr[sel], end[us], arr[q[us], j1[us]], equiv[us + 1])
            chg[us[~same]] = True
        held[sel] = True
        stats[:, 2].index_add_(0, block[us], torch.ones(len(us), dtype=torch.long))
    return outs, stats


def _check_one_launch(arr, svc, speeds, L, R):
    want = kw_queue_plain(*_t(arr, svc, speeds))
    _assert_kw_equal(want, jref.kw_queue_ref(*_j(arr, svc, speeds)))
    outs, stats = _kw_one_launch(*_t(arr, svc, speeds), L, R)
    for got, w in zip(outs, want):
        assert torch.equal(got, w)
    return stats


@pytest.mark.parametrize("seg", ["case", "plan"])
@pytest.mark.parametrize("B,J,c,L,load,ints,unsorted", KW_TWO_PASS_CASES)
def test_kw_queue_one_launch_rounds_and_walk_are_bit_equal(B, J, c, L, load, ints, unsorted, seg):
    """The case's segment length, then the plan's (12 where J is not a
    multiple of 4: path "tma" refuses such rows, the algorithm holds), with
    the plan's rows a block."""
    plan = kwk.tma_plan(B, J, c)
    if seg == "plan":
        L = plan.L if plan is not None else 12
    R = plan.R if plan is not None else 1
    arr, svc, speeds = _kw_load_inputs(B, J, c, load, seed=B * J + c, ints=ints)
    if unsorted:  # one row out of FIFO order: only raw-state coupling is sound
        arr[1, 10:J:7] -= 3.0
    stats = _check_one_launch(arr, svc, speeds, L, R)
    if load >= 1.5 and J > 3 * L:
        assert int(stats[:, 2].sum()) > 0  # saturated: the rounds stop paying, the rows are walked
    if load <= 0.5 and not unsorted and c <= 4 and J > L:
        assert int(stats[:, 2].sum()) == 0 and int(stats[:, 0].max()) <= 3


@pytest.mark.parametrize("seed,load,speeds,unsorted", KW_TWO_PASS_HARD)
def test_kw_queue_one_launch_reruns_are_bit_equal(seed, load, speeds, unsorted):
    arr, svc, _ = _kw_load_inputs(4, 300, len(speeds), load, seed=seed)
    if unsorted == "every 7th":
        arr[1, 10:300:7] -= 3.0
    elif unsorted == "one":
        arr[1, 150] -= 30.0
    # 8-job segments, two rows a block: many rounds, walks in some blocks
    _check_one_launch(arr, svc, np.array(speeds, np.float32), 8, 2)


def test_kw_queue_tma_plan_fills_the_card_and_picks_paths():
    # the main paths' shapes: several warps of chains an SM where B·J allows
    plan = kwk.tma_plan(512, 2048, 4)
    assert plan.L % 8 == 4 and 512 * plan.K <= 132 * kwk.TMA_WARPS_PER_SM * 32
    assert 512 * plan.K > 132 * 8 * 32 and plan.R == 1
    # fewer rows keep the segment length: a row's segments are capped
    assert kwk.tma_plan(48, 2048, 4).L == plan.L and plan.K <= kwk.TMA_MAX_SEGMENTS
    for B, J, c in [(144, 600, 2), (96, 384, 3), (232, 192, 3), (64, 300, 1)]:
        plan = kwk.tma_plan(B, J, c)
        assert plan.L == kwk.TMA_MIN_SEGMENT and plan.K > 1  # J <= 256 is segmented too
        assert plan.R * plan.K <= kwk.TMA_THREADS and plan.blocks * plan.R >= B
        assert plan.smem == kwk.tma_smem_bytes(plan.R, plan.K, c, plan.tile, plan.tiles)
        assert kwk.kernel_path(B, J, c, aligned=True) == "tma"
    # a long row takes longer segments so that its segments fit in a block
    plan = kwk.tma_plan(2, 8192, 4)
    assert plan.K <= kwk.TMA_THREADS < 8192 // kwk.TMA_MIN_SEGMENT
    # refused: rows not a multiple of 4 jobs, views off 16 bytes, rows too long
    assert kwk.kernel_path(8, 602, 2, aligned=True) == "two_launch"
    assert kwk.kernel_path(8, 600, 2, aligned=False) == "two_launch"
    assert kwk.tma_plan(2, 12000, 4) is None and kwk.kernel_path(2, 12000, 4, True) == "two_launch"
    with pytest.raises(ValueError, match="multiple of 4"):
        kwk.tma_plan(8, 600, 2, seg=10)


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
    assert len(compiles) == len(build.sources()) == 4  # one nvcc per source
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


# tests/test_kernels.py's FLASH_CASES: (B, S, H, D, causal, dtype, block_q, block_k)
FLASH_CASES = [
    (2, 256, 4, 64, True, "float32", 128, 128),
    (1, 512, 2, 128, True, "float32", 128, 128),
    (2, 200, 4, 64, True, "float32", 128, 128),
    (1, 128, 8, 64, False, "float32", 64, 64),
    (2, 256, 4, 64, True, "bfloat16", 128, 128),
    (1, 384, 4, 256, True, "bfloat16", 128, 128),
    (1, 96, 2, 80, True, "float32", 32, 32),
]


def _to_torch(a, dtype):
    """A JAX array as a torch tensor of the same values and `dtype`."""
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,S,H,D,causal,dtype,bq,bk", FLASH_CASES)
def test_flash_attention_plain_matches_reference_and_pallas(B, S, H, D, causal, dtype, bq, bk):
    rng = np.random.default_rng(S + D)
    q, k, v = (jnp.asarray(rng.standard_normal((B, S, H, D), np.float32), getattr(jnp, dtype)) for _ in range(3))
    got = flash_attention_plain(*(_to_torch(a, dtype) for a in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, D)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (jref.flash_attention_ref(q, k, v, causal=causal),
                 jops.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)
    before = ops.flash_attention.launches
    again = ops.flash_attention(*(_to_torch(a, dtype) for a in (q, k, v)), causal=causal)
    assert torch.equal(again, got) and ops.flash_attention.launches == before
    assert ref.flash_attention_ref is flash_attention_plain


# (head dim, dtype, every input 16-byte aligned) -> the kernel that takes it:
# the Hopper kernel at the main paths' head dims (64 zamba2, 80 stablelm-3b,
# 128 moonshot / qwen3-32b / llava-next-34b, 256 gemma-2b) when aligned;
# mma.sync for head dim 16 and for views TMA cannot describe; float32 on
# the CUDA cores at every head dim
FLASH_PATHS = [
    (64, torch.bfloat16, True, "wgmma_tma"),
    (80, torch.bfloat16, True, "wgmma_tma"),
    (128, torch.bfloat16, True, "wgmma_tma"),
    (256, torch.bfloat16, True, "wgmma_tma"),
    (16, torch.bfloat16, True, "mma_sync"),
    (64, torch.bfloat16, False, "mma_sync"),
    (128, torch.bfloat16, False, "mma_sync"),
    (256, torch.bfloat16, False, "mma_sync"),
    (16, torch.bfloat16, False, "mma_sync"),
    (64, torch.float32, True, "cuda_core"),
    (256, torch.float32, False, "cuda_core"),
    (16, torch.float32, True, "cuda_core"),
]


@pytest.mark.parametrize("D,dtype,aligned,path", FLASH_PATHS)
def test_flash_attention_dispatch_rule(D, dtype, aligned, path):
    assert kernel_path(D, dtype, aligned) == path
    assert set(ops.flash_attention.launches_by_path) == set(PATHS)


def test_flash_attention_dispatch_refuses_other_dtypes_and_counts_nothing_on_cpu():
    with pytest.raises(TypeError, match="no kernel"):
        kernel_path(64, torch.float16, True)
    q = torch.randn((1, 8, 2, 64)).bfloat16()
    before = dict(ops.flash_attention.launches_by_path)
    ops.flash_attention(q, q, q)
    assert ops.flash_attention.launches_by_path == before


# (P, N, chunks, dtype, 16-byte aligned, chunk, kernel): the Hopper kernel
# takes bf16 at P and N of 64 or 128, chunk 128 and aligned inputs,
# whatever the number of chunks (a cluster of up to 8 walks them in
# groups); the mma_sync kernel every other bf16 call (P = 16, N = 8 or 16,
# chunk 64, unaligned views); float32 takes the CUDA-core kernel whatever
# the shape
SSD_PATHS = [
    (64, 64, 8, torch.bfloat16, True, 128, "wgmma_tma"),
    (64, 128, 8, torch.bfloat16, True, 128, "wgmma_tma"),
    (128, 64, 8, torch.bfloat16, True, 128, "wgmma_tma"),
    (128, 128, 8, torch.bfloat16, True, 128, "wgmma_tma"),
    (64, 64, 1, torch.bfloat16, True, 128, "wgmma_tma"),
    (128, 128, 3, torch.bfloat16, True, 128, "wgmma_tma"),
    (16, 64, 8, torch.bfloat16, True, 128, "mma_sync"),
    (64, 16, 8, torch.bfloat16, True, 128, "mma_sync"),
    (16, 16, 8, torch.bfloat16, True, 128, "mma_sync"),
    (128, 16, 1, torch.bfloat16, True, 128, "mma_sync"),
    (16, 8, 4, torch.bfloat16, True, 32, "mma_sync"),
    (64, 64, 9, torch.bfloat16, True, 128, "wgmma_tma"),
    (128, 128, 9, torch.bfloat16, True, 128, "wgmma_tma"),
    (64, 128, 16, torch.bfloat16, True, 128, "wgmma_tma"),
    (64, 128, 32, torch.bfloat16, True, 128, "wgmma_tma"),
    (64, 64, 256, torch.bfloat16, True, 128, "wgmma_tma"),
    (64, 128, 32, torch.bfloat16, False, 128, "mma_sync"),
    (64, 128, 32, torch.bfloat16, True, 64, "mma_sync"),
    (64, 64, 8, torch.bfloat16, False, 128, "mma_sync"),
    (128, 64, 1, torch.bfloat16, False, 128, "mma_sync"),
    (16, 64, 9, torch.bfloat16, False, 128, "mma_sync"),
    (64, 64, 8, torch.bfloat16, True, 64, "mma_sync"),
    (64, 64, 16, torch.bfloat16, True, 64, "mma_sync"),
    (64, 64, 8, torch.float32, True, 128, "cuda_core"),
    (128, 128, 1, torch.float32, True, 128, "cuda_core"),
    (16, 16, 9, torch.float32, False, 128, "cuda_core"),
    (64, 64, 9, torch.float32, True, 64, "cuda_core"),
]


@pytest.mark.parametrize("P,N,chunks,dtype,aligned,chunk,path", SSD_PATHS)
def test_ssd_scan_dispatch_rule(P, N, chunks, dtype, aligned, chunk, path):
    assert ssd.kernel_path(P, N, chunks, dtype, aligned, chunk) == path
    assert set(ops.ssd_scan.launches_by_path) == set(ssd.PATHS) == set(ssd.CUDA_LAUNCHES)


def test_ssd_scan_dispatch_refuses_other_dtypes_and_counts_nothing_on_cpu():
    with pytest.raises(TypeError, match="no kernel"):
        ssd.kernel_path(64, 64, 8, torch.float16, True)
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in _ssd_inputs(1, 256, 2, 64, 1, 64))
    before, by_path = ops.ssd_scan.launches, dict(ops.ssd_scan.launches_by_path)
    for dtype in (torch.bfloat16, torch.float32):
        y, h = ops.ssd_scan(x.to(dtype), dt, A, B.to(dtype), C.to(dtype), D)
        assert y.dtype == dtype and h.shape == (1, 2, 64, 64)
    assert ops.ssd_scan.launches == before
    assert ops.ssd_scan.launches_by_path == by_path


# tests/test_kernels.py's SSD_CASES: (Bt, S, H, P, G, N, chunk, dtype)
SSD_CASES = [
    (2, 256, 4, 32, 1, 16, 64, "float32"),
    (1, 128, 8, 64, 1, 64, 128, "float32"),
    (1, 100, 4, 16, 2, 8, 32, "float32"),
    (2, 192, 4, 32, 4, 16, 64, "float32"),
    (1, 256, 4, 64, 1, 128, 128, "bfloat16"),
]


def _ssd_inputs(Bt, S, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, H, P), np.float32)
    dt = np.logaddexp(rng.standard_normal((Bt, S, H)), 0.0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((Bt, S, G, N), np.float32)
    C = rng.standard_normal((Bt, S, G, N), np.float32)
    return x, dt, A, B, C, np.ones(H, np.float32)


@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk,dtype", SSD_CASES)
def test_ssd_scan_plain_matches_pallas_and_chunked(Bt, S, H, P, G, N, chunk, dtype):
    x, dt, A, B, C, D = _ssd_inputs(Bt, S, H, P, G, N)
    jdt = getattr(jnp, dtype)
    jx, jB, jC = (jnp.asarray(a, jdt) for a in (x, B, C))
    y, h = ssd_scan_plain(_to_torch(jx, dtype), torch.from_numpy(dt), torch.from_numpy(A),
                          _to_torch(jB, dtype), _to_torch(jC, dtype), torch.from_numpy(D), chunk=chunk)
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    atol, rtol = (2e-1, 5e-2) if dtype == "bfloat16" else (1e-3, 1e-3)
    j_args = (jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, jnp.asarray(D))
    for y_r, h_r in (jops.ssd_scan(*j_args, chunk=chunk), jax.jit(jssd_chunked, static_argnums=6)(*j_args, chunk)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(y_r, np.float32), atol=atol, rtol=rtol)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=atol, rtol=rtol)
    assert ref.ssd_scan_ref is ssd_scan_plain


# (Bt, S, H, P, G, N, dtype): chunk 128 past a cluster of 8 chunks, the
# Hopper kernel's group walk on the card: 9 whole chunks, then 10 with the
# last one ragged
SSD_PAST_A_CLUSTER = [
    (1, 1152, 2, 64, 1, 64, "float32"),
    (1, 1200, 2, 64, 1, 64, "bfloat16"),
]


@pytest.mark.parametrize("Bt,S,H,P,G,N,dtype", SSD_PAST_A_CLUSTER)
def test_ssd_scan_plain_matches_pallas_past_a_cluster(Bt, S, H, P, G, N, dtype):
    """The plain scan, which the card's kernels are held to, against the
    reference's Pallas kernel (interpret mode) at more chunks than one
    cluster of the Hopper kernel holds."""
    x, dt, A, B, C, D = _ssd_inputs(Bt, S, H, P, G, N, seed=S)
    jdt = getattr(jnp, dtype)
    jx, jB, jC = (jnp.asarray(a, jdt) for a in (x, B, C))
    y, h = ssd_scan_plain(_to_torch(jx, dtype), torch.from_numpy(dt), torch.from_numpy(A),
                          _to_torch(jB, dtype), _to_torch(jC, dtype), torch.from_numpy(D), chunk=128)
    y_r, h_r = jops.ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, jnp.asarray(D), chunk=128)
    atol, rtol = (2e-1, 5e-2) if dtype == "bfloat16" else (1e-3, 1e-3)
    assert y.shape == (Bt, S, H, P) and h.shape == (Bt, H, P, N)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_r, np.float32), atol=atol, rtol=rtol)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=atol, rtol=rtol)


def test_ssd_scan_plain_matches_the_recurrence():
    """The plain scan against the reference's literal O(S) recurrence, with
    a ragged last chunk: the masked steps leave h_final as zero padding."""
    x, dt, A, B, C, D = _ssd_inputs(2, 70, 4, 16, 2, 8, seed=3)
    y, h = ssd_scan_plain(*map(torch.from_numpy, (x, dt, A, B, C, D)), chunk=32)
    y_r, h_r = jref.ssd_recurrence_ref(*map(jnp.asarray, (x, dt, A, B, C, D)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=2e-3, rtol=1e-3)


def test_build_tag_hashes_the_shared_headers(monkeypatch, tmp_path):
    """A changed `csrc/*.cuh` changes the library's tag, so the build does
    not load a library compiled against the old header."""
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#define X 1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.headers() == [tmp_path / "b.cuh"]
    before = build._tag()
    (tmp_path / "b.cuh").write_text("#define X 2\n")
    assert build._tag() != before
    (tmp_path / "b.cuh").write_text("#define X 1\n")
    assert build._tag() == before


# The bf16 CUDA kernels' roundings, emulated in plain PyTorch on the CPU and
# held to the reference at the bf16 tolerances above.  flash_attention: an
# online softmax over key tiles (`_flash_key_tile`: the Hopper kernel's 128
# rows, 64 at D = 256; the mma.sync kernel's 64, 32 at D = 256) with P
# rounded to bf16 before P·V, float32 accumulators, l summing the float32 p.
# ssd_scan: every product with a float32 operand takes that operand as
# hi + lo, hi = bf16(v), lo = bf16(v - hi): the gated scores (times x), the
# weighted x of the chunk states (times B) and the carried state (times C).


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _flash_key_tile(D, path):
    """Key rows a step of the bf16 kernel on `path` (csrc/flash_attention.cu:
    HopTile<D>::BN, TcTile<D>::BK)."""
    if path == "wgmma_tma":
        return 128 if D <= 128 else 64
    return 64 if D <= 128 else 32


def flash_bf16_emulated(q, k, v, *, causal=True, path="wgmma_tma"):
    """The bf16 flash kernel's arithmetic on (B, S, H, D) tensors."""
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    block = _flash_key_tile(D, path)
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    m = torch.full(qf.shape[:3], -(2.0**30))
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros(qf.shape)
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, block):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + block]) / D**0.5
        if causal:
            s = torch.where(torch.arange(k0, min(k0 + block, Sk))[None, :] <= rows, s, -(2.0**30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bhkd->bhqd", _bf16(p), vf[:, :, k0:k0 + block])
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3).to(q.dtype)


# (B, Sq, Sk, H, D, causal, block_q, block_k): the bf16 FLASH_CASES, then
# shapes that only the bf16 kernel's ragged, non-causal, D = 80 / 128 and
# Sq != Sk paths reach
FLASH_BF16_CASES = [
    (2, 256, 256, 4, 64, True, 128, 128),
    (1, 384, 384, 4, 256, True, 128, 128),
    (2, 200, 200, 4, 64, True, 128, 128),
    (1, 128, 128, 4, 64, False, 64, 64),
    (1, 96, 96, 2, 80, True, 32, 32),
    (1, 192, 192, 2, 128, True, 64, 64),
    (1, 96, 160, 2, 64, False, 32, 32),
    (1, 160, 96, 2, 64, True, 32, 32),
]


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal,bq,bk", FLASH_BF16_CASES)
def test_flash_bf16_kernel_roundings_match_reference_and_pallas(B, Sq, Sk, H, D, causal, bq, bk):
    rng = np.random.default_rng(Sq + Sk + D)
    q = jnp.asarray(rng.standard_normal((B, Sq, H, D), np.float32), jnp.bfloat16)
    k, v = (jnp.asarray(rng.standard_normal((B, Sk, H, D), np.float32), jnp.bfloat16)
            for _ in range(2))
    wants = (jref.flash_attention_ref(q, k, v, causal=causal),
             jops.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk))
    for path in ("wgmma_tma", "mma_sync"):
        got = flash_bf16_emulated(*(_to_torch(a, "bfloat16") for a in (q, k, v)), causal=causal, path=path)
        assert got.dtype == torch.bfloat16 and got.shape == (B, Sq, H, D)
        for want in wants:
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       rtol=2e-2, atol=2e-2)


def ssd_bf16_emulated(x, dt, A, B, C, D, *, chunk: int = 128):
    """`ssd_scan_plain` with each float32 operand of a product split into
    bf16 hi + lo, as the bf16 kernels compute it."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    Bf = torch.nn.functional.pad(B.float(), (0, 0, 0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    xc = xf.reshape(Bt, nc, Q, H, P)
    Bc = Bf.reshape(Bt, nc, Q, G, N).repeat_interleave(H // G, dim=3)
    Cc = Cf.reshape(Bt, nc, Q, G, N).repeat_interleave(H // G, dim=3)
    dth = dtf.reshape(Bt, nc, Q, H).permute(0, 1, 3, 2)
    cs = torch.cumsum(dth * A.float()[:, None], dim=-1)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    L = torch.where(causal, torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
    gated = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc) * L * dth[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", _split(gated), xc)
    w = (torch.exp(cs[..., -1:] - cs) * dth).permute(0, 1, 3, 2)  # (Bt, nc, Q, H)
    states = torch.einsum("bcjhp,bcjhn->bchpn", _split(w[..., None] * xc), Bc)
    decay = torch.exp(cs[..., -1])
    h = torch.zeros((Bt, H, P, N))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    ch = torch.einsum("bcihn,bchpn->bcihp", Cc, _split(torch.stack(h_prev, dim=1)))
    y = y + ch * torch.exp(cs).permute(0, 1, 3, 2)[..., None] + xc * D.float()[:, None]
    return y.reshape(Bt, nc * Q, H, P)[:, :S].to(x.dtype), h


# (Bt, S, H, P, G, N, chunk): the bf16 SSD_CASES, then G > 1 with a ragged
# last chunk (S = 100, chunk 32), chunk 64 with G = 4, and one chunk (nc = 1)
SSD_BF16_CASES = [
    (1, 256, 4, 64, 1, 128, 128),
    (1, 100, 4, 16, 2, 8, 32),
    (2, 192, 4, 32, 4, 16, 64),
    (1, 128, 8, 64, 1, 64, 128),
]


def _ssd_bf16_case(Bt, S, H, P, G, N):
    x, dt, A, B, C, D = _ssd_inputs(Bt, S, H, P, G, N)
    jx, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (x, B, C))
    t_args = (_to_torch(jx, "bfloat16"), torch.from_numpy(dt), torch.from_numpy(A),
              _to_torch(jB, "bfloat16"), _to_torch(jC, "bfloat16"), torch.from_numpy(D))
    return t_args, (jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, jnp.asarray(D))


@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", SSD_BF16_CASES)
def test_ssd_bf16_kernel_roundings_match_pallas_and_chunked(Bt, S, H, P, G, N, chunk):
    t_args, j_args = _ssd_bf16_case(Bt, S, H, P, G, N)
    y, h = ssd_bf16_emulated(*t_args, chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32 and h.shape == (Bt, H, P, N)
    chunked = jax.jit(jssd_chunked, static_argnums=6)(*j_args, chunk)
    for y_r, h_r in (jops.ssd_scan(*j_args, chunk=chunk), chunked):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(y_r, np.float32),
                                   atol=2e-1, rtol=5e-2)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=2e-1, rtol=5e-2)


@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", SSD_BF16_CASES)
def test_ssd_split_bf16_products_keep_float32_accuracy(Bt, S, H, P, G, N, chunk):
    """On bf16-valued inputs held in float32 (so that no output rounding
    hides it), the split products agree with the plain version's float32
    products to 1e-4 relative to the largest value."""
    t_args, _ = _ssd_bf16_case(Bt, S, H, P, G, N)
    f_args = tuple(t.float() for t in t_args)
    y, h = ssd_bf16_emulated(*f_args, chunk=chunk)
    y_p, h_p = ssd_scan_plain(*f_args, chunk=chunk)
    assert float((y - y_p).abs().max()) <= 1e-4 * float(y_p.abs().max())
    assert float((h - h_p).abs().max()) <= 1e-4 * float(h_p.abs().max())
