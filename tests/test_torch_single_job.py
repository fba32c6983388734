"""The single-job evaluator's kernel (`repro_torch.kernels.single_job`).

On the CPU: the engine's route (`fleet.vector.evaluator_path`), the
chunk size on the kernel's path, the CPU path's sections and its (T, C),
which are the chains' own, the wrapper's checks, and the kernel's
algorithm written out in numpy (`_twin`: stage 0's order once a row, the
single-fork leg, group-blocked orders and each group's fork instant,
cohorts as bit masks, stages without stragglers skipped) against the
chains it replaces, T bit for bit and C within 1e-6.

On a card (marked `cuda`, skipped without one): the kernel against the
chains on the card over the same cases, at the benchmark's two grids and
a cross-family grid with group selection at full size, T bit-equal and C
within 1e-6 relative (the kernel sums in double, the chains in float32 in
another order).  The file imports neither
JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_single_job.py -q
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import core as tcore
from repro_torch import obs
from repro_torch.core.simulate import lowered_eval_cells, policy_draws, running_min
from repro_torch.faults import FaultSpec
from repro_torch.fleet import vector
from repro_torch.kernels import single_job as sj

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

INF = math.inf
#: job1.frontier's and job1.general's policies (perfbench/traffic)
FRONTIER = [tcore.SingleForkPolicy(p, r, keep) for p, r, keep in (
    (0.0, 0, True), (0.05, 1, True), (0.1, 1, True), (0.2, 1, True), (0.1, 2, True),
    (0.1, 1, False), (0.1, 2, False), (0.2, 1, False))]
GENERAL = [tcore.BASELINE, tcore.delayed_relaunch(2.0, r=0, keep=False),
           tcore.delayed_relaunch(3.0, r=1, keep=True),
           tcore.MultiForkPolicy(((0.4, 1, True), (0.1, 1, False)))]


def _lowered(policies, n):
    lp = tcore.lower_policies(policies, n)
    return [(list(zip(*(v[i].tolist() for v in (lp.mode, lp.k, lp.t, lp.r, lp.keep)))), int(lp.d[i]))
            for i in range(len(policies))]


def _laws(kind, n):
    """Each law as its stages [(mode, k, t, r, keep), ...], padded inactive,
    and its group width d."""
    q, tm, off = 0, 1, (-1, 0, INF, 0, True)
    if kind == "frontier":
        return _lowered(FRONTIER, n)
    if kind == "general":
        return _lowered(GENERAL, n)
    if kind == "groups":  # group selection: every d that divides n, k = 0 (the clamp across groups) to d
        divisors = [w for w in range(1, n) if n % w == 0]
        laws = []
        for i, w in enumerate(divisors):
            a, b = (0, w, w // 2, max(w - 1, 0))[i % 4], (w, 0, max(w // 3, 0), w - 1)[i % 4]
            laws += [([(q, a, INF, 1, True), (q, b, INF, 1, False)], w),
                     ([(tm, 0, 1.4, 0, False), (q, w // 2, INF, 1, bool(i % 2))], w),
                     ([(q, max(w - 1, 0), INF, 2, False), (tm, 0, 2.0, 1, True)], w)]
        return laws + [([(q, n // 2, INF, 1, True), (q, n // 3, INF, 1, False)], n)]
    if kind == "groups_one":  # one stage with groups: never the leg
        p = min(w for w in range(2, n + 1) if n % w == 0)
        return [([(q, k, INF, 1, keep)], w) for w in (1, p, n // p)
                for k, keep in ((0, True), (w // 2, False), (w, True))]
    if kind == "stages":  # MAX_STAGES stages, time and quantile, kill and keep, d = 1 to n
        return [([(q if s % 3 else tm, max(w - 1 - s, 0), 1.0 + 0.3 * s, 1, bool(s % 2))
                  for s in range(sj.MAX_STAGES)], w) for w in (1, 2, n // 4, n)]
    # one stage: k = 0 and k = n, keep and kill with r = 0
    edges = [[(q, 0, INF, 1, True)], [(q, n, INF, 1, False)], [(q, n // 3, INF, 0, True)],
             [(q, n // 2, INF, 0, False)], [(tm, 0, 0.1, 1, True)], [(tm, 0, 1e6, 1, False)]]
    if kind == "edges_one":
        return [(law, n) for law in edges]
    # two stages: the edges again, time stages below and above every finish,
    # padded and leading inactive stages
    return [(law, n) for law in (
        [(q, 0, INF, 1, True), (q, n // 2, INF, 1, False)],
        [(q, n, INF, 1, False), (tm, 0, 1.5, 0, False)],
        [(q, n // 3, INF, 0, True), (q, n - 1, INF, 0, False)],
        [(tm, 0, 0.1, 1, False), (tm, 0, 1e6, 1, True)],
        [(tm, 0, 1.2, 0, True), off],
        [off, (tm, 0, 2.0, 1, False)],
        [(q, n - max(n // 10, 1), INF, 1, True), (q, n - max(n // 5, 1), INF, 1, False)])]


def _inputs(n, rows, laws, r_cap, ranked=False, ties=False, per_law=False, seed=0):
    """(x, cm, mode, k, t, r, keep, d) as numpy: times from a 64-value
    sample where `ties`, else 0.5 + Exp(1)."""
    rng = np.random.default_rng(seed)
    d = np.array([w for _, w in laws], np.int32)
    laws = [law for law, _ in laws]
    S = len(laws[0])
    L = len(laws)
    lead = L if per_law else 1
    sample = np.round(0.5 + rng.exponential(1.0, 64), 3)

    def draw(shape):
        return (rng.choice(sample, shape) if ties else 0.5 + rng.exponential(1.0, shape)).astype(np.float32)

    x = draw((lead, rows, n))
    if ranked:
        x = np.sort(x, axis=-1)
    cm = np.minimum.accumulate(draw((lead, rows, S, n, r_cap)), axis=-1)
    cols = [np.array([[st[i] for st in law] for law in laws]) for i in range(5)]
    mode, k, r = (c.astype(np.int32) for c in (cols[0], cols[1], cols[3]))
    return x, cm, mode, k, cols[2].astype(np.float32), r, cols[4].astype(bool), d


def _grouped(order, w):
    """`order` (tasks by rank) sorted stably by group, task // w."""
    return order[np.argsort(order // w, kind="stable")]


def _twin(x, cm, mode, k, t, r, keep, d, ranked):
    """The kernel's algorithm, row by row in numpy float32 (sums in double)."""
    f32 = np.float32
    L, S = mode.shape
    n = x.shape[-1]
    R = x.shape[1]
    T = np.empty((L, R), np.float32)
    C = np.empty((L, R), np.float32)
    for row in range(R):
        shared_order = None if x.shape[0] > 1 or ranked else np.argsort(x[0, row], kind="stable")
        for l in range(L):
            xr = x[l if x.shape[0] > 1 else 0, row]
            cmr = cm[l if cm.shape[0] > 1 else 0, row]
            p0 = np.arange(n) if ranked else (shared_order if shared_order is not None
                                                 else np.argsort(xr, kind="stable"))
            xs = xr[p0]
            w = int(d[l])
            G = n // w
            if S == 1 and mode[l, 0] == 0 and w == n:  # the single-fork leg
                k0, r0 = int(k[l, 0]), int(r[l, 0])
                t1 = xs[max(k0 - 1, 0)]
                f = xs[k0:]
                if keep[l, 0]:
                    y = f - t1
                    if r0 > 0:
                        y = np.minimum(y, cmr[0, k0:, r0 - 1])
                else:
                    y = cmr[0, k0:, r0]
                my = max(y.max() if y.size else -np.inf, 0.0 if k0 > 0 else -np.inf)
                c1 = f32(f32(xs[:k0].astype(np.float64).sum()) + f32(n - k0) * t1)
                T[l, row] = t1 + f32(my)
                C[l, row] = (c1 + f32(r0 + 1) * f32(y.astype(np.float64).sum())) / f32(n)
                continue
            fin = xr.copy()
            alive = np.ones(n, np.int64)
            start = np.zeros((S + 1, G), np.float32)  # each cohort's start by group
            copies = np.ones(S + 1, np.float32)
            cost = 0.0
            first = True
            for s in range(S):
                m, ks, ts, rs, kp = (int(mode[l, s]), int(k[l, s]), t[l, s], int(r[l, s]), bool(keep[l, s]))
                if m == -1 or (m == 0 and ks >= w):
                    continue
                order = _grouped(p0 if first else np.argsort(fin, kind="stable"), w)
                first = False
                ranks = np.arange(n)
                tau_g = (fin[order[np.maximum(np.arange(G) * w + ks - 1, 0)]] if m == 0
                         else np.full(G, ts, np.float32))
                tau = tau_g[ranks // w]
                strag = ranks % w >= ks if m == 0 else fin[order] > tau
                idx, jj, tj = order[strag], ranks[strag], tau[strag]
                if kp:
                    y = fin[idx] - tj
                    if rs > 0:
                        y = np.minimum(y, cmr[s, jj, rs - 1])
                else:
                    y = cmr[s, jj, rs]
                    for c in range(s + 1):
                        live = ((alive[idx] >> c) & 1) == 1
                        settled = copies[c] * np.maximum(tj - start[c, idx // w], f32(0.0))
                        cost += float(settled[live].astype(np.float64).sum())
                    alive[idx] = 0
                alive[idx] |= 1 << (s + 1)
                fin[idx] = tj + y
                start[s + 1] = tau_g
                copies[s + 1] = f32(rs) if kp else f32(rs) + f32(1.0)
            for c in range(S + 1):
                live = ((alive >> c) & 1) == 1
                spans = np.maximum(fin - start[c, np.arange(n) // w], f32(0.0))
                cost += float((copies[c] * spans[live]).astype(np.float64).sum())
            T[l, row] = fin.max()
            C[l, row] = f32(cost) / f32(n)
    return T, C


#: (laws, n, rows, r_cap, ranked, ties, per_law) for the twin and the card
CASES = {
    "frontier": ("frontier", 1026, 3, 3, True, False, False),
    "frontier_ties": ("frontier", 485, 4, 3, True, True, False),
    "general": ("general", 1026, 3, 2, False, False, False),
    "general_ties": ("general", 485, 4, 2, False, True, False),
    "edges_one": ("edges_one", 16, 6, 2, False, True, False),
    "edges_two": ("edges_two", 16, 6, 2, False, True, False),
    "edges_two_485": ("edges_two", 485, 3, 2, False, True, False),
    "per_law_single": ("frontier", 485, 3, 3, False, True, True),
    "per_law_general": ("general", 485, 3, 2, False, False, True),
    "largest": ("edges_two", sj.MAX_TASKS, 2, 2, False, True, False),
    "groups": ("groups", 16, 6, 3, False, True, False),
    "groups_485": ("groups", 485, 3, 3, False, True, False),
    "groups_1026": ("groups_one", 1026, 3, 3, False, True, False),
    "groups_ranked": ("groups_one", 485, 3, 3, True, True, False),
    "groups_per_law": ("groups", 16, 4, 3, False, False, True),
    "largest_stages": ("stages", sj.MAX_TASKS, 2, 2, False, True, False),
}


def _case(name, rows=None):
    kind, n, R, r_cap, ranked, ties, per_law = CASES[name]
    laws = _laws(kind, n)
    return _inputs(n, rows or R, laws, r_cap, ranked, ties, per_law), ranked


def _torch(arrays, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def _gap(got, want):
    return float(((got.double() - want.double()).abs() / want.double().abs().clamp_min(1e-30)).max())


@pytest.mark.parametrize("name", list(CASES))
def test_the_kernels_algorithm_is_the_chains(name):
    arrays, ranked = _case(name)
    T, C = sj.single_job_plain(*_torch(arrays, "cpu"), ranked=ranked)
    T_twin, C_twin = _twin(*arrays, ranked)
    assert torch.equal(torch.from_numpy(T_twin), T)
    assert _gap(torch.from_numpy(C_twin), C) <= 1e-6


def test_the_wrapper_takes_the_plain_chain_on_the_cpu():
    arrays, ranked = _case("general")
    args = _torch(arrays, "cpu")
    before = sj.single_job.launches
    got = sj.single_job(*args, ranked=ranked)
    want = sj.single_job_plain(*args, ranked=ranked)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and sj.single_job.launches == before


@pytest.mark.parametrize("fault", ["dtype", "contiguous", "device_of_k", "stages", "lead", "ranked", "widths"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fault):
    arrays, _ = _case("general")
    x, cm, mode, k, t, r, keep, d = _torch(arrays, "cpu")
    ranked = False
    if fault == "dtype":
        x = x.double()
    elif fault == "contiguous":
        cm = cm.transpose(-1, -2)
    elif fault == "device_of_k":
        k = k.to("meta")
    elif fault == "stages":
        mode = mode[:, :1].contiguous()
    elif fault == "lead":
        x = x.expand(2, *x.shape[1:]).contiguous()
        x = torch.cat([x, x[:1]])
    elif fault == "widths":
        d = d[:1]
    else:
        ranked = True
    with pytest.raises((TypeError, ValueError)):
        sj.single_job(x, cm, mode, k, t, r, keep, d, ranked=ranked)


@pytest.mark.parametrize("device, n, n_stages, path", [
    ("cuda", 1026, 1, "fused"), ("cuda", 1026, 2, "fused"), ("cuda", 16, 2, "fused"),
    ("cuda", sj.MAX_TASKS, 4, "fused"), ("cuda", sj.MAX_TASKS, sj.MAX_STAGES, "fused"), ("cpu", 1026, 1, "masked"),
    ("cpu", 16, 2, "lowered"), ("cuda", sj.MAX_TASKS + 1, 1, "masked"), ("cuda", 16, sj.MAX_STAGES + 1, "lowered"),
])
def test_the_engine_takes_the_kernel_from_device_width_n_and_stages(device, n, n_stages, path):
    """The device, n and S choose the kernel; the laws' group widths do not
    (the kernel takes d < n).  Off the kernel, a single-fork grid (here the
    one-stage ones) takes the masked chain, any other the lowered one."""
    assert vector.evaluator_path(torch.device(device), n, n_stages, n_stages == 1) == path


def test_the_chunk_on_the_kernels_path_counts_only_its_outputs():
    m, J, n = 16, 2048, 1026
    cuda = torch.device("cuda")
    whole = vector.cell_chunk_size(m, J, n, 3, 1, True, device=cuda)
    assert whole == vector.CELL_CHUNK_BYTES // (m * J * 8) >= 16384
    assert vector.cell_chunk_size(m, J, n, 2, 2, False, device=cuda) == whole
    # the faulty path: each law's retry-transformed draws besides
    faulty = vector.cell_chunk_size(m, J, n, 2, 2, False, attempts=3, device=cuda)
    assert faulty == vector.CELL_CHUNK_BYTES // (m * J * 8 + m * J * n * 4 * 3 * (1 + 2 * 2))
    # the chains' intermediates are larger: fewer laws a chunk, on the CPU
    # and where n is beyond the kernel
    assert vector.cell_chunk_size(m, J, n, 3, 1, True) < whole
    assert vector.cell_chunk_size(m, J, sj.MAX_TASKS + 1, 3, 1, True, device=cuda) < whole


X = np.random.default_rng(0).exponential(1.0, 400) + 1.0


@pytest.mark.parametrize("grid", ["single", "general", "group", "dag_mixed"])
def test_the_cpu_keeps_the_chains_and_counts_no_fused_law(grid):
    """On the CPU every chunk runs a chain.  A DAG whose reduce stage holds
    an algebra policy takes the lowered chain in every stage, its
    single-fork map stage too (`dag.rollout._stage_pols`)."""
    rec = obs.enable(obs.Recorder())
    try:
        if grid == "dag_mixed":
            from repro_torch import dag as tdag

            mr = tdag.JobDAG.map_reduce(8, 4, tcore.ShiftedExp(1.0, 1.0), tcore.ShiftedExp(0.5, 2.0), c_map=2)
            vecs = [(FRONTIER[3], GENERAL[1]), (FRONTIER[6], GENERAL[2])]
            tdag.dag_frontier(mr, vecs, (0.1, 0.2), 16, m_trials=2, device="cpu")
            laws, evaluators = 2 * len(vecs), 2
        else:
            pols = {"single": FRONTIER, "general": GENERAL,
                    "group": GENERAL[:2] + [tcore.group_replication(0.25, 1, 4)]}[grid]
            vector.frontier(X, pols, (0.1, 0.2), 40, 16, m_trials=2, c=2, device="cpu")
            laws, evaluators = len(pols), 1
    finally:
        obs.disable()
    chunks = rec.spans_named("evaluator.chunk")
    assert len(rec.spans_named("evaluator")) == evaluators
    assert chunks and {s.args["path"] for s in chunks} == {"masked" if grid == "single" else "lowered"}
    assert sum(s.args["cells"] for s in chunks) == rec.counters["evaluator.cells"] == laws


@pytest.mark.parametrize("grid", ["single", "general", "group"])
def test_a_frontier_querys_tc_on_the_cpu_is_the_chains(grid):
    """`cell_tc` on the CPU gives what the chains give on its draws, float
    for float: the draws from the same generator, then `_masked_cells` or
    `lowered_eval_cells` on all the laws at once."""
    pols = {"single": FRONTIER, "general": GENERAL,
            "group": GENERAL[:2] + [tcore.group_replication(0.25, 1, 4)]}[grid]
    n, shape = 40, (2, 24)
    lowered = tcore.lower_policies(pols, n)
    single = vector.single_fork(lowered)
    assert single is (grid == "single")
    pol, _, _ = vector._law_tensors(lowered, None, torch.device("cpu"))
    assert all(torch.equal(v, torch.as_tensor(w)) for v, w in zip(pol, (
        lowered.mode, lowered.k, lowered.t, lowered.r, lowered.keep, lowered.d)))
    quantile = vector.as_quantile_source(X, "cpu")[1]
    q = lambda u: vector.emp_quantile(quantile, u)  # noqa: E731
    r_cap = lowered.r_max + 1
    T, C = vector.cell_tc(torch.Generator().manual_seed(3), q, pol, None, shape, n, r_cap, single, None, 2)
    g = torch.Generator().manual_seed(3)
    if single:
        x, fresh = vector.fork_draws(g, q, shape, n, r_cap)
        want = vector._masked_cells(x[None], running_min(fresh)[None], pol[1][:, 0], pol[3][:, 0], pol[4][:, 0])
    else:
        x, fresh = policy_draws(g, q, shape, n, r_cap, lowered.n_stages)
        want = lowered_eval_cells(x[None], running_min(fresh)[None], *pol)
    assert torch.equal(T, want[0]) and torch.equal(C, want[1])


# ---------------------------------------------------------------- on a card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _on_card(args, ranked, chains=sj.single_job_plain):
    """The kernel against the chain on the same card tensors: one launch, T
    bit-equal, C within 1e-6 relative.  Returns C's largest gap."""
    before = sj.single_job.launches
    T, C = sj.single_job(*args, ranked=ranked)
    torch.cuda.synchronize()
    assert sj.single_job.launches == before + 1
    T_chain, C_chain = chains(*args, ranked=ranked)
    assert torch.equal(T, T_chain)
    gap = _gap(C, C_chain)
    assert gap <= 1e-6, gap
    return gap


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_the_kernel_is_the_chain_on_card(name):
    dev = _card()
    arrays, ranked = _case(name, rows=64)
    _on_card(_torch(arrays, dev), ranked)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["frontier", "general", "cross"])
def test_the_kernel_is_the_chain_at_the_benchmarks_grids_on_card(kind):
    """The benchmark's grids and a cross-family grid with group selection
    at full size (2048 jobs × 16 trials of Job 1's 1026 tasks), drawn as the
    engine draws them (`chip_smoke.single_job_grid`), on the card."""
    dev = _card()
    args, ranked = chip_smoke.single_job_grid(torch, dev, chip_smoke.FULL, kind)
    gap = _on_card(args, ranked, lambda *a, ranked: chip_smoke.single_job_chains(torch, a, ranked))
    print(f"{kind}: largest relative C gap {gap:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["dtype", "contiguous"])
def test_the_kernel_refuses_a_wrong_dtype_or_a_strided_input_on_card(fault):
    dev = _card()
    arrays, _ = _case("general", rows=4)
    x, cm, mode, k, t, r, keep, d = _torch(arrays, dev)
    if fault == "dtype":
        x = x.half()
    else:
        x = x[..., ::2]
    with pytest.raises((TypeError, ValueError)):
        sj.single_job(x, cm, mode, k, t, r, keep, d)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["single", "general", "faulty", "group"])
def test_the_engine_takes_the_kernel_on_card(grid):
    """`frontier` on the card: every chunk on path "fused", their `cells`
    the laws evaluated, and the rows within Monte-Carlo error of the CPU's
    (other generators)."""
    dev = _card()
    pols = {"general": GENERAL, "group": GENERAL[:2] + [tcore.group_replication(0.25, 1, 4)]}.get(grid, FRONTIER[:4])
    kw = dict(fault=FaultSpec(q=0.1, max_attempts=3)) if grid == "faulty" else {}
    rec = obs.enable(obs.Recorder())
    try:
        rows = vector.frontier(X, pols, (0.1, 0.2), 40, 256, m_trials=8, c=2, device=dev, **kw)
    finally:
        obs.disable()
    chunks = rec.spans_named("evaluator.chunk")
    assert {s.args["path"] for s in chunks} == {"fused"}
    assert sum(s.args["cells"] for s in chunks) == rec.counters["evaluator.cells"] == len(pols)
    cpu = vector.frontier(X, pols, (0.1, 0.2), 40, 256, m_trials=8, c=2, device="cpu", **kw)
    for a, b in zip(rows, cpu):
        sigma = max(float(np.hypot(a["sojourn_std_err"], b["sojourn_std_err"])), 1e-12)
        assert abs(a["mean_sojourn"] - b["mean_sojourn"]) / sigma < 5.0, a["policy"]
