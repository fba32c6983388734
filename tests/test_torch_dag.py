"""The port's DAG path (`repro_torch.dag`) and histogram tails
(`repro_torch.obs.device`, `obs.evtail`, `frontier(tail="hist")`) against
the JAX package, and the reference's DAG contracts restated inside the port.

Tolerances: device histograms count equally on values kept away from bin
edges, and move at most 0.1% of random values to a neighbouring bin (the
two frameworks' float32 `log` may differ by an ulp); min, max and sum rtol
1e-6.  Sketches and EVT keys on the same counts rtol 1e-9 (both numpy).
The critical-path attribution on shared arrays rtol 1e-6, shares summing
to 1.  Sampled estimators (`dag_frontier`, `dag_rollout`, hist frontier
rows) within the reference's Monte-Carlo bound |Δmean| / hypot(se) < 5,
since torch's and JAX's generators differ.  The bitwise contracts (one
stage ≡ frontier, q = 0 ≡ fault=None, pad_cells) hold inside the port.
Everything runs on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dag as jdag
from repro.dag.rollout import _critical_attribution as j_critical_attribution
from repro.fleet import vector as jv
from repro.obs import device as jdevice
from repro.obs import evtail as jevtail
from repro_torch import core as tcore
from repro_torch import dag as tdag
from repro_torch import obs
from repro_torch.dag.rollout import _critical_attribution
from repro_torch.faults import FaultSpec
from repro_torch.fleet import vector
from repro_torch.obs import DEFAULT_HIST, HistSpec, cell_histograms, device_histogram, sketch_from_device

CPU = "cpu"
X_MAP = np.random.default_rng(0).exponential(1.0, 400) + 1.0
X_RED = np.random.default_rng(1).uniform(0.5, 2.0, 300)


def _stages(m, kind):
    """(JobDAG, its policy vectors) of one test geometry, in either package."""
    base, keep, kill = (m.SingleForkPolicy(0.0, 0, True), m.SingleForkPolicy(0.2, 1, True),
                        m.SingleForkPolicy(0.25, 1, False))
    d = tdag if m is tcore else jdag
    if kind == "two_stage":
        dag = d.JobDAG.map_reduce(8, 4, m.ShiftedExp(1.0, 1.0), m.ShiftedExp(0.5, 2.0),
                                  map_policy=keep, c_map=2, c_reduce=2)
        return dag, [dag.policies(), (kill, base)]
    if kind == "fan_in":
        dag = d.JobDAG([
            d.StageSpec("m1", 4, m.ShiftedExp(1.0, 1.0), keep, c=2),
            d.StageSpec("m2", 4, m.ShiftedExp(0.5, 2.0), c=2),
            d.StageSpec("r", 2, m.ShiftedExp(0.5, 2.0), deps=("m1", "m2")),
        ])
        return dag, [dag.policies(), (base, keep, base)]
    dag = d.JobDAG.map_reduce(8, 4, X_MAP, X_RED, map_policy=keep, c_map=2, c_reduce=2)
    return dag, [dag.policies(), (base, base)]


def _order_stats(x, q):
    xs = np.sort(np.asarray(x).ravel())
    k = math.floor(q * (xs.size - 1))
    return float(xs[k]), float(xs[k + 1])


def _own_tail_keys(h, res):
    """A hist row's cost_p* and evt_* keys are those of the sketches of
    the cell's own per-job costs and sojourns (`res`: the cell's
    `dag_rollout`, the same draws), and cost_p50 / cost_p99 read the order
    statistic at rank floor(q·(N-1)) within rel_acc plus the gap to the
    next one."""
    sk, ck = (sketch_from_device(*(z.numpy() for z in device_histogram(x))) for x in (res.sojourn, res.total_cost))
    np.testing.assert_allclose([h[k] for k in ("cost_p50", "cost_p99", "cost_p999")],
                               ck.quantiles((0.5, 0.99, 0.999)), rtol=1e-9)
    want = obs.evt_keys(sk)
    np.testing.assert_allclose([h[k] for k in sorted(want)], [want[k] for k in sorted(want)], rtol=1e-9)
    for q, key in ((0.5, "cost_p50"), (0.99, "cost_p99")):
        lo, hi = _order_stats(res.total_cost.numpy(), q)
        assert abs(h[key] - lo) <= DEFAULT_HIST.rel_acc * hi + (hi - lo), key


def _cost_quantiles_agree(h, r, cost):
    """The reference's cost_p50 / cost_p99 against the port's: per-job costs
    are independent draws, so two samples' q-quantiles lie within 5σ of
    each other in rank, σ = sqrt(2·N·q(1-q)); read off the port's sorted
    costs and widened by both sketches' rel_acc."""
    xs = np.sort(cost.ravel())
    for q, key in ((0.5, "cost_p50"), (0.99, "cost_p99")):
        k = math.floor(q * (xs.size - 1))
        d = math.ceil(5.0 * math.sqrt(2.0 * xs.size * q * (1 - q)))
        lo, hi = float(xs[max(k - d, 0)]), float(xs[min(k + d + 1, xs.size - 1)])
        acc = 2 * DEFAULT_HIST.rel_acc
        assert lo * (1 - acc) <= r[key] <= hi * (1 + acc), (key, r[key], lo, hi)
        assert lo * (1 - acc) <= h[key] <= hi * (1 + acc), (key, h[key], lo, hi)


def _agree(a, b, what):
    sigma = max(float(np.hypot(a["sojourn_std_err"], b["sojourn_std_err"])), 1e-12)
    assert abs(a["mean_sojourn"] - b["mean_sojourn"]) / sigma < 5.0, what
    assert a["mean_cost"] == pytest.approx(b["mean_cost"], abs=0.1), what


# ------------------------------------------------- histograms and tails
def test_device_histogram_counts_equal_the_reference_away_from_bin_edges():
    spec = DEFAULT_HIST
    rng = np.random.default_rng(2)
    keys = rng.integers(spec.key0 + 1, spec.key0 + spec.n_bins - 1, 5000)
    x = np.exp((keys + rng.uniform(0.2, 0.8, keys.size)) * spec.log_gamma).astype(np.float32)
    x[:3] = (0.0, 1e-6, 1e7)  # clamped into the edge bins
    counts, vmin, vmax, total = device_histogram(torch.from_numpy(x), spec)
    jc, jmin, jmax, jsum = jdevice.device_histogram(jnp.asarray(x), jdevice.HistSpec())
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose([vmin, vmax, total], [jmin, jmax, jsum], rtol=1e-6)


def test_device_histogram_on_random_inputs_moves_at_most_a_tenth_of_a_percent():
    spec = HistSpec(lo=1e-2, n_bins=256, rel_acc=0.01)
    x = np.exp(np.random.default_rng(3).normal(0.5, 1.2, (4, 3000))).astype(np.float32)
    counts, agg = cell_histograms(torch.from_numpy(x), spec)
    jspec = jdevice.HistSpec(lo=1e-2, n_bins=256, rel_acc=0.01)
    for i in range(x.shape[0]):
        jc, jmin, jmax, jsum = jdevice.device_histogram(jnp.asarray(x[i]), jspec)
        moved = np.abs(counts[i].numpy() - np.asarray(jc)).sum() / 2
        assert moved <= 1e-3 * x.shape[1]
        np.testing.assert_allclose(agg[i].numpy(), [jmin, jmax, jsum], rtol=1e-6)
        one = device_histogram(torch.from_numpy(x[i]), spec)
        np.testing.assert_array_equal(one[0].numpy(), counts[i].numpy())


def test_sketch_and_evt_keys_from_the_same_counts_match_the_reference():
    x = np.random.default_rng(4).pareto(2.5, 20000).astype(np.float32) + 1.0
    counts, vmin, vmax, total = (z.numpy() for z in device_histogram(torch.from_numpy(x)))
    sk = sketch_from_device(counts, vmin, vmax, total)
    jsk = jdevice.sketch_from_device(counts, vmin, vmax, total, spec=jdevice.DEFAULT_HIST)
    qs = (0.5, 0.9, 0.99, 0.999)
    np.testing.assert_allclose(sk.quantiles(qs), jsk.quantiles(qs), rtol=1e-9)
    got, want = obs.evt_keys(sk), jevtail.evt_keys(jsk)
    assert set(got) == {"evt_xi", "evt_p999", "evt_p9999"}
    np.testing.assert_allclose([got[k] for k in sorted(got)], [want[k] for k in sorted(got)], rtol=1e-9)
    assert got["evt_xi"] > 0  # a Pareto tail is heavy


def test_frontier_hist_rows_against_reference_and_exact_rows():
    """`tail="hist"`: the reference's keys (cost_p*, evt_*), means within
    5σ of the reference's hist rows, cost_p50 / cost_p99 within the
    reference's rank bound, p50/p99 within rel_acc plus the order-statistic
    gap of the port's own exact rows, and cost_p* / evt_* those of the
    cell's own costs and sojourns (the one-stage DAG's rollout gives the
    paths of each cell)."""
    pols = [tcore.SingleForkPolicy(0.0, 0, True), tcore.SingleForkPolicy(0.1, 1, True)]
    dist = tcore.ShiftedExp(1.0, 1.0)
    hist = vector.frontier(dist, pols, (0.15,), 8, 250, m_trials=8, c=2, tail="hist", device=CPU)
    exact = vector.frontier(dist, pols, (0.15,), 8, 250, m_trials=8, c=2, device=CPU)
    ref = jv.frontier(jcore.ShiftedExp(1.0, 1.0), [jcore.SingleForkPolicy(0.0, 0, True),
                      jcore.SingleForkPolicy(0.1, 1, True)], (0.15,), 8, 250, m_trials=8, c=2,
                      key=jax.random.PRNGKey(0), tail="hist")
    one = tdag.JobDAG([tdag.StageSpec("s", 8, dist, c=2)])
    for h, e, r, pol in zip(hist, exact, ref, pols):
        assert set(h) == set(r)
        _agree(h, r, pol.label())
        for k in ("mean_sojourn", "mean_cost", "rho"):
            assert h[k] == e[k]
        res = tdag.dag_rollout(one, 0.15, 250, 8, policies=(pol,), r_caps=(2,), device=CPU)
        _own_tail_keys(h, res)
        _cost_quantiles_agree(h, r, res.total_cost.numpy())
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            lo, hi = _order_stats(res.sojourn.numpy(), q)
            assert lo <= e[key] <= hi
            assert abs(h[key] - e[key]) <= DEFAULT_HIST.rel_acc * hi + (hi - lo)


def test_frontier_dispatch_span_and_cells_counter():
    rec = obs.enable()
    try:
        vector.frontier(tcore.ShiftedExp(1.0, 1.0), [tcore.BASELINE], (0.1, 0.2), 4, 20, m_trials=2, device=CPU)
        vector.frontier(tcore.ShiftedExp(1.0, 1.0), [tcore.BASELINE], (0.1,), 4, 20, m_trials=2, tail="hist", device=CPU)
    finally:
        obs.disable()
    spans = rec.spans_named("frontier_dispatch")
    assert [s.args["tail"] for s in spans] == ["exact", "hist"]
    assert [s.args["cells"] for s in spans] == [2, 1]
    assert all(s.pid == obs.PID_PROFILER and s.dur >= 0 for s in spans)
    # one law a call: the evaluator evaluates the two loads' shared law once
    assert rec.counters == {"frontier.cells": 3.0, "evaluator.cells": 2.0, "evaluator.laws": 2.0}


@pytest.mark.parametrize("program", ["single_fork", "lowered", "faulty"])
def test_stage_laws_change_no_dag_row_and_are_what_the_evaluator_counts(monkeypatch, program):
    """Each stage evaluates its distinct laws (its policy, and q) once: the
    map stage's two or three policies, the reduce stage's one, times the
    two q on the faulty path.  Every cell evaluated on its own (the law
    index forced to the identity) gives the same rows."""
    dag, vecs = _stages(tcore, "two_stage")
    kw, laws = {}, [2, 1]
    if program == "lowered":
        vecs, laws = vecs + [(tcore.delayed_relaunch(2.0, 1), tcore.BASELINE)], [3, 1]
    if program == "faulty":
        kw, laws = dict(fault=[FaultSpec(q=0.1, max_attempts=3), FaultSpec(q=0.2, max_attempts=3)]), [4, 2]

    def call():
        return tdag.dag_frontier(dag, vecs, (0.1, 0.2), 60, m_trials=4, seed=3, device=CPU, **kw)

    rec = obs.enable(obs.Recorder())
    try:
        rows = call()
    finally:
        obs.disable()
    evaluators = rec.spans_named("evaluator")
    assert [s.args["laws"] for s in evaluators] == laws
    assert all(s.args["cells"] == len(rows) for s in evaluators)
    assert rec.counters == {"evaluator.cells": sum(laws)}
    monkeypatch.setattr(vector, "cell_laws", lambda lowered, cell_qs=None: (np.arange(lowered.k.shape[0]), None))
    assert call() == rows


# ---------------------------------------- critical path on shared arrays
@pytest.mark.parametrize("shape", ["fan_in", "two_sinks"])
def test_critical_attribution_matches_the_reference(shape):
    """Fan-in (m1, m2 → r) with tied barriers, where the first predecessor
    wins; and two sinks (m2 alone, m1 → r) with ties between the sinks."""
    rng = np.random.default_rng(5)
    arr = np.cumsum(rng.exponential(1.0, (2, 3, 50)), axis=-1)
    f0 = arr + rng.exponential(1.0, arr.shape)
    f1 = arr + rng.exponential(1.0, arr.shape)
    if shape == "fan_in":
        f1[..., ::5] = f0[..., ::5]
        r2 = np.maximum(f0, f1)
        plan, sinks = ((4, 2, (), None), (4, 2, (), None), (2, 2, (0, 1), None)), (2,)
    else:
        f1 = f1 + 2.0 * (rng.random(arr.shape) < 0.5)
        r2 = f0
        plan, sinks = ((4, 2, (), None), (4, 2, (), None), (2, 2, (0,), None)), (1, 2)
    f2 = r2 + rng.exponential(0.5, arr.shape)
    if shape == "two_sinks":
        f2[..., ::4] = f1[..., ::4]
    z = [a.astype(np.float32) for a in (arr, f0, f1, r2, f2)]

    def run(t):
        return (t(z[0]), [t(z[0]), t(z[0]), t(z[3])], [t(z[1]), t(z[2]), t(z[4])], plan, sinks)

    soj, attrs = _critical_attribution(*run(torch.from_numpy))
    jsoj, jattrs = j_critical_attribution(*run(jnp.asarray))
    np.testing.assert_allclose(soj.numpy(), np.asarray(jsoj), rtol=1e-6)
    for a, b in zip(attrs, jattrs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(sum(attrs).numpy(), soj.numpy(), rtol=1e-5)


# ------------------------------------- sampled estimators vs the reference
@pytest.mark.parametrize("kind", ["two_stage", "fan_in", "empirical"])
def test_dag_frontier_and_rollout_agree_with_the_reference(kind):
    dag, vecs = _stages(tcore, kind)
    jd, jvecs = _stages(jcore, kind)
    lams = (0.2, 0.3)
    rows = tdag.dag_frontier(dag, vecs, lams, 200, m_trials=12, seed=3, device=CPU)
    ref = jdag.dag_frontier(jd, jvecs, lams, 200, m_trials=12, key=jax.random.PRNGKey(3))
    for a, b in zip(rows, ref):
        assert set(a) == set(b) and a["label"] == b["label"]
        _agree(a, b, a["label"])
        assert sum(a[f"{s}/share"] for s in dag.names) == pytest.approx(1.0, abs=1e-5)
    res = tdag.dag_rollout(dag, 0.3, 200, m_trials=12, seed=4, device=CPU)
    jres = jdag.dag_rollout(jd, 0.3, 200, m_trials=12, key=jax.random.PRNGKey(4))
    sigma = float(np.hypot(res.sojourn_std_err, jres.sojourn_std_err))
    assert abs(res.mean_sojourn - jres.mean_sojourn) / sigma < 5.0
    assert res.mean_cost == pytest.approx(jres.mean_cost, abs=0.1)
    assert set(res.summary()) == set(jres.summary())


# ------------------------------------------- contracts inside the port
@pytest.mark.parametrize("program", ["single_fork", "lowered", "faulty"])
def test_one_stage_dag_equals_the_frontier_bit_for_bit(program):
    dist = tcore.ShiftedExp(1.0, 1.0)
    pols = [tcore.SingleForkPolicy(0.2, 1, True), tcore.BASELINE]
    if program == "lowered":
        pols.append(tcore.delayed_relaunch(2.5, r=1, keep=True))
    fault = [FaultSpec(q=0.0, max_attempts=3), FaultSpec(q=0.1, max_attempts=3)] if program == "faulty" else None
    one = tdag.JobDAG([tdag.StageSpec("s", 8, dist, c=2)])
    a = tdag.dag_frontier(one, [(p,) for p in pols], (0.25, 0.4), 150, m_trials=8, seed=7, fault=fault, device=CPU)
    b = vector.frontier(dist, pols, (0.25, 0.4), 8, 150, m_trials=8, seed=7, c=2, fault=fault, device=CPU)
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for k in ("mean_sojourn", "mean_wait", "mean_service", "mean_cost", "sojourn_std_err", "p50", "p99", "p999"):
            assert ra[k] == rb[k], k
        assert ra["s/rho"] == rb["rho_block"] and ra["s/share"] == 1.0
        assert ra.get("q") == rb.get("q")


def test_fault_q0_is_fault_free_and_padding_changes_nothing():
    dag, vecs = _stages(tcore, "two_stage")
    kw = dict(m_trials=6, seed=8, device=CPU)
    base = tdag.dag_frontier(dag, vecs, (0.3,), 100, pad_cells=False, **kw)
    assert tdag.dag_frontier(dag, vecs, (0.3,), 100, pad_cells=True, **kw) == base
    q0 = tdag.dag_frontier(dag, vecs, (0.3,), 100, fault=FaultSpec(q=0.0), **kw)
    assert [{k: v for k, v in r.items() if k != "q"} for r in q0] == base
    assert all(r["q"] == 0.0 for r in q0)
    # the default r_caps are the grid's own; naming them changes nothing,
    # while a wider fresh-draw width is another random stream: MC only
    assert tdag.dag_frontier(dag, vecs, (0.3,), 100, r_caps=(2, 1), **kw) == base
    wide = tdag.dag_frontier(dag, vecs, (0.3,), 100, r_caps=(4, 4), **kw)
    for a, b in zip(base, wide):
        _agree(a, b, a["label"])
    with pytest.raises(ValueError, match="r_cap"):
        tdag.dag_frontier(dag, vecs, (0.3,), 100, r_caps=(1, 1), **kw)
    with pytest.raises(ValueError, match="lam"):
        tdag.dag_frontier(dag, vecs, (0.0,), 100, **kw)
    with pytest.raises(ValueError, match="policy vector"):
        tdag.dag_frontier(dag, [(tcore.BASELINE,)], (0.3,), 100, **kw)
    with pytest.raises(ValueError, match="tail"):
        tdag.dag_frontier(dag, vecs, (0.3,), 100, tail="sketch", **kw)


def test_rollout_paths_are_the_frontier_cell_and_barriers_hold():
    dag, vecs = _stages(tcore, "two_stage")
    row = tdag.dag_frontier(dag, vecs[:1], (0.3,), 120, m_trials=6, seed=2, device=CPU)[0]
    res = tdag.dag_rollout(dag, 0.3, 120, m_trials=6, seed=2, device=CPU)
    summ = res.summary()
    for k in ("mean_sojourn", "mean_cost", "p50", "p99", "map/share", "reduce/wait"):
        assert summ[k] == pytest.approx(row[k], rel=1e-6), k
    assert bool((res.ready[1] == res.finish[0]).all())
    assert bool((res.start >= res.ready).all()) and bool((res.finish[1] >= res.finish[0]).all())
    torch.testing.assert_close(res.attr.sum(dim=0), res.sojourn, rtol=1e-5, atol=1e-5)
    # kernel=True sends the c = 1 queues through kw_queue as well
    one_block = tdag.JobDAG.map_reduce(8, 4, tcore.ShiftedExp(1.0, 1.0), tcore.ShiftedExp(0.5, 2.0))
    a = tdag.dag_frontier(one_block, [one_block.policies()], (0.15,), 80, m_trials=4, device=CPU)[0]
    b = tdag.dag_frontier(one_block, [one_block.policies()], (0.15,), 80, m_trials=4, kernel=True, device=CPU)[0]
    assert a["mean_sojourn"] == pytest.approx(b["mean_sojourn"], rel=1e-5)


def test_hist_dag_rows_carry_tail_keys_within_the_sketch_accuracy():
    dag, vecs = _stages(tcore, "fan_in")
    exact = tdag.dag_frontier(dag, vecs, (0.2,), 200, m_trials=8, seed=1, device=CPU)
    hist = tdag.dag_frontier(dag, vecs, (0.2,), 200, m_trials=8, seed=1, tail="hist", device=CPU)
    jd, jvecs = _stages(jcore, "fan_in")
    ref = jdag.dag_frontier(jd, jvecs, (0.2,), 200, m_trials=8, key=jax.random.PRNGKey(1), tail="hist")
    for e, h, r, vec in zip(exact, hist, ref, vecs):
        assert {"cost_p50", "cost_p99", "cost_p999", "evt_xi", "evt_p999", "evt_p9999"} <= set(h)
        assert set(h) == set(r)
        assert h["mean_sojourn"] == e["mean_sojourn"]
        res = tdag.dag_rollout(dag, 0.2, 200, 8, policies=vec, seed=1, r_caps=(2, 2, 2), device=CPU)
        _own_tail_keys(h, res)
        _cost_quantiles_agree(h, r, res.total_cost.numpy())
        lo, hi = _order_stats(res.sojourn.numpy(), 0.99)
        assert abs(h["p99"] - e["p99"]) <= DEFAULT_HIST.rel_acc * hi + (hi - lo)


def test_exhaustive_search_beats_uniform_and_coordinate_search_converges():
    demo = tdag.JobDAG.map_reduce(8, 4, X_MAP, X_RED, c_map=2, c_reduce=1)
    cands = [tcore.BASELINE, tcore.SingleForkPolicy(0.1, 1, True), tcore.SingleForkPolicy(0.25, 1, False)]
    kw = dict(n_jobs=120, m_trials=6, seed=0, device=CPU)
    ex = tdag.exhaustive_search(demo, cands, 0.35, **kw)
    assert ex["n_cells"] == 9
    uni = tdag.dag_frontier(demo, tdag.uniform_vectors(demo, cands), (0.35,), 120, m_trials=6, seed=0,
                            r_caps=(2, 2), device=CPU)
    assert ex["best"]["mean_sojourn"] <= tdag.best_stable(uni)["mean_sojourn"]
    co = tdag.coordinate_search(demo, cands, 0.35, **kw)
    assert co["converged"] and co["n_evals"] >= len(cands)
    assert ex["best"]["mean_sojourn"] <= co["best"]["mean_sojourn"]
    # an unstable incumbent is abandoned for a stable vector
    hot = tdag.coordinate_search(demo, cands, 0.7, init=(cands[2], cands[2]), **kw)
    assert hot["best"]["rho"] < 0.95 or all(r["rho"] >= 0.95 for r in hot["history"] or [hot["best"]])


def test_retry_transform_running_product_equals_cumprod_bit_for_bit():
    """The fault path's running product of failure flags is the value of
    `torch.cumprod`, for a float q and for one q per cell."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand((3, 50, 6, 5), generator=g) + 0.5
    v = torch.rand((3, 50, 6, 4), generator=g)
    for q in (0.3, torch.tensor([0.0, 0.5, 0.9])[:, None, None, None, None]):
        alive = torch.cumprod((v < q).to(x.dtype), dim=-1)
        assert torch.equal(vector.retry_transform(x, v, q), x[..., 0] + (alive * x[..., 1:]).sum(dim=-1))
