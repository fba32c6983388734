"""The port's serving stack (`repro_torch.runtime`, `repro_torch.core`'s
analysis, residual, optimize and adaptive modules, `repro_torch.obs.
sketch`, `repro_torch.launch.serve`) against the JAX reference, on the CPU.

Tolerances:
- `SimCluster`, `SpeculativeExecutor` and `HedgedServer(adapt=False)` on the
  same seed: latency, cost, p50 and p99 at rel 1e-6 (the only float32 step
  is the distribution's quantile; the rest is float64 numpy in both), and
  equal outputs;
- `analysis` against the golden constants of tests/test_golden_analysis.py:
  Theorem 1 quadrature rel 2e-4 (float32 quadrature), closed forms 1e-12
  (plain Python); `residual` against the reference at rtol = atol = 1e-6
  (its bisection stops at float32 resolution, where a last-ulp difference
  in the tail's `pow` moves a small quantile by a few ulps);
- `optimize.bootstrap_evaluator` within 5σ of the reference's (the two
  draw different random numbers);
- the sketch exactly (numpy in both).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import analysis as janalysis
from repro.core import evt as jevt
from repro.core import optimize as joptimize
from repro.core.bootstrap import estimate as jestimate
from repro.core.distributions import Pareto as JPareto
from repro.core.distributions import ShiftedExp as JShiftedExp
from repro.core.policy import SingleForkPolicy as JPolicy
from repro.core.residual import ResidualDistribution as JResidual
from repro.obs.sketch import QuantileSketch as JSketch
from repro.runtime import HedgedServer as JHedgedServer
from repro.runtime import SimCluster as JSimCluster
from repro.runtime import SpeculativeExecutor as JExecutor
from repro_torch.convert import distribution_from_fields
from repro_torch.core import (
    BASELINE,
    OnlinePolicyController,
    Pareto,
    ResidualDistribution,
    ShiftedExp,
    SingleForkPolicy,
    analysis,
    evt,
    optimize,
)
from repro_torch.core.bootstrap import estimate
from repro_torch.launch import serve
from repro_torch.obs import QuantileSketch
from repro_torch.runtime import HedgedServer, SimCluster, SpeculativeExecutor
from tests.test_golden_analysis import THEOREM1_GOLDEN

POLICIES = [(0.0, 0, True), (0.1, 1, True), (0.2, 2, False), (0.05, 1, False)]


def _port(dist):
    import dataclasses

    return distribution_from_fields(type(dist).__name__, **dataclasses.asdict(dist))


def test_sim_cluster_draws_the_reference_durations():
    dist = Pareto(1.7, 0.04)
    ours = SimCluster(40, dist, seed=3, slow_fraction=0.08, slow_factor=12.0, crash_prob=0.05)
    ref = JSimCluster(40, JPareto(1.7, 0.04), seed=3, slow_fraction=0.08, slow_factor=12.0, crash_prob=0.05)
    assert [w.speed for w in ours.workers] == [w.speed for w in ref.workers]
    got = [ours.sample_duration(w) for w in ours.workers]
    want = [ref.sample_duration(w) for w in ref.workers]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("p,r,keep", POLICIES)
def test_executor_matches_reference(p, r, keep):
    ours = SpeculativeExecutor(SimCluster(48, ShiftedExp(1.0, 2.0), seed=1, slow_fraction=0.15, slow_factor=8.0))
    ref = JExecutor(JSimCluster(48, JShiftedExp(1.0, 2.0), seed=1, slow_fraction=0.15, slow_factor=8.0))
    tasks = [lambda i=i: i * i for i in range(16)]
    a, b = ours.run(tasks, SingleForkPolicy(p, r, keep)), ref.run(tasks, JPolicy(p, r, keep))
    assert [x.value for x in a.results] == [x.value for x in b.results]
    np.testing.assert_allclose([a.latency, a.cost], [b.latency, b.cost], rtol=1e-6)
    np.testing.assert_allclose([x.finish_time for x in a.results], [x.finish_time for x in b.results], rtol=1e-6)
    assert a.n_replicas_launched == b.n_replicas_launched


def test_hedged_server_matches_reference_without_adaptation():
    """The reference's serve set-up (Pareto(1.7, 0.040), slow_fraction 0.08,
    slow_factor 12) with a deterministic serve_fn on both sides."""
    def fn(req):
        return [int(t) * 2 + 1 for t in req]

    requests = [list(np.random.default_rng(i).integers(0, 100, 5)) for i in range(24)]
    ours = HedgedServer(SimCluster(96, Pareto(1.7, 0.04), seed=0, slow_fraction=0.08, slow_factor=12.0),
                        fn, policy=SingleForkPolicy(0.05, 1, True), adapt=False, device="cpu")
    ref = JHedgedServer(JSimCluster(96, JPareto(1.7, 0.04), seed=0, slow_fraction=0.08, slow_factor=12.0),
                        fn, policy=JPolicy(0.05, 1, True), adapt=False)
    for _ in range(5):
        (outs, st), (jouts, jst) = ours.serve_batch(requests), ref.serve_batch(requests)
        assert outs == jouts and st.policy == jst.policy
        np.testing.assert_allclose([st.latency, st.cost, st.p50, st.p99, st.p999],
                                   [jst.latency, jst.cost, jst.p50, jst.p99, jst.p999], rtol=1e-6)


def test_quantile_sketch_is_the_reference_sketch():
    xs = np.random.default_rng(2).pareto(1.5, 5000) + 0.01
    ours, ref = QuantileSketch(0.01), JSketch(0.01)
    ours.add_many(xs[:4000])
    ref.add_many(xs[:4000])
    for x in xs[4000:]:
        ours.add(x)
        ref.add(x)
    qs = (0.0, 0.5, 0.9, 0.99, 0.999, 1.0)
    assert ours.quantiles(qs) == ref.quantiles(qs)
    assert ours.summary() == ref.summary() and ours.exceed_fraction(2.0) == ref.exceed_fraction(2.0)


@pytest.mark.parametrize("dist,n,policy,latency,cost", THEOREM1_GOLDEN,
                         ids=[f"{type(d).__name__}-n{n}-{p.label()}" for d, n, p, _, _ in THEOREM1_GOLDEN])
def test_theorem1_matches_the_golden_constants(dist, n, policy, latency, cost):
    lc = analysis.theorem1(_port(dist), SingleForkPolicy(policy.p, policy.r, policy.keep), n)
    assert lc.latency == pytest.approx(latency, rel=2e-4)
    assert lc.cost == pytest.approx(cost, rel=2e-4)


def test_closed_forms_match_the_golden_constants():
    d, p = ShiftedExp(1.0, 1.0), Pareto(2.0, 1.0)
    keep, kill = SingleForkPolicy(0.1, 1, True), SingleForkPolicy(0.1, 1, False)
    assert analysis.theorem2_latency(d, keep, 100) == pytest.approx(5.242485471941835, rel=1e-12)
    assert analysis.theorem2_cost(d, keep) == pytest.approx(2.0632120558828557, rel=1e-12)
    assert analysis.theorem2_cost(d, keep, as_published=True) == pytest.approx(2.163212055882856, rel=1e-12)
    assert analysis.theorem2_latency(d, kill, 100) == pytest.approx(5.742485471941835, rel=1e-12)
    assert analysis.theorem2_cost(d, kill) == pytest.approx(2.2, rel=1e-12)
    assert analysis.theorem3_latency(p, kill, 100) == pytest.approx(5.341410950879998, rel=1e-12)
    assert analysis.theorem3_cost(p, kill) == pytest.approx(1.9504389006498286, rel=1e-12)
    assert analysis.theorem3_latency(p, keep, 100) == pytest.approx(5.55722600472537, rel=2e-4)
    assert analysis.theorem3_cost(p, keep) == pytest.approx(1.9033844986163406, rel=2e-4)
    assert analysis.corollary1_exponent(2.0, 1) == pytest.approx(0.25, rel=1e-12)
    for ours, ref in ((ShiftedExp(1.0, 1.0), JShiftedExp(1.0, 1.0)), (Pareto(2.0, 1.0), JPareto(2.0, 1.0))):
        for pol in (keep, kill):
            jp = JPolicy(pol.p, pol.r, pol.keep)
            assert analysis.lemma1_prefer_kill(ours, pol.p) == janalysis.lemma1_prefer_kill(ref, pol.p)
            assert evt.expected_max(ours, 100) == pytest.approx(jevt.expected_max(ref, 100), rel=1e-6)
            lc, jlc = analysis.theorem1(ours, pol, 100, method="evt"), janalysis.theorem1(ref, jp, 100, method="evt")
            assert lc.latency == pytest.approx(jlc.latency, rel=2e-4)


@pytest.mark.parametrize("dist,jdist", [(Pareto(2.0, 1.0), JPareto(2.0, 1.0)),
                                        (ShiftedExp(1.0, 2.0), JShiftedExp(1.0, 2.0))])
@pytest.mark.parametrize("p,r,keep", [(0.1, 1, True), (0.2, 2, False)])
def test_residual_matches_reference(dist, jdist, p, r, keep):
    ours, ref = ResidualDistribution(dist, SingleForkPolicy(p, r, keep)), JResidual(jdist, JPolicy(p, r, keep))
    ys = np.linspace(0.0, 6.0, 61, dtype=np.float32)
    np.testing.assert_allclose(ours.tail(torch.from_numpy(ys)).numpy(), np.asarray(ref.tail(ys)), rtol=1e-6, atol=1e-6)
    us = np.array([0.01, 0.25, 0.5, 0.9, 0.99], np.float32)
    np.testing.assert_allclose(ours.quantile(torch.from_numpy(us)).numpy(), np.asarray(ref.quantile(us)),
                               rtol=1e-6, atol=1e-6)
    assert float(ours.mean()) == pytest.approx(float(ref.mean()), rel=1e-6)


def test_bootstrap_evaluator_within_five_sigma_of_reference():
    x = np.random.default_rng(4).pareto(2.0, 300) + 1.0
    m = 2000
    ev = optimize.bootstrap_evaluator(x, m=m, seed=1, device="cpu")
    jev = joptimize.bootstrap_evaluator(x, m=m, seed=1)
    for p, r, keep in ((0.1, 1, True), (0.2, 1, False), (0.05, 2, False)):
        lat, cost = ev(SingleForkPolicy(p, r, keep))
        jlat, jcost = jev(JPolicy(p, r, keep))
        se = estimate(x, SingleForkPolicy(p, r, keep), m=m, seed=1, device="cpu")
        jse = jestimate(x, JPolicy(p, r, keep), m=m, key=jax.random.PRNGKey(1))
        assert abs(lat - jlat) / np.hypot(se.latency_stderr, jse.latency_stderr) < 5
        assert abs(cost - jcost) / np.hypot(se.cost_stderr, jse.cost_stderr) < 5


def test_controller_replans_through_the_bootstrap_on_the_given_device():
    ctl = OnlinePolicyController(reoptimize_every=2, min_samples=32, bootstrap_m=64, epsilon=0.0, device="cpu")
    rng = np.random.default_rng(0)
    assert ctl.current_policy() == BASELINE
    for _ in range(4):
        for d in rng.pareto(1.5, 32) + 1.0:
            ctl.record_task_time(d)
        ctl.record_job_complete(n_tasks=32)
    assert len(ctl.history) == 2 and ctl.current_policy().p > 0  # a heavy tail is worth hedging


def test_serve_entry_point_on_the_cpu():
    res = serve.run(serve.parse_args(["--reduced", "--device", "cpu", "--requests", "4", "--batches", "2",
                                      "--prompt", "20", "--steps", "4"]), log=lambda line: None)
    assert res.model.config.arch_id == "zamba2-1.2b" and res.model.config.n_layers == 5
    assert all(len(o) == 4 for outs in res.outputs for o in outs) and res.logits_finite
    assert len(res.prefill_s) == 8 and len(res.stats) == 2
    # the same requests in both batches, so the same tokens
    assert all(np.array_equal(a, b) for a, b in zip(*res.outputs))
    again = res.model.generate(res.params, {"tokens": torch.as_tensor(res.requests[1][None], dtype=torch.int32)}, 4)
    assert again[0].tolist() == list(res.outputs[0][1])
