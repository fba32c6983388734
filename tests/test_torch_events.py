"""The port's event engine (`repro_torch.fleet.FleetSim`,
`repro_torch.dag.DagFleetSim`) and its adaptive controller
(`FleetPolicyController`) against the JAX package, and the fused engines
held against the port's own event engine.

Both event engines run on the host with numpy's generators, so on the same
seed they draw the same uniforms and differ only in the float32 rounding
of the quantile transforms: job records are held within rtol 1e-5.  The
controller plans through the port's `policy_search` (on the CPU here),
whose random stream is torch's, so it is held to the reference's
behaviours (drift fires, re-plans happen, it beats the best fixed
policy), not to its decisions.  The fused engines against the event
engine: within 5 combined standard errors, as in tests/test_fleet.py and
tests/test_dag.py.
"""

import numpy as np
import pytest

import repro.core as jcore
import repro.dag as jdag
import repro.fleet as jfleet
import repro.faults as jfaults
from repro_torch import core as tcore
from repro_torch import dag as tdag
from repro_torch import faults as tfaults
from repro_torch import fleet as tfleet
from repro_torch.fleet import vector

CPU = "cpu"


def _records(recs):
    return np.array([[r.arrival, r.start, r.finish, r.cost, r.n_replicas] for r in recs])


def _same_records(a, b):
    ra, rb = _records(a), _records(b)
    assert ra.shape == rb.shape
    np.testing.assert_allclose(rb, ra, rtol=1e-5, atol=1e-6)
    assert [r.machine_class for r in a] == [r.machine_class for r in b]


# --------------------------------------------------- the engine, copied
def test_event_heap_orders_by_time_then_fifo_and_cancels_lazily():
    heap = tfleet.EventHeap()
    heap.push(2.0, "b", 1)
    e = heap.push(1.0, "a", 2)
    heap.push(1.0, "a", 3)
    heap.push(0.5, "z", 4)
    e.cancel()
    assert [heap.pop().data for _ in range(3)] == [4, 3, 1]
    assert heap.pop() is None
    with pytest.raises(ValueError):
        heap.push(float("nan"), "x", None)


@pytest.mark.parametrize(
    "case",
    ["pooled_keep", "aligned_c3_kill", "classes_aligned", "faults", "empirical", "priority_relaunch"],
)
def test_fleet_sim_matches_reference_records(case):
    """Same workload, same seed: the port's FleetSim reproduces the
    reference's job records (start, finish, cost, replicas) within rtol
    1e-5, across placement, classes, faults and an empirical workload."""
    x = np.random.default_rng(0).exponential(1.0, 300) + 0.5

    def run(m, fl, faults):
        pol = {
            "pooled_keep": m.SingleForkPolicy(0.2, 1, True),
            "aligned_c3_kill": m.SingleForkPolicy(0.25, 1, False),
            "classes_aligned": m.SingleForkPolicy(0.2, 1, True),
            "faults": m.SingleForkPolicy(0.1, 1, True),
            "empirical": m.SingleForkPolicy(0.2, 2, True),
            "priority_relaunch": m.SingleForkPolicy(0.2, 1, False),
        }[case]
        dist = m.Empirical(x) if case == "empirical" else m.ShiftedExp(1.0, 1.0)
        jobs = fl.poisson_workload(80, rate=0.4, n_tasks=10, dist=dist, seed=3,
                                   priority_levels=2 if case == "priority_relaunch" else 1)
        kw = dict(policy=pol, seed=4)
        if case == "classes_aligned":
            kw.update(classes=(fl.MachineClass("fast", 20, 1.0), fl.MachineClass("slow", 10, 0.5)),
                      placement="aligned")
        else:
            kw.update(capacity=30)
        if case == "aligned_c3_kill":
            kw.update(placement="aligned")
        if case == "faults":
            kw.update(fault=faults.FaultSpec(q=0.1, max_attempts=4, backoff_base=0.2))
        if case == "priority_relaunch":
            kw.update(discipline="priority", relaunch_delay=0.3)
        rep = fl.FleetSim(fl.FleetConfig(**kw)).run(jobs)
        return rep

    ref = run(jcore, jfleet, jfaults)
    got = run(tcore, tfleet, tfaults)
    _same_records(ref.records, got.records)
    assert got.stats.mean_sojourn == pytest.approx(ref.stats.mean_sojourn, rel=1e-5)
    assert got.n_task_failures == ref.n_task_failures
    assert got.n_retries == ref.n_retries


@pytest.mark.parametrize("shape", ["pipeline", "fan_in"])
def test_dag_fleet_sim_matches_reference_records(shape):
    """The DAG event engine on the same arrivals and seed: every stage's
    job records within rtol 1e-5, and the same DAG-level stats."""

    def run(m, d):
        keep, base = m.SingleForkPolicy(0.2, 1, True), m.SingleForkPolicy(0.0, 0, True)
        if shape == "pipeline":
            dag = d.JobDAG.map_reduce(8, 4, m.ShiftedExp(1.0, 1.0), m.ShiftedExp(0.5, 2.0),
                                      map_policy=keep, c_map=2, c_reduce=2)
        else:
            dag = d.JobDAG([
                d.StageSpec("m1", 4, m.ShiftedExp(1.0, 1.0), keep, c=2),
                d.StageSpec("m2", 4, m.ShiftedExp(0.5, 2.0), c=2),
                d.StageSpec("r", 2, m.ShiftedExp(0.5, 2.0), base, deps=("m1", "m2")),
            ])
        return d.DagFleetSim(d.DagFleetConfig(dag, seed=2)).run(d.poisson_arrivals(120, 0.25, seed=5))

    ref, got = run(jcore, jdag), run(tcore, tdag)
    for name in ref.stage_records:
        _same_records(ref.stage_records[name], got.stage_records[name])
    np.testing.assert_allclose([j.finish for j in got.jobs], [j.finish for j in ref.jobs], rtol=1e-5)
    for name, share in ref.critical_path_shares.items():
        assert got.critical_path_shares[name] == pytest.approx(share, abs=1e-5)
    assert sum(got.critical_path_shares.values()) == pytest.approx(1.0)


def test_event_engine_refuses_samples_on_another_device():
    """The event engine draws on the host: an Empirical whose samples lie
    elsewhere is refused, not copied back at every draw."""
    emp = tcore.Empirical(np.arange(1.0, 20.0))
    emp.sorted = emp.sorted.to("meta")
    jobs = tfleet.poisson_workload(3, rate=0.5, n_tasks=2, dist=emp, seed=0)
    with pytest.raises(ValueError, match="host"):
        tfleet.FleetSim(tfleet.FleetConfig(capacity=4)).run(jobs)


# ------------------------------------- fused engines against the events
def test_port_kw_frontier_agrees_with_port_event_engine_c3():
    """The port's `kw_event_agreement_c3`: c = 3 gang blocks under aligned
    placement are the Kiefer–Wolfowitz model the fused frontier runs."""
    pol = tcore.SingleForkPolicy(0.2, 1, True)
    n, n_jobs, lam, c = 10, 200, 0.45, 3
    soj, cost = [], []
    for seed in range(6):
        jobs = tfleet.poisson_workload(n_jobs, rate=lam, n_tasks=n, dist=tcore.ShiftedExp(1.0, 1.0), seed=seed)
        rep = tfleet.FleetSim(
            tfleet.FleetConfig(capacity=c * n, policy=pol, seed=seed, placement="aligned")
        ).run(jobs)
        soj.append(rep.stats.mean_sojourn)
        cost.append(rep.stats.mean_cost)
    row = vector.frontier(tcore.ShiftedExp(1.0, 1.0), [pol], (lam,), n, n_jobs, m_trials=32, c=c, device=CPU)[0]
    se = float(np.hypot(np.std(soj) / np.sqrt(len(soj)), row["sojourn_std_err"]))
    assert abs(np.mean(soj) - row["mean_sojourn"]) < 5 * se + 0.05
    assert abs(np.mean(cost) - row["mean_cost"]) < 0.1
    assert 0.0 < row["mean_wait"] < row["mean_sojourn"]


def test_port_fused_dag_agrees_with_port_event_engine():
    """The port's `dag_fused_vs_event_agreement` on a slice of
    benchmarks/bench_dag.py's grid: E[T] within 5σ, E[C] within 0.1."""
    dag = tdag.JobDAG.map_reduce(8, 4, tcore.ShiftedExp(1.0, 1.0), tcore.ShiftedExp(0.5, 2.0), c_map=2, c_reduce=2)
    base = tcore.SingleForkPolicy(0.0, 0, True)
    vecs = [(tcore.SingleForkPolicy(0.2, 1, True), base),
            (tcore.SingleForkPolicy(0.25, 1, False), tcore.SingleForkPolicy(0.25, 1, True))]
    lams = (0.2, 0.4)
    fused = tdag.dag_frontier(dag, vecs, lams, 400, m_trials=12, seed=17, r_caps=(2, 2), device=CPU)
    for row, (vec, lam) in zip(fused, [(v, lam) for v in vecs for lam in lams]):
        st = tdag.DagFleetSim(tdag.DagFleetConfig(dag, policies=vec)).run(
            tdag.poisson_arrivals(400, lam, seed=int(lam * 1e3))).stats
        sigma = max(float(np.hypot(row["sojourn_std_err"], st.sojourn_std_err)), 1e-12)
        assert abs(row["mean_sojourn"] - st.mean_sojourn) / sigma < 5.0
        assert abs(row["mean_cost"] - st.mean_cost) < 0.1


# ---------------------------------------------------- the controller
def _mini_controller(**kw):
    kw.setdefault("min_samples", 48)
    kw.setdefault("reoptimize_every", 10)
    kw.setdefault("recent_window", 96)
    kw.setdefault("arrival_window", 24)
    kw.setdefault("search_jobs", 128)
    kw.setdefault("search_trials", 6)
    kw.setdefault("epsilon", 0.0)
    kw.setdefault("seed", 5)
    kw.setdefault("device", CPU)
    return tfleet.FleetPolicyController(**kw)


def test_controller_replans_and_converges_on_a_stationary_workload():
    jobs = tfleet.poisson_workload(160, rate=0.5, n_tasks=8, dist=tcore.ShiftedExp(1.0, 1.0), seed=4)
    sim = tfleet.FleetSim(tfleet.FleetConfig(capacity=24, adapt=True, seed=4, device=CPU))
    sim.controller = _mini_controller()
    rep = sim.run(jobs)
    ctrl = rep.controller
    assert len(ctrl.history) >= 3
    assert abs(ctrl.lam_estimate() - 0.5) < 0.3
    assert len({d.policy.label() for d in ctrl.history[-3:]}) <= 2
    assert ctrl.job_n == 8 and ctrl.capacity == 24
    assert [e.kind for e in ctrl.decisions.events].count("replan") == len(ctrl.history)


def test_controller_drift_fires_and_beats_the_best_fixed_policy():
    """The reference's regime-shift behaviours (tests/test_fleet_adaptive.py,
    benchmarks/bench_fleet.py): the KS drift test fires across the shift,
    re-plans follow it, replication backs off after it, and the adaptive
    fleet's mean sojourn beats the best fixed policy tuned on the first
    regime."""
    sc = tfleet.REGIME_SHIFT
    n_jobs = 500
    jobs = sc.workload(n_jobs)
    pre_jobs = jobs[: sc.shift_index(n_jobs)]
    best_pre, best_full = float("inf"), None
    for pol in sc.fixed_grid:
        pre = tfleet.FleetSim(tfleet.FleetConfig(capacity=sc.capacity, policy=pol, seed=sc.seed)).run(pre_jobs)
        if pre.stats.mean_sojourn < best_pre:
            best_pre = pre.stats.mean_sojourn
            best_full = tfleet.FleetSim(
                tfleet.FleetConfig(capacity=sc.capacity, policy=pol, seed=sc.seed)
            ).run(jobs).stats.mean_sojourn
    rep = tfleet.FleetSim(tfleet.FleetConfig(capacity=sc.capacity, adapt=True, seed=sc.seed, device=CPU)).run(jobs)
    ctrl = rep.controller
    assert ctrl.n_drifts >= 1
    assert any(d.trigger == "drift" for d in ctrl.history)
    pre = [d.policy for d in ctrl.history if d.lam_hat < 0.5]
    post = [d.policy for d in ctrl.history if d.lam_hat > 0.8]
    assert pre and post and any(not p.is_baseline for p in pre)

    def budget(pol):
        return 0.0 if pol.is_baseline else pol.p * (pol.r + (0 if pol.keep else 1))

    assert budget(post[-1]) < max(budget(p) for p in pre)
    assert ctrl.history[-1].rho < 1.0
    assert rep.stats.mean_sojourn < best_full


def test_controller_rho_guard_and_search_seed():
    """`_choose` vetoes the finite-horizon trap the port's policy_search
    scores, and re-plans pass integer seeds from the controller's stream."""
    rng = np.random.default_rng(6)
    x = np.asarray(tcore.ShiftedExp(1.0, 1.0).quantile(rng.random(512)))
    cands = [tcore.BASELINE, tcore.SingleForkPolicy(0.1, 1, True), tcore.SingleForkPolicy(0.9, 2, False)]
    rows = vector.policy_search(x, cands, lam=0.225, n=16, n_jobs=256, m_trials=8, c=1, device=CPU)
    tempting = min(rows, key=lambda r: r["mean_sojourn"])
    assert tempting["rho"] >= 1.0
    ctrl = _mini_controller()
    pick = ctrl._choose(rows, 16)
    assert pick["rho"] < ctrl.rho_max
    assert pick["policy"] == tcore.SingleForkPolicy(0.1, 1, True)
    a, b = _mini_controller(seed=3), _mini_controller(seed=3)
    assert [a._search_seed() for _ in range(3)] == [b._search_seed() for _ in range(3)]
    assert all(isinstance(s, int) for s in (a._search_seed(),))


def test_fleet_config_builds_its_controller_on_the_given_device():
    jobs = tfleet.poisson_workload(5, rate=0.2, n_tasks=4, dist=tcore.ShiftedExp(1.0, 1.0), seed=0)
    fleet = tfleet.FleetSim(tfleet.FleetConfig(capacity=8, adapt=True, seed=0, device=CPU))
    assert isinstance(fleet.controller, tfleet.FleetPolicyController)
    assert fleet.controller.device.type == "cpu"
    legacy = tfleet.FleetSim(tfleet.FleetConfig(capacity=8, adapt=True, adapt_mode="online", seed=0, device=CPU))
    assert isinstance(legacy.controller, tcore.OnlinePolicyController)
    legacy.run(jobs)
    assert tfleet.as_policy_provider(fleet.controller) is fleet.controller
    with pytest.raises(ValueError, match="adapt_mode"):
        tfleet.FleetSim(tfleet.FleetConfig(capacity=8, adapt=True, adapt_mode="nope"))
