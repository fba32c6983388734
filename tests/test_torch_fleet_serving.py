"""The port's fleet-backed serving (`repro_torch.runtime.FleetHedgedServer`,
`BatchOutcome`) against the JAX package's, on the CPU.

Each test is one of the reference's serving tests (tests/test_fleet.py,
test_fleet_adaptive.py, test_faults.py, test_dag.py,
test_policy_algebra.py, test_obs.py, test_tail_observatory.py), run on
both packages with the same seeds: the reference's assertions hold on the
port, and the two servers' outcomes agree.

Both event engines run on the host with numpy's generators, so the
outcomes (arrival, start, finish, cost) agree within rtol 1e-5, atol 1e-6
(the float32 rounding of the quantile transforms, as in
tests/test_torch_events.py), and values, failure flags and reasons are
equal.  With `adapt=True` the controller's event stream is the
reference's but its policy search draws torch's random numbers, so the two
runs are the same only until the first re-plan: there the outcomes that
finished before it are compared, and the 19-batch cases below hold the
whole run (outcomes, `serve.*` counters, SLO gauges and reports,
per-priority tails, the private trace's spans) within rtol 1e-5.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as jcore
import repro.dag as jdag
import repro.faults as jfaults
import repro.fleet as jfleet
import repro.obs as jobs
import repro.runtime as jruntime
from repro_torch import core as tcore
from repro_torch import dag as tdag
from repro_torch import faults as tfaults
from repro_torch import fleet as tfleet
from repro_torch import obs as tobs
from repro_torch import runtime as truntime

REF = SimpleNamespace(core=jcore, dag=jdag, faults=jfaults, fleet=jfleet, obs=jobs,
                      Server=jruntime.FleetHedgedServer, kw={})
PORT = SimpleNamespace(core=tcore, dag=tdag, faults=tfaults, fleet=tfleet, obs=tobs,
                       Server=truntime.FleetHedgedServer, kw={"device": "cpu"})
RTOL, ATOL = 1e-5, 1e-6


def _serve(make, batches, **stream):
    """(server, outcomes, stats) of each package: `make(m)` builds the
    server from package namespace `m`, then it serves `batches`."""
    out = {}
    for key, m in (("ref", REF), ("port", PORT)):
        srv = make(m)
        outcomes, stats = srv.serve_stream(batches, **stream)
        out[key] = (srv, outcomes, stats)
    return out


def _first_replan(srv) -> float:
    ctrl = srv.controller
    history = getattr(ctrl, "history", None) if ctrl is not None else None
    return history[0].t if history else math.inf


def _row(o):
    return [o.arrival, o.start, o.finish, o.cost]


def _close(a, b):
    """Nested dicts / lists of numbers equal within RTOL (NaN == NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (float, int)) and not isinstance(a, bool):
        assert b == pytest.approx(a, rel=RTOL, abs=ATOL, nan_ok=True)
    else:
        assert a == b


def _agree(run) -> int:
    """The outcomes of both packages agree up to the first re-plan of
    either controller (all of them without one); with no re-plan the
    serving registry, tails and SLO reports agree too.  Returns how many
    outcomes were compared."""
    (rs, ro, rst), (ps, po, pst) = run["ref"], run["port"]
    assert len(po) == len(ro)
    cut = min(_first_replan(rs), _first_replan(ps))
    pairs = [(a, b) for a, b in zip(ro, po) if max(a.finish, b.finish) < cut]
    if cut == math.inf:
        assert len(pairs) == len(ro)
    assert pairs
    np.testing.assert_allclose([_row(b) for _, b in pairs], [_row(a) for a, _ in pairs], rtol=RTOL, atol=ATOL)
    for a, b in pairs:
        assert (b.values, b.failed, b.failure) == (a.values, a.failed, a.failure)
    if cut == math.inf:
        _close(rs.metrics.collect(), ps.metrics.collect())
        _close(rs.tail_latencies(), ps.tail_latencies())
        _close(rs.slo_report(), ps.slo_report())
        for key in ("n_jobs", "mean_sojourn", "mean_cost", "availability", "failed_job_share"):
            if hasattr(rst, key):  # a DAG's stats have no availability keys
                _close(getattr(rst, key), getattr(pst, key))
    return len(pairs)


def _shifted(m, delta, mu):
    return m.core.ShiftedExp(delta, mu)


# ------------------------------------------------- tests/test_fleet.py
def test_values_and_stats():
    run = _serve(lambda m: m.Server(capacity=32, latency_dist=_shifted(m, 0.01, 20.0), serve_fn=lambda r: r * 2,
                                    adapt=False, seed=1, **m.kw),
                 [list(range(i, i + 8)) for i in range(6)], rate=5.0, seed=2)
    _, outcomes, stats = run["port"]
    assert [o.values for o in outcomes] == [[2 * r for r in range(i, i + 8)] for i in range(6)]
    assert stats.n_jobs == 6
    assert all(o.finish >= o.start >= o.arrival for o in outcomes)
    assert all(isinstance(o, truntime.BatchOutcome) for o in outcomes)
    assert _agree(run) == 6


def test_class_mix_and_its_errors():
    def make(m, **kw):
        classes = (m.fleet.MachineClass("gpu", 16, 1.0), m.fleet.MachineClass("spot", 8, 0.5))
        return m.Server(latency_dist=_shifted(m, 0.01, 20.0), serve_fn=lambda r: r + 1, adapt=False, seed=1,
                        classes=classes, placement="aligned", **m.kw, **kw)

    run = _serve(make, [list(range(i, i + 8)) for i in range(6)], rate=5.0, seed=2)
    srv, outcomes, stats = run["port"]
    assert srv.capacity == 24
    assert [o.values for o in outcomes] == [[r + 1 for r in range(i, i + 8)] for i in range(6)]
    assert set(stats.class_utilization) == {"gpu", "spot"}
    assert stats.class_job_share["gpu"] + stats.class_job_share["spot"] == pytest.approx(1.0)
    _close(run["ref"][2].class_job_share, stats.class_job_share)
    _close(run["ref"][2].class_utilization, stats.class_utilization)
    assert _agree(run) == 6

    msgs = []
    for m in (REF, PORT):
        with pytest.raises(ValueError, match="capacity or classes") as no_pool:
            m.Server(serve_fn=lambda r: r, **m.kw)
        with pytest.raises(ValueError, match="required") as no_dist:
            m.Server(capacity=8, serve_fn=lambda r: r, **m.kw)
        aligned = m.Server(capacity=16, latency_dist=_shifted(m, 0.01, 20.0), serve_fn=lambda r: r,
                           preempt_replicas=True, placement="aligned", **m.kw)
        with pytest.raises(ValueError, match="aligned") as preempt:
            aligned.serve_stream([[1, 2]], rate=1.0)
        msgs.append([str(e.value) for e in (no_pool, no_dist, preempt)])
    assert msgs[1] == msgs[0]


def test_stream_argument_errors_equal_the_reference():
    msgs = []
    for m in (REF, PORT):
        srv = m.Server(capacity=8, latency_dist=_shifted(m, 0.01, 20.0), serve_fn=lambda r: r, adapt=False, **m.kw)
        got = []
        for kw in (dict(arrivals=[0.0]), dict(priorities=[0])):
            with pytest.raises(ValueError) as e:
                srv.serve_stream([[1], [2]], **kw)
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[1] == msgs[0] == ["need one arrival time per batch", "need one priority per batch"]


# ---------------------------------------- tests/test_fleet_adaptive.py
def test_adaptive_mode():
    run = _serve(lambda m: m.Server(capacity=32, latency_dist=_shifted(m, 0.01, 20.0), serve_fn=lambda r: r * 3,
                                    adapt=True, seed=1, **m.kw),
                 [list(range(i, i + 8)) for i in range(10)], rate=5.0, seed=2)
    srv, outcomes, _ = run["port"]
    assert isinstance(srv.controller, tfleet.FleetPolicyController)
    assert srv.controller.device.type == "cpu"
    assert [o.values for o in outcomes] == [[3 * r for r in range(i, i + 8)] for i in range(10)]
    assert srv.controller.n_samples > 0
    assert srv.controller.n_samples == run["ref"][0].controller.n_samples
    assert _agree(run) == 10


# ------------------------------------------------- tests/test_faults.py
def test_deadlines_shed_and_failed_outcomes():
    def make(m):
        return m.Server(capacity=4, latency_dist=_shifted(m, 1.0, 2.0), serve_fn=lambda r: r + 1, adapt=False,
                        seed=3, deadlines={1: 0.75}, fault=m.faults.FaultSpec(q=0.1), shed_rho=0.5, **m.kw)

    batches = [[i, i + 1] for i in range(60)]
    run = _serve(make, batches, rate=4.0, seed=3, priorities=[i % 2 for i in range(60)])
    srv, outcomes, stats = run["port"]
    assert len(outcomes) == 60
    assert any(o.failed for o in outcomes)
    for o, batch in zip(outcomes, batches):
        if o.failed:
            assert o.values == [] and o.failure in ("timeout", "shed", "max_attempts")
        else:
            assert o.values == [b + 1 for b in batch]
    assert 0.0 <= stats.failed_job_share <= 1.0
    assert any(k.startswith("serve.") for k in srv.metrics.collect())
    assert _agree(run) == 60


def test_degradation_metrics_reach_the_registry():
    run = _serve(lambda m: m.Server(capacity=4, latency_dist=_shifted(m, 1.0, 2.0), serve_fn=lambda r: r,
                                    adapt=False, seed=5, deadlines={0: 0.5}, **m.kw),
                 [[1]] * 40, rate=6.0, seed=5)
    srv = run["port"][0]
    assert srv.metrics.gauge("fleet.availability").value == pytest.approx(1.0)
    assert srv.metrics.counter("serve.timeout").value > 0
    assert srv.metrics.counter("serve.timeout").value == run["ref"][0].metrics.counter("serve.timeout").value
    assert _agree(run) == 40


# ---------------------------------------------------- tests/test_dag.py
def _two_stage(m):
    keep = m.core.SingleForkPolicy(0.2, 1, True)
    return m.dag.JobDAG.map_reduce(8, 4, _shifted(m, 1.0, 1.0), _shifted(m, 0.5, 2.0), map_policy=keep,
                                   reduce_policy=m.core.SingleForkPolicy(0.0, 0, True), c_map=2, c_reduce=2)


def test_dag_mode_and_its_errors():
    run = _serve(lambda m: m.Server(dag=_two_stage(m), serve_fn=lambda r: r * 2, **m.kw),
                 [[1, 2, 3]] * 20, rate=0.3, seed=0)
    srv, outcomes, stats = run["port"]
    assert srv.controller is None and srv.capacity == run["ref"][0].capacity
    assert [o.values for o in outcomes] == [[2, 4, 6]] * 20
    assert all(o.finish >= o.start >= o.arrival for o in outcomes)
    assert sum(stats.critical_path_shares.values()) == pytest.approx(1.0)
    _close(run["ref"][2].critical_path_shares, stats.critical_path_shares)
    assert _agree(run) == 20

    bad = [dict(capacity=8), dict(policy="keep"), dict(adapt=False), dict(placement="aligned"),
           dict(deadlines={0: 1.0}), dict(shed_rho=0.5), dict(latency_dist="dist")]
    msgs = []
    for m in (REF, PORT):
        dag = _two_stage(m)
        got = []
        for kw in bad:
            if kw.get("policy"):
                kw = dict(policy=m.core.SingleForkPolicy(0.2, 1, True))
            with pytest.raises(ValueError) as e:
                m.Server(dag=dag, serve_fn=lambda r: r, **kw, **m.kw)
            got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            m.Server(dag=dag, **m.kw)
        got.append(str(e.value))
        msgs.append(got)
    assert msgs[1] == msgs[0]
    assert all("stage specs" in s or "single-pool" in s for s in msgs[1][:-1])
    assert msgs[1][-1] == "serve_fn is required"


# ------------------------------------------- tests/test_policy_algebra.py
@pytest.mark.parametrize("which", ["relaunch", "group"])
def test_accepts_algebra_policies(which):
    def make(m):
        pol = (m.core.delayed_relaunch(0.5, r=1, keep=True) if which == "relaunch"
               else m.core.group_replication(0.25, 1, 4))
        return m.Server(capacity=24, latency_dist=_shifted(m, 0.01, 20.0), serve_fn=lambda r: r * 3, policy=pol,
                        adapt=False, seed=1, **m.kw)

    run = _serve(make, [list(range(i, i + 8)) for i in range(5)], rate=5.0, seed=2)
    _, outcomes, stats = run["port"]
    assert [o.values for o in outcomes] == [[3 * r for r in range(i, i + 8)] for i in range(5)]
    assert stats.n_jobs == 5
    assert all(o.finish >= o.start >= o.arrival for o in outcomes)
    assert _agree(run) == 5


# ---------------------------------------------------- tests/test_obs.py
def test_per_class_tails():
    run = _serve(lambda m: m.Server(capacity=32, latency_dist=_shifted(m, 1.0, 0.5), serve_fn=lambda r: r,
                                    seed=0, **m.kw),
                 [list(range(4))] * 120, rate=1.5, priorities=[i % 3 for i in range(120)])
    srv = run["port"][0]
    tails = srv.tail_latencies()
    assert set(tails) == {0, 1, 2}
    assert sum(t["count"] for t in tails.values()) == 120
    for t in tails.values():
        assert t["p50"] <= t["p99"] <= t["p999"]
    assert len(srv.controller.history) >= 1
    assert _agree(run) >= 19


# ---------------------------------------- tests/test_tail_observatory.py
def _slo(m, name, windows):
    return m.obs.SLO(name, threshold=25.0, quantile=0.99, windows=windows)


def test_slo_wiring():
    run = _serve(lambda m: m.Server(capacity=32, latency_dist=_shifted(m, 1.0, 0.5), serve_fn=lambda r: r, seed=0,
                                    slos=_slo(m, "batch-p99", (16.0, 64.0)), **m.kw),
                 [list(range(4))] * 60, rate=1.5, priorities=[i % 2 for i in range(60)])
    srv = run["port"][0]
    rep = srv.slo_report()
    assert set(rep) == {0, 1}
    for r in rep.values():
        assert r["slo"] == "batch-p99" and r["count"] > 0
        assert set(r["burn_rates"]) == {"16.0", "64.0"}
    snap = srv.metrics.collect()
    assert any(k.startswith("slo.burn_rate{") for k in snap)
    assert any(k.startswith("slo.burning{") for k in snap)
    assert _agree(run) >= 19


def test_slo_per_priority_mapping():
    run = _serve(lambda m: m.Server(capacity=32, latency_dist=_shifted(m, 1.0, 0.5), serve_fn=lambda r: r, seed=0,
                                    slos={0: _slo(m, "gold", (16.0,))}, **m.kw),
                 [[1, 2]] * 30, rate=2.0, priorities=[i % 2 for i in range(30)])
    assert set(run["port"][0].slo_report()) == {0}  # priority 1 has no SLO: untracked
    assert _agree(run) >= 19


# ------------------------------- adapt=True over 19 batches: the whole run
@pytest.mark.parametrize("case", ["tails", "slo", "slo_map"])
def test_adaptive_servers_agree_over_19_batches(case):
    """The three adapt=True tests above, cut to 19 batches (the controller
    first re-plans at its 20th job): the whole run agrees, registry, tails,
    SLO reports and the private recorder's spans included."""
    n = 19
    slos = {"tails": lambda m: None, "slo": lambda m: _slo(m, "batch-p99", (16.0, 64.0)),
            "slo_map": lambda m: {0: _slo(m, "gold", (16.0,))}}[case]
    width, pris, rate = {"tails": (4, 3, 1.5), "slo": (4, 2, 1.5), "slo_map": (2, 2, 2.0)}[case]
    run = _serve(lambda m: m.Server(capacity=32, latency_dist=_shifted(m, 1.0, 0.5), serve_fn=lambda r: r, seed=0,
                                    slos=slos(m), obs=True, **m.kw),
                 [list(range(width))] * n, rate=rate, priorities=[i % pris for i in range(n)])
    assert _agree(run) == n
    ref, port = run["ref"][0], run["port"][0]
    assert not port.controller.history and not ref.controller.history
    assert isinstance(port._rec, tobs.Recorder)
    spans = [[(s.name, s.pid, s.tid) for s in srv._rec.spans] for srv in (ref, port)]
    assert spans[1] == spans[0] and spans[1]
    burns = [[i.args for i in srv._rec.instants if i.name == "slo_burn"] for srv in (ref, port)]
    _close({"burns": dict(enumerate(burns[0]))}, {"burns": dict(enumerate(burns[1]))})
