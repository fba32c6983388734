"""The port's fused frontier engine (`repro_torch.fleet.vector`) against the
JAX reference, and the reference's contracts re-established inside the port.

Deterministic pieces (the empirical gather, the retry transform, the
one-queue KW loop, the masked single-fork evaluator, the slot geometry) are
held on shared numpy inputs.  Sampled estimators — frontier rows on the
grids of tests/test_frontier.py, `fleet_rollout`, `trace_kill_rollout` —
are held within the reference's Monte-Carlo bound,
|Δ mean_sojourn| / hypot(stderr) < 5, since the generators differ.  The
bitwise contracts (q=0 ≡ fault=None, single-fork cells of a mixed grid,
chunk size, pad_cells, policy_search ≡ frontier) are restated on the port
alone.  Everything runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.faults import FaultSpec as JFaultSpec
from repro.fleet import MachineClass as JMachineClass
from repro.fleet import vector as jv
from repro_torch import core as tcore
from repro_torch.faults import FaultSpec
from repro_torch.fleet import MachineClass, vector

CPU = "cpu"
N, N_JOBS, M_TRIALS = 8, 200, 24
LAMS = (0.08, 0.16)
X_EMP = np.random.default_rng(0).exponential(1.0, 400) + 1.0


def _pols(m):
    return (
        m.SingleForkPolicy(0.0, 0, True),
        m.SingleForkPolicy(0.1, 1, True),
        m.SingleForkPolicy(0.2, 1, False),
    )


def _mixed(m):
    return (
        m.group_replication(0.25, 1, 4),
        m.delayed_relaunch(2.0, 1),
        m.MultiForkPolicy(((0.25, 1, True), (0.125, 1, False))),
    )


def _agree(port_rows, ref_rows):
    """Same cells and keys; mean sojourn within 5 combined standard errors."""
    assert [(r["policy"], r["lam"]) for r in port_rows] == [
        (r["policy"], pytest.approx(r["lam"])) for r in ref_rows
    ]
    for a, b in zip(port_rows, ref_rows):
        assert set(a) == set(b)
        sigma = max(float(np.hypot(a["sojourn_std_err"], b["sojourn_std_err"])), 1e-12)
        assert abs(a["mean_sojourn"] - b["mean_sojourn"]) / sigma < 5.0, a["policy"]
        assert a["mean_cost"] == pytest.approx(b["mean_cost"], abs=0.1)


# ------------------------------------------------- deterministic pieces
def test_emp_quantile_and_retry_transform_match_reference():
    xs = np.sort(X_EMP[:97]).astype(np.float32)
    u = np.random.default_rng(1).random((64, 5), dtype=np.float32)
    u[0, :3] = (0.0, 1.0, 1.0 / 97)
    np.testing.assert_array_equal(
        vector.emp_quantile(torch.from_numpy(xs), torch.from_numpy(u)).numpy(),
        np.asarray(jv.emp_quantile(jnp.asarray(xs), jnp.asarray(u))),
    )
    rng = np.random.default_rng(2)
    x = (1.0 + rng.exponential(1.0, (50, 4))).astype(np.float32)
    v = rng.random((50, 3), dtype=np.float32)
    for q in (0.0, 0.3, 0.9):
        np.testing.assert_allclose(
            vector.retry_transform(torch.from_numpy(x), torch.from_numpy(v), q).numpy(),
            np.asarray(jv.retry_transform(jnp.asarray(x), jnp.asarray(v), q)), rtol=1e-6,
        )


def test_one_queue_kw_loop_matches_reference_scan():
    rng = np.random.default_rng(3)
    arr = np.cumsum(rng.exponential(2.0, 120)).astype(np.float32)
    svc = (0.5 + rng.exponential(1.0, 120)).astype(np.float32)
    speeds = np.array([1.5, 1.0, 0.5], np.float32)
    outs = vector.kw_queue(*(torch.from_numpy(z) for z in (arr, svc, speeds)))
    ref = jv.kw_queue(*(jnp.asarray(z) for z in (arr, svc, speeds)))
    for a, b in zip(outs[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(outs[3].numpy(), np.asarray(ref[3]))


def test_masked_single_fork_matches_reference_on_shared_draws():
    rng = np.random.default_rng(4)
    x_sorted = np.sort(1.0 + rng.exponential(1.0, (32, 10)), axis=-1).astype(np.float32)
    fresh = (1.0 + rng.exponential(1.0, (32, 10, 3))).astype(np.float32)
    k = np.array([10, 9, 7, 8, 5], np.int32)
    r = np.array([0, 1, 2, 0, 1], np.int32)
    keep = np.array([True, True, False, False, True])
    ev = jax.vmap(jv.masked_single_fork, in_axes=(None, None, 0, 0, 0))
    T_ref, C_ref = ev(*(jnp.asarray(z) for z in (x_sorted, fresh, k, r, keep)))
    T, C = vector.masked_single_fork(*(torch.from_numpy(z) for z in (x_sorted, fresh, k, r, keep)))
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), rtol=1e-5)
    np.testing.assert_allclose(C.numpy(), np.asarray(C_ref), rtol=1e-5)
    T1, C1 = vector.masked_single_fork(torch.from_numpy(x_sorted), torch.from_numpy(fresh), 7, 2, False)
    assert torch.equal(T1, T[2]) and torch.equal(C1, C[2])


def test_slot_geometry_matches_reference():
    mix = (MachineClass("fast", 16, 1.0), MachineClass("slow", 24, 0.5))
    jmix = (JMachineClass("fast", 16, 1.0), JMachineClass("slow", 24, 0.5))
    for args, jargs in (((8, None, mix), (8, None, jmix)), ((8, 3, None), (8, 3, None))):
        got = vector._slot_arrays(*args, CPU)
        want = jv._slot_arrays(*jargs)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert got[3] == want[3]
    assert vector._slot_arrays(8, 1, None, CPU) is None
    with pytest.raises(ValueError, match="multiple"):
        vector._slot_arrays(8, None, (MachineClass("a", 12),), CPU)


# ------------------------------------- sampled estimators vs the reference
@pytest.mark.parametrize(
    "case", ["analytic", "empirical", "c3", "two_class", "mixed_families", "faulty"]
)
def test_frontier_matches_reference_within_mc_error(case):
    dist, jdist = tcore.ShiftedExp(1.0, 1.0), jcore.ShiftedExp(1.0, 1.0)
    pols, jpols, lams, kw, jkw = _pols(tcore), _pols(jcore), LAMS, {}, {}
    if case == "empirical":
        dist, jdist, lams = tcore.Empirical(X_EMP), jcore.Empirical(X_EMP), (0.3,)
    elif case == "c3":
        pols, jpols, lams, kw, jkw = pols[:2], jpols[:2], (0.4,), dict(c=3), dict(c=3)
    elif case == "two_class":
        pols, jpols, lams = pols[:2], jpols[:2], (0.4,)
        kw = dict(classes=(MachineClass("fast", 2 * N, 1.0), MachineClass("slow", 2 * N, 0.5)))
        jkw = dict(classes=(JMachineClass("fast", 2 * N, 1.0), JMachineClass("slow", 2 * N, 0.5)))
    elif case == "mixed_families":
        pols, jpols, lams = _mixed(tcore), _mixed(jcore), (0.1,)
    elif case == "faulty":
        pols, jpols, lams = pols[1:], jpols[1:], (0.1,)
        kw, jkw = dict(fault=FaultSpec(q=0.2)), dict(fault=JFaultSpec(q=0.2))
    port = vector.frontier(dist, pols, lams, N, N_JOBS, m_trials=M_TRIALS, seed=1, device=CPU, **kw)
    ref = jv.frontier(jdist, jpols, lams, N, N_JOBS, m_trials=M_TRIALS, key=jax.random.PRNGKey(1), **jkw)
    _agree(port, ref)
    if case == "two_class":
        assert "util_fast" in port[0] and "util_slow" in port[0]


@pytest.mark.parametrize("c", [None, 2])
def test_trace_kill_rollout_matches_reference_within_mc_error(c):
    pol_t, pol_j = tcore.SingleForkPolicy(0.25, 2, False), jcore.SingleForkPolicy(0.25, 2, False)
    port = vector.trace_kill_rollout(X_EMP, pol_t, 0.15, N, N_JOBS, M_TRIALS, seed=2, c=c, device=CPU)
    ref = jv.trace_kill_rollout(X_EMP, pol_j, 0.15, N, N_JOBS, M_TRIALS, key=jax.random.PRNGKey(2), c=c)
    sigma = np.hypot(port.sojourn_std_err, ref.sojourn_std_err)
    assert abs(port.mean_sojourn - ref.mean_sojourn) / sigma < 5.0
    assert port.mean_cost == pytest.approx(ref.mean_cost, rel=0.05)
    assert set(port.summary()) == set(ref.summary())


@pytest.mark.parametrize("c", [None, 3])
def test_fleet_rollout_matches_reference_within_mc_error(c):
    pol_t, pol_j = tcore.SingleForkPolicy(0.25, 1, True), jcore.SingleForkPolicy(0.25, 1, True)
    port = vector.fleet_rollout(tcore.ShiftedExp(1.0, 1.0), pol_t, 0.2, N, N_JOBS, M_TRIALS, seed=3, c=c, device=CPU)
    ref = jv.fleet_rollout(jcore.ShiftedExp(1.0, 1.0), pol_j, 0.2, N, N_JOBS, M_TRIALS, key=jax.random.PRNGKey(3), c=c)
    sigma = np.hypot(port.sojourn_std_err, ref.sojourn_std_err)
    assert abs(port.mean_sojourn - ref.mean_sojourn) / sigma < 5.0
    assert set(port.summary()) == set(ref.summary())


# -------------------------------------------- contracts inside the port
DIST = tcore.ShiftedExp(1.0, 1.0)
POLICIES = _pols(tcore)


def _front(pols=POLICIES, lams=(0.1,), **kw):
    kw.setdefault("m_trials", 8)
    return vector.frontier(DIST, pols, lams, N, 100, seed=5, device=CPU, **kw)


def test_q0_fault_spec_is_fault_none_bitwise():
    plain = _front(lams=LAMS)
    q0 = _front(lams=LAMS, fault=FaultSpec(q=0.0))
    for a, b in zip(plain, q0):
        assert b.pop("q") == 0.0
        assert a == b


def test_single_fork_cells_of_a_mixed_grid_are_bitwise_the_single_fork_program():
    """A group cell sends the grid through the general evaluator; its
    single-fork cells stay bit for bit what the single-fork program gives."""
    alone = _front()
    mixed = _front(pols=POLICIES + (tcore.group_replication(0.25, 1, 4),))
    assert mixed[:3] == alone


@pytest.mark.parametrize("kind", ["single_fork", "general", "faulty"])
def test_cell_chunk_size_changes_no_result(kind):
    pols, kw = POLICIES, {}
    if kind == "general":
        pols = POLICIES + _mixed(tcore)
    if kind == "faulty":
        kw = dict(cell_qs=[0.0, 0.1, 0.3], attempts=4)
    cells = list(pols) if kind != "faulty" else list(POLICIES)
    lams = [0.1] * len(cells)
    args = (DIST, cells, lams, N, 100, 8, 5, 2, None, False, None, True)
    whole = vector._eval_cells(*args, device=CPU, **kw)
    one_by_one = vector._eval_cells(*args, device=CPU, cell_chunk=1, **kw)
    assert whole == one_by_one
    assert vector.cell_chunk_size(8, 100, N, 2, 1, kind == "general") >= len(cells)


def test_pad_cells_changes_no_result():
    assert _front(lams=LAMS, pad_cells=True) == _front(lams=LAMS, pad_cells=False)
    assert vector.cell_bucket(3) == 8 and vector.cell_bucket(9) == 16


def test_policy_search_is_the_frontier_at_one_lambda():
    search = vector.policy_search(X_EMP, POLICIES, lam=0.3, n=N, n_jobs=100, m_trials=8, seed=9, device=CPU)
    front = vector.frontier(X_EMP, POLICIES, (0.3,), N, 100, m_trials=8, seed=9, device=CPU)
    for s, f in zip(search, front):
        assert s["policy"] in POLICIES and s["label"] == f["policy"]
        assert {k: v for k, v in s.items() if k not in ("policy", "label")} == {
            k: v for k, v in f.items() if k not in ("policy", "lam")
        }


def test_engine_entry_points_agree_with_each_other():
    # sweep is a frontier wrapper; raw samples and Empirical(samples) are
    # one path; kernel=True at c=1 (the KW queue) ≡ Lindley to 1e-5
    s = vector.sweep(DIST, POLICIES, LAMS, N, 100, m_trials=8, seed=7, device=CPU)
    assert s == vector.frontier(DIST, POLICIES, LAMS, N, 100, m_trials=8, seed=7, device=CPU)
    a = vector.frontier(X_EMP, POLICIES, (0.3,), N, 100, m_trials=8, seed=8, device=CPU)
    b = vector.frontier(tcore.Empirical(X_EMP), POLICIES, (0.3,), N, 100, m_trials=8, seed=8, device=CPU)
    assert a == b
    for x, y in zip(_front(), _front(kernel=True)):
        assert x["mean_sojourn"] == pytest.approx(y["mean_sojourn"], rel=1e-5)
        assert x["p99"] == pytest.approx(y["p99"], rel=1e-5)
    # the per-cell loop agrees with the fused engine within MC error
    loop = vector.sweep_loop(DIST, POLICIES, (0.16,), N, N_JOBS, M_TRIALS, seed=4, device=CPU)
    fused = vector.frontier(DIST, POLICIES, (0.16,), N, N_JOBS, M_TRIALS, seed=4, device=CPU)
    for f, l in zip(fused, loop):
        sigma = np.hypot(f["sojourn_std_err"], l["sojourn_std_err"])
        assert abs(f["mean_sojourn"] - l["mean_sojourn"]) / sigma < 5.0


def test_r_cap_shifts_draws_within_mc_error():
    tight = _front(lams=LAMS, m_trials=24)
    wide = _front(lams=LAMS, m_trials=24, r_cap=4)
    assert tight != wide  # a wider fresh block is another random stream
    for a, b in zip(tight, wide):
        sigma = np.hypot(a["sojourn_std_err"], b["sojourn_std_err"])
        assert abs(a["mean_sojourn"] - b["mean_sojourn"]) / sigma < 5.0


def test_frontier_validations():
    with pytest.raises(ValueError, match="lam"):
        vector.frontier(DIST, POLICIES, (0.0,), N, 50, m_trials=2, device=CPU)
    with pytest.raises(ValueError, match="candidate"):
        vector.frontier(DIST, [], (0.1,), N, 50, m_trials=2, device=CPU)
    with pytest.raises(ValueError, match="arrival rate"):
        vector.frontier(DIST, POLICIES, (), N, 50, m_trials=2, device=CPU)
    with pytest.raises(ValueError, match="r_cap"):
        vector.frontier(DIST, (tcore.SingleForkPolicy(0.1, 3, True),), (0.1,), N, 50,
                        m_trials=2, r_cap=2, device=CPU)
    with pytest.raises(ValueError, match="2 samples"):
        vector.frontier(np.ones(1), POLICIES, (0.1,), N, 50, m_trials=2, device=CPU)
    with pytest.raises(ValueError, match="OnClass"):
        vector.frontier(DIST, (tcore.on_class(POLICIES[1], "fast"),), (0.1,), N, 50, m_trials=2, device=CPU)
    with pytest.raises(ValueError, match="backoff"):
        vector.frontier(DIST, POLICIES, (0.1,), N, 50, m_trials=2, device=CPU,
                        fault=FaultSpec(q=0.1, backoff_base=1.0))
    with pytest.raises(ValueError, match="pi_kill|π_kill"):
        vector.trace_kill_rollout(X_EMP, POLICIES[1], 0.1, N, 50, 2, device=CPU)
    with pytest.raises(ValueError, match="tail"):
        vector.frontier(DIST, POLICIES, (0.1,), N, 50, m_trials=2, tail="sketch", device=CPU)
