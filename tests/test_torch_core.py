"""The port's core (`repro_torch.core`, `data`, `faults`, `fleet.workload`)
against the JAX reference on shared inputs.

Inputs are made with numpy from a seed and handed to both packages.
Deterministic pieces are held to float32 tolerances on the same state
(the reference's lowered tensors come across through `repro_torch.convert`,
so lowering parity and evaluator parity are tested apart); sampled
estimators are held within the reference's own Monte-Carlo bound,
|Δmean| / hypot(stderr) < 5, since the two packages' generators differ.
Everything runs on the CPU (`device="cpu"`).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.distributions as jd
import repro.core.policy as jp
from repro.core import bootstrap as jboot
from repro.data import traces as jtraces
from repro.faults import model as jfaults
from repro.fleet import workload as jwork
from repro_torch import convert
from repro_torch.core import bootstrap as tboot
from repro_torch.core.distributions import ShiftedExp as TShiftedExp
from repro_torch.core import policy as tp
from repro_torch.data import traces as ttraces
from repro_torch.faults import model as tfaults
from repro_torch.fleet import workload as twork

# `core.simulate` the module: the packages re-export a function of that name
jsim = importlib.import_module("repro.core.simulate")
tsim = importlib.import_module("repro_torch.core.simulate")

CPU = "cpu"

# ------------------------------------------------------------ distributions
FAMILIES = [
    ("ShiftedExp", dict(delta=1.0, mu=2.0)),
    ("Pareto", dict(alpha=2.5, xm=1.0)),
    ("Uniform", dict(a=0.5, b=3.0)),
    ("Weibull", dict(k=0.7, lam=1.5)),
]
U = np.concatenate(
    [np.linspace(0.0, 0.999, 241), np.random.default_rng(0).random(256)]
).astype(np.float32)


@pytest.mark.parametrize("family,fields", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_analytic_distribution_parity(family, fields):
    ref = getattr(jd, family)(**fields)
    port = convert.distribution_from_fields(family, **dataclasses.asdict(ref))
    q_ref = np.asarray(ref.quantile(jnp.asarray(U)))
    q = port.quantile(torch.from_numpy(U)).numpy()
    np.testing.assert_allclose(q, q_ref, rtol=1e-6)
    x = np.concatenate([q_ref, q_ref - 0.01, [0.0, 1e3]]).astype(np.float32)
    # atol: far in the tail one side may underflow to a float32 denormal
    # where the other gives 0 (tiny = the smallest normal float32)
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_allclose(
        port.tail(torch.from_numpy(x)).numpy(), np.asarray(ref.tail(jnp.asarray(x))),
        rtol=1e-6, atol=tiny,
    )
    # cdf = 1 - tail in float32: near 0 it keeps the tail's absolute
    # rounding (~6e-8), which no relative tolerance can absorb
    np.testing.assert_allclose(
        port.cdf(torch.from_numpy(x)).numpy(), np.asarray(ref.cdf(jnp.asarray(x))),
        rtol=1e-6, atol=1e-7,
    )
    assert port.mean() == pytest.approx(ref.mean(), rel=1e-12)
    assert port.support() == ref.support()


def test_empirical_distribution_parity():
    samples = np.random.default_rng(1).exponential(1.0, 333) + 0.5
    ref = jd.Empirical(samples)
    port = convert.empirical_from_numpy(np.asarray(ref.sorted))
    np.testing.assert_array_equal(port.sorted.numpy(), np.asarray(ref.sorted))
    u = np.concatenate([U, [0.0, 1.0, 1.0 / 333, 2.0 / 333]]).astype(np.float32)
    np.testing.assert_array_equal(
        port.quantile(torch.from_numpy(u)).numpy(), np.asarray(ref.quantile(jnp.asarray(u)))
    )
    x = np.array(ref.quantile(jnp.asarray(u)))
    for fn in ("tail", "cdf"):
        np.testing.assert_allclose(
            getattr(port, fn)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(ref, fn)(jnp.asarray(x))), rtol=1e-6,
        )
    assert float(port.mean()) == pytest.approx(float(ref.mean()), rel=1e-6)
    assert port.support() == ref.support()
    # Empirical straight from raw samples sorts exactly as the reference
    np.testing.assert_array_equal(
        convert.distribution_from_fields("Empirical", samples=samples).sorted.numpy(),
        np.asarray(ref.sorted),
    )


# -------------------------------------------------------------- policy algebra
def _grid(m):
    """One mixed-family grid, built from either package's policy module."""
    return [
        m.BASELINE,
        m.SingleForkPolicy(0.1, 1, True),
        m.SingleForkPolicy(0.25, 2, False),
        m.delayed_relaunch(1.5, 1),
        m.delayed_relaunch(0.5, 0, keep=False),
        m.group_replication(0.25, 1, 4),
        m.group_replication(0.5, 2, 8, keep=False),
        m.MultiForkPolicy(((0.3, 1, True), (0.1, 2, False))),
        m.ForkPolicy(when=(m.AtQuantile(0.4), m.AtTime(3.0)), how_many=(1, 2), keep=(True, False)),
    ]


N_POL = 16
FIELDS = ("mode", "k", "t", "r", "keep", "d")


def test_lower_policies_element_equal():
    ref = jp.lower_policies(_grid(jp), N_POL)
    port = tp.lower_policies(_grid(tp), N_POL)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    for f in ("n", "n_stages", "class_names", "r_max", "multi_stage", "has_time", "has_group"):
        assert getattr(port, f) == getattr(ref, f), f
    assert [p.label() for p in _grid(tp)] == [p.label() for p in _grid(jp)]
    assert [tp.max_replicas(p) for p in _grid(tp)] == [jp.max_replicas(p) for p in _grid(jp)]
    # the convert path rebuilds the same lowered state from the arrays alone
    via = convert.lowered_from_numpy(*(getattr(ref, f) for f in FIELDS))
    for f in (*FIELDS, "n", "n_stages", "r_max", "multi_stage", "has_time", "has_group"):
        assert np.array_equal(getattr(via, f), getattr(ref, f)), f


def test_num_stragglers_equal_for_all_n_up_to_64():
    for n in range(1, 65):
        ps = np.concatenate([np.linspace(0.0, 0.99, 100), (np.arange(1, 2 * n) - 0.5) / n / 2])
        for p in ps[(ps >= 0) & (ps < 1)]:
            assert tp.num_stragglers(n, float(p)) == jp.num_stragglers(n, float(p)), (n, p)
            if p > 0 and n > 1:
                assert tp.fork_index(n, float(p)) == jp.fork_index(n, float(p))


# ---------------------------------------------- evaluators on shared state
M_EV, R_CAP = 64, 3


def _draws(n_stages, seed=3):
    rng = np.random.default_rng(seed)
    x = (1.0 + rng.exponential(1.0, (M_EV, N_POL))).astype(np.float32)
    fresh = (1.0 + rng.exponential(1.0, (M_EV, n_stages, N_POL, R_CAP))).astype(np.float32)
    return x, fresh


def test_lowered_policy_eval_matches_reference_on_shared_state():
    ref = jp.lower_policies(_grid(jp), N_POL)
    port = convert.lowered_from_numpy(*(getattr(ref, f) for f in FIELDS))
    x, fresh = _draws(ref.n_stages)
    ev = jax.jit(jax.vmap(jsim.lowered_policy_eval, in_axes=(None, None, 0, 0, 0, 0, 0, 0)))
    T_ref, C_ref = ev(jnp.asarray(x), jnp.asarray(fresh), *(jnp.asarray(getattr(ref, f)) for f in FIELDS))
    params = [torch.as_tensor(getattr(port, f)) for f in FIELDS]
    T, C = tsim.lowered_policy_eval(torch.from_numpy(x), torch.from_numpy(fresh), *params)
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), rtol=1e-5)
    np.testing.assert_allclose(C.numpy(), np.asarray(C_ref), rtol=1e-5)
    # one cell at a time (the reference's signature) is the same computation
    for i in (0, 5, 7):
        Ti, Ci = tsim.lowered_policy_eval(
            torch.from_numpy(x), torch.from_numpy(fresh), *(p[i] for p in params)
        )
        assert torch.equal(Ti, T[i]) and torch.equal(Ci, C[i])


def test_running_min_is_cummin():
    fresh = torch.from_numpy(_draws(2)[1])
    for width in (1, 2, 3):
        block = fresh[..., :width]
        assert torch.equal(tsim.running_min(block), torch.cummin(block, dim=-1).values)


def test_single_fork_cells_lowered_equal_masked_bitwise():
    """Single-stage quantile cells at full width through the general
    evaluator ≡ `masked_single_fork` on the same draws, bit for bit."""
    from repro_torch.fleet.vector import masked_single_fork

    pols = [tp.BASELINE, tp.SingleForkPolicy(0.1, 1, True), tp.SingleForkPolicy(0.3, 2, False),
            tp.SingleForkPolicy(0.2, 0, False)]
    low = tp.lower_policies(pols, N_POL)
    x, fresh = _draws(1, seed=4)
    xt, ft = torch.from_numpy(x), torch.from_numpy(fresh)
    T_gen, C_gen = tsim.lowered_policy_eval(
        xt, ft, *(torch.as_tensor(getattr(low, f)) for f in FIELDS)
    )
    T_m, C_m = masked_single_fork(
        torch.sort(xt, dim=-1).values, ft[:, 0], torch.as_tensor(low.k[:, 0]),
        torch.as_tensor(low.r[:, 0]), torch.as_tensor(low.keep[:, 0]),
    )
    assert torch.equal(T_gen, T_m) and torch.equal(C_gen, C_m)


DIST = (1.0, 1.0)  # ShiftedExp(delta, mu)


@pytest.mark.parametrize(
    "build",
    [
        lambda m: m.SingleForkPolicy(0.2, 1, True),
        lambda m: m.SingleForkPolicy(0.1, 2, False),
        lambda m: m.group_replication(0.25, 1, 5),
        lambda m: m.MultiForkPolicy(((0.3, 1, True), (0.1, 1, False))),
    ],
    ids=["keep", "kill", "group", "multi"],
)
def test_simulate_within_mc_error(build):
    n, m = 20, 4000
    ref = jsim.simulate(jd.ShiftedExp(*DIST), build(jp), n, m, key=jax.random.PRNGKey(0))
    port = tsim.simulate(TShiftedExp(*DIST),
                         build(tp), n, m, seed=0, device=CPU)
    for stat in ("latency", "cost"):
        se = np.hypot(getattr(ref, f"{stat}_std_err"), getattr(port, f"{stat}_std_err"))
        z = abs(getattr(ref, f"mean_{stat}") - getattr(port, f"mean_{stat}")) / se
        assert z < 5.0, (stat, z)


def test_simulate_multifork_within_mc_error():
    n, m = 20, 2000
    ref = jsim.simulate_multifork(
        jd.ShiftedExp(*DIST), jp.MultiForkPolicy(((0.3, 1, True), (0.1, 1, False))), n, m
    )
    pol = tp.MultiForkPolicy(((0.3, 1, True), (0.1, 1, False)))
    port = tsim.simulate_multifork(TShiftedExp(*DIST), pol, n, m, device=CPU)
    for stat in ("latency", "cost"):
        se = np.hypot(getattr(ref, f"{stat}_std_err"), getattr(port, f"{stat}_std_err"))
        assert abs(getattr(ref, f"mean_{stat}") - getattr(port, f"mean_{stat}")) / se < 5.0
    # the lowered evaluator realizes the same law as the event-accurate one
    low = tsim.simulate(TShiftedExp(*DIST), pol, n, m, seed=1, device=CPU)
    se = np.hypot(low.latency_std_err, port.latency_std_err)
    assert abs(low.mean_latency - port.mean_latency) / se < 5.0


# ---------------------------------------------------------------- bootstrap
TRACE = np.random.default_rng(5).exponential(1.0, 300) + 1.0


@pytest.mark.parametrize(
    "pol", [(0.0, 0, True), (0.1, 1, True), (0.2, 2, False)], ids=["baseline", "keep", "kill"]
)
def test_bootstrap_estimate_within_combined_stderr(pol):
    ref = jboot.estimate(TRACE, jp.SingleForkPolicy(*pol), m=2000)
    port = tboot.estimate(TRACE, tp.SingleForkPolicy(*pol), m=2000, device=CPU)
    assert abs(ref.latency - port.latency) / np.hypot(ref.latency_stderr, port.latency_stderr) < 5
    assert abs(ref.cost - port.cost) / np.hypot(ref.cost_stderr, port.cost_stderr) < 5


def test_residual_tail_grid_and_interp_match_reference():
    for pol in ((0.1, 1, True), (0.2, 2, False)):
        ys_r, ty_r = jboot.residual_tail_grid(TRACE, jp.SingleForkPolicy(*pol))
        ys, ty = tboot.residual_tail_grid(TRACE, tp.SingleForkPolicy(*pol))
        np.testing.assert_array_equal(ys.numpy(), np.asarray(ys_r))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(ty_r))
        # the tabulated cdf has flat steps: jnp.interp's zero-width rule
        u = np.random.default_rng(6).random(4096).astype(np.float32)
        u[:3] = (0.0, 1.0, float(1.0 - ty[1]))
        np.testing.assert_allclose(
            tboot.interp(torch.from_numpy(u), 1.0 - ty, ys).numpy(),
            np.asarray(jnp.interp(jnp.asarray(u), 1.0 - ty_r, ys_r)), rtol=1e-6, atol=1e-6,
        )


# ------------------------------------------------ numpy modules kept as copies
def test_traces_same_samples_for_the_same_seed():
    for job in jtraces.TRACE_JOBS:
        for seed in (0, 3):
            np.testing.assert_array_equal(
                ttraces.synthesize_trace(job, seed), jtraces.synthesize_trace(job, seed)
            )
    for stage in jtraces.STAGE_TRACES:
        np.testing.assert_array_equal(
            ttraces.load_stage_trace(stage, 1), jtraces.load_stage_trace(stage, 1)
        )
    assert ttraces.STAGE_TRACES == jtraces.STAGE_TRACES
    assert len(ttraces.load_trace("job1")) == 1026


def test_fault_model_matches_reference():
    for q, nu, ex in ((0.0, 0.0, 1.0), (0.1, 0.05, 2.0), (0.3, 1.0, 0.5)):
        assert tfaults.effective_fail_prob(q, nu, ex) == jfaults.effective_fail_prob(q, nu, ex)
    spec = dict(q=0.1, backoff_base=1.0, backoff_factor=3.0, backoff_cap=5.0, max_attempts=5)
    assert tfaults.FaultSpec(**spec).delays() == jfaults.FaultSpec(**spec).delays()
    for bad in (dict(q=1.0), dict(max_attempts=0), dict(backoff_factor=0.5)):
        with pytest.raises(ValueError):
            tfaults.FaultSpec(**bad)
    sched = tfaults.schedule_for_kill_fraction(40, 0.25, 1.0, 2.0)
    assert sched.outages[0].n_slots == jfaults.schedule_for_kill_fraction(40, 0.25, 1.0, 2.0).outages[0].n_slots


def test_workload_generators_match_reference():
    ref = jwork.poisson_workload(50, 0.5, 8, jd.ShiftedExp(*DIST), seed=2, priority_levels=3)
    port = twork.poisson_workload(50, 0.5, 8, TShiftedExp(*DIST),
                                  seed=2, priority_levels=3)
    assert [(j.arrival, j.priority) for j in port] == [(j.arrival, j.priority) for j in ref]
    ref_t = jwork.trace_workload(20, 0.3, n_tasks=8, seed=1)
    port_t = twork.trace_workload(20, 0.3, n_tasks=8, seed=1)
    assert [j.arrival for j in port_t] == [j.arrival for j in ref_t]
    for a, b in zip(port_t, ref_t):
        np.testing.assert_array_equal(a.dist.sorted.numpy(), np.asarray(b.dist.sorted))
    with pytest.raises(ValueError):
        twork.MachineClass("x", 0)
