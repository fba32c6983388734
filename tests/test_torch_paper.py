"""The paper's evaluations (Figs. 3-10, Corollary 1, Table 1) on the port,
against the JAX package, on the CPU.

- The eq. 19/20 optimizers on `analytic_evaluator` for ShiftedExp(1, 1)
  and Pareto(2, 2) at n = 400: the port's picks are the reference's up to
  COBYLA's last steps, and its values at the reference's picks agree
  within float32 rounding (both packages' Theorem 1 is a float32
  quadrature).  The reference's picks come from
  tools/paper_reference.json: its own search takes about a minute on an
  8-core CPU (0.56 s a Theorem 1 evaluation); the reference's evaluator is called
  again at its recorded latency-sensitive picks, so the file's values
  cannot go stale.
- Both packages' `bootstrap_evaluator` on a few policies of one trace
  job, within 5 combined standard errors.
- One Figs. 3/5 cell and one Figs. 7-10 point recomputed by the
  reference equal tools/paper_reference.json's.
- chip_smoke.py's phase `paper` rehearsed at `PAPER_SMALL` against the
  file's section "small" (the reference's numbers at that size).
- chip_smoke.py's `PAPER_*` grids are the reference benchmarks' own.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.data import synthesize_trace as jsynthesize_trace
from repro_torch import core as tcore
from repro_torch.data import synthesize_trace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

DOC = json.loads((ROOT / "tools" / "paper_reference.json").read_text())
DISTS = {name: args for _, name, args in chip_smoke.PAPER_FIG46}


@pytest.mark.parametrize("name", sorted(DISTS))
def test_analytic_optimizers_pick_the_references_policies(name):
    """The grid search is deterministic, so each pick's (r, keep) is the
    reference's; COBYLA's refinement of p then walks a flat objective on
    values that differ from the reference's by float32 rounding, and stops
    at another p within its tolerance.  So: the reference's pick, evaluated
    by the port, has the reference's values within PAPER_QUADRATURE_RTOL
    (measured: 1.05e-5 at Pareto's baseline, 5.1e-7 or less elsewhere),
    the port's pick scores at least as well on the port's evaluator (within
    1e-6), satisfies eq. 19's budget, and lies within 0.01 in p (a fifth of
    COBYLA's first step; measured: 0.0025)."""
    ref = DOC["analytic_optimizers"]
    want = ref["picks"][name]
    ev = tcore.analytic_evaluator(getattr(tcore, name)(*DISTS[name]), ref["n"])
    lat, base = tcore.optimize_latency_sensitive(ev, r_max=ref["r_max"], p_grid=ref["p_grid"])
    cost, _ = tcore.optimize_cost_sensitive(ev, lam=ref["lam"], n=ref["n"], r_max=ref["r_max"],
                                            p_grid=ref["p_grid"])
    objectives = {"latency_sensitive": lambda lc: lc[0], "baseline": lambda lc: lc[0],
                  "cost_sensitive": lambda lc: lc[0] + ref["lam"] * ref["n"] * lc[1]}
    for key, got in (("latency_sensitive", lat), ("cost_sensitive", cost), ("baseline", base)):
        w = want[key]
        assert (got.policy.r, got.policy.keep) == (w["r"], w["keep"]), (key, got, w)
        assert abs(got.policy.p - w["p"]) <= 0.01, (key, got, w)
        at_ref = ev(tcore.SingleForkPolicy(w["p"], w["r"], w["keep"]))
        assert at_ref == pytest.approx((w["latency"], w["cost"]), rel=chip_smoke.PAPER_QUADRATURE_RTOL), (key, at_ref, w)
        obj = objectives[key]
        assert obj((got.latency, got.cost)) <= obj(at_ref) * (1 + 1e-6), (key, got, at_ref)
    assert lat.cost <= base.cost
    # the file's values are the reference's own
    w = want["latency_sensitive"]
    jev = jcore.analytic_evaluator(getattr(jcore, name)(*DISTS[name]), ref["n"])
    assert jev(jcore.SingleForkPolicy(w["p"], w["r"], w["keep"])) == pytest.approx((w["latency"], w["cost"]),
                                                                                   rel=1e-6)


def test_bootstrap_evaluators_agree_within_five_sigma():
    x = synthesize_trace("job3")
    assert np.array_equal(x, jsynthesize_trace("job3"))
    jev, tev = jcore.bootstrap_evaluator(x, m=300), tcore.bootstrap_evaluator(x, m=300, device="cpu")
    for p, r, keep in ((0.0, 0, True), (0.1, 1, True), (0.2, 2, False)):
        jpol, tpol = jcore.SingleForkPolicy(p, r, keep), tcore.SingleForkPolicy(p, r, keep)
        want = jcore.estimate(x, jpol, m=300, key=jax.random.PRNGKey(0))
        got = tcore.estimate(x, tpol, m=300, seed=0, device="cpu")
        assert jev(jpol) == (want.latency, want.cost) and tev(tpol) == (got.latency, got.cost)
        for a, b, sa, sb in ((got.latency, want.latency, got.latency_stderr, want.latency_stderr),
                             (got.cost, want.cost, got.cost_stderr, want.cost_stderr)):
            assert abs(a - b) <= chip_smoke.PAPER_SIGMAS * np.hypot(sa, sb), (tpol.label(), a, b)


def test_reference_file_is_the_references_numbers():
    full = DOC["sections"]["full"]
    assert full["sizes"] == json.loads(json.dumps({k: v for k, v in chip_smoke.FULL["paper"].items()
                                                   if k != "reference"}))
    sim = jcore.simulate(jcore.ShiftedExp(1.0, 1.0), jcore.SingleForkPolicy(0.1, 1, True), 50, m=2000,
                         key=jax.random.PRNGKey(50))
    cell = full["fig35"]["fig3"]["r1_keep_p0.1_n50"]
    assert (sim.mean_latency, sim.mean_cost, sim.latency_std_err) == pytest.approx(
        (cell["latency"], cell["cost"], cell["latency_se"]), rel=1e-6)
    est = jcore.estimate(jsynthesize_trace("job3"), jcore.SingleForkPolicy(0.1, 2, False), m=400,
                         key=jax.random.PRNGKey(1))
    (point,) = [e for e in full["trace"]["job3"]["curves"]["r2_kill"] if e["p"] == 0.1]
    assert (est.latency, est.cost, est.latency_stderr) == pytest.approx(
        (point["latency"], point["cost"], point["latency_se"]), rel=1e-6)


def test_paper_phase_rehearsed_at_the_small_size():
    grids = chip_smoke.phase_paper(torch, torch.device("cpu"), {"paper": chip_smoke.PAPER_SMALL})
    assert list(grids) == ["fig3_fig5", "fig4_fig6_corollary1", "fig7_fig10", "cross_family", "table1"]
    for name, g in grids.items():
        assert g["wall_s"] > 0
        if "max_sigma" in g:
            assert 0 <= g["max_sigma"] <= chip_smoke.PAPER_SIGMAS, (name, g["max_sigma"])
    fits = grids["fig4_fig6_corollary1"]["exponents"]
    assert len(fits) == 9 and all(f["fitted"] == pytest.approx(f["theory"], rel=1e-6) for f in fits)
    cross = grids["cross_family"]
    assert cross["pareto_marks"] == 2 * len(chip_smoke.paper_cross_policies(tcore))
    # each stage's kw_queue call was held against kw_queue_plain at its own shape
    assert [q["stage"] for q in cross["kw_queue"]] == list(chip_smoke.PAPER_SMALL["cross_stages"])
    assert all(q["rows"] == [len(chip_smoke.PAPER_CROSS_LAMS) * len(chip_smoke.paper_cross_policies(tcore))
                             * chip_smoke.PAPER_SMALL["cross_trials"], chip_smoke.PAPER_SMALL["cross_jobs"]]
               and q["c"] == 1 for q in cross["kw_queue"])
    job = grids["table1"]["jobs"]["job2"]
    assert job["port"]["latency_speedup"] > 1.0 and set(job["reference_picks_here"]) == {
        "baseline", "latency_sensitive", "cost_sensitive"}
    # a section computed on other grids is refused
    with pytest.raises(RuntimeError, match="sizes"):
        chip_smoke.paper_reference(dict(chip_smoke.PAPER_SMALL, trace_m=65))


def test_paper_grids_are_the_reference_benchmarks():
    from benchmarks import bench_fig3_fig5, bench_fig4_fig6, bench_scaling, bench_table1, bench_trace

    cs = chip_smoke
    assert cs.PAPER_FIG35_NS == bench_fig3_fig5.NS
    assert [(p.p, p.r, p.keep) for p in bench_fig3_fig5.POLICIES] == list(cs.PAPER_FIG35_POLICIES)
    assert cs.PAPER_FIG46_P_GRID == tuple(bench_fig4_fig6.P_GRID) and cs.PAPER_FIG46_N == bench_fig4_fig6.N
    assert cs.PAPER_SCALING_NS == bench_scaling.NS
    assert cs.PAPER_TABLE1_P_GRID == tuple(bench_table1.P_GRID)
    assert cs.PAPER_TRACE_P_GRID == tuple(bench_trace.P_GRID)
    assert (cs.PAPER_CROSS_N, cs.PAPER_CROSS_LAMS) == (bench_trace.CROSS_N, bench_trace.CROSS_LAMS)
    assert [p.label() for p in cs.paper_cross_policies(jcore)] == [p.label() for p in bench_trace.CROSS_GRID]
    assert [p.label() for p in cs.paper_cross_policies(tcore)] == [p.label() for p in bench_trace.CROSS_GRID]
