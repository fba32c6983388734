#!/usr/bin/env python3
"""The JAX package's numbers on the paper's evaluation grids, for phase
`paper` of chip_smoke.py, written to tools/paper_reference.json.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/paper_reference.py

Runs on the CPU (about 10 minutes on 8 cores, most of it the reference's Theorem 1
quadratures) and imports the reference (`repro`); chip_smoke.py reads the
file and never this tool, since the card's machine has no JAX.  The grids
and sizes are chip_smoke.py's `PAPER_*` constants, `FULL["paper"]`
(section "full") and `PAPER_SMALL` (section "small", for the CPU
rehearsal in tests/test_torch_paper.py).  Each number is stored with its
standard error where it is a Monte Carlo estimate, beside the grid it came
from and the commit it was computed at.  Also stored: the eq. 19/20
optimizers on `analytic_evaluator` for ShiftedExp(1, 1) and Pareto(2, 2) at
n = 400 (`ANALYTIC_OPT`), which tests/test_torch_paper.py holds the port's
against (the reference takes about a minute a search on 8 CPU cores).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402

OUT = ROOT / "tools" / "paper_reference.json"
#: the analytic optimizers' grid: n, p grid, r_max, λ
ANALYTIC_OPT = dict(n=400, p_grid=(0.05, 0.1, 0.2, 0.3, 0.4), r_max=4, lam=0.1)


def _est(e) -> dict:
    return dict(latency=float(e.latency), cost=float(e.cost), latency_se=float(e.latency_stderr),
                cost_se=float(e.cost_stderr))


def fig35(core, jax, sz) -> dict:
    out = {}
    for fig, name, args, thm in cs.PAPER_FIG35:
        dist, cells = getattr(core, name)(*args), {}
        for p, r, keep in cs.PAPER_FIG35_POLICIES:
            pol = core.SingleForkPolicy(p, r, keep)
            for n in sz["fig35_ns"]:
                sim = core.simulate(dist, pol, n, m=sz["fig35_m"], key=jax.random.PRNGKey(n))
                cells[f"{cs.curve_key(r, keep)}_p{p}_n{n}"] = dict(
                    latency=sim.mean_latency, cost=sim.mean_cost, latency_se=sim.latency_std_err,
                    cost_se=sim.cost_std_err, analytic=getattr(core, thm)(dist, pol, n))
        out[fig] = cells
    return out


def fig46(core, sz) -> dict:
    out = {}
    for fig, name, args in cs.PAPER_FIG46:
        ev = core.analytic_evaluator(getattr(core, name)(*args), cs.PAPER_FIG46_N)
        base = [float(v) for v in ev(core.BASELINE)]
        curves = {cs.curve_key(r, keep): [[float(e.policy.p), float(e.latency), float(e.cost)]
                                          for e in core.tradeoff_curve(ev, r, keep, sz["fig46_p"])]
                  for r, keep in cs.PAPER_FIG46_CURVES}
        best = min((pt[1] for c in curves.values() for pt in c if pt[2] <= base[1] * 1.001), default=base[0])
        out[fig] = dict(baseline=base, curves=curves, best_speedup_at_iso_cost=base[0] / best)
    return out


def scaling(core, sz) -> list:
    out = []
    for alpha in cs.PAPER_SCALING_ALPHAS:
        dist = core.Pareto(alpha, 2.0)
        for r in cs.PAPER_SCALING_RS:
            pol = core.SingleForkPolicy(cs.PAPER_SCALING_P, r, False)
            first = 2.0 * cs.PAPER_SCALING_P ** (-1.0 / alpha)
            growth = [core.theorem3_latency(dist, pol, n) - first for n in sz["scaling_ns"]]
            slope = float(np.polyfit(np.log(sz["scaling_ns"]), np.log(growth), 1)[0])
            out.append(dict(alpha=alpha, r=r, fitted=slope, theory=core.corollary1_exponent(alpha, r)))
    return out


def trace(core, jax, sz) -> dict:
    from repro.data import synthesize_trace

    out = {}
    for job in sz["trace_jobs"]:
        x = synthesize_trace(job)
        base = _est(core.estimate(x, core.BASELINE, m=sz["trace_m"], key=jax.random.PRNGKey(0)))
        curves = {cs.curve_key(r, keep): [
            dict(p=p, **_est(core.estimate(x, core.SingleForkPolicy(p, r, keep), m=sz["trace_m"],
                                           key=jax.random.PRNGKey(1))))
            for p in sz["trace_p"]] for r in cs.PAPER_TRACE_RS for keep in (True, False)}
        keep1 = curves[cs.curve_key(1, True)]
        out[job] = dict(baseline=base, curves=curves, headline=dict(
            latency_cut=1.0 - min(e["latency"] for e in keep1) / base["latency"],
            cost_delta=min(e["cost"] for e in keep1) / base["cost"] - 1.0))
    return out


def cross(core, jax, sz) -> dict:
    from repro.data.traces import load_stage_trace
    from repro.fleet import vector

    out = {}
    for stage in sz["cross_stages"]:
        rows = vector.frontier(core.Empirical(load_stage_trace(stage)), cs.paper_cross_policies(core),
                               cs.PAPER_CROSS_LAMS, cs.PAPER_CROSS_N, sz["cross_jobs"], m_trials=sz["cross_trials"],
                               key=jax.random.PRNGKey(cs.PAPER_CROSS_SEED))
        out[stage] = {}
        for lam in cs.PAPER_CROSS_LAMS:
            cell = [r for r in rows if abs(r["lam"] - lam) < 1e-12]
            front = set(cs.pareto_front(cell))
            out[stage][str(lam)] = [dict(policy=r["policy"], mean_sojourn=r["mean_sojourn"], mean_cost=r["mean_cost"],
                                         p99=r["p99"], sojourn_std_err=r["sojourn_std_err"], on_front=i in front)
                                    for i, r in enumerate(cell)]
    return out


def _pick(core, jax, x, e, m) -> dict:
    """A pick of the optimizers with its standard errors: `estimate` with
    the evaluator's key, which gives the evaluator's numbers again."""
    est = _est(core.estimate(x, e.policy, m=m, key=jax.random.PRNGKey(0)))
    if (est["latency"], est["cost"]) != (float(e.latency), float(e.cost)):
        raise RuntimeError(f"the evaluator's key gave {e}, estimate {est}")
    return dict(p=float(e.policy.p), r=int(e.policy.r), keep=bool(e.policy.keep), **est)


def table1(core, jax, sz) -> dict:
    from repro.data import synthesize_trace

    out = {}
    for job in sz["table1_jobs"]:
        x = synthesize_trace(job)
        ev = core.bootstrap_evaluator(x, m=sz["table1_m"])
        lat, base = core.optimize_latency_sensitive(ev, r_max=cs.PAPER_TABLE1_R_MAX, p_grid=sz["table1_p"])
        cost, _ = core.optimize_cost_sensitive(ev, lam=cs.PAPER_TABLE1_LAM, n=len(x), r_max=cs.PAPER_TABLE1_R_MAX,
                                               p_grid=sz["table1_p"])
        out[job] = dict(baseline=_pick(core, jax, x, base, sz["table1_m"]),
                        latency_sensitive=_pick(core, jax, x, lat, sz["table1_m"]),
                        cost_sensitive=_pick(core, jax, x, cost, sz["table1_m"]))
    return out


def analytic_optimizers(core) -> dict:
    out = {}
    for fig, name, args in cs.PAPER_FIG46:
        ev = core.analytic_evaluator(getattr(core, name)(*args), ANALYTIC_OPT["n"])
        lat, base = core.optimize_latency_sensitive(ev, r_max=ANALYTIC_OPT["r_max"], p_grid=ANALYTIC_OPT["p_grid"])
        cost, _ = core.optimize_cost_sensitive(ev, lam=ANALYTIC_OPT["lam"], n=ANALYTIC_OPT["n"],
                                               r_max=ANALYTIC_OPT["r_max"], p_grid=ANALYTIC_OPT["p_grid"])
        out[name] = {k: dict(p=float(e.policy.p), r=int(e.policy.r), keep=bool(e.policy.keep),
                             latency=float(e.latency), cost=float(e.cost))
                     for k, e in (("latency_sensitive", lat), ("cost_sensitive", cost), ("baseline", base))}
    return dict(ANALYTIC_OPT, picks=out)


def section(core, jax, sizes: dict) -> dict:
    sz = json.loads(json.dumps({k: v for k, v in sizes.items() if k != "reference"}))
    out, seconds = dict(sizes=sz), {}
    for name, fn in (("fig35", lambda: fig35(core, jax, sz)), ("fig46", lambda: fig46(core, sz)),
                     ("scaling", lambda: scaling(core, sz)), ("trace", lambda: trace(core, jax, sz)),
                     ("cross", lambda: cross(core, jax, sz)), ("table1", lambda: table1(core, jax, sz))):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"{sizes['reference']} {name}: {seconds[name]} s", flush=True)
    out["cpu_seconds"] = seconds
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    import jax

    import repro.core as core

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True)
    doc = dict(generated_by="tools/paper_reference.py", package="repro (JAX, CPU)", jax=jax.__version__,
               commit=commit.stdout.strip() if commit.returncode == 0 else None,
               sections={sizes["reference"]: section(core, jax, sizes) for sizes in (cs.PAPER_SMALL, cs.FULL["paper"])})
    t0 = time.perf_counter()
    doc["analytic_optimizers"] = analytic_optimizers(core)
    print(f"analytic optimizers: {time.perf_counter() - t0:.1f} s", flush=True)
    args.out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
