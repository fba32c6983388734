"""Scheduling-policy selection (paper §4.3).

Two formulations over single-fork policies π(p, r, keep|kill):

  latency-sensitive (eq. 19):  min E[T]  s.t.  E[C] <= E[C(π0)], r <= r_max
  cost-sensitive   (eq. 20):  min E[T] + λ·n·E[C]  s.t.  r <= r_max

The search space is tiny (r and keep/kill are discrete, p ∈ (0, 0.5]), so we
do what the paper does: coarse grid over (r, keep, p) then COBYLA refinement
of the continuous p around the best grid point (scipy, matching [17]).

The evaluation backend is pluggable:
  * `analytic_evaluator(dist, n)`        — Theorem 1 quadrature
  * `bootstrap_evaluator(samples, m)`    — Algorithm 1 on a trace

Counterpart of `repro.core.optimize`; the bootstrap evaluator takes a
`seed` and a `device` (None means the card) for the port's
`core.bootstrap.estimate`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np

from . import analysis, bootstrap
from .distributions import Distribution
from .policy import BASELINE, SingleForkPolicy

__all__ = [
    "PolicyEvaluation",
    "analytic_evaluator",
    "bootstrap_evaluator",
    "tradeoff_curve",
    "optimize_latency_sensitive",
    "optimize_cost_sensitive",
]

Evaluator = Callable[[SingleForkPolicy], Tuple[float, float]]  # -> (E[T], E[C])


@dataclasses.dataclass(frozen=True)
class PolicyEvaluation:
    policy: SingleForkPolicy
    latency: float
    cost: float


def analytic_evaluator(dist: Distribution, n: int, method: str = "numeric") -> Evaluator:
    def ev(policy: SingleForkPolicy):
        lc = analysis.theorem1(dist, policy, n, method=method)
        return lc.latency, lc.cost

    return ev


def bootstrap_evaluator(samples, m: int = 1000, seed: int = 0, device=None) -> Evaluator:
    """Every policy is evaluated from the same seed: common random numbers
    across the candidates, as the reference's one key."""

    def ev(policy: SingleForkPolicy):
        est = bootstrap.estimate(samples, policy, m=m, seed=seed, device=device)
        return est.latency, est.cost

    return ev


def tradeoff_curve(
    evaluator: Evaluator,
    r: int,
    keep: bool,
    p_grid: Sequence[float],
) -> list[PolicyEvaluation]:
    """E[T]–E[C] curve for fixed (r, keep) as p sweeps (paper Figs. 4c/6c/8–10)."""
    out = []
    for p in p_grid:
        pol = SingleForkPolicy(p=float(p), r=r, keep=keep)
        lat, cost = evaluator(pol)
        out.append(PolicyEvaluation(pol, lat, cost))
    return out


def _grid_candidates(r_max: int, p_grid: Sequence[float]):
    for r in range(0, r_max + 1):
        for keep in (True, False):
            if keep and r == 0:
                continue  # π_keep(p, 0) == baseline
            for p in p_grid:
                yield SingleForkPolicy(p=float(p), r=r, keep=keep)


def _refine_p(
    evaluator: Evaluator,
    best: PolicyEvaluation,
    objective: Callable[[float, float], float],
    constraint: Callable[[float, float], float] | None,
    p_lo: float = 0.005,
    p_hi: float = 0.6,
) -> PolicyEvaluation:
    """COBYLA refinement of the continuous parameter p (paper uses COBYLA
    [17] because the search space is low-dimensional)."""
    try:
        from scipy.optimize import minimize
    except ImportError:  # pragma: no cover
        return best

    r, keep = best.policy.r, best.policy.keep

    def f(v):
        p = float(np.clip(v[0], p_lo, p_hi))
        lat, cost = evaluator(SingleForkPolicy(p=p, r=r, keep=keep))
        pen = 0.0
        if constraint is not None:
            pen = 1e6 * max(0.0, -constraint(lat, cost))
        return objective(lat, cost) + pen

    res = minimize(
        f,
        x0=[best.policy.p],
        method="COBYLA",
        options={"rhobeg": 0.05, "maxiter": 40, "tol": 1e-4},
    )
    p_star = float(np.clip(res.x[0], p_lo, p_hi))
    pol = SingleForkPolicy(p=p_star, r=r, keep=keep)
    lat, cost = evaluator(pol)
    cand = PolicyEvaluation(pol, lat, cost)
    ok = constraint is None or constraint(cand.latency, cand.cost) >= 0
    if ok and objective(cand.latency, cand.cost) < objective(best.latency, best.cost):
        return cand
    return best


def optimize_latency_sensitive(
    evaluator: Evaluator,
    r_max: int = 4,
    p_grid: Sequence[float] | None = None,
    cost_slack: float = 1.0,
) -> tuple[PolicyEvaluation, PolicyEvaluation]:
    """eq. (19): min E[T] s.t. E[C] <= cost_slack · E[C(baseline)].

    Returns (best, baseline_evaluation)."""
    if p_grid is None:
        p_grid = np.round(np.arange(0.01, 0.51, 0.01), 4)
    base_lat, base_cost = evaluator(BASELINE)
    budget = cost_slack * base_cost
    best = PolicyEvaluation(BASELINE, base_lat, base_cost)
    for pol in _grid_candidates(r_max, p_grid):
        lat, cost = evaluator(pol)
        if cost <= budget and lat < best.latency:
            best = PolicyEvaluation(pol, lat, cost)
    best = _refine_p(
        evaluator,
        best,
        objective=lambda lat, cost: lat,
        constraint=lambda lat, cost: budget - cost,
    )
    return best, PolicyEvaluation(BASELINE, base_lat, base_cost)


def optimize_cost_sensitive(
    evaluator: Evaluator,
    lam: float,
    n: int,
    r_max: int = 4,
    p_grid: Sequence[float] | None = None,
) -> tuple[PolicyEvaluation, PolicyEvaluation]:
    """eq. (20): min E[T] + λ·n·E[C], r <= r_max."""
    if p_grid is None:
        p_grid = np.round(np.arange(0.01, 0.51, 0.01), 4)
    base_lat, base_cost = evaluator(BASELINE)

    def obj(lat, cost):
        return lat + lam * n * cost

    best = PolicyEvaluation(BASELINE, base_lat, base_cost)
    for pol in _grid_candidates(r_max, p_grid):
        lat, cost = evaluator(pol)
        if obj(lat, cost) < obj(best.latency, best.cost):
            best = PolicyEvaluation(pol, lat, cost)
    best = _refine_p(evaluator, best, objective=obj, constraint=None)
    return best, PolicyEvaluation(BASELINE, base_lat, base_cost)
