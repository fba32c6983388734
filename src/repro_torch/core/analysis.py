"""Single-fork latency/cost analysis (paper §3, Appendix A.2).

Entry points
------------
`theorem1(dist, policy, n)`
    General evaluator of Theorem 1: works for ANY distribution via numeric
    quadrature (exact finite-`pn` order-statistics integral, no asymptotics
    in the second term), so it doubles as the reference the closed forms and
    the Monte-Carlo simulator are validated against.

`theorem2_*` / `theorem3_*`
    Paper closed forms for ShiftedExp (eq. 10–11) and Pareto (eq. 14–18).

`lemma1_prefer_kill(dist, p)`
    Stochastic-dominance criterion eq. (8).

`corollary1_exponent(alpha, r)`
    E[T] = Θ(n^{1/(α(r+1))}) growth exponent.

Counterpart of `repro.core.analysis`: the quadratures are float32 torch on
the CPU (host-side planning math, as the reference's run in float32), the
Theorem 2/3 closed forms plain Python.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import evt
from .distributions import Distribution, Pareto, ShiftedExp
from .policy import SingleForkPolicy, num_stragglers
from .residual import ResidualDistribution

__all__ = [
    "LatencyCost",
    "theorem1",
    "theorem2_latency",
    "theorem2_cost",
    "theorem3_latency",
    "theorem3_cost",
    "lemma1_prefer_kill",
    "corollary1_exponent",
    "baseline_latency",
    "baseline_cost",
]


@dataclasses.dataclass(frozen=True)
class LatencyCost:
    latency: float  # E[T]
    cost: float  # E[C]

    def as_tuple(self):
        return (self.latency, self.cost)


# --------------------------------------------------------------------------
# shared quadrature helpers
# --------------------------------------------------------------------------


def _expected_max_numeric(dist: Distribution, k: int, num: int = 4096) -> float:
    """E[max of k iid draws] = ∫ (1 - F(y)^k) dy over the support.

    Linear grid to the 1-1/(10k) quantile + log-spaced tail grid beyond it —
    the tail grid matters for heavy (Fréchet-domain) tails where the max is
    dominated by rare huge values.
    """
    lo = float(dist.support()[0])
    q_mid = float(dist.quantile(1.0 - 1.0 / (10.0 * k)))
    # float32 resolution near u=1 is ~6e-8; clamp so (1-u) stays exact
    eps_hi = max(1e-6 / k, 3e-7)
    q_hi = float(dist.quantile(1.0 - eps_hi))
    q_mid = max(q_mid, lo + 1e-9)
    if not math.isfinite(q_hi):
        q_hi = q_mid * 100.0
    q_hi = max(q_hi, q_mid * (1.0 + 1e-6))
    f32 = torch.float32
    lin = torch.linspace(lo, q_mid, num, dtype=f32)
    log_ends = torch.log(torch.tensor([q_mid, q_hi], dtype=f32)).tolist()
    logg = torch.exp(torch.linspace(*log_ends, num, dtype=f32))
    ys = torch.cat([lin, logg[1:]])
    cdf = torch.clamp(1.0 - dist.tail(ys), 0.0, 1.0)
    integrand = 1.0 - cdf**k
    return float(lo + torch.trapezoid(integrand, ys))


def _cost_first_terms(dist: Distribution, p: float, num: int = 4096) -> float:
    """∫_0^{1-p} F_X^{-1}(h) dh + p·F_X^{-1}(1-p)  (Theorem 1 eq. (6))."""
    hs = torch.linspace(0.0, 1.0 - p, num, dtype=torch.float32)
    integral = float(torch.trapezoid(dist.quantile(hs), hs))
    return integral + p * float(dist.quantile(1.0 - p))


# --------------------------------------------------------------------------
# baseline (p = 0): wait for all n originals
# --------------------------------------------------------------------------


def baseline_latency(dist: Distribution, n: int, method: str = "numeric") -> float:
    if method == "evt":
        return float(evt.expected_max(dist, n))
    return _expected_max_numeric(dist, n)


def baseline_cost(dist: Distribution) -> float:
    return float(dist.mean_numeric() if math.isinf(_safe_mean(dist)) else _safe_mean(dist))


def _safe_mean(dist: Distribution) -> float:
    try:
        return float(dist.mean())
    except NotImplementedError:  # pragma: no cover
        return float("inf")


# --------------------------------------------------------------------------
# Theorem 1 — general single-fork evaluator
# --------------------------------------------------------------------------


def theorem1(
    dist: Distribution,
    policy: SingleForkPolicy,
    n: int,
    method: str = "numeric",
) -> LatencyCost:
    """E[T], E[C] of π(p, r) on n tasks with execution times ~ dist.

    method='numeric' evaluates E[Y_{pn:pn}] and E[Y] by quadrature (exact
    for finite pn); method='evt' uses the asymptotic norming constants
    (Theorem 6 + Lemma 3), matching the paper's closed forms.
    """
    if policy.is_baseline:
        return LatencyCost(baseline_latency(dist, n, method), baseline_cost(dist))

    p, r = policy.p, policy.r
    s = num_stragglers(n, p)
    fork_time = float(dist.quantile(1.0 - p))
    resid = ResidualDistribution(dist, policy)

    if method == "evt":
        e_max = _residual_expected_max_evt(dist, resid, policy, s)
    else:
        e_max = _expected_max_numeric(resid, s)

    latency = fork_time + e_max
    cost = _cost_first_terms(dist, p) + (r + 1) * p * float(resid.mean())
    return LatencyCost(latency, cost)


def _residual_expected_max_evt(
    dist: Distribution, resid: ResidualDistribution, policy: SingleForkPolicy, s: int
) -> float:
    """E[Y_{s:s}] via Theorem 6 with Lemma 3's domain closure."""
    info = evt.classify(dist)
    r = policy.r
    if info.domain is evt.Domain.GUMBEL:
        # F_Y stays Gumbel; b_s = F̄_Y^{-1}(1/s), a_s from the residual hazard.
        b_s = float(resid.quantile(1.0 - 1.0 / s))
        if isinstance(dist, ShiftedExp):
            a_s = 1.0 / (dist.mu * (r + 1))
        else:
            # numeric auxiliary function η(b_s) = F̄_Y(b_s)/f_Y(b_s)
            eps = 1e-4 * max(b_s, 1.0)
            t0, t1 = float(resid.tail(b_s)), float(resid.tail(b_s + eps))
            a_s = t0 * eps / max(t0 - t1, 1e-12)
        return b_s + a_s * evt.GUMBEL_MEAN
    if info.domain is evt.Domain.FRECHET:
        xi = info.xi * (r + 1) if not policy.keep else info.xi * (r + 1)
        # Lemma 3: F_Y ∈ DA(Φ_{(r+1)ξ}) for both keep and kill (keep's tail
        # product has total polynomial order (r+1)α as y → ∞).
        a_s = float(resid.quantile(1.0 - 1.0 / s))
        return a_s * evt.expected_extreme_value(evt.Domain.FRECHET, xi)
    # reversed-Weibull
    omega = dist.support()[1]
    xi = info.xi * (r + 1) if not policy.keep else info.xi
    a_s = omega - float(resid.quantile(1.0 - 1.0 / s))
    return omega + a_s * evt.expected_extreme_value(evt.Domain.WEIBULL, xi)


# --------------------------------------------------------------------------
# Theorem 2 — ShiftedExp closed forms (eq. 10, 11)
# --------------------------------------------------------------------------


def theorem2_latency(dist: ShiftedExp, policy: SingleForkPolicy, n: int) -> float:
    p, r = policy.p, policy.r
    delta, mu = dist.delta, dist.mu
    common = (math.log(n) - r * math.log(p) + evt.GUMBEL_MEAN) / ((r + 1) * mu)
    if policy.keep:
        return (2 * r + 1) / (r + 1) * delta + common
    return 2 * delta + common


def theorem2_cost(
    dist: ShiftedExp, policy: SingleForkPolicy, n: int = 0, as_published: bool = False
) -> float:
    """Closed-form E[C] for ShiftedExp.

    NOTE (paper erratum): eq. (11) as printed overstates E[C] by exactly
    p·Δ — in the derivation, ∫_0^{1-p} Δ dh contributes Δ(1-p), but eq. (51)
    carries Δ, leaving a spurious +pΔ in (52)/(11).  Monte-Carlo simulation
    and the Theorem-1 quadrature both confirm the corrected forms

        π_keep: Δ + 1/μ + p·r(1-e^{-μΔ})/μ
        π_kill: Δ + 1/μ + p(r+1)Δ

    `as_published=True` returns the printed (11) for literal reproduction.
    """
    p, r = policy.p, policy.r
    delta, mu = dist.delta, dist.mu
    base = delta + 1.0 / mu
    slip = p * delta if as_published else 0.0
    if policy.keep:
        return base + p * r * (1.0 - math.exp(-mu * delta)) / mu + slip
    return base + p * (r + 1) * delta + slip


# --------------------------------------------------------------------------
# Theorem 3 — Pareto closed forms (eq. 14–18)
# --------------------------------------------------------------------------


def theorem3_latency(dist: Pareto, policy: SingleForkPolicy, n: int) -> float:
    p, r = policy.p, policy.r
    alpha, xm = dist.alpha, dist.xm
    s = num_stragglers(n, p)
    xi = (r + 1) * alpha
    if xi <= 1.0:
        return float("inf")
    gamma_term = math.gamma(1.0 - 1.0 / xi)
    if not policy.keep:
        a_pn = xm * (p * n) ** (1.0 / xi)
    else:
        resid = ResidualDistribution(dist, policy)
        a_pn = float(resid.quantile(1.0 - 1.0 / s))
    return xm * p ** (-1.0 / alpha) + gamma_term * a_pn


def theorem3_cost(dist: Pareto, policy: SingleForkPolicy, n: int = 0) -> float:
    p, r = policy.p, policy.r
    alpha, xm = dist.alpha, dist.xm
    first = xm * alpha / (alpha - 1.0) - xm * p ** (1.0 - 1.0 / alpha) / (alpha - 1.0)
    if not policy.keep:
        e_y = (r + 1) * alpha / ((r + 1) * alpha - 1.0) * xm
    else:
        e_y = float(ResidualDistribution(dist, policy).mean())
    return first + (r + 1) * p * e_y


# --------------------------------------------------------------------------
# Lemma 1 — kill or keep
# --------------------------------------------------------------------------


def lemma1_prefer_kill(dist: Distribution, p: float, num: int = 2048) -> int:
    """Check eq. (8) on a grid.  Returns +1 if killing dominates, -1 if
    keeping dominates, 0 if neither dominates everywhere."""
    fork = float(dist.quantile(1.0 - p))
    hi = float(dist.quantile(1.0 - 1e-6))
    xs = torch.linspace(0.0, max(hi - fork, hi, 1.0), num, dtype=torch.float32)
    lhs = dist.tail(xs + fork) / p
    rhs = dist.tail(xs)
    # float32 evaluation of the boundary-equality points needs slack
    tol = 1e-5 + 1e-5 * rhs
    kill_ok = bool(torch.all(lhs >= rhs - tol))
    keep_ok = bool(torch.all(lhs <= rhs + tol))
    if kill_ok and not keep_ok:
        return 1
    if keep_ok and not kill_ok:
        return -1
    if kill_ok and keep_ok:
        return 0  # distributions coincide on the grid (memoryless boundary)
    return 0


def corollary1_exponent(alpha: float, r: int) -> float:
    """E[T] = Θ(n^{1/(α(r+1))}) for Pareto(α, ·) under π(·, r)."""
    return 1.0 / (alpha * (r + 1))
