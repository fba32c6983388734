"""Extreme value theory machinery (paper Appendix A.1).

Implements the pieces of the Fisher–Tippett–Gnedenko theorem the paper uses:

  * domain-of-attraction classification for our distribution families
    (Theorem 5): Gumbel Λ (exponential-type tails), Fréchet Φ_ξ (heavy
    tails), reversed-Weibull Ψ_ξ (finite upper end point);
  * norming constants a_n, b_n (Theorem 6);
  * expected extremes E[Λ] = γ_EM, E[Φ_ξ] = Γ(1-1/ξ), E[Ψ_ξ] = -Γ(1+1/ξ)
    (Lemma 2);
  * DA closure of the residual distribution F_Y (Lemma 3).

So `expected_max(dist, n) ≈ b_n + a_n·E[G]` — the asymptotic that Theorems
2 and 3 instantiate for shifted-exponential and Pareto.

Counterpart of `repro.core.evt`: the closed forms are plain Python, the one
quadrature (`expected_max_numeric`) is float32 torch.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

from .distributions import Distribution, Empirical, Pareto, ShiftedExp, Uniform, Weibull

__all__ = [
    "Domain",
    "GUMBEL_MEAN",
    "classify",
    "norming_constants",
    "expected_extreme_value",
    "expected_max",
]

#: Euler–Mascheroni constant γ (paper eq. (12))
GUMBEL_MEAN = 0.5772156649015329


class Domain(enum.Enum):
    GUMBEL = "gumbel"  # DA(Λ)
    FRECHET = "frechet"  # DA(Φ_ξ)
    WEIBULL = "weibull"  # DA(Ψ_ξ)  (reversed-Weibull)


@dataclasses.dataclass(frozen=True)
class DomainInfo:
    domain: Domain
    xi: float = float("nan")  # tail index for Fréchet / reversed-Weibull
    eta: float = float("nan")  # auxiliary function value for Gumbel (1/hazard)


def classify(dist: Distribution) -> DomainInfo:
    """Theorem 5, specialized to the analytic families we ship."""
    if isinstance(dist, ShiftedExp):
        return DomainInfo(Domain.GUMBEL, eta=1.0 / dist.mu)
    if isinstance(dist, Weibull):
        # hazard-based auxiliary function η(x) = F̄/f = λ^k x^{1-k}/k;
        # evaluated at the 1-1/n quantile by norming_constants.
        return DomainInfo(Domain.GUMBEL)
    if isinstance(dist, Pareto):
        return DomainInfo(Domain.FRECHET, xi=dist.alpha)
    if isinstance(dist, Uniform):
        return DomainInfo(Domain.WEIBULL, xi=1.0)
    if isinstance(dist, Empirical):
        raise ValueError(
            "empirical distributions have a finite sample maximum; use the "
            "bootstrap estimator (Algorithm 1) rather than EVT asymptotics"
        )
    raise ValueError(f"no DA classification for {type(dist).__name__}")


def expected_extreme_value(domain: Domain, xi: float = float("nan")) -> float:
    """Lemma 2: mean of the limiting extreme-value distribution."""
    if domain is Domain.GUMBEL:
        return GUMBEL_MEAN
    if domain is Domain.FRECHET:
        if xi <= 1.0:
            return float("inf")
        return math.gamma(1.0 - 1.0 / xi)
    if domain is Domain.WEIBULL:
        return -math.gamma(1.0 + 1.0 / xi)
    raise ValueError(domain)


def norming_constants(dist: Distribution, n: int) -> tuple[float, float, DomainInfo]:
    """Theorem 6: (a_n, b_n, info) such that (X_{n:n} - b_n)/a_n → G."""
    info = classify(dist)
    q = float(dist.quantile(1.0 - 1.0 / n))
    if info.domain is Domain.GUMBEL:
        if isinstance(dist, ShiftedExp):
            a_n = 1.0 / dist.mu
        elif isinstance(dist, Weibull):
            # η(x) = λ^k x^{1-k} / k evaluated at b_n
            a_n = (dist.lam**dist.k) * q ** (1.0 - dist.k) / dist.k
        else:  # pragma: no cover - classify() limits the types
            a_n = info.eta
        return a_n, q, info
    if info.domain is Domain.FRECHET:
        return q, 0.0, info
    # reversed-Weibull: b_n = ω(F), a_n = ω(F) - F^{-1}(1-1/n)
    omega = dist.support()[1]
    return omega - q, omega, info


def expected_max(dist: Distribution, n: int) -> float:
    """E[X_{n:n}] ≈ b_n + a_n · E[G]  (Theorem 6 + Lemma 2)."""
    a_n, b_n, info = norming_constants(dist, n)
    return b_n + a_n * expected_extreme_value(info.domain, info.xi)


def expected_max_numeric(tail_fn, k: int, lo: float, hi: float, num: int = 8192):
    """Exact finite-k alternative: E[max of k iid Y] = lo + ∫ (1 - F^k) dy.

    Valid for Y >= lo; used to cross-check the EVT asymptotics and to
    evaluate Theorem 1's E[Y_{pn:pn}] for arbitrary (e.g. empirical) F_Y.
    """
    ys = torch.linspace(lo, hi, num, dtype=torch.float32)
    cdf = 1.0 - torch.clamp(tail_fn(ys), 0.0, 1.0)
    return lo + torch.trapezoid(1.0 - cdf**k, ys)
