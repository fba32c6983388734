"""EVT-extended streaming tails: peaks-over-threshold GPD on sketches.

A numpy copy of `repro.obs.evtail` for the port.

The paper's argument lives at quantiles raw Monte Carlo cannot resolve:
p999 of a 2 400-sample cell is decided by the top 2-3 draws, and p9999
does not exist in the sample at all.  Extreme value theory closes the
gap.  By Pickands–Balkema–de Haan, for any distribution in a maximum
domain of attraction the exceedances over a high threshold u converge to
a Generalized Pareto law

    P(X - u > y | X > u)  →  (1 + ξ y / σ)^(-1/ξ)        (ξ → 0: e^(-y/σ))

so fitting (ξ, σ) to the observed exceedances extrapolates the tail
*beyond* the sample with two parameters instead of raw order statistics.

`EVTail` runs that fit directly on a `QuantileSketch`'s γ-buckets — the
bucket midpoints above the threshold are weighted exceedances, so the
same fixed-size payload the fused engines already ship off-device
(`tail="hist"`) is enough; no retained sample arrays anywhere.  The fit
is a weighted Grimshaw profile likelihood: with θ = ξ/σ the GPD MLE is
one-dimensional, every θ giving closed-form ξ̂(θ) = Σw·log(1+θy)/Σw and
profile log-likelihood -W(log(ξ̂/θ) + ξ̂ + 1), which a two-pass log grid
maximizes robustly for any ξ (heavy Fréchet tails included, where the
probability-weighted-moment estimator breaks down past ξ ≥ 1/2).

The fitted shape bridges back to `core/evt.py`'s Fisher–Tippett domains:
ξ > 0 ⇔ DA(Φ) with tail index α = 1/ξ, ξ ≈ 0 ⇔ DA(Λ), ξ < 0 ⇔ DA(Ψ)
with a finite endpoint at u + σ/|ξ| — and `gpd_params_of` gives the
analytic (ξ, σ(u)) for the repo's distribution families, the identity
the tests pin the estimator against.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from .sketch import QuantileSketch

__all__ = [
    "GPDFit",
    "EVTail",
    "fit_gpd",
    "evt_keys",
    "domain_of_fit",
    "gpd_params_of",
]

#: |ξ| below this is treated as the exponential (Gumbel) limit
_XI_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class GPDFit:
    """A fitted peaks-over-threshold model: GPD(ξ, σ) above threshold u.

    `zeta` is the exceedance probability P(X > u) — the POT quantile
    formula needs it to translate absolute quantile levels q into the
    conditional exceedance scale.
    """

    xi: float
    sigma: float
    u: float
    zeta: float
    n_exceed: float = 0.0
    n_total: float = 0.0

    def quantile(self, q: float) -> float:
        """Extrapolated quantile at level q ∈ [1 - ζ, 1)."""
        if not 0.0 < q < 1.0:
            raise ValueError("q must be in (0, 1)")
        if self.sigma != self.sigma or self.sigma <= 0 or self.zeta <= 0:
            return float("nan")
        t = (1.0 - q) / self.zeta
        if t > 1.0:  # below the threshold: the GPD model says nothing
            return float("nan")
        if abs(self.xi) < _XI_EPS:
            return self.u - self.sigma * math.log(t)
        return self.u + self.sigma / self.xi * (t ** (-self.xi) - 1.0)

    def tail_prob(self, x: float) -> float:
        """P(X > x) under the fitted model, for x >= u."""
        if x < self.u:
            raise ValueError("tail_prob is only modeled above the threshold")
        y = x - self.u
        if abs(self.xi) < _XI_EPS:
            return self.zeta * math.exp(-y / self.sigma)
        base = 1.0 + self.xi * y / self.sigma
        if base <= 0.0:  # beyond the finite endpoint (ξ < 0)
            return 0.0
        return self.zeta * base ** (-1.0 / self.xi)

    @property
    def endpoint(self) -> float:
        """Finite upper endpoint u + σ/|ξ| for ξ < 0, else +inf."""
        if self.xi < -_XI_EPS:
            return self.u - self.sigma / self.xi
        return float("inf")


def _profile_ll(theta: np.ndarray, y: np.ndarray, w: np.ndarray, W: float):
    """Grimshaw reduction: per-θ closed-form ξ̂ and profile log-likelihood."""
    xi = (w[None, :] * np.log1p(theta[:, None] * y[None, :])).sum(axis=1) / W
    with np.errstate(divide="ignore", invalid="ignore"):
        ll = -W * (np.log(xi / theta) + xi + 1.0)
    ll[~np.isfinite(ll)] = -np.inf
    return xi, ll


def fit_gpd(
    y: Sequence[float],
    weights: Optional[Sequence[float]] = None,
    *,
    u: float = 0.0,
    zeta: float = 1.0,
    n_total: float = 0.0,
) -> GPDFit:
    """Weighted GPD MLE on exceedances `y` (> 0) via the 1-D θ profile.

    Works on raw exceedance arrays (weights=None) and on γ-bucket
    (midpoint - u, count) pairs alike — the weighted likelihood is what
    makes sketch-resident fitting possible.
    """
    y = np.asarray(y, dtype=np.float64).ravel()
    if weights is None:
        w = np.ones_like(y)
    else:
        w = np.asarray(weights, dtype=np.float64).ravel()
    keep = (y > 0) & (w > 0)
    y, w = y[keep], w[keep]
    W = float(w.sum())
    if y.size == 0 or W <= 0:
        return GPDFit(float("nan"), float("nan"), u, zeta, 0.0, n_total)
    mean = float((w * y).sum() / W)
    if y.size == 1 or mean <= 0 or float(y.max()) <= float(y.min()) * (1 + 1e-12):
        # degenerate spike: exponential with the observed mean excess
        return GPDFit(0.0, mean, u, zeta, W, n_total)
    ymax = float(y.max())
    # θ grid: negative branch approaches the support bound -1/ymax (ξ < 0,
    # finite endpoint just above the largest exceedance), positive branch
    # log-spans the heavy-tail range; θ → 0 is the exponential limit,
    # scored separately in closed form.
    best = (0.0, mean, -W * (math.log(mean) + 1.0))  # (xi, sigma, ll) at θ=0
    lo = -1.0 / ymax
    for _pass in range(2):
        if _pass == 0:
            neg = lo * (1.0 - np.geomspace(1e-6, 1.0 - 1e-6, 40))
            pos = np.geomspace(1e-4, 1e4, 80) / mean
            thetas = np.concatenate([neg, pos])
        else:
            th0 = best_theta
            if th0 == 0.0:
                break
            lo_z = max(abs(th0) / 4.0, 1e-12)
            hi_z = abs(th0) * 4.0
            if th0 > 0:
                thetas = np.geomspace(lo_z, hi_z, 60)
            else:
                thetas = -np.geomspace(lo_z, min(hi_z, -lo * (1 - 1e-9)), 60)
        xi, ll = _profile_ll(thetas, y, w, W)
        i = int(np.argmax(ll))
        if ll[i] > best[2]:
            best = (float(xi[i]), float(xi[i] / thetas[i]), float(ll[i]))
            best_theta = float(thetas[i])
        else:
            best_theta = 0.0 if _pass == 0 else best_theta
    xi_hat, sigma_hat, _ = best
    if abs(xi_hat) < _XI_EPS:
        xi_hat = 0.0
    return GPDFit(xi_hat, sigma_hat, u, zeta, W, n_total)


class EVTail:
    """POT tail model fitted to a `QuantileSketch`'s bucket mass.

    The sketch resolves quantiles up to roughly rank 1 - O(10)/count; the
    fitted GPD extends `extreme_quantile(q)` beyond that with the
    Pickands–Balkema–de Haan extrapolation, and `agreement()` cross-checks
    model against sample in the region both can see.
    """

    def __init__(self, sketch: QuantileSketch, fit: GPDFit,
                 threshold_q: float = 0.9):
        self.sketch = sketch
        self.fit = fit
        self.threshold_q = threshold_q

    # ------------------------------------------------------------ builders
    @classmethod
    def from_sketch(cls, sketch: QuantileSketch,
                    threshold_q: float = 0.9) -> "EVTail":
        """Fit on the γ-buckets above the threshold_q sample quantile.

        Bucket midpoints above u become weighted exceedances — within the
        sketch's rel_acc of the raw values, which is noise far below the
        tail-fit uncertainty.  Fewer than 4 exceedance buckets degrades
        gracefully to the exponential (mean-excess) fit.
        """
        if not 0.0 < threshold_q < 1.0:
            raise ValueError("threshold_q must be in (0, 1)")
        if sketch.count <= 0:
            return cls(sketch, GPDFit(float("nan"), float("nan"),
                                      float("nan"), 0.0), threshold_q)
        u = sketch.quantile(threshold_q)
        ku = sketch.key(u) if u > 0 else -(10**9)
        ys, ws = [], []
        for k, c in sorted(sketch._store.items()):
            if k <= ku:
                continue
            v = min(sketch.bucket_value(k), sketch.max)
            if v > u:
                ys.append(v - u)
                ws.append(c)
        n_exceed = float(sum(ws))
        zeta = n_exceed / sketch.count
        if n_exceed == 0 or zeta <= 0:
            return cls(sketch, GPDFit(float("nan"), float("nan"), u, 0.0,
                                      0.0, sketch.count), threshold_q)
        fit = fit_gpd(ys, ws, u=u, zeta=zeta, n_total=sketch.count)
        return cls(sketch, fit, threshold_q)

    @classmethod
    def from_samples(cls, xs, threshold_q: float = 0.9,
                     rel_acc: float = 0.01) -> "EVTail":
        """Sketch the samples, then fit — one code path for raw arrays."""
        sk = QuantileSketch(rel_acc=rel_acc)
        sk.add_many(xs)
        return cls.from_sketch(sk, threshold_q)

    @classmethod
    def from_bincounts(cls, counts, vmin, vmax, total, spec,
                       threshold_q: float = 0.9) -> "EVTail":
        """Device-side `tail="hist"` payload → EVT tail, no samples moved."""
        from .device import sketch_from_device

        sk = sketch_from_device(counts, vmin, vmax, total, spec=spec)
        return cls.from_sketch(sk, threshold_q)

    # ------------------------------------------------------------- queries
    def extreme_quantile(self, q: float) -> float:
        """Tail quantile at level q: the GPD extrapolation above the fit
        threshold, the sketch's own (rank-exact-within-rel_acc) estimate
        below it — monotone across the splice by construction."""
        if not 0.0 <= q < 1.0:
            raise ValueError("q must be in [0, 1)")
        boundary = 1.0 - self.fit.zeta
        if q < boundary or self.fit.zeta <= 0:
            return self.sketch.quantile(q)
        return self.fit.quantile(q)

    def resolvable_q(self, min_rank: float = 32.0) -> float:
        """Highest quantile the sample itself still resolves (≥ min_rank
        samples beyond it) — the upper edge of the MC-vs-EVT overlap."""
        if self.sketch.count <= 0:
            return float("nan")
        return 1.0 - min_rank / self.sketch.count

    def agreement(self, qs: Optional[Sequence[float]] = None,
                  min_rank: float = 32.0) -> dict:
        """MC-vs-EVT cross-check in the overlap region.

        Where the sample still resolves the quantile (rank ≥ min_rank) the
        GPD model and the sketch must agree; a large `max_rel_dev` means
        the threshold is too low (model bias) or the tail is not yet in
        its asymptotic regime — either way, do not trust the
        extrapolation.  Returns per-q values plus the max relative
        deviation (nan when there is no overlap)."""
        hi = self.resolvable_q(min_rank)
        if qs is None:
            lo = self.threshold_q
            if not hi > lo:
                return {"qs": [], "evt": [], "mc": [], "max_rel_dev": float("nan")}
            qs = [1.0 - (1.0 - lo) * ((1.0 - hi) / (1.0 - lo)) ** f
                  for f in np.linspace(0.0, 1.0, 9)]
        evt = [self.fit.quantile(q) for q in qs]
        mc = self.sketch.quantiles(tuple(qs))
        devs = [abs(e - m) / m for e, m in zip(evt, mc)
                if m > 0 and e == e and m == m]
        return {
            "qs": list(qs),
            "evt": evt,
            "mc": mc,
            "max_rel_dev": max(devs) if devs else float("nan"),
        }

    def summary(self) -> dict:
        f = self.fit
        return {
            "xi": f.xi, "sigma": f.sigma, "u": f.u, "zeta": f.zeta,
            "n_exceed": f.n_exceed, "count": self.sketch.count,
            "threshold_q": self.threshold_q,
            "p999": self.extreme_quantile(0.999) if self.sketch.count else float("nan"),
            "p9999": self.extreme_quantile(0.9999) if self.sketch.count else float("nan"),
            "domain": domain_of_fit(f).value if f.xi == f.xi else None,
        }

    def __repr__(self) -> str:
        return (f"EVTail(xi={self.fit.xi:.3f}, sigma={self.fit.sigma:.4g}, "
                f"u={self.fit.u:.4g}, zeta={self.fit.zeta:.4g})")


def evt_keys(sketch: QuantileSketch, threshold_q: float = 0.9) -> dict:
    """The frontier-row EVT columns for one tail sketch (nan-safe): the
    fitted shape plus extrapolated p999/p9999."""
    try:
        ev = EVTail.from_sketch(sketch, threshold_q)
        return {
            "evt_xi": float(ev.fit.xi),
            "evt_p999": float(ev.extreme_quantile(0.999)),
            "evt_p9999": float(ev.extreme_quantile(0.9999)),
        }
    except (ValueError, ZeroDivisionError):
        nan = float("nan")
        return {"evt_xi": nan, "evt_p999": nan, "evt_p9999": nan}


# --------------------------------------------------------------------------
# bridge to core.evt's Fisher–Tippett domain machinery
# --------------------------------------------------------------------------


def domain_of_fit(fit: GPDFit, tol: float = 0.05):
    """Map a fitted GPD shape to the Fisher–Tippett domain of attraction:
    ξ > tol → Fréchet (tail index 1/ξ), |ξ| ≤ tol → Gumbel, ξ < -tol →
    reversed-Weibull (finite endpoint)."""
    from ..core.evt import Domain

    if fit.xi != fit.xi:
        raise ValueError("cannot classify an empty fit")
    if fit.xi > tol:
        return Domain.FRECHET
    if fit.xi < -tol:
        return Domain.WEIBULL
    return Domain.GUMBEL


def gpd_params_of(dist, u: float) -> tuple[float, float]:
    """Analytic POT parameters (ξ, σ(u)) for the repo's families.

    The Pickands–Balkema–de Haan counterpart of `core.evt.classify`:
    Pareto(α) exceedances over u are *exactly* GPD(ξ=1/α, σ=u/α);
    ShiftedExp(μ) exactly GPD(0, 1/μ); Uniform(a, b) exactly
    GPD(-1, b-u); Weibull(k, λ) asymptotically GPD(0, η(u)) with the
    hazard auxiliary η(u) = λ^k u^{1-k}/k from Theorem 6.  Together with
    `GPDFit.quantile` this reproduces the family quantile functions —
    the identity the property tests pin.
    """
    from ..core.distributions import Pareto, ShiftedExp, Uniform, Weibull
    from ..core.evt import classify

    info = classify(dist)  # raises for families with no DA classification
    lo, hi = dist.support()
    if not lo <= u < hi:
        raise ValueError(f"threshold u={u} outside support [{lo}, {hi})")
    if isinstance(dist, Pareto):
        return 1.0 / dist.alpha, u / dist.alpha
    if isinstance(dist, ShiftedExp):
        return 0.0, info.eta
    if isinstance(dist, Weibull):
        return 0.0, (dist.lam ** dist.k) * u ** (1.0 - dist.k) / dist.k
    if isinstance(dist, Uniform):
        return -1.0 / info.xi, (hi - u) / info.xi
    raise ValueError(f"no analytic GPD parameters for {type(dist).__name__}")
