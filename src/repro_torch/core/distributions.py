"""Execution-time distributions (paper §2.2, §3.2), in PyTorch.

Counterpart of `repro.core.distributions`.  Every distribution exposes

  tail(x)      = Pr(X > x)                      (F̄_X)
  cdf(x)       = Pr(X <= x)
  quantile(u)  = F_X^{-1}(u)                    (inverse c.d.f.)
  mean()       = E[X]
  sample(generator, shape)                      (inverse-transform sampling)

Math is float32 torch on the device of the argument; parameters are Python
floats on frozen dataclasses, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "Distribution",
    "ShiftedExp",
    "Pareto",
    "Uniform",
    "Weibull",
    "Empirical",
]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


class Distribution:
    """Base class; subclasses implement tail/quantile analytically."""

    def tail(self, x):
        raise NotImplementedError

    def cdf(self, x):
        return 1.0 - self.tail(x)

    def quantile(self, u):
        raise NotImplementedError

    def mean(self):
        raise NotImplementedError

    def support(self) -> Tuple[float, float]:
        """(lower, upper) end points; upper may be inf."""
        raise NotImplementedError

    def sample(self, generator: torch.Generator, shape=()):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return self.quantile(u)


@dataclasses.dataclass(frozen=True)
class ShiftedExp(Distribution):
    """ShiftedExp(Δ, μ): F̄(x) = exp(-μ(x-Δ)) for x >= Δ (paper eq. (9))."""

    delta: float
    mu: float

    def tail(self, x):
        x = _f32(x)
        return torch.where(x >= self.delta, torch.exp(-self.mu * (x - self.delta)), 1.0)

    def quantile(self, u):
        u = _f32(u).clamp(0.0, 1.0 - 1e-12)
        return self.delta - torch.log1p(-u) / self.mu

    def mean(self):
        return self.delta + 1.0 / self.mu

    def support(self):
        return (self.delta, float("inf"))


@dataclasses.dataclass(frozen=True)
class Pareto(Distribution):
    """Pareto(α, x_m): F̄(x) = (x_m/x)^α for x >= x_m (paper eq. (13))."""

    alpha: float
    xm: float

    def tail(self, x):
        x = _f32(x)
        safe = torch.clamp(x, min=self.xm)
        return torch.where(x >= self.xm, (self.xm / safe) ** self.alpha, 1.0)

    def quantile(self, u):
        u = _f32(u).clamp(0.0, 1.0 - 1e-12)
        return self.xm * (1.0 - u) ** (-1.0 / self.alpha)

    def mean(self):
        if self.alpha <= 1.0:
            return float("inf")
        return self.alpha * self.xm / (self.alpha - 1.0)

    def support(self):
        return (self.xm, float("inf"))


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    """Uniform(a, b): finite upper end point ⇒ DA(Ψ_1) (reversed-Weibull)."""

    a: float
    b: float

    def tail(self, x):
        x = _f32(x)
        return torch.clamp((self.b - x) / (self.b - self.a), 0.0, 1.0)

    def quantile(self, u):
        return self.a + (self.b - self.a) * _f32(u).clamp(0.0, 1.0)

    def mean(self):
        return 0.5 * (self.a + self.b)

    def support(self):
        return (self.a, self.b)


@dataclasses.dataclass(frozen=True)
class Weibull(Distribution):
    """Weibull(k, lam): F̄(x) = exp(-(x/λ)^k); DA(Λ) for any k > 0."""

    k: float
    lam: float

    def tail(self, x):
        x = _f32(x)
        return torch.exp(-torch.clamp(x, min=0.0) ** self.k / self.lam**self.k)

    def quantile(self, u):
        u = _f32(u).clamp(0.0, 1.0 - 1e-12)
        return self.lam * (-torch.log1p(-u)) ** (1.0 / self.k)

    def mean(self):
        return self.lam * math.gamma(1.0 + 1.0 / self.k)

    def support(self):
        return (0.0, float("inf"))


class Empirical(Distribution):
    """Empirical distribution F̂_X from n execution-time samples (paper §4).

    tail/cdf are the right-continuous step functions of the sample; quantile
    is the type-1 inverse `sorted[clip(ceil(u·n) - 1, 0, n - 1)]`.  Sampling
    is bootstrap resampling, as Algorithm 1 prescribes.  `sorted` is a
    float32 tensor on the device of the samples given (the CPU for numpy
    input); methods move it to their argument's device.
    """

    def __init__(self, samples):
        if not torch.is_tensor(samples):
            samples = torch.as_tensor(np.array(samples))
        if samples.ndim != 1:
            raise ValueError("Empirical expects a 1-D sample vector")
        self.sorted = torch.sort(samples.to(torch.float32)).values
        self.n = int(samples.shape[0])

    def _xs(self, like: torch.Tensor) -> torch.Tensor:
        return self.sorted.to(like.device)

    def tail(self, x):
        x = _f32(x)
        idx = torch.searchsorted(self._xs(x), x, right=True)
        return 1.0 - idx / self.n

    def cdf(self, x):
        x = _f32(x)
        idx = torch.searchsorted(self._xs(x), x, right=True)
        return idx / self.n

    def quantile(self, u):
        u = _f32(u).clamp(0.0, 1.0)
        idx = torch.clamp(torch.ceil(u * self.n).to(torch.int32) - 1, 0, self.n - 1)
        return self._xs(u)[idx]

    def mean(self):
        return torch.mean(self.sorted)

    def support(self):
        return (float(self.sorted[0]), float(self.sorted[-1]))

    def sample(self, generator: torch.Generator, shape=()):
        idx = torch.randint(0, self.n, shape, generator=generator, device=generator.device)
        return self.sorted.to(generator.device)[idx]
