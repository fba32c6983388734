"""Residual execution time Y of a straggling task after the fork point
(paper Theorem 1, eq. (7)), in PyTorch.

    F̄_Y(y) = F̄_X(y)^{r+1}                                   for π_kill(p, r)
    F̄_Y(y) = (1/p) · F̄_X(y)^r · F̄_X(y + F_X^{-1}(1-p))      for π_keep(p, r)

Counterpart of `repro.core.residual`.  Quantiles come from monotone
bisection on the tail with the reference's fixed iteration counts (its two
`fori_loop`s are plain loops here).  Math is float32 on the argument's
device.
"""

from __future__ import annotations

import torch

from .distributions import Distribution, _f32
from .policy import SingleForkPolicy

__all__ = ["ResidualDistribution"]

_BISECT_ITERS = 60
_GROW_ITERS = 60


class ResidualDistribution(Distribution):
    def __init__(self, base: Distribution, policy: SingleForkPolicy):
        if policy.p <= 0.0:
            raise ValueError("residual distribution needs p > 0 (a fork must occur)")
        self.base = base
        self.policy = policy
        # T^(1) → F_X^{-1}(1-p) as n→∞ (Central Value Theorem, Thm 4)
        self.fork_time = float(base.quantile(1.0 - policy.p))

    def tail(self, y):
        y = _f32(y)
        r, p = self.policy.r, self.policy.p
        base_tail = torch.clamp(self.base.tail(y), 0.0, 1.0)
        if self.policy.keep:
            cond = torch.clamp(self.base.tail(y + self.fork_time) / p, 0.0, 1.0)
            t = base_tail**r * cond
        else:
            t = base_tail ** (r + 1)
        return torch.where(y <= 0.0, 1.0, torch.clamp(t, 0.0, 1.0))

    def quantile(self, u):
        """F_Y^{-1}(u) by bisection on the (monotone, right-continuous) cdf."""
        u = _f32(u).clamp(0.0, 1.0 - 1e-7)
        target_tail = 1.0 - u
        hi = torch.full_like(u, max(1.0, self.fork_time))
        for _ in range(_GROW_ITERS):  # grow an upper bracket until tail(hi) <= every target
            if bool(torch.any(self.tail(hi) > target_tail)):
                hi = hi * 2.0
        lo = torch.zeros_like(hi)
        for _ in range(_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            too_low = self.tail(mid) > target_tail  # mid below the quantile
            lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
        return 0.5 * (lo + hi)

    def mean(self, num: int = 8192):
        """E[Y] = ∫_0^∞ F̄_Y(y) dy (Y >= 0), integrated to a far quantile."""
        hi = float(self.quantile(1.0 - 1e-6))
        ys = torch.linspace(0.0, hi, num, dtype=torch.float32)
        return torch.trapezoid(self.tail(ys), ys)

    def support(self):
        return (0.0, self.base.support()[1])

    def sample(self, generator: torch.Generator, shape=()):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return self.quantile(u)
