"""Algorithm 1 — bootstrap latency/cost estimation from empirical traces.

Counterpart of `repro.core.bootstrap`.  Given n task execution-time samples,
estimate (E[T], E[C]) of a single-fork policy by bootstrapping:

  1. F̂_X = empirical cdf of the samples.
  2. F̂_Y from eq. (7) — tabulated on a y-grid, sampled by inverse transform.
  3. Repeat m times: resample n from F̂_X, sort; T̂1 = k-th smallest
     (k = (1-p)n), Ĉ1 = Σ_{j<=k} x̂_(j); draw k' = pn residuals from F̂_Y,
     T̂2 = max, Y_sum = Σ; T̂ = T̂1 + T̂2, Ĉ = (Ĉ1 + pn·T̂1 + (r+1)·Y_sum)/n.
  4. Output the means and their standard errors (Theorem 4).

The m replicates are a batch dimension.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import generator as _generator
from ..device import resolve_device
from .policy import SingleForkPolicy, num_stragglers

__all__ = ["BootstrapEstimate", "estimate", "residual_tail_grid"]

_GRID = 4096


@dataclasses.dataclass(frozen=True)
class BootstrapEstimate:
    latency: float
    cost: float
    latency_stderr: float
    cost_stderr: float

    def as_tuple(self):
        return (self.latency, self.cost)


def residual_tail_grid(samples: np.ndarray, policy: SingleForkPolicy, grid: int = _GRID):
    """Tabulate F̄_Y on a y-grid from the empirical F̄_X via eq. (7).

    Host numpy in float64, as the reference; returns (ys, tail_y) as
    float32 CPU tensors.
    """
    xs = np.sort(np.asarray(samples, dtype=np.float64))
    n = xs.shape[0]
    p, r = policy.p, policy.r

    def tail_x(y):
        return 1.0 - np.searchsorted(xs, y, side="right") / n

    fork = float(np.quantile(xs, 1.0 - p, method="inverted_cdf"))
    hi = float(xs[-1]) * 1.0 + 1e-9
    ys = np.linspace(0.0, hi, grid)
    if policy.keep:
        ty = np.clip(tail_x(ys) ** r * tail_x(ys + fork) / p, 0.0, 1.0)
    else:
        ty = np.clip(tail_x(ys) ** (r + 1), 0.0, 1.0)
    ty[0] = 1.0
    ty = np.minimum.accumulate(ty)
    return torch.as_tensor(ys, dtype=torch.float32), torch.as_tensor(ty, dtype=torch.float32)


def interp(x, xp, fp):
    """`jnp.interp` semantics: linear between the points of the sorted xp,
    constant beyond its ends, and the left value across a zero-width step."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _bootstrap_core(generator, sorted_x, ys, tail_y, k: int, s: int, rp1: float, n: int, m: int):
    """m bootstrap replicates of (T̂, Ĉ), as (m,) tensors."""
    dev = sorted_x.device
    cdf_y = 1.0 - tail_y
    iota = torch.arange(n, device=dev)
    idx = torch.randint(0, n, (m, n), generator=generator, device=dev)
    xhat = torch.sort(sorted_x[idx], dim=-1).values
    t1 = xhat[:, k - 1]
    c1 = torch.where(iota < k, xhat, 0.0).sum(dim=-1)
    u = torch.rand((m, n), generator=generator, device=dev)
    yhat = interp(u, cdf_y, ys)
    mask = iota < s
    t2 = torch.where(mask, yhat, -torch.inf).amax(dim=-1)
    ysum = torch.where(mask, yhat, 0.0).sum(dim=-1)
    return t1 + t2, (c1 + s * t1 + rp1 * ysum) / n


def estimate(
    samples,
    policy: SingleForkPolicy,
    m: int = 1000,
    seed: int = 0,
    device=None,
) -> BootstrapEstimate:
    """Run Algorithm 1 with m bootstrap replicates."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    xs = np.sort(np.asarray(samples, dtype=np.float64))
    n = xs.shape[0]
    sorted_x = torch.as_tensor(xs, dtype=torch.float32, device=dev)

    if policy.is_baseline:
        idx = torch.randint(0, n, (m, n), generator=g, device=dev)
        xhat = sorted_x[idx]
        lat, cost = xhat.amax(dim=-1), xhat.mean(dim=-1)
    else:
        s = num_stragglers(n, policy.p)
        ys, tail_y = residual_tail_grid(xs, policy)
        lat, cost = _bootstrap_core(
            g, sorted_x, ys.to(dev), tail_y.to(dev), n - s, s, float(policy.r + 1), n, m
        )

    return BootstrapEstimate(
        latency=float(lat.mean()),
        cost=float(cost.mean()),
        latency_stderr=float(lat.std(correction=0) / math.sqrt(m)),
        cost_stderr=float(cost.std(correction=0) / math.sqrt(m)),
    )
