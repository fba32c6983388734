"""Vectorized Monte-Carlo simulation of single-/multi-fork job execution.

Counterpart of `repro.core.simulate`: the exact finite-n ground truth (the
points in the paper's Figs. 3 and 5).  Per trial, draw the n original
execution times, apply the fork semantics of Definition 1, read off (T, C)
per Definitions 1–2.  Trials are a batch dimension written out.

Semantics per trial (policy π(p, r), s = pn stragglers):

  T1    = s-th largest original time  (= (1-p)n-th order statistic)
  C1/n  = Σ_{i<=k} X_(i) + s·T1
  Y_j   = min(X_(k+j) - T1, fresh_1..r)       π_keep
        = min(fresh_1..r+1)                   π_kill
  T     = T1 + max_j Y_j
  C·n   = C1 + (r+1)·Σ_j Y_j
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..device import generator as _generator
from ..device import resolve_device
from .distributions import Distribution
from .policy import (
    MODE_QUANTILE,
    MultiForkPolicy,
    SingleForkPolicy,
    lower_policies,
    num_stragglers,
)

__all__ = [
    "SimResult",
    "lowered_policy_eval",
    "policy_draws",
    "simulate",
    "simulate_multifork",
    "single_fork_batch",
    "single_fork_trial",
]


@dataclasses.dataclass
class SimResult:
    latency: torch.Tensor  # (m,) per-trial T
    cost: torch.Tensor  # (m,) per-trial C

    @property
    def mean_latency(self) -> float:
        return float(self.latency.mean())

    @property
    def mean_cost(self) -> float:
        return float(self.cost.mean())

    @property
    def latency_std_err(self) -> float:
        return float(self.latency.std(correction=0) / math.sqrt(self.latency.shape[0]))

    @property
    def cost_std_err(self) -> float:
        return float(self.cost.std(correction=0) / math.sqrt(self.cost.shape[0]))


def single_fork_batch(generator, dist: Distribution, n: int, s: int, r: int, keep: bool, shape=()):
    """(T, C) for a `shape`-batch of independent jobs under π(p, r, keep)
    with s = pn stragglers; all randomness in two bulk draws."""
    x_sorted = torch.sort(dist.sample(generator, tuple(shape) + (n,)), dim=-1).values
    k = n - s
    if s == 0:
        return x_sorted[..., -1], x_sorted.sum(dim=-1) / n

    t1 = x_sorted[..., k - 1]
    iota = torch.arange(n, device=x_sorted.device)
    finished_cost = torch.where(iota < k, x_sorted, 0.0).sum(dim=-1)
    c1 = finished_cost + s * t1

    stragglers = x_sorted[..., k:]
    fresh = dist.sample(generator, tuple(shape) + (s, r + 1))
    if keep:
        remaining = stragglers - t1[..., None]
        y = torch.minimum(remaining, fresh[..., :r].amin(dim=-1)) if r > 0 else remaining
    else:
        y = fresh.amin(dim=-1)

    latency = t1 + y.amax(dim=-1)
    cost = (c1 + (r + 1) * y.sum(dim=-1)) / n
    return latency, cost


def single_fork_trial(generator, dist: Distribution, n: int, s: int, r: int, keep: bool):
    """One job's (T, C): `single_fork_batch` with an empty batch shape
    (the same draws from the same generator state)."""
    return single_fork_batch(generator, dist, n, s, r, keep, shape=())


# --------------------------------------------------------------------------
# the generalized evaluator: one program for the whole policy algebra
# --------------------------------------------------------------------------


def policy_draws(generator, quantile, shape, n: int, r_cap: int, n_stages: int = 1):
    """Shared-CRN draws for the lowered-policy evaluator: x = `shape`-batch
    of n raw (unsorted) original times, fresh = per-stage fresh-replica
    block of width r_cap aligned by completion rank.  Two bulk draws; for
    n_stages=1 they are the same numbers as `fleet.vector.fork_draws`
    before its sort."""
    dev = generator.device
    x = quantile(torch.rand(tuple(shape) + (n,), generator=generator, device=dev))
    fresh = quantile(
        torch.rand(tuple(shape) + (n_stages, n, r_cap), generator=generator, device=dev)
    )
    return x, fresh


def running_min(fresh: torch.Tensor) -> torch.Tensor:
    """Running min over the last (replica) axis: the values of
    `torch.cummin(fresh, dim=-1)`, as r_cap - 1 elementwise minimums.  Min
    is exact, so the values are the same; at the frontier's shapes (a
    replica axis of 2–4 under 33M rows) torch.cummin's scan kernel took
    most of the call's device time (PERF.md, PR 11)."""
    out = torch.empty_like(fresh)
    out[..., 0] = fresh[..., 0]
    for j in range(1, fresh.shape[-1]):
        torch.minimum(out[..., j - 1], fresh[..., j], out=out[..., j])
    return out


def _cell(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(C,) per-cell values shaped to broadcast against (C, ...) of `ndim` dims."""
    return v.reshape(v.shape[:1] + (1,) * (ndim - 1))


def take_replica(cm: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """Per-cell replica column of the running-min'd fresh block.

    cm: (1 or C, B..., n, r_cap); idx: (C,) column per cell; shape: the
    (C, B..., n) result shape.  `torch.gather` raises on an index out of
    range where `jnp.take` would fill, so callers keep idx in [0, r_cap)."""
    full = tuple(shape) + (1,)
    index = _cell(idx.long(), len(full)).expand(full)
    return torch.gather(cm.expand(tuple(shape) + cm.shape[-1:]), -1, index)[..., 0]


def lowered_eval_cells(x, cm, mode, k, t, r, keep, d):
    """`lowered_policy_eval` for C cells at once on shared draws.

    x: (1 or C, B..., n) raw times; cm: (1 or C, B..., S, n, r_cap), the
    fresh block already running-min'd over its replica axis; mode, k, t, r, keep:
    (C, S); d: (C,).  Returns (T, C), each (C, B...).
    """
    n = x.shape[-1]
    n_stages = mode.shape[1]
    n_cells = mode.shape[0]
    shape = (n_cells,) + tuple(x.shape[1:])
    nd = len(shape)
    dev = x.device
    iota = torch.arange(n, device=dev, dtype=torch.int32)
    dc = _cell(d, nd)
    gid = (iota // dc).expand(shape)  # group of each ORIGINAL task index
    pos = iota % dc  # within-group rank after the group-blocked sort
    base = gid * dc

    finish = x.expand(shape)
    cohorts = [(torch.zeros_like(x), torch.ones_like(x))]  # (start, n_copies)
    cost = torch.zeros(shape[:-1], dtype=x.dtype, device=dev)
    t_leg = c_leg = None
    for s in range(n_stages):
        # group-blocked sort: two-level STABLE argsort (values, then group
        # ids); for d = n the group ids are all zero and perm sorts finish
        o1 = torch.argsort(finish, dim=-1, stable=True)
        o2 = torch.argsort(torch.gather(gid, -1, o1), dim=-1, stable=True)
        perm = torch.gather(o1, -1, o2)
        f_p = torch.gather(finish, -1, perm)

        mode_s, k_s, t_s, r_s, keep_s = (_cell(v[:, s], nd) for v in (mode, k, t, r, keep))
        is_q = mode_s == MODE_QUANTILE
        # each position's group fork instant: the group's k-th finish
        tau_q = torch.gather(f_p, -1, torch.clamp(base + k_s - 1, min=0).long())
        tau = torch.where(is_q, tau_q, t_s)
        # inactive padding stages lower to mode=-1 with t=inf → no stragglers
        strag = torch.where(is_q, pos >= k_s, f_p > t_s)

        cms = cm[..., s, :, :]
        fresh_keep = torch.where(
            r_s > 0, take_replica(cms, torch.clamp(r[:, s] - 1, min=0), shape), torch.inf
        )
        fresh_kill = take_replica(cms, r[:, s], shape)
        remaining = f_p - tau
        y = torch.where(keep_s, torch.minimum(remaining, fresh_keep), fresh_kill)
        y = torch.where(strag, y, 0.0)

        if n_stages == 1:
            # the single-fork op sequence of `masked_single_fork`, bit for
            # bit (selected below for quantile cells at full width)
            k0 = k_s[..., 0]
            t1 = torch.gather(
                f_p, -1, torch.clamp(k_s - 1, min=0).long().expand(shape[:-1] + (1,))
            )[..., 0]
            c1 = torch.where(strag, 0.0, f_p).sum(dim=-1) + (n - k0) * t1
            t_leg = t1 + y.amax(dim=-1)
            c_leg = (c1 + (r_s[..., 0] + 1.0) * y.sum(dim=-1)) / n

        # back to original task order, then cohort accounting
        def unperm(v):
            return torch.empty_like(v).scatter_(-1, perm, v)

        strag_o = unperm(strag & (mode_s >= 0))
        tau_o = unperm(tau)
        newf = unperm(torch.where(strag, tau + y, f_p))
        settle = strag_o & ~keep_s
        new_cohorts = []
        for start, count in cohorts:
            cost = cost + torch.where(
                settle, count * torch.clamp(tau_o - start, min=0.0), 0.0
            ).sum(dim=-1)
            new_cohorts.append((start, torch.where(settle, 0.0, count)))
        extra = torch.where(strag_o, torch.where(keep_s, r_s * 1.0, r_s + 1.0), 0.0)
        new_cohorts.append((torch.where(strag_o, tau_o, 0.0), extra))
        cohorts = new_cohorts
        finish = newf
    for start, count in cohorts:
        cost = cost + (count * torch.clamp(finish - start, min=0.0)).sum(dim=-1)
    t_gen = finish.amax(dim=-1)
    c_gen = cost / n
    if n_stages == 1:
        use_leg = _cell((mode[:, 0] == MODE_QUANTILE) & (d == n), nd - 1)
        return torch.where(use_leg, t_leg, t_gen), torch.where(use_leg, c_leg, c_gen)
    return t_gen, c_gen


def lowered_policy_eval(x, fresh, mode, k, t, r, keep, d):
    """(T, C) for one lowered policy cell on shared draws.

    Evaluates the full algebra — quantile- and time-triggered stages,
    keep|kill, group selection, multi-stage schedules — with the lowered
    params of `core.policy.lower_policies` as tensors:

      x      (..., n)             raw original execution times
      fresh  (..., S, n, r_cap)   fresh-replica draws, running-min'd here
      mode, k, t, r, keep  (S,)   per-stage lowered params
      d      ()                   group width (= n → unrestricted)

    Passing (C, S) params and a (C,) d evaluates C cells on the same draws
    and gives results with a leading C dimension.  Single-stage quantile
    cells at full width reproduce `fleet.vector.masked_single_fork` bit
    for bit.
    """
    one = mode.ndim == 1
    if one:
        mode, k, t, r, keep = (v[None] for v in (mode, k, t, r, keep))
        d = torch.as_tensor(d, device=x.device).reshape(1)
    cm = running_min(fresh)
    T, C = lowered_eval_cells(x[None], cm[None], mode, k, t, r, keep, d)
    return (T[0], C[0]) if one else (T, C)


def simulate(
    dist: Distribution,
    policy,
    n: int,
    m: int = 1000,
    seed: int = 0,
    device=None,
) -> SimResult:
    """m Monte-Carlo trials of an n-task job under `policy`.

    `SingleForkPolicy` runs `single_fork_batch`; every other algebra policy
    lowers to the tensor evaluator on the same draw layout.  `OnClass`
    placement is queue geometry, not single-job sampling — rejected here.
    """
    dev = resolve_device(device)
    g = _generator(seed, dev)
    if isinstance(policy, SingleForkPolicy):
        s = num_stragglers(n, policy.p)
        lat, cost = single_fork_batch(g, dist, n, s, policy.r, policy.keep, shape=(m,))
        return SimResult(latency=lat, cost=cost)
    lp = lower_policies([policy], n)
    if lp.class_names[0] is not None:
        raise ValueError(
            "OnClass policies restrict placement in a fleet; a single job "
            "has no machine classes to restrict"
        )
    mode, k, t, r, keep, d = (
        torch.as_tensor(v, device=dev) for v in (lp.mode, lp.k, lp.t, lp.r, lp.keep, lp.d)
    )
    x, fresh = policy_draws(g, dist.quantile, (m,), n, max(lp.r_max + 1, 1), lp.n_stages)
    cm = running_min(fresh)
    lat, cost = lowered_eval_cells(x[None], cm[None], mode, k, t, r, keep, d)
    return SimResult(latency=lat[0], cost=cost[0])


# --------------------------------------------------------------------------
# multi-fork generalization ([24, §6.4]) — simulation only
# --------------------------------------------------------------------------


def simulate_multifork(
    dist: Distribution,
    policy: MultiForkPolicy,
    n: int,
    m: int = 1000,
    seed: int = 0,
    device=None,
) -> SimResult:
    """Event-accurate multi-fork simulation, m trials as a batch.

    Tracked per task: earliest possible finish time given the copies
    launched so far.  At each stage i (triggered when (1-p_i)n tasks are
    done) every unfinished task gets r_i fresh copies (kill_i additionally
    discards the old copies).  Cost accounting mirrors Definition 2.
    """
    dev = resolve_device(device)
    g = _generator(seed, dev)
    finish = dist.sample(g, (m, n))
    cost = torch.zeros((m,), device=dev)
    cohorts = [(torch.zeros((m, n), device=dev), torch.ones((m, n), device=dev))]
    for p_i, r_i, keep_i in policy.stages:
        k_i = n - num_stragglers(n, p_i)
        t_fork = torch.sort(finish, dim=-1).values[:, k_i - 1 : k_i]
        unfinished = finish > t_fork
        n_fresh = r_i if keep_i else r_i + 1
        fresh = dist.sample(g, (m, n, max(n_fresh, 1)))
        fresh_finish = t_fork + fresh.amin(dim=-1)
        if not keep_i:
            new_cohorts = []
            for start, count in cohorts:
                cost = cost + torch.where(
                    unfinished, count * torch.clamp(t_fork - start, min=0.0), 0.0
                ).sum(dim=-1)
                new_cohorts.append((start, torch.where(unfinished, 0.0, count)))
            cohorts = new_cohorts
            finish = torch.where(unfinished, fresh_finish, finish)
            extra = torch.where(unfinished, float(r_i + 1), 0.0)
            cohorts.append((t_fork.expand(m, n), extra))
        elif r_i > 0:
            finish = torch.where(unfinished, torch.minimum(finish, fresh_finish), finish)
            cohorts.append((t_fork.expand(m, n), torch.where(unfinished, float(r_i), 0.0)))
    for start, count in cohorts:
        cost = cost + (count * torch.clamp(finish - start, min=0.0)).sum(dim=-1)
    return SimResult(latency=finish.amax(dim=-1), cost=cost / n)
