"""The plain reference of the planner's queries, in PyTorch, written from the
paper's definitions and independent of the program.

It imports nothing of the program (nor JAX).  It is handed what the
benchmark made (the trace, the policy grid as plain data, the loads and
the query's seed) and works everything else out again:

* **Draws.**  The planner is a Monte-Carlo engine on common random numbers,
  so its outputs can only be judged draw for draw.  The reference takes the
  uniforms from a `torch.Generator` seeded with the query's seed on the same
  device, in the order and shapes the planner documents (`describe` below):
  the original times, the fresh replica block, then the arrivals.  Task
  times are the type-1 inverse of the sorted trace.
* **Single job** (Definitions 1-2, and their multi-stage and time-triggered
  forms): per stage the tasks are ranked by their current finish (stable);
  a quantile stage forks at the k-th finish with k = n - pn (pn rounded half
  up, at least 1), a time stage at its instant; the task at rank i draws its
  fresh copies from column i of the fresh block.  Keep: a straggler finishes
  at tau + min(remaining, min of r fresh); kill: at tau + min of r + 1 fresh,
  its running copies charged up to tau.  Cost is the copy-seconds of every
  copy over n.
* **Queue**: per (cell, trial) a FIFO G/G/c queue on c unit-speed gang
  blocks, one job at a time: the lowest-index slot idle at the arrival,
  else the lowest-index slot among the earliest-freeing; start = max(a,
  free), finish = start + T.
* **Rows**: the means, standard error, loads and `np.percentile` tails.

`dtype` runs all of it in a lower precision: that is the control, which the
comparison has to fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: row keys compared
ROW_KEYS = ("mean_sojourn", "mean_wait", "mean_service", "mean_cost", "utilization",
            "sojourn_std_err", "rho", "rho_work", "rho_block", "p50", "p99", "p999", "util_default")


def stragglers(n: int, p: float) -> int:
    """pn rounded half up, at least 1 for p > 0 and at most n - 1."""
    if p <= 0.0:
        return 0
    return max(1, min(n - 1, int(math.floor(p * n + 0.5))))


def stages_of(spec) -> list:
    """A policy spec (see `bench.spec`) as its fork stages
    [(kind "q"|"t", p or t, r, keep)]; the baseline has none."""
    (kind, val), = spec.items()
    if kind == "single":
        p, r, keep = val
        return [] if p == 0.0 or (keep and r == 0) else [("q", float(p), int(r), bool(keep))]
    if kind == "delayed":
        t, r, keep = val
        return [("t", float(t), int(r), bool(keep))]
    if kind == "multi":
        return [("q", float(p), int(r), bool(keep)) for p, r, keep in val]
    raise ValueError(f"unknown policy kind {kind!r}")


def describe(policies: list) -> dict:
    """The draw layout of the grid: the fresh width r_cap (largest
    r + 1), the fork stages S, and whether every cell is a single
    quantile fork (the sorted layout) or not (raw times, S fresh blocks)."""
    st = [stages_of(p) for p in policies]
    r_max = max((r for s in st for _, _, r, _ in s), default=0)
    general = any(len(s) > 1 or any(k == "t" for k, _, _, _ in s) for s in st)
    return dict(stages=st, r_cap=r_max + 1, S=max(1, max(len(s) for s in st)), general=general)


def quantile(xs, u):
    """Type-1 inverse of the sorted sample xs: xs[clip(ceil(u n) - 1, 0, n - 1)]."""
    n = xs.shape[0]
    return xs[torch.clamp(torch.ceil(u * n).long() - 1, 0, n - 1)]


def running_min(fresh):
    """The running minimum over the last (replica) axis."""
    out = fresh.clone()
    for j in range(1, fresh.shape[-1]):
        torch.minimum(out[..., j - 1], out[..., j], out=out[..., j])
    return out


def single_job(x, cm, stages, n, ranked=False):
    """(T, C) of every job of the batch under one policy.

    x: (B..., n) task times (`ranked`: already in ascending order); cm:
    (B..., S, n, r_cap), the running minimum of each rank's fresh draws
    over the replica axis."""
    finish = x
    zero = torch.zeros_like(x)
    cohorts = [(zero, torch.ones_like(x))]  # (start, copies) of each task
    cost = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    rank = torch.arange(n, device=x.device)
    for s, (kind, val, r, keep) in enumerate(stages):
        if ranked and s == 0:  # a stable sort of sorted times keeps them in place
            order = rank.expand(finish.shape)
        else:
            order = torch.argsort(finish, dim=-1, stable=True)
        f = torch.gather(finish, -1, order)
        if kind == "q":
            k = n - stragglers(n, val)
            tau = f[..., k - 1:k]
            strag = (rank >= k).expand(f.shape)
        else:
            tau = torch.full_like(f[..., :1], val)
            strag = f > tau
        col = cm[..., s, :, :]
        if keep:
            fresh = col[..., r - 1] if r > 0 else torch.full_like(f, math.inf)
            y = torch.minimum(f - tau, fresh)
        else:
            y = col[..., r]
        new = torch.where(strag, tau + y, f)
        back = torch.empty_like(order).scatter_(-1, order, rank.expand(order.shape))
        strag_t = torch.gather(strag, -1, back)
        finish = torch.gather(new, -1, back)
        tau_t = tau.expand(f.shape)
        if not keep:  # the running copies of a straggler stop at tau
            settled = []
            for start, count in cohorts:
                cost = cost + torch.where(strag_t, count * torch.clamp(tau_t - start, min=0.0), 0.0).sum(-1)
                settled.append((start, torch.where(strag_t, 0.0, count)))
            cohorts = settled
        extra = float(r if keep else r + 1)
        cohorts.append((torch.where(strag_t, tau_t, zero), torch.where(strag_t, extra, 0.0).to(x.dtype)))
    for start, count in cohorts:
        cost = cost + (count * torch.clamp(finish - start, min=0.0)).sum(-1)
    return finish.amax(dim=-1), cost / n


def fifo_queue(ready, service, c):
    """Every row of (B, J) a FIFO queue on c unit-speed slots.  Returns
    (starts, finishes)."""
    B, J = ready.shape
    lane = torch.arange(c, device=ready.device)
    free = torch.zeros((B, c), dtype=ready.dtype, device=ready.device)
    starts = torch.empty_like(ready)
    finishes = torch.empty_like(ready)
    rows = torch.arange(B, device=ready.device)
    for j in range(J):
        a = ready[:, j]
        idle = torch.where(free <= a[:, None], lane, c).amin(dim=1)
        slot = torch.where(idle < c, idle, torch.argmin(free, dim=1))
        start = torch.maximum(a, free[rows, slot])
        fin = start + service[:, j]
        free[rows, slot] = fin
        starts[:, j], finishes[:, j] = start, fin
    return starts, finishes


def cells_tc(g, xs, n, lay, shape):
    """(T, C) of every cell of the grid, each (cells, *shape), on the
    query's draws."""
    dev = xs.device
    S, r_cap = lay["S"], lay["r_cap"]
    fresh_shape = tuple(shape) + ((S, n, r_cap) if lay["general"] else (n, r_cap))
    x = quantile(xs, torch.rand(tuple(shape) + (n,), generator=g, device=dev))
    cm = running_min(quantile(xs, torch.rand(fresh_shape, generator=g, device=dev)))
    if not lay["general"]:
        x = torch.sort(x, dim=-1).values
        cm = cm.unsqueeze(-3)
    done = {}  # (T, C) depend on the policy, not on the load
    Ts, Cs = [], []
    for stages in lay["stages"]:
        if tuple(stages) not in done:
            done[tuple(stages)] = single_job(x, cm, stages, n, ranked=not lay["general"])
        T, C = done[tuple(stages)]
        Ts.append(T)
        Cs.append(C)
    return torch.stack(Ts), torch.stack(Cs)


def _mean(z):
    return z.mean(dim=(1, 2))


def _pcts(soj) -> np.ndarray:
    """np.percentile's linear rule over each cell's sojourns: (3, cells)."""
    a = soj.float().reshape(soj.shape[0], -1).cpu().numpy()
    return np.stack([np.percentile(row, (50.0, 99.0, 99.9)) for row in a], axis=1)


def _se(soj):
    per_trial = soj.float().mean(dim=-1)
    m = per_trial.shape[1]
    return per_trial.std(dim=1, correction=0) / math.sqrt(max(m - 1, 1))


def query(model, seed: int, device, dtype=torch.float32) -> dict:
    """One query of the cell: the (T, C) and the queue's finishes of every
    job of every cell, and the rows.

    `model` is the cell as `bench.spec.Model` makes it: the trace, n, c,
    the grid's (policy spec, load) cells, trials m and jobs J."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    n, c = model.n, model.c
    shape = (model.m_trials, model.n_jobs)
    cells = model.cells()
    lams = torch.tensor([lam for _, lam in cells], dtype=torch.float32, device=dev)
    xs = torch.sort(torch.as_tensor(np.asarray(model.samples, dtype=np.float32), device=dev)).values
    T, C = cells_tc(g, xs.to(dtype), n, describe([pol for pol, _ in cells]), shape)
    gaps = torch.empty(shape, device=dev).exponential_(generator=g)
    arrivals = (torch.cumsum(gaps, dim=-1)[None] / lams[:, None, None]).to(dtype)
    J = shape[-1]
    start, fin = (z.reshape(arrivals.shape) for z in fifo_queue(arrivals.reshape(-1, J), T.reshape(-1, J), c))

    lams = lams.to(dtype)
    soj = fin - arrivals
    makespan = torch.clamp(fin.amax(dim=-1) - arrivals[..., 0], min=1e-12)
    util = ((C * n).float().sum(dim=-1) / (c * n * makespan.float())).mean(dim=1)
    rho_work = lams.float() * _mean(C).float() / c
    rho_block = lams.float() * _mean(T).float() / c
    cols = dict(mean_sojourn=_mean(soj), mean_wait=_mean(start - arrivals), mean_service=_mean(T),
                mean_cost=_mean(C), utilization=util, sojourn_std_err=_se(soj),
                rho=torch.maximum(rho_work, rho_block), rho_work=rho_work, rho_block=rho_block, util_default=util)
    cols = {k: v.float().cpu().numpy() for k, v in cols.items()}
    pcts = _pcts(soj)
    rows = []
    for i in range(T.shape[0]):
        row = {k: float(v[i]) for k, v in cols.items()}
        row["p50"], row["p99"], row["p999"] = (float(pcts[j, i]) for j in range(3))
        rows.append(row)
    return dict(T=T, C=C, fin=fin, rows=rows)
