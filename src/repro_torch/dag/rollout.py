"""Fused stage-composed DAG rollouts in PyTorch: the vectorized fast path
for multi-stage jobs.

Counterpart of `repro.dag.rollout`.  A DAG job traverses its stages
through barriers: stage s cannot start until every predecessor's *last*
task (straggler included) has finished.  Each stage owns a pool of `c`
gang blocks, so per stage the fleet is a FIFO G/G/c queue whose per-job
service time is that stage's single-gang makespan T(π_s) — the
`fleet.vector` model once per stage, chained by feeding each stage's
completion times to its successors as their arrival (barrier-release)
times.

  * Per stage, ONE shared common-random-number draw set feeds every
    (λ × per-stage-policy-vector) cell (`fleet.vector.cell_tc`: the
    single-fork or lowered evaluator, with the geometric-retry transform
    under a fault), each distinct stage law (the stage's policy, and q)
    evaluated once and gathered to its cells.  The draws of a stage are freed before the next
    stage's are taken; only the per-cell (cells, m, J) tensors carry over.
  * Stage queues run through `fleet.vector.batched_queue`: the
    Kiefer–Wolfowitz kernel (`kernels.kw_queue`, CUDA on the card) at
    c > 1, the closed-form Lindley recursion at c = 1 unless `kernel=True`.
    One call per stage covers every (cell, trial) row.
  * A downstream stage's barrier releases need not be in job order (a
    c > 1 upstream queue completes jobs out of order), so the stage sorts
    its jobs by release time (stable: ties keep job order), runs the FIFO
    queue, and scatters the results back.  A source stage's releases are
    the arrivals, already in order, so it is not sorted.
  * Critical-path attribution: walking back from the sink that finished
    last, each stage on the path credits the predecessor whose barrier
    released it (the first of tied finishes), so per job the stage
    attributions telescope to the sojourn and shares sum to 1.

The generator is consumed stage by stage: stage 0's draws, then the
arrivals, then each later stage's draws.  A one-stage DAG therefore
consumes it exactly as `fleet.vector.frontier` does, and its rows equal the
frontier's bit for bit on the same seed.  Entry points take `seed` in place
of JAX's `key` and `device=None` (the card; pass `device="cpu"` for the
plain PyTorch path).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.policy import SingleForkPolicy, lower_policies, max_replicas
from ..device import generator as _generator
from ..device import resolve_device
from ..fleet.vector import (
    _arrivals,
    _fault_qs,
    _hist_spec,
    _tail_keys,
    as_quantile_source,
    batched_queue,
    _law_tensors,
    cell_tc,
    emp_quantile,
    single_fork,
)
from .graph import JobDAG

__all__ = ["DagRolloutResult", "dag_frontier", "dag_rollout", "stage_queue", "vector_label"]


def vector_label(policies: Sequence[SingleForkPolicy], dag: Optional[JobDAG] = None) -> str:
    """Human-readable per-stage policy vector, e.g. 'map:pi_keep(p=0.1, r=1) | reduce:baseline'."""
    names = dag.names if dag is not None else tuple(f"s{i}" for i in range(len(policies)))
    return " | ".join(f"{n}:{p.label()}" for n, p in zip(names, policies))


def _plan(dag: JobDAG, device):
    """Per stage (n_tasks, c, pred indices, analytic dist or None), the
    sinks' indices, and each stage's sorted empirical samples on `device`
    (a placeholder for analytic stages)."""
    plan, xss = [], []
    for s in dag.stages:
        dist, xs = as_quantile_source(s.dist, device)
        plan.append((s.n_tasks, s.c, tuple(dag.index[d] for d in s.deps), dist))
        xss.append(xs)
    return tuple(plan), tuple(dag.index[n] for n in dag.sinks), tuple(xss)


def _stage_pols(dag: JobDAG, vecs, device, cell_qs=None):
    """Per stage, what `fleet.vector.cell_tc` takes for the stage's
    distinct laws (`fleet.vector._law_tensors`: pol, qs, law_of_cell) and
    whether they take the single-fork program.  Cell i's policy for a stage
    and its q (`cell_qs`, the faulty path) make its law there: a stage's
    rows repeat across λ, and across the vectors that share that stage's
    policy.  Only a grid single-fork in every stage (`single_fork`) takes
    the single-fork program; a grid with any algebra policy in any stage
    takes the lowered program in every stage, as in the reference."""
    lps = [
        lower_policies([vec[s] for vec in vecs], spec.n_tasks)
        for s, spec in enumerate(dag.stages)
    ]
    for lp, spec in zip(lps, dag.stages):
        if (lp.k < 0).any() or (lp.k > spec.n_tasks).any() or (lp.r < 0).any():
            raise ValueError(
                f"stage {spec.name!r}: lowered fork indices must lie in [0, n] "
                "and replica counts >= 0"
            )
    single = all(single_fork(lp) for lp in lps)
    return [_law_tensors(lp, cell_qs, device) + (single,) for lp in lps]


def _resolve_r_caps(dag: JobDAG, cell_vectors, r_caps):
    r_max = [
        max(max_replicas(vec[s]) for vec in cell_vectors)
        for s in range(len(dag.stages))
    ]
    if r_caps is None:
        return tuple(r + 1 for r in r_max)
    r_caps = tuple(int(r) for r in r_caps)
    if len(r_caps) != len(dag.stages):
        raise ValueError(f"need one r_cap per stage, got {len(r_caps)}")
    for s, (cap, rm) in enumerate(zip(r_caps, r_max)):
        if cap < rm + 1:
            raise ValueError(f"stage {dag.stages[s].name!r}: r_cap={cap} < r_max+1={rm + 1}")
    return r_caps


def stage_queue(ready, T, c: int, kernel: bool = False, in_order: bool = False):
    """One stage's FIFO G/G/c queue over (..., n_jobs) rows of barrier
    releases `ready` and gang makespans `T`, in job order: the rows are
    sorted by release time (stable: ties keep job order), queued through
    `fleet.vector.batched_queue` on c unit-speed gang blocks, and the
    results scattered back.  `in_order=True` skips the sort for releases
    already in order (a source stage's arrivals).  Returns (starts,
    finishes, slots)."""
    speeds = torch.ones((c,), device=ready.device)
    if in_order:
        st, fi, _, sl = batched_queue(ready, T, speeds, kernel=kernel)
        return st, fi, sl
    ready_sorted, order = torch.sort(ready, dim=-1, stable=True)
    outs = batched_queue(ready_sorted, torch.gather(T, -1, order), speeds, kernel=kernel)
    st, fi, _, sl = (torch.empty_like(z).scatter_(-1, order, z) for z in outs)
    return st, fi, sl


def _compose(g, xss, pols, lams, plan, n_jobs, m_trials, r_caps, kernel, attempts=None):
    """The stage-composed core: per-stage (cells, m, J) tensors.

    Stages advance in the DAG's validated topological order: each draws its
    CRN set, evaluates each of its distinct laws' (T, C) on it once (in
    chunks under `fleet.vector.CELL_CHUNK_BYTES`), gives every cell its
    law's, frees the draws, and queues its jobs in barrier-release order.
    `pols` is `_stage_pols`' list; a stage with laws' qs takes the
    geometric-retry transform with `attempts` draws.  Returns (arrivals, readys, starts, finishes,
    Ts, Cs), the last five one tensor per stage."""
    shape = (m_trials, n_jobs)
    arrivals = None
    readys, starts, finishes, Ts, Cs = [], [], [], [], []
    for s, (n_s, c_s, preds, dist_s) in enumerate(plan):
        quantile = dist_s.quantile if dist_s is not None else partial(emp_quantile, xss[s])
        pol, qs, law_of_cell, single = pols[s]
        T_s, C_s = cell_tc(g, quantile, pol, qs, shape, n_s, r_caps[s], single, attempts, None, law_of_cell)
        if arrivals is None:
            # after the first stage's draws, as the frontier draws them
            arrivals = _arrivals(g, shape)[None] / lams[:, None, None]
        if not preds:  # a source stage: releases are the arrivals, in order
            ready = arrivals
        else:
            ready = finishes[preds[0]]
            for p in preds[1:]:
                ready = torch.maximum(ready, finishes[p])
        st, fi, _ = stage_queue(ready, T_s, c_s, kernel, in_order=not preds)
        readys.append(ready)
        starts.append(st)
        finishes.append(fi)
        Ts.append(T_s)
        Cs.append(C_s)
    return arrivals, readys, starts, finishes, Ts, Cs


def _critical_attribution(arrivals, readys, finishes, plan, sinks):
    """Per-job critical-path decomposition: attr[s] = the time the job spent
    in stage s *on the path that determined its completion*, else 0.

    Walk backwards from the sink with the max finish; every critical stage
    credits the predecessor whose barrier released it (argmax over the
    predecessors' finishes, the first of tied values, as `torch.argmax`
    and `jnp.argmax` both pick).  The chain telescopes: Σ_s attr_s =
    sojourn, so shares sum to 1.  Returns (sojourn, attrs)."""
    S = len(plan)
    shape = finishes[0].shape
    dev = finishes[0].device
    crit = [torch.zeros(shape, dtype=torch.bool, device=dev) for _ in range(S)]
    if len(sinks) == 1:
        F = finishes[sinks[0]]
        crit[sinks[0]] = torch.ones(shape, dtype=torch.bool, device=dev)
    else:
        sink_f = torch.stack([finishes[s] for s in sinks])
        F = sink_f.amax(dim=0)
        winner = torch.argmax(sink_f, dim=0)
        for j, s in enumerate(sinks):
            crit[s] = winner == j
    attrs = [None] * S
    for s in reversed(range(S)):
        preds = plan[s][2]
        attrs[s] = torch.where(crit[s], finishes[s] - readys[s], 0.0)
        if len(preds) == 1:
            crit[preds[0]] = crit[preds[0]] | crit[s]
        elif preds:
            win = torch.argmax(torch.stack([finishes[p] for p in preds]), dim=0)
            for j, p in enumerate(preds):
                crit[p] = crit[p] | (crit[s] & (win == j))
    return F - arrivals, attrs


#: job-level stats of `_dag_stats`, in stack order; the percentile keys are
#: added host-side
_DAG_KEYS = ("mean_sojourn", "mean_wait", "mean_service", "mean_cost", "sojourn_std_err", "rho")
#: per-stage stats, keyed as "<stage>/<key>" in the row dicts
_DAG_STAGE_KEYS = ("share", "sojourn", "wait", "service", "cost", "rho")


def _dag_stats(arrivals, readys, starts, finishes, Ts, Cs, lams, plan, sinks):
    """One stats row per cell (cells, 6 + 6·S), with the (cells, m, J) job
    sojourns and costs for the percentile keys.  The sojourn's mean and
    standard error are the frontier's expressions, so a one-stage DAG's
    rows equal the frontier's bit for bit."""
    sojourn, attrs = _critical_attribution(arrivals, readys, finishes, plan, sinks)

    def mean(z):  # per cell
        return z.mean(dim=(1, 2))

    cost = sum(Cs)
    per_trial = sojourn.mean(dim=-1)  # (cells, m)
    m = per_trial.shape[1]
    se = per_trial.std(dim=1, correction=0) / math.sqrt(max(m - 1, 1))
    mean_soj = mean(sojourn)
    # per-stage blocks: share, sojourn (ready->finish), wait, service, cost,
    # rho (λ·E[T_s] / c_s, the gang-block occupancy of the stage's pool)
    blocks = [
        torch.stack(
            [
                mean(attrs[s]) / torch.clamp(mean_soj, min=1e-12),
                mean(finishes[s] - readys[s]),
                mean(starts[s] - readys[s]),
                mean(Ts[s]),
                mean(Cs[s]),
                lams * mean(Ts[s]) / plan[s][1],
            ],
            dim=1,
        )
        for s in range(len(plan))
    ]
    rho = torch.stack([b[:, 5] for b in blocks], dim=1).amax(dim=1)
    base = torch.stack(
        [
            mean_soj,
            mean(sum(st - rd for st, rd in zip(starts, readys))),
            mean(sum(Ts)),
            mean(cost),
            se,
            rho,
        ],
        dim=1,
    )
    return torch.cat([base] + blocks, dim=1), sojourn, cost


def _eval_dag_cells(dag, cell_vectors, cell_lams, n_jobs, m_trials, seed, kernel, r_caps,
                    tail="exact", cell_qs=None, attempts=None, device=None):
    """Shared engine behind `dag_frontier` and the joint searches: one stats
    dict per (policy-vector, λ [, q]) cell, all cells on each stage's shared
    draws.  `tail` follows the frontier: "exact" computes the percentile
    keys from the sojourns on the host, "hist" (or an `obs.HistSpec`) from
    histograms counted on the device, adding cost_p* and evt_* keys."""
    if not cell_vectors:
        raise ValueError("need at least one candidate policy vector")
    cell_vectors = [dag.validate_policy_vector(v) for v in cell_vectors]
    if any(lam <= 0 for lam in cell_lams):
        raise ValueError("arrival rate lam must be > 0")
    hist = _hist_spec(tail)
    dev = resolve_device(device)
    plan, sinks, xss = _plan(dag, dev)
    r_caps = _resolve_r_caps(dag, cell_vectors, r_caps)
    n_cells = len(cell_vectors)
    lams = torch.tensor([float(lam) for lam in cell_lams], dtype=torch.float32, device=dev)
    if cell_qs is not None:
        if len(cell_qs) != n_cells:
            raise ValueError("need one q per cell")
        if attempts is None or attempts < 1:
            raise ValueError("cell_qs needs attempts >= 1")
    pols = _stage_pols(dag, cell_vectors, dev, cell_qs)
    paths = _compose(
        _generator(seed, dev), xss, pols, lams, plan, n_jobs, m_trials, r_caps, kernel, attempts=attempts,
    )
    stats, sojourn, cost = _dag_stats(*paths, lams, plan, sinks)
    del paths
    stats = stats.cpu().numpy()
    pcts, cost_pcts, cell_evt = _tail_keys(sojourn, cost, hist)
    rows = []
    nk = len(_DAG_KEYS)
    nsk = len(_DAG_STAGE_KEYS)
    for i, (vec, lam) in enumerate(zip(cell_vectors, cell_lams)):
        row = dict(
            lam=float(lam),
            policies=tuple(vec),
            label=vector_label(vec, dag),
            **dict(zip(_DAG_KEYS, map(float, stats[i, :nk]))),
        )
        if cell_qs is not None:
            row["q"] = float(cell_qs[i])
        row["p50"], row["p99"], row["p999"] = (float(pcts[j, i]) for j in range(3))
        if hist is not None:
            row["cost_p50"], row["cost_p99"], row["cost_p999"] = (
                float(cost_pcts[j, i]) for j in range(3)
            )
            row.update(cell_evt[i])
        for s, spec in enumerate(dag.stages):
            off = nk + s * nsk
            for j, k in enumerate(_DAG_STAGE_KEYS):
                row[f"{spec.name}/{k}"] = float(stats[i, off + j])
        rows.append(row)
    return rows


def dag_frontier(
    dag: JobDAG,
    policy_vectors,
    lams,
    n_jobs: int,
    m_trials: int = 32,
    seed: int = 0,
    kernel: bool = False,
    r_caps=None,
    pad_cells: bool = True,
    tail="exact",
    fault=None,
    device=None,
) -> list[dict]:
    """The whole (per-stage-policy-vector × λ) cross-product over shared
    CRN draws, one draw set per stage.

    `policy_vectors` is a sequence of per-stage tuples (one policy per
    stage, in DAG stage order; `dag.policies()` gives the specs' own).
    Rows come back vector-major with job-level keys (`mean_sojourn` =
    arrival → last sink barrier, `mean_cost` = Σ stages' Definition-2
    costs, `rho` = max per-stage gang-block occupancy, percentiles) plus
    per-stage `"<stage>/<key>"` entries, including `"<stage>/share"`, the
    critical-path attribution (shares sum to 1 per cell).

    `r_caps` pins each stage's fresh-draw width (and so its random
    stream); `pad_cells` is the reference's compile-sharing pad, accepted
    for parity and changing nothing; `kernel=True` sends c = 1 stage queues
    through the queue kernel as well.  `fault` (a `FaultSpec` or a sequence
    — q law, immediate relaunch only) adds a failure axis as in
    `fleet.vector.frontier`: cells = vectors × λs × faults with q fastest,
    every stage samples through the geometric-retry transform, rows gain
    "q", and a single disabled spec reproduces the fault-free rows bit for
    bit.  `tail="hist"` as in the frontier.
    """
    policy_vectors = [tuple(v) for v in policy_vectors]
    lams = [float(lam) for lam in lams]
    if not lams:
        raise ValueError("need at least one arrival rate")
    cell_vectors = [vec for vec in policy_vectors for _ in lams]
    cell_lams = lams * len(policy_vectors)
    cell_qs = attempts = None
    if fault is not None:
        qs, attempts = _fault_qs(fault)
        if len(qs) == 1 and qs[0] == 0.0:
            rows = _eval_dag_cells(
                dag, cell_vectors, cell_lams, n_jobs, m_trials, seed, kernel, r_caps,
                tail=tail, device=device,
            )
            for row in rows:
                row["q"] = 0.0
            return rows
        cell_vectors = [vec for vec in cell_vectors for _ in qs]
        cell_lams = [lam for lam in cell_lams for _ in qs]
        cell_qs = qs * (len(policy_vectors) * len(lams))
    return _eval_dag_cells(
        dag, cell_vectors, cell_lams, n_jobs, m_trials, seed, kernel, r_caps,
        tail=tail, cell_qs=cell_qs, attempts=attempts, device=device,
    )


@dataclasses.dataclass
class DagRolloutResult:
    """Full per-stage sample paths of one (policy-vector, λ) DAG rollout."""

    stage_names: tuple
    arrivals: torch.Tensor  # (m_trials, n_jobs)
    sojourn: torch.Tensor  # (m_trials, n_jobs) arrival -> last sink barrier
    ready: torch.Tensor  # (S, m, J) barrier-release per stage
    start: torch.Tensor  # (S, m, J) stage queue admission
    finish: torch.Tensor  # (S, m, J) stage barrier (last task done)
    service: torch.Tensor  # (S, m, J) per-stage gang makespan T(π_s)
    cost: torch.Tensor  # (S, m, J) per-stage Definition-2 cost
    attr: torch.Tensor  # (S, m, J) critical-path attribution (sums to sojourn)

    @property
    def total_cost(self) -> torch.Tensor:
        return self.cost.sum(dim=0)

    @property
    def wait(self) -> torch.Tensor:
        """(S, m, J) per-stage queueing delay (release -> admission)."""
        return self.start - self.ready

    @property
    def mean_sojourn(self) -> float:
        return float(self.sojourn.mean())

    @property
    def mean_cost(self) -> float:
        return float(self.total_cost.mean())

    @property
    def sojourn_std_err(self) -> float:
        per_trial = self.sojourn.mean(dim=1)
        m = per_trial.shape[0]
        return float(per_trial.std(correction=0) / math.sqrt(max(m - 1, 1)))

    def stage_shares(self) -> dict:
        """E[critical-path time in stage] / E[sojourn]; sums to 1."""
        denom = max(float(self.sojourn.mean()), 1e-12)
        return {name: float(self.attr[s].mean()) / denom for s, name in enumerate(self.stage_names)}

    def summary(self) -> dict:
        out = dict(
            mean_sojourn=self.mean_sojourn,
            mean_cost=self.mean_cost,
            sojourn_std_err=self.sojourn_std_err,
        )
        soj = self.sojourn.cpu().numpy().ravel()
        out["p50"], out["p99"], out["p999"] = (
            float(v) for v in np.percentile(soj, (50.0, 99.0, 99.9))
        )
        for s, name in enumerate(self.stage_names):
            out[f"{name}/sojourn"] = float((self.finish[s] - self.ready[s]).mean())
            out[f"{name}/wait"] = float((self.start[s] - self.ready[s]).mean())
            out[f"{name}/service"] = float(self.service[s].mean())
            out[f"{name}/cost"] = float(self.cost[s].mean())
        for name, share in self.stage_shares().items():
            out[f"{name}/share"] = share
        return out


def dag_rollout(
    dag: JobDAG,
    lam: float,
    n_jobs: int,
    m_trials: int = 32,
    policies: Optional[Sequence] = None,
    seed: int = 0,
    kernel: bool = False,
    r_caps=None,
    device=None,
) -> DagRolloutResult:
    """m_trials independent fleets of n_jobs Poisson(λ) DAG jobs under one
    per-stage policy vector (default: the stage specs' own policies).

    Returns the full per-stage sample paths — barrier releases, queue
    admissions, stage barriers, per-stage (T, C), and the critical-path
    attribution — from the same engine as `dag_frontier`, so a one-cell
    frontier on the same seed reads the same paths.
    """
    if lam <= 0:
        raise ValueError("arrival rate lam must be > 0")
    dev = resolve_device(device)
    vec = dag.validate_policy_vector(policies)
    plan, sinks, xss = _plan(dag, dev)
    r_caps = _resolve_r_caps(dag, [vec], r_caps)
    pols = _stage_pols(dag, [vec], dev)
    lams = torch.tensor([float(lam)], dtype=torch.float32, device=dev)
    arrivals, readys, starts, finishes, Ts, Cs = _compose(
        _generator(seed, dev), xss, pols, lams, plan, n_jobs, m_trials, r_caps, kernel,
    )
    sojourn, attrs = _critical_attribution(arrivals, readys, finishes, plan, sinks)

    def stack(zs):  # (S, m, J): the one cell of each stage
        return torch.stack([z[0] for z in zs])

    return DagRolloutResult(
        stage_names=dag.names,
        arrivals=arrivals[0],
        sojourn=sojourn[0],
        ready=stack(readys),
        start=stack(starts),
        finish=stack(finishes),
        service=stack(Ts),
        cost=stack(Cs),
        attr=stack(attrs),
    )
