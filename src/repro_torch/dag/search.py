"""Joint per-stage policy search over a DAG's replication policies.

Counterpart of `repro.dag.search`: every entry point takes `seed` (the
frontier's generator seed) in place of JAX's `key`, and `device=None` (the
card; pass `device="cpu"` for the plain PyTorch path).

The search space is a product grid: one candidate list per stage, a policy
*vector* per point.  Because stage policies couple through the barrier (a
map-stage straggler delays every reduce task, a reduce-pool overload queues
jobs that map capacity already paid for), the best vector is generally NOT
the best single-stage policy applied uniformly — the demo and bench gate
exactly that separation.

Two modes, both running every evaluation through the fused stage-composed
engine (`dag.rollout.dag_frontier`) so a whole candidate set is one device
call over shared CRN draws:

  * `exhaustive_search` — the full cross-product, for small grids (the
    number of cells is Π_s |candidates_s|; fine for the 2-3 stage demos,
    marked `slow` in the tests beyond that);
  * `coordinate_search` — coordinate ascent over stages: sweep stage s's
    candidates with every other stage pinned, adopt the best, repeat until
    a full pass changes nothing (or `max_sweeps`).  Each coordinate step
    is one fused dispatch of |candidates_s| cells; with shared draws the
    argmin per step is variance-reduced, and the same seed is reused across
    steps so successive comparisons are common-random-number consistent.

Both report the `dag_frontier` row per vector — latency E[T], cost E[C]
summed over stages, per-stage critical-path shares — and rank by an
`objective`: "latency" (default), "cost", or a (E[T] + w·E[C]) blend via
`cost_weight`.  Candidates whose `rho` (max per-stage gang-block
occupancy) reaches `rho_max` are vetoed while a stable alternative exists,
mirroring the fleet controller's stability guard.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

from ..core.policy import max_replicas

from .graph import JobDAG
from .rollout import dag_frontier

__all__ = ["best_stable", "coordinate_search", "exhaustive_search", "uniform_vectors"]


def uniform_vectors(dag: JobDAG, candidates: Sequence):
    """The uniform slice of the product grid: the same single-stage policy
    applied to every stage — the baseline a joint search must beat."""
    return [tuple(pol for _ in dag.stages) for pol in candidates]


def _objective_fn(objective: str, cost_weight: float):
    if objective == "latency":
        return lambda row: row["mean_sojourn"] + cost_weight * row["mean_cost"]
    if objective == "cost":
        return lambda row: row["mean_cost"]
    raise ValueError(f"unknown objective {objective!r} (use 'latency' or 'cost')")


def _pick(rows: list[dict], objective, rho_max: float) -> dict:
    """Best row by the objective; ρ-unstable rows are vetoed while any
    stable row exists (the fleet controller's guard, DAG-wide)."""
    stable = [r for r in rows if r["rho"] < rho_max]
    return min(stable or rows, key=objective)


def best_stable(
    rows: list[dict],
    objective: str = "latency",
    cost_weight: float = 0.0,
    rho_max: float = 0.95,
) -> dict:
    """The ρ-guarded argmin over `dag_frontier` rows: the searches' own
    selection rule, exported so benchmark/demo read-outs apply the SAME
    guard instead of re-implementing it (when every row is unstable the
    objective-best row still wins — there is no sentinel tie)."""
    return _pick(rows, _objective_fn(objective, cost_weight), rho_max)


def _normalize_candidates(dag: JobDAG, stage_candidates) -> list[list]:
    # a flat list of policies (anything with a .label, i.e. any algebra
    # family) is shared by every stage; per-stage lists arrive as sequences
    if stage_candidates and hasattr(stage_candidates[0], "label"):
        stage_candidates = [list(stage_candidates)] * len(dag.stages)
    stage_candidates = [list(c) for c in stage_candidates]
    if len(stage_candidates) != len(dag.stages):
        raise ValueError(
            f"need one candidate list per stage ({len(dag.stages)}), "
            f"got {len(stage_candidates)}"
        )
    if any(not c for c in stage_candidates):
        raise ValueError("every stage needs at least one candidate policy")
    return stage_candidates


def _pinned_r_caps(stage_candidates) -> tuple:
    """One r_cap per stage covering every candidate, so every evaluation in
    a search shares one draw shape: comparisons across coordinate steps
    stay common-random-number consistent as the evaluated vector set flexes."""
    return tuple(max(max_replicas(p) for p in cands) + 1 for cands in stage_candidates)


def exhaustive_search(
    dag: JobDAG,
    stage_candidates,
    lam: float,
    n_jobs: int = 256,
    m_trials: int = 16,
    seed: int = 0,
    kernel: bool = False,
    objective: str = "latency",
    cost_weight: float = 0.0,
    rho_max: float = 0.95,
    device=None,
) -> dict:
    """Evaluate the full per-stage candidate cross-product in one fused
    dispatch and rank it.

    `stage_candidates` is either one candidate list per stage or a single
    flat list shared by every stage.  Returns {"best": row, "rows": all
    rows ranked by the objective, "n_cells": grid size}; each row carries
    the policy vector under "policies" and the critical-path shares under
    "<stage>/share".
    """
    stage_candidates = _normalize_candidates(dag, stage_candidates)
    vectors = [tuple(v) for v in itertools.product(*stage_candidates)]
    rows = dag_frontier(
        dag, vectors, (lam,), n_jobs, m_trials=m_trials, seed=seed, kernel=kernel,
        r_caps=_pinned_r_caps(stage_candidates), device=device,
    )
    obj = _objective_fn(objective, cost_weight)
    ranked = sorted(rows, key=obj)
    return dict(best=_pick(rows, obj, rho_max), rows=ranked, n_cells=len(vectors))


def coordinate_search(
    dag: JobDAG,
    stage_candidates,
    lam: float,
    n_jobs: int = 256,
    m_trials: int = 16,
    seed: int = 0,
    kernel: bool = False,
    objective: str = "latency",
    cost_weight: float = 0.0,
    rho_max: float = 0.95,
    init: Optional[Sequence] = None,
    max_sweeps: int = 4,
    device=None,
) -> dict:
    """Coordinate ascent over stages through the fused engine.

    Starts from `init` (default: each stage's spec policy), then repeatedly
    sweeps one stage's candidate list with the rest pinned, adopting the
    best vector found; converges when a full sweep over all stages changes
    nothing.  Total evaluations are Σ_s |candidates_s| per sweep — linear
    where the exhaustive grid is exponential — and every sweep reuses the
    same seed, so all comparisons share CRN draws.

    Returns {"best": row, "history": one row per adopted improvement,
    "n_evals": total cells evaluated, "sweeps": full sweeps run,
    "converged": whether a sweep ended with no change}.
    """
    stage_candidates = _normalize_candidates(dag, stage_candidates)
    obj = _objective_fn(objective, cost_weight)
    r_caps = _pinned_r_caps(
        [cands + [pol] for cands, pol in
         zip(stage_candidates, dag.validate_policy_vector(init))]
    )
    current = tuple(dag.validate_policy_vector(init))
    n_evals = 0
    best_row = None
    history: list[dict] = []
    converged = False
    sweeps = 0
    for _ in range(max_sweeps):
        sweeps += 1
        changed = False
        for s in range(len(dag.stages)):
            vectors = [
                tuple(current[:s]) + (cand,) + tuple(current[s + 1 :])
                for cand in stage_candidates[s]
            ]
            if current not in vectors:
                vectors.append(current)  # never regress the incumbent
            rows = dag_frontier(
                dag, vectors, (lam,), n_jobs, m_trials=m_trials, seed=seed,
                kernel=kernel, r_caps=r_caps, device=device,
            )
            n_evals += len(rows)
            pick = _pick(rows, obj, rho_max)
            # shared CRN + pinned r_caps: the incumbent's row is identical
            # across steps, so adoptions cannot cycle — stability moves are
            # one-way (a stable pick is only ever replaced by a stable one,
            # since the incumbent itself keeps a stable row in the running)
            # and stable-to-stable moves strictly improve the objective
            best_row = next(r for r in rows if r["policies"] == current)
            escape_unstable = (
                best_row["rho"] >= rho_max and pick["rho"] < rho_max
            )
            if pick["policies"] != current and (
                escape_unstable or obj(pick) < obj(best_row)
            ):
                # the ρ-guard outranks the objective, exactly as in _pick:
                # an unstable incumbent is abandoned for ANY stable pick
                current = pick["policies"]
                best_row = pick
                history.append(pick)
                changed = True
        if not changed:
            converged = True
            break
    return dict(
        best=best_row,
        history=history,
        n_evals=n_evals,
        sweeps=sweeps,
        converged=converged,
    )
